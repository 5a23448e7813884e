"""Tensor-list forms of the JAX package's pytree utilities
(``apex_tpu/utils/tree.py``).

A "tree" here is a tensor, a list or tuple of them, or a dict of them
(a ``state_dict``, or ``named_parameters`` as a dict); non-tensor leaves
pass through.  :func:`tree_isfinite` and :func:`tree_global_norm` take
any iterable of tensors and answer with a device scalar: nothing here
reads a device value back to the host.

:func:`tree_flatten_with_path`, :func:`tree_unflatten` and
:func:`keystr` walk a general tree (dicts, ``OrderedDict`` and
``defaultdict``, lists, tuples and namedtuples; ``None`` an empty
subtree; anything else a leaf) in the JAX tree order and name each leaf
as ``jax.tree_util.keystr`` does: ``['key']`` for a dict entry,
``[i]`` for a list or tuple item, ``.field`` for a namedtuple field.
The checkpoint manifests key their leaves by these names.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch


def _map(fn, tree, path=()):
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v, path + (k,)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return tree


def tree_cast(tree, dtype: torch.dtype, *,
              predicate: Optional[Callable] = None):
    """Every floating-point tensor of ``tree`` cast to ``dtype``.
    ``predicate(path, tensor) -> bool`` (path: the tuple of dict keys and
    list indices down to the tensor) may veto single tensors."""

    def cast(path, x):
        if x.is_floating_point() and (predicate is None
                                      or predicate(path, x)):
            return x.to(dtype)
        return x

    return _map(cast, tree)


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    _map(lambda _, t: out.append(t), tree)
    return out


def tree_size(tree) -> int:
    """The number of elements of every tensor of ``tree``."""
    return sum(t.numel() for t in _leaves(tree))


def tree_zeros_like(tree):
    """``tree`` with every tensor replaced by zeros of its shape, dtype and
    device."""
    return _map(lambda _, t: torch.zeros_like(t), tree)


def tree_select(pred: torch.Tensor, on_true: Iterable[torch.Tensor],
                on_false: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Branchless select, tensor by tensor: ``where(pred, a, b)`` (the
    skip-step primitive of amp and the optimizers)."""
    return [torch.where(pred, a, b) for a, b in zip(on_true, on_false)]


def tree_select_(pred: torch.Tensor, dst: Iterable[torch.Tensor],
                 on_false: Iterable[torch.Tensor]) -> None:
    """In place: each ``dst`` tensor keeps its values where ``pred`` and
    takes ``on_false``'s bits otherwise (``where(pred, dst, b)`` written
    into ``dst``)."""
    for d, b in zip(dst, on_false):
        torch.where(pred, d, b, out=d)


def _floats(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    return [t for t in tensors if t.is_floating_point()]


def tree_isfinite(tensors: Iterable[torch.Tensor],
                  device=None) -> torch.Tensor:
    """One all-finite check over every floating tensor: a device bool.
    The max-abs norm of each tensor is taken by one fused
    ``torch._foreach_norm`` (it propagates a NaN, and an inf stays inf),
    and the norms are AND-reduced on the device.  ``device`` places the
    answer when there is no floating tensor."""
    floats = _floats(tensors)
    if not floats:
        return torch.ones((), dtype=torch.bool, device=device)
    norms = torch._foreach_norm(floats, ord=float("inf"))
    return torch.isfinite(torch.stack(norms)).all()


def tree_global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The l2 norm over every tensor, in fp32 (the JAX package's
    ``sqrt(sum(sum(x^2)))``), a device scalar."""
    tensors = [t.float() for t in tensors]
    if not tensors:
        return torch.tensor(0.0)
    sq = torch.stack([torch.sum(t * t) for t in tensors])
    return torch.sqrt(sq.sum())


# a path is a tuple of (kind, key) pairs, kind "dict", "seq" or "attr"
# (JAX's DictKey, SequenceKey and GetAttrKey)
Path = Tuple[Tuple[str, Any], ...]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[Path, Any]], tuple]:
    """``([(path, leaf), ...], treedef)`` in the JAX tree order: a dict's
    and a ``defaultdict``'s entries by sorted key, an ``OrderedDict``'s
    in insertion order, sequences and namedtuples in order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if node is None:
            return ("none",)
        kind = type(node)
        if kind in (dict, defaultdict, OrderedDict):
            keys = tuple(node) if kind is OrderedDict else tuple(sorted(node))
            factory = node.default_factory if kind is defaultdict else None
            return ("dict", kind, factory, keys, tuple(
                walk(node[k], path + (("dict", k),)) for k in keys))
        if _is_namedtuple(node):
            return ("seq", kind, tuple(
                walk(v, path + (("attr", f),))
                for f, v in zip(kind._fields, node)))
        if kind in (list, tuple):
            return ("seq", kind, tuple(walk(v, path + (("seq", i),))
                                       for i, v in enumerate(node)))
        out.append((path, node))
        return ("leaf",)

    treedef = walk(tree, ())
    return out, treedef


def tree_unflatten(treedef: tuple, leaves) -> Any:
    """The tree of ``treedef`` (from :func:`tree_flatten_with_path`)
    with ``leaves`` in its leaf order."""
    it = iter(leaves)

    def build(node):
        tag = node[0]
        if tag == "leaf":
            return next(it)
        if tag == "none":
            return None
        if tag == "dict":
            _, kind, factory, keys, children = node
            items = [(k, build(c)) for k, c in zip(keys, children)]
            return (defaultdict(factory, items) if kind is defaultdict
                    else kind(items))
        _, kind, children = node
        items = [build(c) for c in children]
        return kind(items) if kind in (list, tuple) else kind(*items)

    return build(treedef)


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a path: ``[repr(key)]``, ``[i]`` and
    ``.name`` joined."""
    return "".join(f"[{k!r}]" if kind == "dict" else f"[{k}]"
                   if kind == "seq" else f".{k}" for kind, k in path)


def path_parts(path: Path) -> List[str]:
    """The path's keys, indices and field names as strings (the
    checkpoint manifest's ``path`` entry)."""
    return [str(k) for _, k in path]


__all__ = ["tree_flatten_with_path", "tree_unflatten", "keystr",
           "path_parts", "tree_cast", "tree_select", "tree_select_",
           "tree_size", "tree_zeros_like",
           "tree_isfinite", "tree_global_norm"]
