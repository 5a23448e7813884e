"""Tensor-list forms of the JAX package's pytree utilities
(``apex_tpu/utils/tree.py``).

A "tree" here is a tensor, a list or tuple of them, or a dict of them
(a ``state_dict``, or ``named_parameters`` as a dict); non-tensor leaves
pass through.  :func:`tree_isfinite` and :func:`tree_global_norm` take
any iterable of tensors and answer with a device scalar: nothing here
reads a device value back to the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

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


__all__ = ["tree_cast", "tree_select", "tree_select_", "tree_isfinite",
           "tree_global_norm"]
