"""Superblock pack/unpack.

PyTorch port of the packing half of the JAX package's
``apex_tpu/multi_tensor/flat.py`` (reference ``apex_C.flatten`` /
``unflatten``, csrc/flatten_unflatten.cpp): the leaves of a tree are
concatenated in the JAX tree order into one 1-D buffer, each padded with
zeros to a multiple of ``align`` (default 128), and the total padded to a
multiple of ``max(align, total_multiple_of)``.  Offsets, sizes and values
are the JAX package's for the same tree.

A tree is nested dicts, ``OrderedDict``/``defaultdict``s, lists, tuples
and namedtuples (``None`` is an empty subtree); anything else is a leaf
(tensors, arrays or numbers), as in JAX.  Entries of a dict or a
``defaultdict`` are taken in sorted key order, of an ``OrderedDict`` in
insertion order, as JAX orders them; :class:`FlatSchema` keeps its own
description of the structure (``treedef``, the container types
included), since there is no JAX ``PyTreeDef`` here.  ``unflatten`` gives views of the superblock when the
dtype is unchanged, so a model whose parameters are rebound to those
views trains on the superblock itself.

:func:`repartition_flat` and :func:`reshard_stack` (numpy, host only)
re-partition a sharded checkpoint's stacked leaves for a new shard count,
as the JAX package's do; the checkpoint restore and
:func:`reshard_tree` (the in-memory twin, over structure-prefix
:class:`PartitionSpec` trees) share them.  :func:`reshard_stack_device`
is the on-device grow-or-keep form.

There is no JAX ``PartitionSpec`` here: :class:`PartitionSpec` is a plain
tuple (one entry per leading dim: an axis name, a tuple of names, or
``None``), marked by its type so that a tree of specs can be a structure
prefix of a state tree, as in JAX (``None`` in a spec tree: no spec).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict, defaultdict
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["FlatSchema", "PartitionSpec", "P", "make_schema", "flatten",
           "unflatten", "repartition_flat", "reshard_stack",
           "reshard_stack_device", "spec_lead_axes", "is_replicated_stack",
           "expand_specs", "reshard_tree"]

# treedef nodes: ("leaf",), ("none",), ("dict", type, default_factory,
# keys, children), ("seq", type, children); nested tuples, so hashable
_LEAF = ("leaf",)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _tree_flatten(tree) -> Tuple[List[Any], tuple]:
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return ("none",)
        kind = type(node)
        if kind in (dict, defaultdict, OrderedDict):
            keys = tuple(node) if kind is OrderedDict else tuple(sorted(node))
            factory = node.default_factory if kind is defaultdict else None
            return ("dict", kind, factory, keys,
                    tuple(walk(node[k]) for k in keys))
        if kind in (list, tuple) or _is_namedtuple(node):
            return ("seq", kind, tuple(walk(c) for c in node))
        leaves.append(node)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def _tree_unflatten(treedef: tuple, leaves) -> Any:
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
            if kind is defaultdict:
                return defaultdict(factory, items)
            return kind(items)
        _, kind, children = node
        items = [build(c) for c in children]
        return kind(items) if kind in (list, tuple) else kind(*items)

    return build(treedef)


def _round_up(n: int, align: int) -> int:
    return (n + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class FlatSchema:
    """Static metadata describing a packed superblock (hashable)."""

    treedef: tuple
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]  # start offset of each leaf (aligned)
    sizes: Tuple[int, ...]  # unpadded leaf sizes
    total: int  # total padded length
    align: int

    @property
    def num_tensors(self) -> int:
        return len(self.shapes)

    def leaf_slice(self, i: int) -> slice:
        return slice(self.offsets[i], self.offsets[i] + self.sizes[i])

    def segment_ids(self) -> torch.Tensor:
        """Per-element leaf index, int32 on the CPU (padding marked with
        ``num_tensors``): the offset table the reference keeps in kernel
        arguments (TensorListMetadata, csrc/multi_tensor_apply.cuh)."""
        ids = torch.full((self.total,), self.num_tensors, dtype=torch.int32)
        for i in range(self.num_tensors):
            ids[self.leaf_slice(i)] = i
        return ids


def make_schema(tree, *, align: int = 128,
                total_multiple_of: int = 1) -> FlatSchema:
    leaves, treedef = _tree_flatten(tree)
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        leaf = torch.as_tensor(leaf)
        shapes.append(tuple(leaf.shape))
        dtypes.append(leaf.dtype)
        offsets.append(off)
        sizes.append(leaf.numel())
        off += _round_up(leaf.numel(), align)
    total = _round_up(off, max(align, total_multiple_of))
    return FlatSchema(treedef=treedef, shapes=tuple(shapes),
                      dtypes=tuple(dtypes), offsets=tuple(offsets),
                      sizes=tuple(sizes), total=total, align=align)


def flatten(tree, schema: Optional[FlatSchema] = None, *,
            dtype: Optional[torch.dtype] = None, align: int = 128,
            total_multiple_of: int = 1) -> Tuple[torch.Tensor, FlatSchema]:
    """Pack a tree into one 1-D buffer on its first leaf's device.
    Returns ``(flat, schema)``.

    ``dtype`` forces a cast (e.g. bf16 grads into an fp32 superblock);
    by default the buffer takes the leaves' promoted dtype.  Differentiable
    (a concatenation), and a new buffer: the leaves are not aliased.
    """
    if schema is None:
        schema = make_schema(tree, align=align,
                             total_multiple_of=total_multiple_of)
    leaves = [torch.as_tensor(x) for x in _tree_flatten(tree)[0]]
    buf_dtype = dtype or functools.reduce(torch.promote_types, schema.dtypes)
    device = leaves[0].device if leaves else None
    parts: List[torch.Tensor] = []
    pos = 0
    for i, leaf in enumerate(leaves):
        pad = schema.offsets[i] - pos
        if pad:
            parts.append(torch.zeros(pad, dtype=buf_dtype, device=device))
        parts.append(leaf.reshape(-1).to(buf_dtype))
        pos = schema.offsets[i] + schema.sizes[i]
    if schema.total - pos:
        parts.append(torch.zeros(schema.total - pos, dtype=buf_dtype,
                                 device=device))
    return torch.cat(parts), schema


def unflatten(flat: torch.Tensor, schema: FlatSchema, *,
              dtype: Optional[torch.dtype] = None):
    """Rebuild the tree: views of the superblock where the leaf's dtype
    (or ``dtype``) is the buffer's, cast copies otherwise."""
    leaves = [flat[schema.leaf_slice(i)].reshape(schema.shapes[i]).to(
        dtype or schema.dtypes[i]) for i in range(schema.num_tensors)]
    return _tree_unflatten(schema.treedef, leaves)


def repartition_flat(flat: np.ndarray, new_size: int, *,
                     label: str = "flat buffer") -> np.ndarray:
    """Resize a 1-D flat superblock for a new shard topology.

    Only the ``total_multiple_of`` tail padding depends on the shard
    count, so an N->M re-partition is concat -> resize -> re-split, and
    the only legal size change is in the padding tail: growth
    zero-fills; shrinkage requires the dropped tail to be all zeros —
    anything else is real state and raises."""
    flat = np.ascontiguousarray(flat).reshape(-1)
    if new_size > flat.size:
        out = np.zeros((new_size,), flat.dtype)
        out[: flat.size] = flat
        return out
    if new_size < flat.size:
        if np.any(flat[new_size:] != 0):
            raise ValueError(
                f"cannot repartition {label} from {flat.size} to "
                f"{new_size} elements: the {flat.size - new_size} dropped "
                "trailing elements are not all zero — that region holds "
                "real state, not flat-schema padding (schema mismatch?)")
        return flat[:new_size]
    return flat


def reshard_stack(val: np.ndarray, n_lead: int, want_shape, *,
                  replicated: bool = False,
                  label: str = "sharded stack") -> np.ndarray:
    """Re-partition one stacked sharded leaf across topologies.

    ``val`` is a ``[n_a, n_b, ..., *content]`` stack whose first
    ``n_lead`` dims are per-rank stack axes; ``want_shape`` is the
    target's stacked shape.  ``replicated`` (broadcast step counters):
    coordinate (0, ..., 0) speaks for the whole new topology and the
    content shape must match.  Otherwise the leaf's logical value is its
    C-order flatten, re-partitioned under :func:`repartition_flat`'s
    pad/trim contract and reshaped to ``want_shape``."""
    val = np.asarray(val)
    want_shape = tuple(int(x) for x in want_shape)
    if n_lead >= val.ndim + 1 and not replicated:
        raise ValueError(
            f"cannot reshard {label}: {n_lead} stack axes on a "
            f"{val.ndim}-D array")
    if replicated:
        n_lead = min(n_lead, val.ndim)
        content = val[(0,) * n_lead]
        tail = want_shape[len(want_shape) - content.ndim:] if content.ndim \
            else ()
        if content.shape != tuple(tail):
            raise ValueError(
                f"cannot reshard replicated {label}: per-rank shape "
                f"{content.shape} != target per-rank shape {tuple(tail)}")
        # contiguous: callers may .view() raw-bits stored dtypes
        return np.ascontiguousarray(np.broadcast_to(content, want_shape))
    out = repartition_flat(val, int(np.prod(want_shape, dtype=np.int64)),
                           label=label)
    return out.reshape(want_shape)


class PartitionSpec(tuple):
    """A leaf's partition spec: one entry per leading dim (a mesh axis
    name, a tuple of names, or ``None``), as ``jax.sharding.
    PartitionSpec(*parts)``; ``PartitionSpec()`` is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"

    def __reduce__(self):
        # rebuilt from its parts (a tuple subclass would otherwise come
        # back as one entry holding them all)
        return (type(self), tuple(self))


P = PartitionSpec


def _is_spec_leaf(x) -> bool:
    return x is None or isinstance(x, PartitionSpec)


def expand_specs(spec_tree, tree) -> list:
    """One spec (or None) per leaf of ``tree``, in its leaf order, from a
    ``spec_tree`` that is a structure prefix of it: a spec leaf covers
    every leaf of the subtree it stands over (the ``pjit`` rule)."""
    out: list = []

    def walk(spec, node):
        if _is_spec_leaf(spec):
            out.extend([spec] * len(_tree_flatten(node)[0]))
            return
        kind = type(node)
        if kind in (dict, defaultdict, OrderedDict):
            keys = tuple(node) if kind is OrderedDict else tuple(sorted(node))
            if set(spec) != set(keys):
                raise ValueError("shardings tree is not a structure prefix "
                                 f"of the state tree: keys {sorted(spec)} "
                                 f"vs {list(keys)}")
            for k in keys:
                walk(spec[k], node[k])
            return
        if node is None:
            return
        if isinstance(node, (list, tuple)) and len(spec) == len(node):
            for s_, n_ in zip(spec, node):
                walk(s_, n_)
            return
        raise ValueError("shardings tree is not a structure prefix of the "
                         f"state tree at a {kind.__name__}")

    walk(spec_tree, tree)
    return out


def reshard_stack_device(val: torch.Tensor, want_shape) -> torch.Tensor:
    """On-device twin of :func:`reshard_stack`'s non-replicated branch for
    the grow/equal cases: C-order flatten, zero-pad the schema tail,
    reshape.  Trims stay host-side: the all-zero-tail check
    (:func:`repartition_flat`) is a data-dependent host decision."""
    want_shape = tuple(int(x) for x in want_shape)
    new_size = int(np.prod(want_shape, dtype=np.int64))
    flat = torch.as_tensor(val).reshape(-1)
    if new_size < flat.numel():
        raise ValueError(
            f"reshard_stack_device only grows or keeps size "
            f"({flat.numel()} -> {new_size} shrinks): trims need the "
            "host-side reshard_stack, whose all-zero-tail check is a "
            "data-dependent decision")
    if new_size > flat.numel():
        flat = torch.cat([flat, flat.new_zeros(new_size - flat.numel())])
    return flat.reshape(want_shape)


def spec_lead_axes(spec, axes) -> list:
    """Leading mesh-axis names of a spec: walk entries from dim 0 while
    each names exactly one axis in ``axes`` (str, or a 1-tuple); stop at
    the first entry that does not."""
    lead = []
    for part in (spec or ()):
        if isinstance(part, (tuple, list)):
            part = part[0] if len(part) == 1 else None
        if part in axes:
            lead.append(part)
        else:
            break
    return lead


def is_replicated_stack(val, n_lead: int) -> bool:
    """Per-rank replicated broadcast value: scalar content (ndim ==
    n_lead) with every coordinate equal.  A content stack of one or more
    dims is by contract a data partition even when rank-identical (fresh
    all-zero moments must reshard by concat)."""
    val = np.asarray(val)
    if val.ndim != n_lead:
        return False
    flat = val.reshape(-1)
    return bool(np.all(flat == flat[0]))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            return t.view(torch.int16).numpy()     # raw bits: moved, not cast
        return t.numpy()
    return np.asarray(leaf)


def reshard_tree(tree, spec_from, spec_to, *, target, axes_from,
                 axes_to=None, label: str = "state"):
    """Re-stack every leaf of ``tree`` whose ``spec_from`` spec leads with
    mesh-axis names to the shape of the matching ``target`` leaf (an N->M
    reshape of the (dp, pp, tp) topology; the in-memory twin of the
    format-4 checkpoint reshard, sharing :func:`reshard_stack`).

    ``spec_from`` / ``spec_to`` — structure-prefix spec trees of the
    source and target states; ``axes_from`` / ``axes_to`` — axis name ->
    size of the two topologies.  Leaves with no leading axis names pass
    through unchanged; the others come back as tensors of the source
    leaf's dtype on its device, bit for bit (a host pass, once per mesh
    rebuild)."""
    axes_to = dict(axes_to if axes_to is not None else axes_from)
    leaves, treedef = _tree_flatten(tree)
    tgt_leaves = _tree_flatten(target)[0]
    specs_f = expand_specs(spec_from, tree)
    specs_t = expand_specs(spec_to, target)
    if not (len(leaves) == len(tgt_leaves) == len(specs_f) == len(specs_t)):
        raise ValueError(
            f"reshard_tree({label}): tree/target/spec leaf counts "
            f"disagree ({len(leaves)}/{len(tgt_leaves)}/{len(specs_f)}/"
            f"{len(specs_t)})")
    out = []
    for i, (leaf, tgt) in enumerate(zip(leaves, tgt_leaves)):
        lead_f = spec_lead_axes(specs_f[i], axes_from)
        lead_t = spec_lead_axes(specs_t[i], axes_to)
        if not lead_f and not lead_t:
            out.append(leaf)
            continue
        val = _host(leaf)
        res = reshard_stack(val, len(lead_f), tuple(tgt.shape),
                            replicated=is_replicated_stack(val, len(lead_f)),
                            label=f"{label} leaf {i}")
        t = torch.from_numpy(np.ascontiguousarray(res))
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype in (torch.bfloat16, torch.float16):
                t = t.view(leaf.dtype)
            t = t.to(leaf.device)
        out.append(t)
    return _tree_unflatten(treedef, out)
