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
as the JAX package's do; the checkpoint restore uses them to bring a
sharded save onto one card.  Not ported yet (ROADMAP.md):
``reshard_stack_device``, ``reshard_tree``, ``spec_lead_axes`` and
``is_replicated_stack``, which serve sharded saves and live resharding
across a mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict, defaultdict
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["FlatSchema", "make_schema", "flatten", "unflatten",
           "repartition_flat", "reshard_stack"]

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
