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

Not ported yet (ROADMAP.md): ``repartition_flat``, ``reshard_stack*``,
``reshard_tree``, ``spec_lead_axes`` and ``is_replicated_stack``, which
serve checkpoint resharding across a mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict, defaultdict
from typing import Any, List, Optional, Tuple

import torch

__all__ = ["FlatSchema", "make_schema", "flatten", "unflatten"]

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
