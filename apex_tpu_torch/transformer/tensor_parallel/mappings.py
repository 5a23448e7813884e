"""The four tensor-parallel regions, as ``torch.autograd.Function``\\ s.

PyTorch port of the JAX package's ``apex_tpu/transformer/tensor_parallel/
mappings.py`` in the reference's form (reference mappings.py:77-159):
JAX derives each backward by transposing the collective inside
``shard_map``; PyTorch's autograd cannot transpose a collective, so each
region writes its pair:

========  ================  ==============
 region    forward           backward
========  ================  ==============
 copy      identity          all-reduce
 reduce    all-reduce        identity
 scatter   split last dim    all-gather
 gather    all-gather        split last dim
========  ================  ==============

``group`` is a process group (``None``: one shard, every region the
identity); the default, :data:`TENSOR`, is the registered tensor group of
:mod:`apex_tpu_torch.transformer.parallel_state` (one shard when nothing
is registered).  The collectives are :mod:`apex_tpu_torch.parallel.comm`'s
(half sums taken in fp32 and rounded once; staged through the host under
gloo).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import parallel_state

#: the registered tensor-parallel group (:func:`parallel_state.group_of`)
TENSOR = "tensor"


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.split(x, group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return comm.split(g, ctx.group), None


def _apply(fn, x, group):
    group = parallel_state.group_of(group)
    if comm.group_size(group) == 1:
        return x
    return fn.apply(x, group)


def copy_to_tensor_model_parallel_region(x, group=TENSOR):
    """Identity forward, all-reduce backward (reference :77-91)."""
    return _apply(_Copy, x, group)


def reduce_from_tensor_model_parallel_region(x, group=TENSOR):
    """All-reduce forward, identity backward (reference :93-107)."""
    return _apply(_Reduce, x, group)


def scatter_to_tensor_model_parallel_region(x, group=TENSOR):
    """This rank's chunk of the last dim; backward all-gathers
    (reference :109-123)."""
    return _apply(_Scatter, x, group)


def gather_from_tensor_model_parallel_region(x, group=TENSOR):
    """All-gather along the last dim; backward splits (reference
    :125-139)."""
    return _apply(_Gather, x, group)


__all__ = ["TENSOR", "copy_to_tensor_model_parallel_region",
           "reduce_from_tensor_model_parallel_region",
           "scatter_to_tensor_model_parallel_region",
           "gather_from_tensor_model_parallel_region"]
