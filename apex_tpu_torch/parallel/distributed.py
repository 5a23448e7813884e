"""Data-parallel gradient reduction.

PyTorch port of the JAX package's ``apex_tpu/parallel/distributed.py``
(reference apex/parallel/distributed.py:129-639 and ``Reducer``
:89-126).  The JAX module reduces a gradient tree with a ``psum`` over
the mesh's data axis inside the compiled step; here the same tree is
reduced over the data-parallel process group
(:func:`apex_tpu_torch.transformer.parallel_state.get_data_parallel_group`
by default), after the backward.  The numerics contract is the JAX
module's (its table, distributed.py:35-76):

=========================  ============================================
gradient_average           divide the summed gradients by the world size
gradient_predivide_factor  g / f before the sum, / (world / f) after
allreduce_always_fp32      reduce in fp32, cast back to the grad's dtype
=========================  ============================================

A bf16 or fp16 sum is taken in fp32 and rounded once in any case
(:mod:`apex_tpu_torch.parallel.comm`).  :class:`DistributedDataParallel`
is the JAX module's callable reducer with the reference's constructor
surface: the options that manage eager overlap (``message_size``,
``delay_allreduce``, ``num_allreduce_streams``, ...) are accepted and
recorded, and reduce nothing differently.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.parallel import comm
from apex_tpu_torch.utils.tree import _map

#: the registered data-parallel group
#: (:func:`apex_tpu_torch.transformer.parallel_state.group_of`)
DATA = "data"


def _data_group(group):
    from apex_tpu_torch.transformer import parallel_state

    return parallel_state.group_of(group)


def all_reduce_grads(grads: Any, group=DATA, *,
                     gradient_average: bool = True,
                     gradient_predivide_factor: float = 1.0,
                     allreduce_always_fp32: bool = False) -> Any:
    """The gradient tree (tensors in dicts, lists and tuples) reduced over
    ``group`` (default: the registered data-parallel group; ``None``: one
    rank), new tensors in the grads' dtypes."""
    group = _data_group(group)
    world = comm.group_size(group)

    def reduce_one(g):
        dtype = g.dtype
        if allreduce_always_fp32:
            g = g.float()
        if gradient_predivide_factor != 1.0:
            g = g / gradient_predivide_factor
        g = comm.all_reduce(g, group)
        if gradient_average:
            if gradient_predivide_factor != 1.0:
                g = g / (world / gradient_predivide_factor)
            else:
                g = g / world
        elif gradient_predivide_factor != 1.0:
            g = g * gradient_predivide_factor
        return g.to(dtype)

    return _map(lambda _, g: reduce_one(g), grads)


@torch.no_grad()
def broadcast_params(params: Any, group=DATA) -> Any:
    """Every rank of ``group`` takes its rank 0's values, written into the
    tensors in place (the broadcast the reference performs when it builds
    DDP, distributed.py:253-256); returns ``params``."""
    group = _data_group(group)
    if comm.group_size(group) == 1:
        return params
    import torch.distributed as dist

    src = dist.get_global_rank(group, 0)

    def bcast(p):
        p.copy_(comm.broadcast(p.detach(), src, group))
        return p

    _map(lambda _, p: bcast(p), params)
    return params


class DistributedDataParallel:
    """Callable gradient reducer with the reference's constructor
    (distributed.py:162-189): ``ddp(grads)`` is :func:`all_reduce_grads`
    with the instance's options.  Built with ``module=`` (as
    ``pipeline_parallel.build_model`` wraps each chunk), it holds the
    module at ``.module`` and reads every other attribute through to it
    (``ddp.parameters()``, a stage's ``pre_process``); calling it still
    reduces gradients."""

    def __init__(self, group=DATA, message_size: int = 10_000_000,
                 delay_allreduce: bool = False,
                 shared_param: Optional[bool] = None,
                 allreduce_trigger_params: Optional[list] = None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators: Optional[tuple] = None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 gradient_average_split_factor: Optional[float] = None,
                 prof: bool = False, *, module=None):
        self.module = module
        self.group = group
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        # eager-only knobs, kept for the reference's surface
        self._ignored = dict(message_size=message_size,
                             delay_allreduce=delay_allreduce,
                             num_allreduce_streams=num_allreduce_streams,
                             prof=prof)

    def __getattr__(self, name):
        module = self.__dict__.get("module")
        if module is None:
            raise AttributeError(name)
        return getattr(module, name)

    def __call__(self, grads: Any) -> Any:
        return all_reduce_grads(
            grads, self.group, gradient_average=self.gradient_average,
            gradient_predivide_factor=self.gradient_predivide_factor,
            allreduce_always_fp32=self.allreduce_always_fp32)

    reduce = __call__


class Reducer:
    """Manual reducer (reference distributed.py:89-126): the caller
    reduces when ready with ``reducer.reduce(grads)``."""

    def __init__(self, group=DATA, gradient_average: bool = True):
        self.group = group
        self.gradient_average = gradient_average

    def reduce(self, tree: Any) -> Any:
        return all_reduce_grads(tree, self.group,
                                gradient_average=self.gradient_average)


__all__ = ["all_reduce_grads", "broadcast_params", "DistributedDataParallel",
           "Reducer"]
