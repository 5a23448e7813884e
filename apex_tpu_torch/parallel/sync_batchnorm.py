"""SyncBatchNorm: batch norm with the JAX package's arithmetic, its
statistics over a group of ranks.

PyTorch port of the JAX package's ``apex_tpu/parallel/sync_batchnorm.py``
(reference ``apex.parallel.SyncBatchNorm``).  The statistics are the JAX
ones, in its order: fp32 sums of x and x^2 over every axis but the
channel's, ``var = E[x^2] - mean^2`` (biased), the running variance made
unbiased by ``n / max(n - 1, 1)``, and the output computed in fp32 and
rounded once to the input's dtype.  ``F.batch_norm`` computes its
variance another way, so it is not used.

Across ranks the sums, the sums of squares and the count are summed over
the group in one all-reduce of a packed ``[2C + 1]`` fp32 tensor (JAX's
three ``psum``s over the mesh axis), so ranks with unequal batches weigh
in by their counts.  The group is named as :func:`resolve_group` takes
it: ``None``, a ``torch.distributed`` ``ProcessGroup``, or a kind name
that :func:`apex_tpu_torch.transformer.parallel_state.group_of` knows
(``"data"``).  A name that resolves to no group while the world is above
one rank raises: it would otherwise mean this rank alone.

The training forward and backward are one ``autograd.Function``: the
backward is the analytic gradient of that forward (what JAX's AD derives
from it), from the saved input in its own dtype, so no fp32 copy of an
activation is kept for the backward.  Across ranks it sums the pair
(sum dy, sum dy * xhat) over the group, again packed into one tensor,
and divides by the global count (reference
``optimized_sync_batchnorm_kernel.py:93-111``): the input gradient of
the sum of every rank's loss, as JAX's ``psum`` transposes into a
``psum``.  The weight and bias gradients stay this rank's own, for the
data-parallel all-reduce to average.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import comm


def _world() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def resolve_group(group: Any, what: str = "axis_name"):
    """The process group that ``group`` names: ``None`` (this rank
    alone), a ``torch.distributed`` ``ProcessGroup`` as it is, or a kind
    name (``"data"``, ``"tensor"``, ...) looked up with
    :func:`~apex_tpu_torch.transformer.parallel_state.group_of`.  A name
    with no registered group is this rank alone at a world of one (JAX's
    axis of one device) and raises ``ValueError`` above one."""
    if group is None:
        return None
    if isinstance(group, str):
        from apex_tpu_torch.transformer import parallel_state

        found = parallel_state.group_of(group)
        if found is None and _world() > 1:
            raise ValueError(
                f"{what}={group!r} names no registered process group at a "
                f"world of {_world()} ranks: call parallel_state."
                "initialize_model_parallel on every rank first, or pass a "
                "torch.distributed ProcessGroup")
        return found
    dist = torch.distributed
    if dist.is_available() and isinstance(group, dist.ProcessGroup):
        return group
    raise TypeError(f"{what}={group!r}: expected None, a process group or "
                    "a group's kind name")


def _reduce_dims(x: torch.Tensor, channel_axis: int) -> Tuple[int, ...]:
    c = channel_axis % x.ndim
    return tuple(i for i in range(x.ndim) if i != c)


def _bshape(x: torch.Tensor, channel_axis: int) -> list:
    shape = [1] * x.ndim
    c = channel_axis % x.ndim
    shape[c] = x.shape[c]
    return shape


def sync_batch_norm_stats(x: torch.Tensor, axis_name: Any = None,
                          channel_axis: int = -1):
    """(mean, biased var, count) per channel over ``x`` on every rank of
    the group ``axis_name`` names, fp32; ``count`` a 0-d fp32 tensor, as
    the JAX function returns it."""
    group = resolve_group(axis_name)
    dims = _reduce_dims(x, channel_axis)
    n = 1
    for d in dims:
        n *= x.shape[d]
    # a tensor divisor: a division by a Python number may run as a
    # product with its rounded reciprocal
    n = torch.full((), float(n), dtype=torch.float32, device=x.device)
    x32 = x.float()
    s = torch.sum(x32, dim=dims)
    sq = torch.sum(x32 * x32, dim=dims)
    if comm.group_size(group) > 1:
        c = s.numel()
        packed = comm.all_reduce(torch.cat([s, sq, n.reshape(1)]), group)
        s, sq, n = packed[:c], packed[c:2 * c], packed[2 * c]
    mean = s / n
    var = sq / n - mean * mean
    return mean, var, n


def update_running_stats(running_mean, running_var, mean, var, n, momentum):
    """The EMA of the running statistics with the unbiased ``n/(n-1)``
    variance (shared by SyncBN and GroupBN, as in the JAX package)."""
    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    return ((1 - momentum) * running_mean + momentum * mean,
            (1 - momentum) * running_var + momentum * unbiased)


def affine(x, mean, invstd, weight, bias, shape):
    y = (x.float() - mean.reshape(shape)) * invstd.reshape(shape)
    if weight is not None:
        y = y * weight.float().reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y


class BatchStatsNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * w + b over the batch's own
    statistics, pooled over ``group`` (a process group or None):
    ``apply(x, weight, bias, channel_axis, eps, out_dtype, group=None)``
    returns (y in ``out_dtype``, mean, var, count), the statistics not
    differentiated (they feed the running state only)."""

    @staticmethod
    def forward(ctx, x, weight, bias, channel_axis, eps, out_dtype,
                group=None):
        mean, var, n = sync_batch_norm_stats(x, group, channel_axis)
        invstd = torch.rsqrt(var + eps)
        shape = _bshape(x, channel_axis)
        y = affine(x, mean, invstd, weight, bias, shape).to(out_dtype)
        ctx.save_for_backward(x, weight, bias, mean, invstd, n)
        ctx.channel_axis = channel_axis
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        x, weight, bias, mean, invstd, n = ctx.saved_tensors
        shape = _bshape(x, ctx.channel_axis)
        dims = _reduce_dims(x, ctx.channel_axis)
        xhat = (x.float() - mean.reshape(shape)) * invstd.reshape(shape)
        dy32 = dy.float()
        dbias = torch.sum(dy32, dim=dims)
        dweight = torch.sum(dy32 * xhat, dim=dims)
        sum_dy, sum_dy_xhat = dbias, dweight
        if comm.group_size(ctx.group) > 1:
            c = dbias.numel()
            packed = comm.all_reduce(torch.cat([dbias, dweight]), ctx.group)
            sum_dy, sum_dy_xhat = packed[:c], packed[c:]
        scale = invstd if weight is None else invstd * weight.float()
        dx = (dy32 - (sum_dy / n).reshape(shape)
              - xhat * (sum_dy_xhat / n).reshape(shape)) * scale.reshape(shape)
        return (dx.to(x.dtype),
                None if weight is None else dweight.to(weight.dtype),
                None if bias is None else dbias.to(bias.dtype), None, None,
                None, None)


def sync_batch_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor],
                    running_mean: Optional[torch.Tensor] = None,
                    running_var: Optional[torch.Tensor] = None, *,
                    axis_name: Any = None, training: bool = True,
                    momentum: float = 0.1, eps: float = 1e-5,
                    channel_axis: int = -1):
    """Functional batch norm: ``(y, new_running_mean, new_running_var)``.

    Training uses the batch's statistics over the group ``axis_name``
    names (:func:`resolve_group`) and returns the updated running ones
    (None without running stats).  Eval normalises with the running
    statistics when given, with no collective, else with the batch's
    (torch ``_BatchNorm``'s contract)."""
    if training or running_mean is None:
        group = resolve_group(axis_name)
        y, mean, var, n = BatchStatsNorm.apply(x, weight, bias,
                                               channel_axis, eps, x.dtype,
                                               group)
        if training and running_mean is not None:
            new_rm, new_rv = update_running_stats(
                running_mean, running_var, mean, var, n, momentum)
        elif running_mean is not None:
            new_rm, new_rv = running_mean, running_var
        else:
            new_rm = new_rv = None
        return y, new_rm, new_rv
    invstd = torch.rsqrt(running_var.float() + eps)
    y = affine(x, running_mean.float(), invstd, weight, bias,
                _bshape(x, channel_axis))
    return y.to(x.dtype), running_mean, running_var


class SyncBatchNorm(nn.Module):
    """``apex.parallel.SyncBatchNorm`` (torch ``_BatchNorm``'s arguments,
    ``process_group`` and ``channel_last``): parameters ``weight``/``bias``
    and buffers ``running_mean``/``running_var`` (fp32), updated in place
    by a training forward with the statistics of every rank of
    ``process_group`` (as :func:`resolve_group` takes it; ``None`` is
    this rank alone).  ``channel_last`` (the default, as in the JAX
    package) normalises the last axis, else axis 1 (NCHW).  Built on the
    card unless ``device`` says otherwise."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, process_group: Any = None,
                 channel_last: bool = True, fuse_relu: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        resolve_group(process_group, "process_group")
        device = resolve_device(device)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.process_group = process_group
        self.channel_axis = -1 if channel_last else 1
        self.fuse_relu = fuse_relu
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device,
                                                  dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device,
                                                 dtype=dtype))
        else:
            self.weight = self.bias = None
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(
                num_features, device=device, dtype=torch.float32))
            self.register_buffer("running_var", torch.ones(
                num_features, device=device, dtype=torch.float32))
        else:
            self.running_mean = self.running_var = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, rm, rv = sync_batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            axis_name=self.process_group, training=self.training,
            momentum=self.momentum, eps=self.eps,
            channel_axis=self.channel_axis)
        if self.training and self.track_running_stats:
            with torch.no_grad():
                self.running_mean.copy_(rm)
                self.running_var.copy_(rv)
        return torch.relu(y) if self.fuse_relu else y


def convert_syncbn_model(module: Any, process_group: Any = None,
                         channel_last: bool = False, *, device=None) -> Any:
    """Every batch norm of ``module`` swapped for a :class:`SyncBatchNorm`
    (reference apex/parallel/__init__.py:21-57): an ``nn.Module`` tree is
    rebuilt with the norms' parameters and running statistics copied;
    lists, tuples and dicts are walked as the JAX function walks them,
    and any other object with ``num_features`` is rebuilt from its
    settings (on ``device``, the card by default).  Each norm pools its
    statistics over ``process_group``.  ``channel_last=False`` keeps
    torch's NCHW norms."""
    resolve_group(process_group, "process_group")
    if isinstance(module, SyncBatchNorm):
        return module
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        out = SyncBatchNorm(module.num_features, module.eps,
                            module.momentum if module.momentum is not None
                            else 0.1, module.affine,
                            module.track_running_stats, process_group,
                            channel_last, device=_device_of(module))
        with torch.no_grad():
            if module.affine:
                out.weight.copy_(module.weight)
                out.bias.copy_(module.bias)
            if module.track_running_stats:
                out.running_mean.copy_(module.running_mean)
                out.running_var.copy_(module.running_var)
        return out
    if isinstance(module, nn.Module):
        for name, child in list(module.named_children()):
            setattr(module, name, convert_syncbn_model(
                child, process_group, channel_last))
        return module
    if isinstance(module, (list, tuple)):
        return type(module)(convert_syncbn_model(m, process_group,
                                                 channel_last, device=device)
                            for m in module)
    if isinstance(module, dict):
        return {k: convert_syncbn_model(v, process_group, channel_last,
                                        device=device)
                for k, v in module.items()}
    if hasattr(module, "num_features"):
        return SyncBatchNorm(
            module.num_features, eps=getattr(module, "eps", 1e-5),
            momentum=getattr(module, "momentum", 0.1),
            affine=getattr(module, "affine", True),
            track_running_stats=getattr(module, "track_running_stats", True),
            process_group=process_group, channel_last=channel_last,
            device=device)
    return module


def _device_of(module: nn.Module):
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return "cpu"


def bn_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX batch norm's ``{"params": ..., "state": ...}`` (numpy or JAX
    arrays) as the ``state_dict`` of :class:`SyncBatchNorm` or GroupBN's
    ``BatchNorm2d_NHWC``: the same names and layouts, fp32."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for part in ("params", "state")
            for k, v in variables.get(part, {}).items()}


def create_syncbn_process_group(group_size: int, world_size: int):
    """BN groups of ``group_size`` consecutive ranks (reference
    apex/parallel/__init__.py:60-95): ``dist.new_group`` for every block
    of ranks, called on every rank in the same order; returns the group
    holding this rank.  ``group_size`` must divide ``world_size``
    (``ValueError``, as in the JAX package), which must be the process
    group's world.  A group of one rank is this rank alone: ``None``.
    (The JAX function returns the axis names of a split data axis; here a
    group is a process group.)"""
    if group_size <= 0 or world_size % group_size != 0:
        raise ValueError("group_size must divide world_size")
    if world_size != _world():
        raise ValueError(f"world_size={world_size} is not the process "
                         f"group's world of {_world()} ranks")
    if group_size == 1:
        return None
    dist = torch.distributed
    rank = dist.get_rank()
    mine = None
    for start in range(0, world_size, group_size):
        g = dist.new_group(ranks=list(range(start, start + group_size)))
        if start <= rank < start + group_size:
            mine = g
    return mine


__all__ = ["BatchStatsNorm", "SyncBatchNorm", "affine",
           "bn_state_dict_from_jax", "convert_syncbn_model",
           "create_syncbn_process_group", "resolve_group", "sync_batch_norm",
           "sync_batch_norm_stats", "update_running_stats"]
