"""GroupBN's ``BatchNorm2d_NHWC``.

PyTorch port of the JAX package's ``apex_tpu/contrib/groupbn/batch_norm.py``
(reference apex/contrib/groupbn): NHWC batch norm with the statistics of
:mod:`apex_tpu_torch.parallel.sync_batchnorm`, ``fuse_relu``, and the
``bn_addrelu`` form that adds a residual ``z`` before the relu — the add
and the relu in fp32, then one rounding to the input's dtype, as in the
JAX module.  The ``minibatch_mean`` / ``minibatch_riv`` buffers hold the
last training batch's mean and inverse standard deviation, as the
reference's do.

``bn_group > 1`` pools the statistics over ``axis_name``, a group of
exactly ``bn_group`` ranks (a process group, or a kind name
:func:`~apex_tpu_torch.parallel.sync_batchnorm.resolve_group` takes;
:func:`~apex_tpu_torch.parallel.create_syncbn_process_group` makes such
groups): where the JAX module psums over a mesh sub-axis of that size
and the reference exchanges peer statistics through CUDA IPC buffers.
A missing ``axis_name`` or a group of another size raises
``ValueError``.  The occupancy knobs (``max_cta_per_sm``,
``cta_launch_margin``, ``multi_stream``) are accepted and ignored, as in
the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.parallel.sync_batchnorm import (BatchStatsNorm, affine,
                                                    resolve_group,
                                                    update_running_stats)


class BatchNorm2d_NHWC(nn.Module):
    """NHWC BatchNorm2d with fused (add +) relu.  ``forward(x, z=None)``:
    x [N, H, W, C]; with ``z`` the result is ``relu(bn(x) + z)`` (passing
    ``z`` implies the relu, as in the reference).  Parameters ``weight``
    and ``bias``; fp32 buffers ``running_mean``, ``running_var``,
    ``minibatch_mean`` and ``minibatch_riv``, updated in place by a
    training forward (with the group's statistics at ``bn_group > 1``).
    Built on the card unless ``device`` says otherwise."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, axis_name: Any = None, eps: float = 1e-5,
                 momentum: float = 0.1, max_cta_per_sm: int = 2,
                 cta_launch_margin: int = 12, multi_stream: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        del max_cta_per_sm, cta_launch_margin, multi_stream
        if bn_group > 1 and axis_name is None:
            raise ValueError("bn_group > 1 requires axis_name (a group of "
                             "bn_group ranks)")
        self.bn_group = bn_group
        self.axis_name = axis_name if bn_group > 1 else None
        self._group()      # the group's size is checked before anything
        device = resolve_device(device)
        self.num_features = num_features
        self.fuse_relu = fuse_relu
        self.eps = eps
        self.momentum = momentum
        c = num_features
        self.weight = nn.Parameter(torch.ones(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))
        for name, fill in (("running_mean", 0.0), ("running_var", 1.0),
                           ("minibatch_mean", 0.0), ("minibatch_riv", 1.0)):
            self.register_buffer(name, torch.full((c,), fill, device=device,
                                                  dtype=torch.float32))

    def _group(self):
        """The process group of the statistics (None: this rank alone),
        of exactly ``bn_group`` ranks."""
        if self.axis_name is None:
            return None
        group = resolve_group(self.axis_name)
        size = comm.group_size(group)
        if size != self.bn_group:
            raise ValueError(f"bn_group={self.bn_group}, but axis_name="
                             f"{self.axis_name!r} is a group of {size} "
                             "rank(s)")
        return group

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.training:
            y, mean, var, n = BatchStatsNorm.apply(
                x, self.weight, self.bias, -1, self.eps, torch.float32,
                self._group())
            with torch.no_grad():
                rm, rv = update_running_stats(
                    self.running_mean, self.running_var, mean, var, n,
                    self.momentum)
                self.running_mean.copy_(rm)
                self.running_var.copy_(rv)
                self.minibatch_mean.copy_(mean)
                self.minibatch_riv.copy_(torch.rsqrt(var + self.eps))
        else:
            y = affine(x, self.running_mean,
                       torch.rsqrt(self.running_var + self.eps),
                       self.weight, self.bias, [self.num_features])
        if z is not None:
            y = torch.relu(y + z.float())
        elif self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)


__all__ = ["BatchNorm2d_NHWC"]
