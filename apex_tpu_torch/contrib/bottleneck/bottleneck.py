"""The ResNet bottleneck block of ``apex.contrib.bottleneck`` and its
spatial form.

PyTorch port of the JAX package's
``apex_tpu/contrib/bottleneck/bottleneck.py``: conv1x1 -> conv3x3(stride)
-> conv1x1, each followed by a frozen-BN affine (``scale * y + bias`` in
the activation's dtype) and a relu (none after the third), a residual add
with an optional strided 1x1 downsample, and a last relu.  The
convolutions are cuDNN's (``F.conv2d``) with the TF "SAME" padding of the
JAX ``lax.conv_general_dilated(..., "SAME")``
(:func:`apex_tpu_torch.models.resnet.conv_same`).

Input and output are NHWC, weights OIHW.  The spatial form
(``SpatialBottleneck(axis_name=group)``) shards H over the ranks of a
group, rank r holding rows [r H_local, (r + 1) H_local).  Only the 3x3
reads rows across a shard's edge: :func:`halo_exchange` fetches them from
the neighbours (the JAX module's two ``ppermute``s, here one
:func:`apex_tpu_torch.parallel.comm.exchange` that posts every send and
receive before it waits), the edge ranks taking zeros, and
:func:`spatial_conv2d` runs the 3x3 VALID in H on the extended shard.
The halo follows TF "SAME"'s split for kernel k at stride s: ``(k - s)
// 2`` rows from the rank above and the rest from the rank below, so (1,
1) at k 3, s 1 and (0, 1) at k 3, s 2, where one direction carries no
message at all.  The backward sends each halo's gradient back to the
rank that owns those rows, which adds it to its edge rows: the reverse
``ppermute`` JAX's AD derives, and the reference's hand-written halo
terms (bottleneck.py:289-510).  The 1x1 convolutions and the epilogues
stay local.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.resnet import conv_same
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.parallel.sync_batchnorm import resolve_group

# exchange tags: the rows going down (to rank r + 1) and up (to r - 1)
_DOWN, _UP = 0, 1


def _swap_edges(group, down, up):
    """Send ``down`` to rank r + 1 and ``up`` to rank r - 1 (either None:
    nothing goes that way, on any rank), and take the tensors of the same
    shapes that the neighbours send this way: (from r - 1, from r + 1),
    None where there is no neighbour or no message."""
    n, r = comm.group_size(group), comm.group_rank(group)
    sends, recvs, slots = [], [], []
    for slot, t, to, tag in ((0, down, r + 1, _DOWN), (1, up, r - 1, _UP)):
        if t is None:
            continue
        if 0 <= to < n:
            sends.append((t, to, tag))
        frm = 2 * r - to          # the neighbour on the other side
        if 0 <= frm < n:
            recvs.append(comm.Recv(frm, tuple(t.shape), t.dtype, t.device,
                                   tag))
            slots.append(slot)
    got = [None, None]
    if sends or recvs:
        for slot, t in zip(slots, comm.exchange(sends, recvs, group)):
            got[slot] = t
    return got


class _HaloExchange(torch.autograd.Function):
    """(N, H, W, C) -> (N, lo + H + hi, W, C): the ``lo`` rows above from
    rank r - 1's bottom and the ``hi`` rows below from rank r + 1's top,
    zeros at the group's edges; the backward returns each halo's
    gradient to the rank that owns the rows."""

    @staticmethod
    def forward(ctx, x, group, lo, hi):
        ctx.group, ctx.lo, ctx.hi = group, lo, hi
        rows = x.shape[1]
        above, below = _swap_edges(group, x[:, rows - lo:] if lo else None,
                                   x[:, :hi] if hi else None)
        parts = []
        if lo:
            parts.append(above if above is not None else
                         x.new_zeros((x.shape[0], lo) + x.shape[2:]))
        parts.append(x)
        if hi:
            parts.append(below if below is not None else
                         x.new_zeros((x.shape[0], hi) + x.shape[2:]))
        return torch.cat(parts, dim=1) if len(parts) > 1 else x.clone()

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.lo, ctx.hi
        rows = g.shape[1] - lo - hi
        dx = g[:, lo:lo + rows].clone()
        # the gradient of my bottom halo goes down to rank r + 1's top
        # rows, that of my top halo up to rank r - 1's bottom rows
        from_above, from_below = _swap_edges(
            ctx.group, g[:, lo + rows:] if hi else None,
            g[:, :lo] if lo else None)
        if from_below is not None:   # rank r + 1's top halo: my bottom rows
            dx[:, rows - lo:] += from_below
        if from_above is not None:   # rank r - 1's bottom halo: my top rows
            dx[:, :hi] += from_above
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, axis_name: Any, halo_lo: int = 1,
                  halo_hi: int = 1) -> torch.Tensor:
    """Extend an H-sharded NHWC shard with its neighbours' rows: (N,
    H_local, W, C) -> (N, halo_lo + H_local + halo_hi, W, C), the top
    ``halo_lo`` rows from the rank above (its bottom rows), the bottom
    ``halo_hi`` from the rank below (its top rows), zeros past the
    group's edges (the SAME convolution's zero padding).
    Differentiable."""
    group = resolve_group(axis_name)
    if x.shape[1] < max(halo_lo, halo_hi):
        raise ValueError(f"local H ({x.shape[1]}) is below the halo "
                         f"({halo_lo}, {halo_hi})")
    return _HaloExchange.apply(x, group, halo_lo, halo_hi)


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                   axis_name: Any = None) -> torch.Tensor:
    """2-D convolution of NHWC ``x`` with OIHW ``w``, SAME-padded over the
    whole of H; NHWC out.  With ``axis_name`` (H sharded over that
    group's ranks) the halo of TF "SAME"'s split comes from the
    neighbours and the convolution runs VALID in H; ``H_local % stride``
    must be 0 (``ValueError``, as in the JAX package)."""
    if axis_name is None:
        y = conv_same(x.permute(0, 3, 1, 2), w, stride)
        return y.permute(0, 2, 3, 1)
    if x.shape[1] % stride:
        raise ValueError("local H must be divisible by the stride")
    kh, kw = w.shape[2], w.shape[3]
    pad_h = max(kh - stride, 0)
    pad_w = max(kw - stride, 0)
    xh = halo_exchange(x, axis_name, pad_h // 2, pad_h - pad_h // 2)
    wl, wh = pad_w // 2, pad_w - pad_w // 2
    xc = xh.permute(0, 3, 1, 2)
    if wh != wl:
        xc = F.pad(xc, (0, wh - wl)).contiguous(
            memory_format=torch.channels_last)
    y = F.conv2d(xc, w, stride=stride, padding=(0, wl))
    return y.permute(0, 2, 3, 1)


def _scale_bias_relu(y, scale, bias, relu=True):
    y = y * scale.to(y.dtype).reshape(1, -1, 1, 1) \
        + bias.to(y.dtype).reshape(1, -1, 1, 1)
    return torch.relu(y) if relu else y


class SpatialBottleneck(nn.Module):
    """Bottleneck block with frozen-BN affines (no running statistics).
    ``stride_1x1`` puts the stride on the first 1x1 (the reference's
    argument), else on the 3x3.  Parameters: ``conv1``-``conv3`` (and
    ``conv4``, the downsample, when the stride or the width changes) and
    a ``scale<i>``/``bias<i>`` pair after each.  With ``axis_name`` (a
    process group or a kind name) the input and output are H shards over
    its ranks, the 3x3 through :func:`spatial_conv2d`."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1,
                 stride_1x1: bool = False, axis_name: Any = None, *,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        resolve_group(axis_name)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.in_channels = in_channels
        self.bottleneck_channels = bottleneck_channels
        self.out_channels = out_channels
        self.stride = stride
        self.stride_1x1 = stride_1x1
        self.axis_name = axis_name
        self.has_downsample = stride != 1 or in_channels != out_channels

        def he(cin, cout, k):
            # he-normal over fan_in, as the JAX init
            w = torch.randn((cout, cin, k, k), generator=gen) \
                * math.sqrt(2.0 / (k * k * cin))
            return nn.Parameter(w.to(dev, dtype).contiguous(
                memory_format=torch.channels_last))

        c_in, c_b, c_out = in_channels, bottleneck_channels, out_channels
        shapes = [(c_in, c_b, 1), (c_b, c_b, 3), (c_b, c_out, 1)]
        if self.has_downsample:
            shapes.append((c_in, c_out, 1))
        for i, (a, b, k) in enumerate(shapes, 1):
            setattr(self, f"conv{i}", he(a, b, k))
            setattr(self, f"scale{i}", nn.Parameter(
                torch.ones(b, device=dev, dtype=dtype)))
            setattr(self, f"bias{i}", nn.Parameter(
                torch.zeros(b, device=dev, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, C_in] -> [N, H / stride, W / stride, C_out] (H a
        rank's shard under ``axis_name``)."""
        s1 = self.stride if self.stride_1x1 else 1
        s2 = 1 if self.stride_1x1 else self.stride
        if self.axis_name is not None and x.shape[1] % self.stride:
            # a shard's strided 1x1 keeps the global stride phase only
            # when its first row sits at a multiple of the stride
            raise ValueError(
                f"local H ({x.shape[1]}) must be divisible by stride "
                f"({self.stride}) under spatial sharding")
        xc = x.permute(0, 3, 1, 2)
        out = _scale_bias_relu(conv_same(xc, self.conv1, s1), self.scale1,
                               self.bias1)
        # only the 3x3 reads rows across the shard's edge
        out = spatial_conv2d(out.permute(0, 2, 3, 1), self.conv2, stride=s2,
                             axis_name=self.axis_name).permute(0, 3, 1, 2)
        out = _scale_bias_relu(out, self.scale2, self.bias2)
        out = _scale_bias_relu(conv_same(out, self.conv3), self.scale3,
                               self.bias3, relu=False)
        if self.has_downsample:
            resid = _scale_bias_relu(conv_same(xc, self.conv4, self.stride),
                                     self.scale4, self.bias4, relu=False)
        else:
            resid = xc
        return torch.relu(out + resid).permute(0, 2, 3, 1)


class Bottleneck(SpatialBottleneck):
    """The unsharded block (reference
    apex/contrib/bottleneck/bottleneck.py:64)."""

    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, stride_1x1: bool = False, **kw):
        super().__init__(in_channels, bottleneck_channels, out_channels,
                         stride=stride, stride_1x1=stride_1x1,
                         axis_name=None, **kw)


def bottleneck_state_dict_from_jax(params: Mapping[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX block's params (HWIO convs) as the port's ``state_dict``."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if k.startswith("conv"):
            out[k] = torch.from_numpy(np.array(
                a.transpose(3, 2, 0, 1), dtype=np.float32, order="C")
            ).contiguous(memory_format=torch.channels_last)
        else:
            out[k] = torch.from_numpy(np.array(a, dtype=np.float32))
    return out


__all__ = ["Bottleneck", "SpatialBottleneck", "bottleneck_state_dict_from_jax",
           "halo_exchange", "spatial_conv2d"]
