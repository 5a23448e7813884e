"""ResNet (v1.5) — the canonical amp workload, on the card.

PyTorch port of the JAX package's ``apex_tpu/models/resnet.py`` (the
model behind ``examples/imagenet/main_amp.py`` and the L1 cross-product):
bottleneck blocks with the stride on the 3x3, batch norm through
:func:`apex_tpu_torch.parallel.sync_batch_norm` (the JAX arithmetic; a
training forward pools the statistics over the group
``ResNetConfig.bn_axis_name`` names, ``--sync_bn``, and eval uses none),
a zero-initialised last gamma in every block and an fp32 head.

The input is NHWC, as in the JAX package; ``x.permute(0, 3, 1, 2)`` of a
contiguous NHWC tensor is an NCHW view in channels-last memory, so the
convolutions (cuDNN through ``F.conv2d``, as JAX leaves them to XLA's
convolution) run channels-last with no copy.  Weights are OIHW and the
head's ``fc.w`` is ``[classes, features]`` (``F.linear``'s layout);
:func:`resnet_state_dict_from_jax` maps the JAX tree (HWIO, ``[in,
out]``) onto them.  The modules carry the JAX tree's names (``conv1``,
``bn1``, ``layer1.0.bn_ds``, ``fc``), so amp's name rule keeps the norms
fp32 under O2 as it does in the JAX package.

Convolutions pad as TF "SAME" does (the JAX ``padding="SAME"``): for a
kernel k at stride s over n pixels the pad is ``max((ceil(n/s) - 1) s +
k - n, 0)``, the smaller half before; at 7x7/s2 on an even size that is
2 before and 3 after, at 3x3/s2 0 and 1 — not the symmetric pad of
``F.conv2d(padding=...)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import (resolve_group,
                                                    sync_batch_norm)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    # "data" (or a process group) => SyncBN over the data-parallel ranks
    bn_axis_name: Any = None
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


def resnet50_config(**kw) -> ResNetConfig:
    return ResNetConfig(block_sizes=(3, 4, 6, 3), **kw)


def resnet18_config(**kw) -> ResNetConfig:
    # as in the JAX package: the bottleneck path at (2, 2, 2, 2)
    return ResNetConfig(block_sizes=(2, 2, 2, 2), **kw)


def same_pads(n: int, k: int, s: int) -> tuple:
    """(before, after) of TF "SAME" padding for kernel ``k`` at stride
    ``s`` over ``n`` pixels."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """``x`` [N, C, H, W] (channels-last memory) * ``w`` OIHW with SAME
    padding: the symmetric part as the convolution's own padding, the
    extra pixel after (where the split is uneven) by ``F.pad``."""
    kh, kw = w.shape[2], w.shape[3]
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], kh, stride),
                          same_pads(x.shape[3], kw, stride))
    lo_h, lo_w = min(hl, hh), min(wl, wh)
    if hh != hl or wh != wl:
        x = F.pad(x, (wl - lo_w, wh - lo_w, hl - lo_h, hh - lo_h))
        x = x.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=(lo_h, lo_w))


class _Conv(nn.Module):
    """A bias-free convolution holding ``w`` (OIHW, channels-last)."""

    def __init__(self, cin: int, cout: int, k: int, gen, device, dtype):
        super().__init__()
        # he-normal fan_out (torchvision's resnet init, the JAX package's)
        std = math.sqrt(2.0 / (k * k * cout))
        w = torch.randn((cout, cin, k, k), generator=gen) * std
        self.w = nn.Parameter(w.to(device, dtype).contiguous(
            memory_format=torch.channels_last))


class _BN(nn.Module):
    """A batch norm's ``weight``/``bias`` and its fp32 running ``mean`` /
    ``var`` (the JAX state's keys)."""

    def __init__(self, c: int, device, dtype, zero_gamma: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.full(
            (c,), 0.0 if zero_gamma else 1.0, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("mean", torch.zeros(c, device=device,
                                                 dtype=torch.float32))
        self.register_buffer("var", torch.ones(c, device=device,
                                               dtype=torch.float32))


class _Block(nn.Module):
    def __init__(self, in_c, mid, out_c, stride, gen, device, dtype):
        super().__init__()
        self.stride = stride
        self.conv1 = _Conv(in_c, mid, 1, gen, device, dtype)
        self.conv2 = _Conv(mid, mid, 3, gen, device, dtype)
        self.conv3 = _Conv(mid, out_c, 1, gen, device, dtype)
        self.bn1 = _BN(mid, device, dtype)
        self.bn2 = _BN(mid, device, dtype)
        # zero-init the last gamma (torchvision's zero_init_residual)
        self.bn3 = _BN(out_c, device, dtype, zero_gamma=True)
        if stride != 1 or in_c != out_c:
            self.downsample = _Conv(in_c, out_c, 1, gen, device, dtype)
            self.bn_ds = _BN(out_c, device, dtype)
        else:
            self.downsample = self.bn_ds = None


class ResNet(nn.Module):
    """Bottleneck ResNet (v1.5).  ``forward(x)``: x [N, H, W, 3] NHWC,
    returns fp32 logits [N, classes]; a training forward (``self.training``)
    normalises with the batch's statistics and updates the running ones
    in place, as the JAX ``apply`` returns its new state."""

    expansion = 4

    def __init__(self, cfg: ResNetConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        resolve_group(cfg.bn_axis_name, "bn_axis_name")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.conv1 = _Conv(3, cfg.width, 7, gen, dev, dtype)
        self.bn1 = _BN(cfg.width, dev, dtype)
        in_c = cfg.width
        for stage, n_blocks in enumerate(cfg.block_sizes):
            mid = cfg.width * (2 ** stage)
            out_c = mid * self.expansion
            blocks = []
            for b in range(n_blocks):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                blocks.append(_Block(in_c, mid, out_c, stride, gen, dev,
                                     dtype))
                in_c = out_c
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))
        self.fc = nn.Module()
        self.fc.w = nn.Parameter((torch.randn((cfg.num_classes, in_c),
                                              generator=gen)
                                  / math.sqrt(in_c)).to(dev, dtype))
        self.fc.b = nn.Parameter(torch.zeros(cfg.num_classes, device=dev,
                                             dtype=dtype))

    def stages(self):
        return [getattr(self, f"layer{i + 1}")
                for i in range(len(self.cfg.block_sizes))]

    def _bn(self, bn: _BN, x: torch.Tensor, group) -> torch.Tensor:
        y, rm, rv = sync_batch_norm(
            x, bn.weight, bn.bias, bn.mean, bn.var, axis_name=group,
            training=self.training, momentum=self.cfg.bn_momentum,
            eps=self.cfg.bn_eps, channel_axis=1)
        if self.training:
            with torch.no_grad():
                bn.mean.copy_(rm)
                bn.var.copy_(rv)
        return y

    def _block(self, blk: _Block, x: torch.Tensor, g) -> torch.Tensor:
        h = torch.relu(self._bn(blk.bn1, conv_same(x, blk.conv1.w), g))
        h = torch.relu(self._bn(blk.bn2, conv_same(h, blk.conv2.w,
                                                   blk.stride), g))
        h = self._bn(blk.bn3, conv_same(h, blk.conv3.w), g)
        if blk.downsample is not None:
            sc = self._bn(blk.bn_ds, conv_same(x, blk.downsample.w,
                                               blk.stride), g)
        else:
            sc = x
        return torch.relu(h + sc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the statistics' group in training; eval reads the running ones
        g = (resolve_group(self.cfg.bn_axis_name, "bn_axis_name")
             if self.training else None)
        h = x.permute(0, 3, 1, 2)   # NCHW view of NHWC memory
        h = conv_same(h, self.conv1.w, 2)
        h = torch.relu(self._bn(self.bn1, h, g))
        h = F.max_pool2d(h, 3, 2, 1)
        for blocks in self.stages():
            for blk in blocks:
                h = self._block(blk, h, g)
        # the JAX mean over (H, W): fp32 sums, one rounding to the dtype
        h = h.float().mean(dim=(2, 3)).to(h.dtype)
        return F.linear(h.float(), self.fc.w.float(), self.fc.b.float())


def _t(a) -> torch.Tensor:
    """A new fp32 tensor of a (numpy or JAX) array's values."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def resnet_state_dict_from_jax(params: Mapping[str, Any],
                               state: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX ``ResNet.init`` tree ``(params, bn_state)`` (numpy or JAX
    arrays) as a ``state_dict`` of the port's :class:`ResNet`: conv
    weights HWIO -> OIHW, ``fc.w`` transposed, the batch norms' gammas
    (the zero ``bn3`` ones included), betas and running statistics."""
    out: Dict[str, torch.Tensor] = {}

    def conv(prefix, p):
        out[f"{prefix}.w"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1)
                                ).contiguous(memory_format=torch.channels_last)

    def bn(prefix, p, s):
        out[f"{prefix}.weight"] = _t(p["weight"])
        out[f"{prefix}.bias"] = _t(p["bias"])
        out[f"{prefix}.mean"] = _t(s["mean"])
        out[f"{prefix}.var"] = _t(s["var"])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], state["bn1"])
    stage = 1
    while f"layer{stage}" in params:
        for b, (bp, bs) in enumerate(zip(params[f"layer{stage}"],
                                         state[f"layer{stage}"])):
            pre = f"layer{stage}.{b}"
            for c in ("conv1", "conv2", "conv3", "downsample"):
                if c in bp:
                    conv(f"{pre}.{c}", bp[c])
            for n in ("bn1", "bn2", "bn3", "bn_ds"):
                if n in bp:
                    bn(f"{pre}.{n}", bp[n], bs[n])
        stage += 1
    out["fc.w"] = _t(np.asarray(params["fc"]["w"]).T)
    out["fc.b"] = _t(params["fc"]["b"])
    return out


__all__ = ["ResNet", "ResNetConfig", "conv_same", "resnet18_config",
           "resnet50_config", "resnet_state_dict_from_jax", "same_pads"]
