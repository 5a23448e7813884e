"""Fused LayerNorm and RMSNorm.

PyTorch port of the JAX package's ``apex_tpu/ops/fused_layer_norm.py``.
One autograd function computes the statistics in fp32, saves ``(mean,
invvar)`` for the backward and returns the output in x's dtype (the
"mixed" semantics: a bf16 x with fp32 weights gives a bf16 y and fp32
dweight/dbias).  Each direction has two implementations of one contract:

* kernels written by hand for Hopper, for CUDA tensors, in place of the
  TPU kernels ``_pallas_ln_fwd`` and ``_pallas_ln_bwd``: fp32 and bf16
  rows at :data:`SM90_WIDTHS` columns run ``csrc/layer_norm_sm90.cu``
  (``layer_norm_fwd_sm90``, ``layer_norm_bwd_sm90``: each row read once
  into registers), every other width ``csrc/layer_norm.cu``
  (``layer_norm_fwd``, ``layer_norm_bwd``); :func:`_ln_route` names the
  route from the dtype and the width alone;
* a plain PyTorch version with the JAX package's math
  (:func:`_ln_fwd_plain` for ``_xla_ln_fwd``, :func:`_ln_bwd_plain` for
  the XLA backward of ``_layer_norm_bwd``), for CPU tensors.

Where the tensors lie picks the implementation, and nothing else does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.kernels import DTYPE_CODES as _KERNEL_DTYPES
from apex_tpu_torch.kernels import (LAYER_NORM_BWD, LAYER_NORM_BWD_SM90,
                                    LAYER_NORM_FWD, LAYER_NORM_FWD_SM90)

#: the widths ``layer_norm_sm90.cu`` has instances of, for fp32 and bf16 x
SM90_WIDTHS = (1024, 2048, 4096)
#: rows per dgamma/dbeta partial of either backward (``layer_norm.cu``'s
#: kRowsPerBlock, ``layer_norm_sm90.cu``'s kBwdRowsPerBlock)
_ROWS_PER_PARTIAL = 32
_SM90_WARPS = 8          # layer_norm_sm90.cu's warps a block (kWarps)
_SM90_LANE_COLS = 16     # its backward's columns a lane (kBwdLaneCols)


def _ln_route(dtype: torch.dtype, cols: int) -> str:
    """``"sm90"`` (``layer_norm_sm90.cu``) for fp32 and bf16 at
    :data:`SM90_WIDTHS` columns, else ``"rows"`` (``layer_norm.cu``,
    which :func:`_check_rows` holds to its own limits)."""
    if dtype in _KERNEL_DTYPES and cols in SM90_WIDTHS:
        return "sm90"
    return "rows"


def ln_bwd_partition(rows: int, dtype: torch.dtype, cols: int) -> list:
    """The rows whose dgamma/dbeta each backward block sums, as
    ``[block][group] -> rows in the order the group adds them``; the block
    adds its groups in order, then the second pass its blocks.  It is a
    function of the shape and dtype alone, as the kernels' order is.
    ``layer_norm_sm90.cu`` gives a row ``cols / 512`` warps, so a block of
    eight warps holds ``8 / (cols / 512)`` groups, each taking every
    group-th row of the block's 32; ``layer_norm.cu`` sums a block's rows
    in order (one group)."""
    groups = 1
    if _ln_route(dtype, cols) == "sm90":
        groups = _SM90_WARPS // (cols // (32 * _SM90_LANE_COLS))
    return [[list(range(r0 + g, min(rows, r0 + _ROWS_PER_PARTIAL), groups))
             for g in range(groups)]
            for r0 in range(0, rows, _ROWS_PER_PARTIAL)]


def ln_bwd_workspace(rows: int, cols: int) -> int:
    """fp32 elements of the backward's partials: dweight's and dbias's,
    one row of ``cols`` for each block of :func:`ln_bwd_partition`."""
    return 2 * math.ceil(rows / _ROWS_PER_PARTIAL) * cols


def _ln_fwd_plain(x2d, weight, bias, eps):
    """y in x's dtype, fp32 mean and invvar [rows] (``_xla_ln_fwd``)."""
    x = x2d.float()
    mean = x.mean(-1)
    xc = x - mean[:, None]
    var = (xc * xc).mean(-1)
    invvar = torch.rsqrt(var + eps)
    y = xc * invvar[:, None]
    if weight is not None:
        y = y * weight.float()[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.to(x2d.dtype), mean, invvar


def _ln_bwd_plain(x2d, dy, mean, invvar, weight, has_bias):
    """(dx in x's dtype, dweight, dbias in fp32 or None): the JAX
    package's one-pass backward."""
    x = x2d.float()
    g = dy.float()
    xhat = (x - mean[:, None]) * invvar[:, None]
    gw = g * weight.float()[None, :] if weight is not None else g
    c1 = gw.mean(-1, keepdim=True)
    c2 = (gw * xhat).mean(-1, keepdim=True)
    dx = ((gw - c1 - xhat * c2) * invvar[:, None]).to(x2d.dtype)
    dw = (g * xhat).sum(0) if weight is not None else None
    db = g.sum(0) if has_bias else None
    return dx, dw, db


def _check_rows(x2d: torch.Tensor, name: str = "x") -> None:
    """What both kernels take: fp32 or bf16 rows of whole 16-byte
    vectors, 16-byte aligned."""
    if x2d.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the LayerNorm kernels take float32 or bfloat16 "
                        f"{name}, got {x2d.dtype}")
    if x2d.shape[1] % (16 // x2d.element_size()):
        raise ValueError(f"the LayerNorm kernels read 16-byte vectors: cols "
                         f"{x2d.shape[1]} must be a multiple of "
                         f"{16 // x2d.element_size()} for {x2d.dtype}")
    if x2d.data_ptr() % 16:
        raise ValueError(f"the LayerNorm kernels need a 16-byte aligned "
                         f"{name}; pass {name}.clone()")


def _f32_on(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"layer-norm parameter is on {t.device}, expected "
                         f"{device}")
    return t.float().contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ln_fwd_cuda(x2d, weight, bias, eps):
    """Launch the forward of :func:`_ln_route`'s kernel; same contract as
    :func:`_ln_fwd_plain`."""
    _check_rows(x2d)
    rows, cols = x2d.shape
    w, b = _f32_on(weight, x2d.device), _f32_on(bias, x2d.device)
    y = torch.empty_like(x2d)
    mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    invvar = torch.empty_like(mean)
    kernel = (LAYER_NORM_FWD_SM90 if _ln_route(x2d.dtype, cols) == "sm90"
              else LAYER_NORM_FWD)
    kernel(_KERNEL_DTYPES[x2d.dtype], x2d.device.index, x2d.data_ptr(),
           _ptr(w), _ptr(b), y.data_ptr(), mean.data_ptr(), invvar.data_ptr(),
           rows, cols, eps, _stream(x2d.device))
    return y, mean, invvar


def _ln_bwd_cuda(x2d, dy, mean, invvar, weight, has_bias):
    """Launch the backward of :func:`_ln_route`'s kernel; same contract as
    :func:`_ln_bwd_plain`."""
    _check_rows(x2d)
    rows, cols = x2d.shape
    dy = dy.to(x2d.dtype).contiguous()
    _check_rows(dy, "dy")
    w = _f32_on(weight, x2d.device)
    dx = torch.empty_like(x2d)
    dw = (torch.empty(cols, dtype=torch.float32, device=x2d.device)
          if weight is not None else None)
    db = (torch.empty(cols, dtype=torch.float32, device=x2d.device)
          if has_bias else None)
    part = torch.empty(ln_bwd_workspace(rows, cols), dtype=torch.float32,
                       device=x2d.device)
    kernel = (LAYER_NORM_BWD_SM90 if _ln_route(x2d.dtype, cols) == "sm90"
              else LAYER_NORM_BWD)
    kernel(_KERNEL_DTYPES[x2d.dtype], x2d.device.index, x2d.data_ptr(),
           dy.data_ptr(), mean.data_ptr(), invvar.data_ptr(), _ptr(w),
           dx.data_ptr(), _ptr(dw), _ptr(db), part.data_ptr(), rows, cols,
           _stream(x2d.device))
    return dx, dw, db


def _ln_fwd(x2d, weight, bias, eps):
    fn = _ln_fwd_cuda if x2d.is_cuda else _ln_fwd_plain
    return fn(x2d, weight, bias, eps)


def _ln_bwd(x2d, dy, mean, invvar, weight, has_bias):
    fn = _ln_bwd_cuda if x2d.is_cuda else _ln_bwd_plain
    return fn(x2d, dy, mean, invvar, weight, has_bias)


class _LayerNorm(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX package's ``_layer_norm``: residuals
    (x, weight, mean, invvar); dweight/dbias come back in the parameters'
    dtypes."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps):
        y, mean, invvar = _ln_fwd(x2d, weight, bias, eps)
        ctx.save_for_backward(x2d, weight, mean, invvar)
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, invvar = ctx.saved_tensors
        dx, dw, db = _ln_bwd(x2d, dy, mean, invvar, weight, ctx.has_bias)
        if dw is not None:
            dw = dw.to(weight.dtype)
        if db is not None:
            db = db.to(ctx.bias_dtype)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused layer norm over the trailing dims covered by ``weight`` (the
    last dim without one).  Statistics are fp32; the output has x's
    dtype.  CUDA tensors run :func:`_ln_route`'s kernel
    (``csrc/layer_norm_sm90.cu`` or ``csrc/layer_norm.cu``); CPU tensors run
    the plain version."""
    norm_ndim = weight.ndim if weight is not None else 1
    cols = math.prod(x.shape[-norm_ndim:])
    x2d = x.reshape(-1, cols).contiguous()
    w = weight.reshape(cols) if weight is not None else None
    b = bias.reshape(cols) if bias is not None else None
    return _LayerNorm.apply(x2d, w, b, float(eps)).reshape(x.shape)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, *,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, output in x's dtype (plain PyTorch; the JAX
    package has no kernel for it either)."""
    norm_ndim = weight.ndim if weight is not None else 1
    cols = math.prod(x.shape[-norm_ndim:])
    x2d = x.reshape(-1, cols).float()
    y = x2d * torch.rsqrt((x2d * x2d).mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.reshape(cols).float()[None, :]
    return y.to(x.dtype).reshape(x.shape)


class FusedLayerNorm(nn.Module):
    """``apex.normalization.FusedLayerNorm``: fp32 statistics, output in
    the input's dtype, parameters ``weight`` (ones) and ``bias`` (zeros)
    in fp32 unless ``dtype`` says otherwise."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, device=device, dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, device=device, dtype=dtype))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class MixedFusedLayerNorm(FusedLayerNorm):
    """Megatron variant: statistics fp32, output follows the input's
    dtype.  Identical here: mixed is the default."""


# the contrib fast layer norm is the same computation; one kernel covers
# every size, so these are aliases (as in the JAX package)
FastLayerNorm = FusedLayerNorm
fast_layer_norm = layer_norm
