"""Attention: the serving path's prefill and paged decode, the generic
flash attention with its backward (the multi-head attention modules,
varlen), and the training path's packed-QKV self-attention with its
backward.

PyTorch port of the JAX package's ``apex_tpu/ops/attention.py``.  Each
public function has two implementations of one contract:

* a kernel written by hand for Hopper, which runs for CUDA tensors:
  ``csrc/flash_fwd_sm90.cu`` (bf16 at head dims 64 and 128, on the tensor
  cores) and ``csrc/flash_fwd.cu`` (fp32, head dim 8) in place of the TPU
  kernel ``_flash_fwd_pallas``,
  ``csrc/flash_bwd_sm90.cu`` (bf16 at head dims 64 and 128, on the tensor
  cores) and ``csrc/flash_bwd.cu`` (fp32, head dim 8) in place of
  ``_flash_bwd_pallas``,
  ``csrc/flash_decode_sm90.cu`` (head dim 128: the bf16 pool and the
  quantized int8 and fp8 pools) and ``csrc/flash_decode.cu`` (the fp32
  pool, head dim 8) in place of ``_flash_decode_pallas``,
  ``csrc/flash_qkv_fwd_sm90.cu`` and ``csrc/flash_qkv_bwd_sm90.cu``
  (bf16, on the tensor cores) and ``csrc/flash_qkv_fwd.cu`` and
  ``csrc/flash_qkv_bwd.cu`` (fp32), each at head dims 64 and 128, in
  place of ``_flash_qkv_fwd_pallas`` and ``_flash_qkv_bwd_pallas``;
* a plain PyTorch version with the JAX package's math
  (:func:`_blockwise_fwd` for ``_blockwise_fwd_xla``,
  :func:`_blockwise_bwd` for ``_blockwise_bwd_xla``,
  :func:`_paged_attention` for ``_paged_attention_xla``), which runs for
  CPU tensors.

Where the tensors lie picks the implementation, and nothing else does:
a CUDA tensor goes through the kernel or the call raises.  A failed
build or launch is an error, never a quiet switch to the plain version.
The one plain path on the card is the JAX package's own: a trainable
additive mask (``mask_is_constant=False``) runs the differentiable plain
version, as JAX runs its XLA path there.

Attention dropout is the JAX package's counter hash of (seed,
batch-head, row, col) (:func:`_keep_from_coords`), bit for bit, so the
forward, the backward and the plain versions draw the same mask with
nothing stored.  :func:`flash_attention` and :func:`flash_attention_qkv`
are differentiable, each a ``torch.library`` custom op pair, so a
selective checkpoint can keep their outputs.  The JAX package's TPU
tiling knobs (``block``, ``block_q``, ``block_k``) have no meaning here
and are not taken.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from apex_tpu_torch.kernels import (DTYPE_CODES, FLASH_BWD, FLASH_BWD_SM90,
                                    FLASH_DECODE, FLASH_DECODE_SM90,
                                    FLASH_DECODE_SM90_FP8,
                                    FLASH_DECODE_SM90_INT8, FLASH_FWD,
                                    FLASH_FWD_SM90, FLASH_QKV_BWD,
                                    FLASH_QKV_BWD_D64, FLASH_QKV_BWD_SM90,
                                    FLASH_QKV_BWD_SM90_D64, FLASH_QKV_FWD,
                                    FLASH_QKV_FWD_D64, FLASH_QKV_FWD_SM90,
                                    FLASH_QKV_FWD_SM90_D64)

_NEG_INF = -1e30

SegmentIds = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _masked_exp(s, m):
    """exp(s - m) with fully-masked rows (m still at _NEG_INF) forced to 0
    so l stays 0 and the l_safe guard yields zeros instead of mean(V)."""
    return torch.where(m <= _NEG_INF / 2, 0.0, torch.exp(s - m))


def _segment_block_bounds(seg_q, seg_k, block_q, block_k):
    """(lohi_q [sbh, n_qb, 2], lohi_k [sbh, n_kb, 2]) int32 block ranges.

    A (q-block, k-block) tile is *possibly live* iff the segment-id
    intervals [min, max] of the two blocks intersect — conservative: a
    tile outside the returned range has no equal (seg_q, seg_k) pair, so
    skipping it is exact.  The forward kernels apply this rule per q-block
    inside the kernel, at their own tiles (:func:`flash_fwd_tiles_of`);
    this function is the rule's statement in PyTorch (held against the JAX
    package's in the tests) and counts the tiles a run visits."""
    sbh, sq = seg_q.shape
    sk = seg_k.shape[1]
    n_qb, n_kb = sq // block_q, sk // block_k
    q = seg_q.reshape(sbh, n_qb, block_q)
    k = seg_k.reshape(sbh, n_kb, block_k)
    qmin, qmax = q.amin(-1), q.amax(-1)
    kmin, kmax = k.amin(-1), k.amax(-1)
    live = ((qmin[:, :, None] <= kmax[:, None, :])
            & (kmin[:, None, :] <= qmax[:, :, None]))  # [sbh, n_qb, n_kb]

    def lohi(m, n):
        any_ = m.any(-1)
        first = m.to(torch.int8).argmax(-1)
        last = m.flip(-1).to(torch.int8).argmax(-1)
        lo = torch.where(any_, first, 0)
        hi = torch.where(any_, n - last, 0)
        return torch.stack([lo, hi], -1).to(torch.int32)

    return lohi(live, n_kb), lohi(live.transpose(1, 2), n_qb)


def _apply_masks(s, mask_bias, seg_q, seg_k, causal):
    if mask_bias is not None:
        s = s + mask_bias
    if seg_q is not None:
        s = torch.where(seg_q[..., :, None] == seg_k[..., None, :], s,
                        _NEG_INF)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        tri = torch.ones(sq, sk, dtype=torch.bool,
                         device=s.device).tril(sk - sq)
        s = torch.where(tri, s, _NEG_INF)
    return s


_U32 = 0xFFFFFFFF


def _dropout_threshold(rate: float) -> int:
    """keep iff hash >= this: round, don't truncate, so a tiny positive
    rate is not a threshold of 0 (the JAX package's rule)."""
    return min(round(rate * 2.0 ** 32), 2 ** 32 - 1)


def _keep_from_coords(rows, cols, b, seed, rate):
    """keep = hash(seed, b, row, col) >= rate * 2^32: the JAX package's
    uint32 counter hash, bit for bit, in int64 arithmetic cut to 32 bits
    after every multiply and add."""
    rows, cols, b = (torch.as_tensor(t).to(torch.int64) & _U32
                     for t in (rows, cols, b))
    x = ((rows * 0x9E3779B1) & _U32) ^ ((cols * 0x85EBCA77) & _U32)
    x = x ^ (((int(seed) & _U32) + (b * 0x27D4EB2F & _U32)) & _U32)
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return x >= _dropout_threshold(rate)


def _dropout_keep(seed, b, qi, ki, bq, bk, rate, device=None):
    """Keep-mask [bq, bk] of the score tile whose top-left corner is
    global (qi, ki) of batch-head ``b``: coordinates are global, so any
    tiling replays the same bits."""
    rows = qi + torch.arange(bq, device=device)[:, None]
    cols = ki + torch.arange(bk, device=device)[None, :]
    return _keep_from_coords(rows, cols, torch.tensor(b, device=device),
                             seed, rate)


def _dropout_keep_full(seed, bh, sq, sk, rate, device=None):
    """[bh, sq, sk] keep-mask, bitwise the tiled kernels' masks."""
    rows = torch.arange(sq, device=device)[None, :, None]
    cols = torch.arange(sk, device=device)[None, None, :]
    b = torch.arange(bh, device=device)[:, None, None]
    return _keep_from_coords(rows, cols, b, seed, rate)


def _dropout_keep_like(p, seed, rate):
    """The keep-mask of a score tensor [..., sq, sk] whose leading dims,
    flattened row-major, are the batch-head index bh = b*h + head."""
    sq, sk = p.shape[-2:]
    n = p.numel() // max(1, sq * sk)
    return _dropout_keep_full(seed, n, sq, sk, rate,
                              device=p.device).view(p.shape)


def _blockwise_fwd(q, k, v, scale, causal, mask_bias, seg_q, seg_k,
                   dropout_seed=None, dropout_rate=0.0):
    """The plain version of the flash forward: q [..., sq, d], k/v
    [..., sk, d] -> (o [..., sq, d] in q's dtype, lse [..., sq] fp32),
    the whole score matrix in fp32 (the JAX package's
    ``_blockwise_fwd_xla``).  The leading dims are [bh] or [b, h];
    ``mask_bias`` and the segment ids broadcast against the scores
    [..., sq, sk] and [..., sq] / [..., sk].  Dropout drops p after the
    row sum l has taken it, so lse counts every visible column."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    s = _apply_masks(s, mask_bias, seg_q, seg_k, causal)
    m = s.amax(-1)
    p = _masked_exp(s, m[..., None])
    l = p.sum(-1)
    if dropout_rate > 0:
        keep = _dropout_keep_like(p, dropout_seed, dropout_rate)
        p = torch.where(keep, p, 0.0) / (1.0 - dropout_rate)
    o = torch.einsum("...qk,...kd->...qd", p, v.float())
    l_safe = torch.where(l == 0, 1.0, l)
    o = o / l_safe[..., None]
    lse = torch.where(l == 0, _NEG_INF, m + torch.log(l_safe))
    return o.to(q.dtype), lse


def _blockwise_bwd(q, k, v, seg_q, seg_k, o, lse, do, scale, causal,
                   dropout_seed=None, dropout_rate=0.0, mask_bias=None):
    """The plain version of the flash backward, (dq, dk, dv) in the
    inputs' dtypes: the delta trick on the whole fp32 score matrix
    (``_blockwise_bwd_xla`` without its k-blocking): p is rebuilt from
    lse with the forward's masks, ds = p (dp - rowsum(do o)) scale with p
    undropped and dp dropped.  Leading dims as :func:`_blockwise_fwd`."""
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    delta = (do32 * o.float()).sum(-1)
    s = torch.einsum("...qd,...kd->...qk", q32, k32) * scale
    s = _apply_masks(s, mask_bias, seg_q, seg_k, causal)
    p = _masked_exp(s, lse[..., None])
    dp = torch.einsum("...qd,...kd->...qk", do32, v32)
    p_drop = p
    if dropout_rate > 0:
        keep = _dropout_keep_like(p, dropout_seed, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        p_drop = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    dv = torch.einsum("...qk,...qd->...kd", p_drop, do32)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("...qk,...qd->...kd", ds, q32)
    dq = torch.einsum("...qk,...kd->...qd", ds, k32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers -------------------------------------------------------

_KERNEL_DTYPES = DTYPE_CODES
# the toy configs', Transformer-big's (and BERT's) and GPT-1.3B's
_KERNEL_HEAD_DIMS = (8, 64, 128)


def _kernel_loadable(t: torch.Tensor) -> bool:
    """The 16-byte vector loads the kernels read with: unit last stride,
    every other stride and the base address a multiple of 16 bytes."""
    unit = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(s % unit for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_kernel_operand(name: str, t: torch.Tensor, like: torch.Tensor):
    """Device, dtype, and the kernels' 16-byte vector-load alignment."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {like.dtype}")
    if not _kernel_loadable(t):
        raise ValueError(
            f"{name} (strides {t.stride()}) must have a unit last stride "
            "and 16-byte aligned rows for the CUDA kernel; pass "
            f"{name}.contiguous()")


def _check_kernel_dtype_and_dim(q: torch.Tensor):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {q.shape[-1]}")


def _int32_on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"index operand is on {t.device}, expected {device}")
    return t.to(torch.int32).contiguous()


def _check_qkv(q, k, v):
    """Shapes, dtype, head dim and alignment of [B, H, s, d] q, k, v for
    the two generic kernels; returns (B, H, sq, sk, d)."""
    B, H, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (B, H, sk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    _check_kernel_dtype_and_dim(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, t, q)
    if k.stride() != v.stride():
        raise ValueError("k and v must share their strides")
    return B, H, sq, sk, d


def _kernel_segments(seg_q, seg_k, B, H, sq, sk, device):
    """Segment ids as the kernels read them: (int32 [rows, sq], int32
    [rows, sk], seg_div) with rows in {1, B, B*H} and row = bh / seg_div;
    (None, None, 1) without segments."""
    if seg_q is None:
        return None, None, 1
    seg_q, seg_k = _int32_on(seg_q, device), _int32_on(seg_k, device)
    rows = max(seg_q.shape[0], seg_k.shape[0])

    def to_rows(t, n):
        if t.shape[0] == 1 and rows > 1:
            return t.expand(rows, n).contiguous()
        if t.shape[0] == B and rows == B * H and H > 1:
            return t.repeat_interleave(H, 0)
        return t

    seg_q, seg_k = to_rows(seg_q, sq), to_rows(seg_k, sk)
    if (rows not in (1, B, B * H) or tuple(seg_q.shape) != (rows, sq)
            or tuple(seg_k.shape) != (rows, sk)):
        raise ValueError(
            f"segment ids {tuple(seg_q.shape)}/{tuple(seg_k.shape)} do not "
            f"fit q [{B}, {H}, {sq}, d] and k [{B}, {H}, {sk}, d]")
    return seg_q, seg_k, (B * H) // rows


def _kernel_mask(mask, B, H, sq, sk, device):
    """(pointer, (b, h, row, col) strides) of the fp32 mask as a
    [B, H, sq, sk] view, broadcast dims at stride 0; (None, zeros)
    without one."""
    if mask is None:
        return None, (0, 0, 0, 0)
    if mask.device != device:
        raise ValueError(f"mask_bias is on {mask.device}, expected {device}")
    if mask.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take an fp32 mask_bias, got "
                        f"{mask.dtype}")
    m = mask.broadcast_to(B, H, sq, sk)
    return m.data_ptr(), m.stride()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


#: the tiles each route of the generic forward walks, as (query rows of a
#: block, key columns of a tile): the scalar ``csrc/flash_fwd_kernel.cuh``
#: and the tensor-core ``csrc/flash_fwd_sm90.cu``
FLASH_FWD_TILES = (64, 64)
FLASH_FWD_SM90_TILES = (128, 128)
_SM90_HEAD_DIMS = (64, 128)


def _fwd_on_tensor_cores(q: torch.Tensor) -> bool:
    """The route of :func:`_flash_fwd_cuda`: bf16 at head dims 64 and 128
    runs ``flash_fwd_sm90.cu`` (wgmma and TMA), everything else the scalar
    ``flash_fwd.cu`` (the tensor cores take no fp32 operands, and TF32
    would not meet the fp32 contract)."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in _SM90_HEAD_DIMS


def flash_fwd_tiles_of(q: torch.Tensor) -> tuple:
    """The tiles the forward walks for operands like ``q`` (one of
    :data:`FLASH_FWD_TILES`, :data:`FLASH_FWD_SM90_TILES`)."""
    return FLASH_FWD_SM90_TILES if _fwd_on_tensor_cores(q) else FLASH_FWD_TILES


def flash_fwd_visits_len(q: torch.Tensor) -> int:
    """The length of the ``visits`` tensor of :func:`_flash_fwd_cuda` for
    q [B, H, sq, d]: a count per q-tile block, at the route's tiles."""
    B, H, sq = q.shape[:3]
    return B * H * -(-sq // flash_fwd_tiles_of(q)[0])


def _flash_fwd_cuda(q, k, v, mask, seg_q, seg_k, scale, causal,
                    dropout_rate, dropout_seed, visits=None):
    """Launch the generic forward: q [B, H, sq, d], k/v [B, H, sk, d]
    with any strides the kernels can load; ``mask`` fp32 broadcastable to
    [B, H, sq, sk] or None; seg ids [rows, s] with rows in {1, B, B*H} or
    None.  bf16 at head dims 64 and 128 runs ``flash_fwd_sm90.cu``,
    anything else ``flash_fwd.cu`` (:func:`_fwd_on_tensor_cores`).
    ``visits``: None, or an int32 tensor of :func:`flash_fwd_visits_len`
    elements that receives the key tiles each q-tile block walked (the
    tensor-core kernel counts them; the scalar one does not).  Returns (o
    [B, H, sq, d] laid out in q's dimension order, lse [B*H, sq] fp32)."""
    B, H, sq, sk, d = _check_qkv(q, k, v)
    seg_q, seg_k, seg_div = _kernel_segments(seg_q, seg_k, B, H, sq, sk,
                                             q.device)
    mptr, mst = _kernel_mask(mask, B, H, sq, sk, q.device)
    seed, thresh, keep, inv = _dropout_launch_args(dropout_rate, dropout_seed)
    tensor_cores = _fwd_on_tensor_cores(q)
    if visits is not None and (not tensor_cores
                               or visits.dtype != torch.int32
                               or visits.device != q.device
                               or visits.numel() != flash_fwd_visits_len(q)):
        raise ValueError("visits are counted by the bf16 kernel at head dims "
                         "64 and 128 only, as int32 [flash_fwd_visits_len(q)]"
                         " on q's device")
    if tensor_cores:
        q, k, v = (_tma_loadable(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B * H, sq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), mptr,
            *(None if t is None else t.data_ptr() for t in (seg_q, seg_k)),
            seg_div)
    if tensor_cores:
        strides = (ctypes.c_int64 * 16)(
            *(st for t in (q, k, v, o) for st in t.stride()[:3]), *mst)
        FLASH_FWD_SM90(d, q.device.index, *ptrs,
                       None if visits is None else visits.data_ptr(),
                       B, H, sq, sk, strides, scale, int(causal), seed,
                       thresh, inv, _stream(q.device))
    else:
        strides = (ctypes.c_int64 * 13)(*q.stride()[:3], *k.stride()[:3],
                                        *o.stride()[:3], *mst)
        FLASH_FWD(_KERNEL_DTYPES[q.dtype], d, q.device.index, *ptrs,
                  B, H, sq, sk, strides, scale, int(causal), seed, thresh,
                  keep, _stream(q.device))
    return o, lse


#: the tiles each route of the generic backward walks, as (query rows, key
#: columns) of its dk/dv pass and of its dq pass: the scalar
#: ``csrc/flash_bwd_kernel.cuh`` and the tensor-core ``csrc/flash_bwd_sm90.cu``
FLASH_BWD_TILES = {"dkdv": (64, 64), "dq": (64, 64)}
FLASH_BWD_SM90_TILES = {"dkdv": (32, 128), "dq": (128, 64)}


def _bwd_on_tensor_cores(q: torch.Tensor) -> bool:
    """The route of :func:`_flash_bwd_cuda`: bf16 at head dims 64 and 128
    runs ``flash_bwd_sm90.cu`` (wgmma and TMA), everything else the scalar
    ``flash_bwd.cu`` (the tensor cores take no fp32 operands, and TF32
    would not meet the fp32 contract)."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in _SM90_HEAD_DIMS


def flash_bwd_tiles_of(q: torch.Tensor) -> dict:
    """The tiles the backward walks for operands like ``q`` (one of
    :data:`FLASH_BWD_TILES`, :data:`FLASH_BWD_SM90_TILES`)."""
    return FLASH_BWD_SM90_TILES if _bwd_on_tensor_cores(q) else FLASH_BWD_TILES


def flash_bwd_visits_len(q: torch.Tensor, sk: int) -> int:
    """The length of the ``visits`` tensor of :func:`_flash_bwd_cuda` for
    q [B, H, sq, d] and sk keys: a count per dk/dv block, then per dq
    block, at the route's tiles."""
    B, H, sq = q.shape[:3]
    tiles = flash_bwd_tiles_of(q)
    return B * H * (-(-sk // tiles["dkdv"][1]) + -(-sq // tiles["dq"][0]))


def _tma_loadable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a contiguous copy when it broadcasts a dimension
    (a zero stride on a dimension of size > 1), which a TMA map cannot
    describe."""
    if any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)):
        return t.contiguous()
    return t


def _flash_bwd_cuda(q, k, v, o, lse, do, mask, seg_q, seg_k, scale, causal,
                    dropout_rate, dropout_seed, visits=None):
    """Launch the generic backward: (dq, dk, dv) laid out in q's, k's and
    v's dimension orders.  bf16 at head dims 64 and 128 runs
    ``flash_bwd_sm90.cu``, anything else ``flash_bwd.cu``
    (:func:`_bwd_on_tensor_cores`).  ``visits``: None, or an int32 tensor
    of :func:`flash_bwd_visits_len` elements that receives the tiles each
    dk/dv block and then each dq block walked (at the route's tiles,
    :func:`flash_bwd_tiles_of`)."""
    B, H, sq, sk, d = _check_qkv(q, k, v)
    if do.dtype != q.dtype or not _kernel_loadable(do):
        do = do.to(q.dtype).contiguous()
    for name, t in (("o", o), ("do", do)):
        _check_kernel_operand(name, t, q)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} do not "
                         f"match q {tuple(q.shape)}")
    lse = lse.contiguous()
    if lse.device != q.device or tuple(lse.shape) != (B * H, sq):
        raise ValueError(f"lse {tuple(lse.shape)} on {lse.device} does not "
                         f"fit q {tuple(q.shape)}")
    seg_q, seg_k, seg_div = _kernel_segments(seg_q, seg_k, B, H, sq, sk,
                                             q.device)
    mptr, mst = _kernel_mask(mask, B, H, sq, sk, q.device)
    seed, thresh, _, inv = _dropout_launch_args(dropout_rate, dropout_seed)
    if visits is not None and (visits.dtype != torch.int32
                               or visits.device != q.device
                               or visits.numel() != flash_bwd_visits_len(
                                   q, sk)):
        raise ValueError("visits must be int32 [flash_bwd_visits_len(q, sk)]"
                         " on q's device")
    tensor_cores = _bwd_on_tensor_cores(q)
    if tensor_cores:
        q, k, v, do = (_tma_loadable(t) for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), mptr,
            *(None if t is None else t.data_ptr() for t in (seg_q, seg_k)),
            seg_div, None if visits is None else visits.data_ptr(),
            B, H, sq, sk)
    tail = (scale, int(causal), seed, thresh, inv, _stream(q.device))
    if tensor_cores:
        strides = (ctypes.c_int64 * 28)(
            *(st for t in (q, k, v, o, do, dq, dk, dv)
              for st in t.stride()[:3]), *mst)
        FLASH_BWD_SM90(d, q.device.index, *ptrs, strides, *tail)
    else:
        strides = (ctypes.c_int64 * 22)(
            *(st for t in (q, k, o, do, dq, dk) for st in t.stride()[:3]),
            *mst)
        FLASH_BWD(_KERNEL_DTYPES[q.dtype], d, q.device.index, *ptrs, strides,
                  *tail)
    return dq, dk, dv


def _plain_segments(seg_q, seg_k, B, H):
    """[rows, s] ids (rows in {1, B, B*H}) as [B|1, H|1, s], to broadcast
    against [B, H, sq, sk] scores."""
    if seg_q is None:
        return None, None

    def view(t):
        rows = t.shape[0]
        return t.view(B, H, -1) if rows == B * H else t.view(rows, 1, -1)

    return view(seg_q), view(seg_k)


def _flash_fwd_plain(q, k, v, mask, seg_q, seg_k, scale, causal,
                     dropout_rate, dropout_seed):
    """The plain version of :func:`_flash_fwd_cuda`, same contract."""
    B, H, sq, _ = q.shape
    seg_q, seg_k = _plain_segments(seg_q, seg_k, B, H)
    o, lse = _blockwise_fwd(q, k, v, scale, causal, mask, seg_q, seg_k,
                            dropout_seed, dropout_rate)
    return o, lse.reshape(B * H, sq)


def _flash_bwd_plain(q, k, v, o, lse, do, mask, seg_q, seg_k, scale, causal,
                     dropout_rate, dropout_seed):
    """The plain version of :func:`_flash_bwd_cuda`, same contract."""
    B, H, sq, _ = q.shape
    seg_q, seg_k = _plain_segments(seg_q, seg_k, B, H)
    return _blockwise_bwd(q, k, v, seg_q, seg_k, o, lse.view(B, H, sq), do,
                          scale, causal, dropout_seed, dropout_rate,
                          mask_bias=mask)


def _check_dropout(rate: float, seed: Optional[int]) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0 and seed is None:
        # a defaulted seed would drop the same positions every step
        raise ValueError("dropout_rate > 0 requires dropout_seed")


def _segments(segment_ids: Optional[SegmentIds]):
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, tuple):
        seg_q, seg_k = segment_ids
    else:
        seg_q = seg_k = segment_ids
    if seg_q.ndim == 1:
        seg_q = seg_q[None]
    if seg_k.ndim == 1:
        seg_k = seg_k[None]
    return seg_q, seg_k


def _dropout_launch_args(rate, seed):
    """(seed as uint32, threshold, 1 - rate, 1 / (1 - rate)), the last
    two rounded to fp32 by ctypes as the JAX package's weak-typed
    constants are."""
    if rate <= 0:
        return 0, 0, 1.0, 1.0
    return (int(seed) & _U32, _dropout_threshold(rate), 1.0 - rate,
            1.0 / (1.0 - rate))


# A torch.library custom op pair, as the packed flash_attention_qkv is, so
# that a selective checkpoint or a compiler sees one forward op with its
# backward rather than the kernels' internals.
@torch.library.custom_op("apex_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], seg_q: Optional[torch.Tensor],
                  seg_k: Optional[torch.Tensor], scale: float, causal: bool,
                  dropout_rate: float,
                  dropout_seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    fn = _flash_fwd_cuda if q.is_cuda else _flash_fwd_plain
    return fn(q, k, v, mask, seg_q, seg_k, scale, causal, dropout_rate,
              dropout_seed)


@_flash_fwd_op.register_fake
def _(q, k, v, mask, seg_q, seg_k, scale, causal, dropout_rate,
      dropout_seed):
    B, H, sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty(B * H, sq, dtype=torch.float32))


@torch.library.custom_op("apex_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  mask: Optional[torch.Tensor], seg_q: Optional[torch.Tensor],
                  seg_k: Optional[torch.Tensor], scale: float, causal: bool,
                  dropout_rate: float, dropout_seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    fn = _flash_bwd_cuda if q.is_cuda else _flash_bwd_plain
    return fn(q, k, v, o, lse, do, mask, seg_q, seg_k, scale, causal,
              dropout_rate, dropout_seed)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, mask, seg_q, seg_k, scale, causal, dropout_rate,
      dropout_seed):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, mask, seg_q, seg_k, scale, causal, rate, seed = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, mask, seg_q, seg_k)
    ctx.args = (scale, causal, rate, seed)
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, do, _dlse):
    q, k, v, o, lse, mask, seg_q, seg_k = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, o, lse, do, mask, seg_q, seg_k,
                               *ctx.args)
    # the mask and the segment ids are constants: no gradient
    return dq, dk, dv, None, None, None, None, None, None, None


_flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def _mask_4d(mask_bias, B, H):
    """An additive mask [mbh, sq, sk] (mbh in {B*H, 1}) or
    [B|1, H|1, sq, sk] as a 4-D tensor that broadcasts against the
    [B, H, sq, sk] scores, without copying it."""
    if mask_bias.ndim == 3:
        if mask_bias.shape[0] == 1:
            return mask_bias[None]
        return mask_bias.view(B, H, *mask_bias.shape[1:])
    if mask_bias.ndim != 4:
        raise ValueError(f"mask_bias must be [mbh, sq, sk] or "
                         f"[b|1, h|1, sq, sk], got {tuple(mask_bias.shape)}")
    return mask_bias


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    mask_bias: Optional[torch.Tensor] = None,
    segment_ids: Optional[SegmentIds] = None,
    scale: Optional[float] = None,
    mask_is_constant: bool = True,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the fp32 log-sum-exp of
    every score row, ``lse`` [b*h, sq] (-1e30 for a row that sees no
    column, whose output is exact zeros).  ``lse`` carries no
    gradient."""
    _check_dropout(dropout_rate, dropout_seed)
    seg_q, seg_k = _segments(segment_ids)
    three_d = q.ndim == 3
    if three_d:  # [bh, s, d] is [bh, 1, s, d] with per-row segment ids
        q, k, v = q[:, None], k[:, None], v[:, None]
    if q.ndim != 4:
        raise ValueError(f"q must be [b, h, s, d] or [bh, s, d], got "
                         f"{tuple(q.shape)}")
    B, H, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    if mask_bias is not None:
        mask_bias = _mask_4d(mask_bias, B, H)
    if mask_bias is not None and not mask_is_constant:
        # a trainable bias: the plain differentiable version, so autograd
        # gives the bias its gradient (the kernels take constant masks),
        # as the JAX package takes its XLA path here
        pq, pk = _plain_segments(seg_q, seg_k, B, H)
        o, lse = _blockwise_fwd(q, k, v, float(scale), bool(causal),
                                mask_bias, pq, pk, seed, float(dropout_rate))
        lse = lse.reshape(B * H, sq)
    else:
        if mask_bias is not None:
            mask_bias = mask_bias.detach().to(torch.float32)
        o, lse = _flash_fwd_op(q, k, v, mask_bias, seg_q, seg_k, float(scale),
                               bool(causal), float(dropout_rate), seed)
    return (o[:, 0] if three_d else o), lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    mask_bias: Optional[torch.Tensor] = None,
    segment_ids: Optional[SegmentIds] = None,
    scale: Optional[float] = None,
    mask_is_constant: bool = True,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention over [b, h, s, d] (or [bh, s, d]) tensors,
    differentiable in q, k and v.

    ``causal`` aligns the mask to the END of the keys: row i sees columns
    ``<= i + sk - sq``.  ``segment_ids`` masks attention across segment
    boundaries (varlen packing): an int tensor [s] or [b, s] (or [bh, s]
    for the 3-D layout) for self-attention, or a ``(seg_q, seg_k)`` pair
    for cross-length cases.  ``mask_bias`` is an additive mask [mbh, sq,
    sk] (mbh in {bh, 1}) or [b|1, h|1, sq, sk], added to the
    scaled scores before the segment and causal masks; a broadcast mask is
    never expanded in memory.  It is a constant under differentiation
    unless ``mask_is_constant=False``, which runs the plain differentiable
    version (whole score matrix) so the bias gets its gradient.
    ``dropout_rate`` > 0 drops attention probabilities with the counter
    hash of ``dropout_seed`` (an int) at batch-head ``b*h + head`` and
    global (row, col), replayed bit for bit by the backward.  Scores are
    fp32 whatever the input dtype; the output has q's dtype.  CUDA tensors
    run, bf16 at head dims 64 and 128, ``csrc/flash_fwd_sm90.cu`` and for
    the gradients ``csrc/flash_bwd_sm90.cu`` (on the tensor cores, with P
    rounded to bf16 before P V as the JAX kernels round it), the rest
    (fp32; head dim 8) ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``;
    CPU tensors run :func:`_blockwise_fwd` and :func:`_blockwise_bwd`."""
    o, _ = flash_attention_fwd(q, k, v, causal=causal, mask_bias=mask_bias,
                               segment_ids=segment_ids, scale=scale,
                               mask_is_constant=mask_is_constant,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
    return o


def flash_attention_varlen(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Packed variable-length attention, the reference FMHA's interface:
    sequences concatenated along one token axis, delimited by
    ``cu_seqlens`` prefix sums.

    q/k/v: [total_tokens, h, d]; cu_seqlens_q/k: int [batch+1] with
    cu[0] == 0 and cu[batch] <= total_tokens.  Token i belongs to
    sequence j iff cu[j] <= i < cu[j+1]; tokens past cu[-1] land in one
    padding bucket and attend only among themselves.  Runs as
    :func:`flash_attention` with segment ids, heads as a strided view
    (no copy); differentiable in q, k and v."""
    if cu_seqlens_k is None:
        cu_seqlens_k = cu_seqlens_q

    def seg(cu, total):
        cu = cu.to(torch.int64)
        return torch.searchsorted(
            cu, torch.arange(total, device=cu.device), right=True) - 1

    seg_q = seg(cu_seqlens_q, q.shape[0]).to(q.device)
    seg_k = seg(cu_seqlens_k, k.shape[0]).to(q.device)
    o = flash_attention(q.movedim(1, 0), k.movedim(1, 0), v.movedim(1, 0),
                        causal=causal, segment_ids=(seg_q, seg_k),
                        scale=scale)
    return o.movedim(0, 1)


def code_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``, or for an fp8 tensor a uint8 view of the same bytes: fp8
    pools are gathered and scattered through it, since not every build
    indexes float8 tensors (the pool's dtype never changes)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _gather_pages(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]``, through :func:`code_bytes`."""
    return code_bytes(pool)[idx].view(pool.dtype)


def _paged_attention(q, k_pages, v_pages, page_table, kv_len, scale,
                     k_scale=None, v_scale=None):
    """The plain version of the decode attention: gather each request's
    page list into a contiguous [b, p_max*page_size, h, d] view, then
    masked attention in fp32 (the JAX package's ``_paged_attention_xla``).
    With ``k_scale``/``v_scale`` [n_pages, page_size, h] the pool holds
    int8 or fp8 codes, dequantized on read as ``code.float() * scale``."""
    b, h, q_len, d = q.shape
    page_size = k_pages.shape[1]
    p_max = page_table.shape[1]
    idx = page_table.long()
    kc = _gather_pages(k_pages, idx)       # [b, p_max, page_size, h, d]
    vc = _gather_pages(v_pages, idx)
    if k_scale is not None:
        kc = kc.float() * k_scale[idx][..., None]
        vc = vc.float() * v_scale[idx][..., None]
    kc = kc.reshape(b, p_max * page_size, h, d)
    vc = vc.reshape(b, p_max * page_size, h, d)
    s = torch.einsum("bhqd,bkhd->bhqk", q.float(), kc.float()) * scale
    rows = torch.arange(q_len, device=q.device)[:, None]
    cols = torch.arange(p_max * page_size, device=q.device)[None, :]
    limit = (kv_len.long() - q_len)[:, None, None, None] + rows
    s = torch.where(cols <= limit, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = _masked_exp(s, m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p, vc.float())
    return (o / torch.where(l == 0, 1.0, l)).to(q.dtype)


#: ``csrc/flash_decode_sm90.cu``'s partition of a request's page walk: a
#: split of a block is ``_DECODE_SPLIT_ELEMS / d`` columns rounded down to
#: whole pages (kSplitElems); its warps (kWarps) fold tiles of
#: ``_DECODE_TILE`` columns (kTile), tile t to warp t % kWarps; a block
#: works for one query row
_DECODE_SPLIT_ELEMS = 16384
_DECODE_WARPS = 4
_DECODE_TILE = 16
#: the pool dtypes of ``flash_decode_sm90.cu``'s entry points, at head dim
#: 128; the fp32 pool and head dim 8 run ``flash_decode.cu``
_DECODE_SM90_KERNELS = {torch.bfloat16: FLASH_DECODE_SM90,
                        torch.int8: FLASH_DECODE_SM90_INT8,
                        torch.float8_e4m3fn: FLASH_DECODE_SM90_FP8}
_DECODE_SM90_HEAD_DIMS = (128,)


def decode_split_columns(page_size: int, d: int) -> int:
    """The columns one block of ``flash_decode_sm90.cu`` walks: the
    split's elements over the head dim, rounded down to whole pages, at
    least one page."""
    return max(1, _DECODE_SPLIT_ELEMS // d // page_size) * page_size


def decode_partition(kv_len: int, page_size: int, d: int) -> list:
    """The order in which ``flash_decode_sm90.cu`` folds one query row's
    visible columns, as ``[split][warp] -> columns in the order the warp
    folds them``: each split (a block) adds its warps in order, then the
    splits are added in order.  A tile's columns are summed by a fixed
    butterfly inside the warp.  For q_len 1 a row sees ``kv_len`` columns
    (``kv_len - q_len + i + 1`` for row i of a longer window, which walks
    the partition of that count).  It is a function of the
    request's own length, the page size and the head dim alone, never of
    the batch or the card: the engine's batched == sequential contract
    rests on it.  An empty window still has one split, which writes the
    zeros."""
    cols = decode_split_columns(page_size, d)
    n_splits = max(1, -(-kv_len // cols))
    out = []
    for s in range(n_splits):
        c0, n = s * cols, max(0, min(kv_len - s * cols, cols))
        n_tiles = -(-n // _DECODE_TILE)
        out.append([[c0 + j for t in range(w, n_tiles, _DECODE_WARPS)
                     for j in range(t * _DECODE_TILE,
                                    min(n, (t + 1) * _DECODE_TILE))]
                    for w in range(_DECODE_WARPS)])
    return out


def decode_max_splits(p_max: int, page_size: int, d: int) -> int:
    """Splits of the longest window a ``p_max``-page table can hold
    (``len(decode_partition(p_max * page_size, page_size, d))``): the
    split-partial workspace's extent (1: no workspace, no merge pass)."""
    return max(1, -(-p_max * page_size // decode_split_columns(page_size,
                                                                d)))


def _decode_route(q: torch.Tensor, k_pages: torch.Tensor) -> str:
    """``"sm90"`` (``flash_decode_sm90.cu``) for a bf16, int8 or fp8 pool
    at head dim 128 with an fp32 or bf16 q, else ``"scalar"``
    (``flash_decode.cu``: the fp32 pool, head dim 8)."""
    if (k_pages.dtype in _DECODE_SM90_KERNELS and q.dtype in _KERNEL_DTYPES
            and q.shape[-1] in _DECODE_SM90_HEAD_DIMS):
        return "sm90"
    return "scalar"


def _check_decode_tables(page_table, kv_len, B, device):
    page_table = _int32_on(page_table, device)
    kv_len = _int32_on(kv_len, device)
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or tuple(kv_len.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not fit batch {B}")
    return page_table, kv_len


def _check_pools(q, k_pages, v_pages):
    B, H, q_len, d = q.shape
    n_pages, page_size = k_pages.shape[:2]
    if (tuple(k_pages.shape) != (n_pages, page_size, H, d)
            or v_pages.shape != k_pages.shape
            or v_pages.dtype != k_pages.dtype):
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k_pages.stride() != v_pages.stride():
        raise ValueError("k_pages and v_pages must share their strides")
    return n_pages, page_size


def _flash_decode_cuda(q, k_pages, v_pages, page_table, kv_len, scale):
    """Launch ``flash_decode.cu`` (the fp32 pool, head dim 8); returns o
    [b, h, q_len, d] laid out as [b, q_len, h, d]."""
    B, H, q_len, d = q.shape
    n_pages, page_size = _check_pools(q, k_pages, v_pages)
    _check_kernel_dtype_and_dim(q)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check_kernel_operand(name, t, q)
    page_table, kv_len = _check_decode_tables(page_table, kv_len, B,
                                              q.device)
    o = torch.empty((B, q_len, H, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k_pages.stride()[:3],
                                   *o.stride()[:3])
    FLASH_DECODE(_KERNEL_DTYPES[q.dtype], d, q.device.index,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 o.data_ptr(), page_table.data_ptr(), kv_len.data_ptr(),
                 B, H, q_len, page_table.shape[1], page_size, n_pages,
                 strides, scale, _stream(q.device))
    return o


def _flash_decode_sm90_cuda(q, k_pages, v_pages, page_table, kv_len, scale,
                            k_scale=None, v_scale=None):
    """Launch ``flash_decode_sm90.cu``'s entry point for the pool's dtype
    (bf16, or the int8 / fp8 codes with their fp32 scales); returns o
    [b, h, q_len, d] in q's dtype, laid out as [b, q_len, h, d].  The
    split partials' workspace is sized by :func:`decode_max_splits`."""
    B, H, q_len, d = q.shape
    n_pages, page_size = _check_pools(q, k_pages, v_pages)
    kernel = _DECODE_SM90_KERNELS[k_pages.dtype]
    quantized = k_pages.dtype != torch.bfloat16
    if quantized != (k_scale is not None):
        raise ValueError(f"a {k_pages.dtype} pool takes k_scale/v_scale "
                         "exactly when it holds quantized codes")
    _check_kernel_dtype_and_dim(q)
    _check_kernel_operand("q", q, q)
    if k_pages.device != q.device:
        raise ValueError(f"k_pages is on {k_pages.device}, expected "
                         f"{q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check_kernel_operand(name, t, k_pages)
    scale_strides = (0, 0, 0)
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.device != q.device or t.dtype != torch.float32 \
                    or tuple(t.shape) != (n_pages, page_size, H):
                raise ValueError(
                    f"{name} must be fp32 [{n_pages}, {page_size}, {H}] on "
                    f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
        if k_scale.stride() != v_scale.stride():
            raise ValueError("k_scale and v_scale must share their strides")
        scale_strides = k_scale.stride()
    page_table, kv_len = _check_decode_tables(page_table, kv_len, B,
                                              q.device)
    p_max = page_table.shape[1]
    max_splits = decode_max_splits(p_max, page_size, d)
    o = torch.empty((B, q_len, H, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    work = (torch.empty(B * H * q_len * max_splits * (d + 2),
                        dtype=torch.float32, device=q.device)
            if max_splits > 1 else None)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k_pages.stride()[:3],
                                    *o.stride()[:3], *scale_strides)
    kernel(_KERNEL_DTYPES[q.dtype], d, q.device.index,
           q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
           k_scale.data_ptr() if quantized else None,
           v_scale.data_ptr() if quantized else None,
           o.data_ptr(), None if work is None else work.data_ptr(),
           page_table.data_ptr(), kv_len.data_ptr(),
           B, H, q_len, p_max, page_size, n_pages, max_splits,
           strides, scale, _stream(q.device))
    return o


def flash_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_table: torch.Tensor, kv_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode-mode attention against a paged KV pool.

    ``q`` [b, h, q_len, d]: the last ``q_len`` positions of each request.
    ``k_pages``/``v_pages`` [n_pages, page_size, h, d]: the shared pool.
    ``page_table`` [b, p_max] int: each request's page list in cache
    order, rows padded with page 0 (the pool's scratch page).  ``kv_len``
    [b]: valid tokens per request, INCLUDING the real query rows, whose
    K/V must already be in the pool.  Query row i sees columns
    ``[0, kv_len - q_len + i]``; a row whose window is empty
    (``kv_len < q_len``) returns exact zeros.  A page id outside the pool
    is an error on both implementations (on the card the kernel traps,
    which poisons the CUDA context as a device-side assert does).

    Quantized pool: with ``k_scale``/``v_scale`` [n_pages, page_size, h]
    fp32 (both or neither) the pools hold int8 or fp8 e4m3 codes, and
    both implementations dequantize on read, ``code * scale`` in fp32.

    Deterministic and row-independent on both implementations: a row's
    result depends on its own request's pages only.  CUDA tensors run
    ``csrc/flash_decode_sm90.cu`` (head dim 128: a bf16, int8 or fp8
    pool) or ``csrc/flash_decode.cu`` (an fp32 pool, head dim 8); a
    quantized pool at another shape raises.  CPU tensors run
    :func:`_paged_attention`."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        if _decode_route(q, k_pages) == "sm90":
            return _flash_decode_sm90_cuda(q, k_pages, v_pages, page_table,
                                           kv_len, float(scale), k_scale,
                                           v_scale)
        if k_scale is not None:
            raise ValueError(
                f"the quantized pool's kernel takes head dim "
                f"{_DECODE_SM90_HEAD_DIMS} with int8 or fp8 codes and an "
                f"fp32 or bf16 q; got head dim {q.shape[-1]}, "
                f"{k_pages.dtype} codes, {q.dtype} q")
        return _flash_decode_cuda(q, k_pages, v_pages, page_table, kv_len,
                                  float(scale))
    return _paged_attention(q, k_pages, v_pages, page_table, kv_len,
                            float(scale), k_scale, v_scale)


# -- packed-QKV self-attention (the training path) -------------------------


def _normalize_qkv_segments(segment_ids, b, s):
    """segment_ids (int [s] / [b, s] or a (seg_q, seg_k) pair of those)
    -> (seg_q, seg_k) int32 tensors with batch dim in {b, 1}, or (None,
    None)."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, tuple):
        seg_q, seg_k = segment_ids
    else:
        seg_q = seg_k = segment_ids
    seg_q, seg_k = (torch.as_tensor(t).to(torch.int32) for t in (seg_q, seg_k))
    if seg_q.ndim == 1:
        seg_q = seg_q[None]
    if seg_k.ndim == 1:
        seg_k = seg_k[None]
    if seg_q.shape[-1] != s or seg_k.shape[-1] != s:
        raise ValueError(
            f"segment_ids length {seg_q.shape[-1]}/{seg_k.shape[-1]} != "
            f"sequence length {s} (packed QKV is self-attention)")
    for name, a in (("seg_q", seg_q), ("seg_k", seg_k)):
        if a.shape[0] not in (1, b):
            raise ValueError(f"segment_ids {name} batch dim {a.shape[0]} is "
                             f"neither 1 nor the qkv batch {b}")
    return seg_q, seg_k


def _qkv_heads(qkv, num_heads):
    """Per-head views of the Megatron-interleaved qkv [b, s, np*3*hn]:
    q, k, v each [b*np, s, hn] (copies, the plain path's layout)."""
    b, s, w = qkv.shape
    hn = w // (3 * num_heads)
    t = qkv.view(b, s, num_heads, 3, hn).permute(3, 0, 2, 1, 4)
    return [x.reshape(b * num_heads, s, hn) for x in t]


def _per_head_segments(seg, b, num_heads):
    if seg is not None and seg.shape[0] == b and b > 1:
        seg = seg.repeat_interleave(num_heads, 0)
    return seg


def _flash_qkv_fwd_plain(qkv, seg_q, seg_k, num_heads, scale, causal,
                         dropout_rate, dropout_seed):
    """The plain version of the packed forward: ctx [b, s, np*hn] in
    qkv's dtype and lse [b*np, s] fp32, through :func:`_blockwise_fwd` on
    the per-head views (head index b*np + h, as the kernels hash it)."""
    b, s, _ = qkv.shape
    q, k, v = _qkv_heads(qkv, num_heads)
    o, lse = _blockwise_fwd(
        q, k, v, scale, causal, None,
        _per_head_segments(seg_q, b, num_heads),
        _per_head_segments(seg_k, b, num_heads), dropout_seed, dropout_rate)
    ctx = o.view(b, num_heads, s, -1).transpose(1, 2).reshape(b, s, -1)
    return ctx, lse


def _flash_qkv_bwd_plain(qkv, dctx, ctx, lse, seg_q, seg_k, num_heads,
                         scale, causal, dropout_rate, dropout_seed):
    """The plain version of the packed backward: dqkv in qkv's layout and
    dtype, through :func:`_blockwise_bwd` on the per-head views."""
    b, s, w = qkv.shape
    hn = w // (3 * num_heads)
    q, k, v = _qkv_heads(qkv, num_heads)

    def heads(t):  # [b, s, np*hn] -> [b*np, s, hn]
        return t.view(b, s, num_heads, hn).transpose(1, 2).reshape(
            b * num_heads, s, hn)

    dq, dk, dv = _blockwise_bwd(
        q, k, v, _per_head_segments(seg_q, b, num_heads),
        _per_head_segments(seg_k, b, num_heads), heads(ctx), lse,
        heads(dctx), scale, causal, dropout_seed, dropout_rate)
    d = torch.stack([dq, dk, dv]).view(3, b, num_heads, s, hn)
    return d.permute(1, 3, 2, 0, 4).reshape(b, s, w)


#: the packed kernels' instances, (forward, backward) by (route, head
#: dim): bf16 runs the tensor-core sources, fp32 the scalar ones; each
#: instance is an entry point of its own, so its launches count apart
QKV_KERNELS = {("sm90", 128): (FLASH_QKV_FWD_SM90, FLASH_QKV_BWD_SM90),
               ("sm90", 64): (FLASH_QKV_FWD_SM90_D64, FLASH_QKV_BWD_SM90_D64),
               ("scalar", 128): (FLASH_QKV_FWD, FLASH_QKV_BWD),
               ("scalar", 64): (FLASH_QKV_FWD_D64, FLASH_QKV_BWD_D64)}
QKV_HEAD_DIMS = tuple(sorted({hn for _, hn in QKV_KERNELS}))


def _qkv_route(dtype: torch.dtype) -> str:
    """bf16 on the tensor cores; fp32 on the scalar kernels (the tensor
    cores take no fp32 operands, and TF32 would not meet the fp32
    contract)."""
    return "sm90" if dtype == torch.bfloat16 else "scalar"


def _qkv_kernel_args(qkv, seg_q, seg_k, num_heads):
    """Checks shared by the two packed kernels; returns (hn, seg
    pointers, seg_div)."""
    b, s, w = qkv.shape
    hn = w // (3 * num_heads)
    if qkv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the packed-QKV kernels take float32 or bfloat16, "
                        f"got {qkv.dtype}")
    if hn not in QKV_HEAD_DIMS:
        raise ValueError(f"the packed-QKV kernels are built for head dims "
                         f"{QKV_HEAD_DIMS}, got {hn}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the packed-QKV kernels take a contiguous, 16-byte "
                         "aligned qkv")
    if seg_q is None:
        return hn, (None, None), 1
    seg_q, seg_k = (_int32_on(t, qkv.device) for t in (seg_q, seg_k))
    if seg_q.shape[0] != seg_k.shape[0]:
        # the kernels read one id row per (batch, head) for both sides
        seg_q, seg_k = (t.expand(b, s).contiguous() for t in (seg_q, seg_k))
    return hn, (seg_q, seg_k), (b * num_heads) // seg_q.shape[0]


#: the tiles the bf16 packed backward walks (csrc/flash_qkv_bwd_sm90.cu):
#: (query rows, key columns) of its dk/dv pass and of its dq pass, the
#: same at head dims 64 and 128
QKV_SM90_BWD_TILES = {"dkdv": (32, 128), "dq": (128, 64)}


def _flash_qkv_fwd_cuda(qkv, seg_q, seg_k, num_heads, scale, causal,
                        dropout_rate, dropout_seed):
    """Launch the packed forward; same contract as
    :func:`_flash_qkv_fwd_plain`.  A bf16 qkv runs
    ``flash_qkv_fwd_sm90.cu`` (wgmma and TMA), an fp32 one
    ``flash_qkv_fwd.cu`` (scalar FMAs), each at its head dim's instance
    (:data:`QKV_KERNELS`)."""
    b, s, _ = qkv.shape
    hn, segs, seg_div = _qkv_kernel_args(qkv, seg_q, seg_k, num_heads)
    seed, thresh, keep, _ = _dropout_launch_args(dropout_rate, dropout_seed)
    ctx = torch.empty((b, s, num_heads * hn), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((b * num_heads, s), dtype=torch.float32,
                      device=qkv.device)
    head = (qkv.data_ptr(), ctx.data_ptr(), lse.data_ptr(),
            *(None if t is None else t.data_ptr() for t in segs), seg_div, b,
            num_heads, s, scale, int(causal), seed, thresh, keep,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    route = _qkv_route(qkv.dtype)
    kernel = QKV_KERNELS[route, hn][0]
    if route == "sm90":
        kernel(hn, qkv.device.index, *head)
    else:
        kernel(_KERNEL_DTYPES[qkv.dtype], hn, qkv.device.index, *head)
    return ctx, lse


def _flash_qkv_bwd_cuda(qkv, dctx, ctx, lse, seg_q, seg_k, num_heads,
                        scale, causal, dropout_rate, dropout_seed,
                        visits=None):
    """Launch the packed backward; same contract as
    :func:`_flash_qkv_bwd_plain`.  A bf16 qkv runs
    ``flash_qkv_bwd_sm90.cu``, an fp32 one ``flash_qkv_bwd.cu`` (as the
    forward).  ``visits`` (int32 on the card, or None) takes the tiles each
    block of the bf16 kernel walked: [b*np*ceil(s/128)] for its dk/dv pass,
    then [b*np*ceil(s/128)] for its dq pass (tiles of
    :data:`QKV_SM90_BWD_TILES`)."""
    b, s, _ = qkv.shape
    hn, segs, seg_div = _qkv_kernel_args(qkv, seg_q, seg_k, num_heads)
    seed, thresh, _, inv = _dropout_launch_args(dropout_rate, dropout_seed)
    dctx = dctx.to(qkv.dtype).contiguous()
    ctx = ctx.contiguous()
    lse = lse.contiguous()
    for name, t in (("dctx", dctx), ("ctx", ctx), ("lse", lse)):
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{qkv.device}")
    delta = torch.empty_like(lse)
    dqkv = torch.empty_like(qkv)
    ptrs = (qkv.data_ptr(), dctx.data_ptr(), ctx.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dqkv.data_ptr(),
            *(None if t is None else t.data_ptr() for t in segs), seg_div)
    tail = (b, num_heads, s, scale, int(causal), seed, thresh, inv,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    route = _qkv_route(qkv.dtype)
    kernel = QKV_KERNELS[route, hn][1]
    if route == "sm90":
        if visits is not None:
            n = -(-s // QKV_SM90_BWD_TILES["dkdv"][1])
            n += -(-s // QKV_SM90_BWD_TILES["dq"][0])
            if (visits.dtype != torch.int32 or visits.device != qkv.device
                    or visits.numel() != b * num_heads * n):
                raise ValueError("visits must be int32 [b*np*(ceil(s/128) * "
                                 "2)] on qkv's device")
        kernel(hn, qkv.device.index, *ptrs,
               None if visits is None else visits.data_ptr(), *tail)
    else:
        if visits is not None:
            raise ValueError("visits are counted by the bf16 kernel only")
        kernel(_KERNEL_DTYPES[qkv.dtype], hn, qkv.device.index, *ptrs, *tail)
    return dqkv


# A torch.library custom op, so that a selective activation checkpoint
# (``transformer.testing.standalone_gpt``, remat policy "attn_res") can
# keep (ctx, lse) and the recompute never re-runs the forward kernel.
@torch.library.custom_op("apex_tpu_torch::flash_qkv_fwd", mutates_args=())
def _flash_qkv_fwd_op(qkv: torch.Tensor, seg_q: Optional[torch.Tensor],
                      seg_k: Optional[torch.Tensor], num_heads: int,
                      scale: float, causal: bool, dropout_rate: float,
                      dropout_seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    fn = _flash_qkv_fwd_cuda if qkv.is_cuda else _flash_qkv_fwd_plain
    return fn(qkv, seg_q, seg_k, num_heads, scale, causal, dropout_rate,
              dropout_seed)


@_flash_qkv_fwd_op.register_fake
def _(qkv, seg_q, seg_k, num_heads, scale, causal, dropout_rate,
      dropout_seed):
    b, s, w = qkv.shape
    return (qkv.new_empty(b, s, w // 3),
            qkv.new_empty(b * num_heads, s, dtype=torch.float32))


@torch.library.custom_op("apex_tpu_torch::flash_qkv_bwd", mutates_args=())
def _flash_qkv_bwd_op(qkv: torch.Tensor, dctx: torch.Tensor,
                      ctx: torch.Tensor, lse: torch.Tensor,
                      seg_q: Optional[torch.Tensor],
                      seg_k: Optional[torch.Tensor], num_heads: int,
                      scale: float, causal: bool, dropout_rate: float,
                      dropout_seed: int) -> torch.Tensor:
    fn = _flash_qkv_bwd_cuda if qkv.is_cuda else _flash_qkv_bwd_plain
    return fn(qkv, dctx, ctx, lse, seg_q, seg_k, num_heads, scale, causal,
              dropout_rate, dropout_seed)


@_flash_qkv_bwd_op.register_fake
def _(qkv, dctx, ctx, lse, seg_q, seg_k, num_heads, scale, causal,
      dropout_rate, dropout_seed):
    return torch.empty_like(qkv)


def _flash_qkv_setup(ctx, inputs, output):
    qkv, seg_q, seg_k, num_heads, scale, causal, rate, seed = inputs
    out, lse = output
    ctx.save_for_backward(qkv, out, lse, seg_q, seg_k)
    ctx.args = (num_heads, scale, causal, rate, seed)


def _flash_qkv_backward(ctx, dout, dlse):
    qkv, out, lse, seg_q, seg_k = ctx.saved_tensors
    dqkv = _flash_qkv_bwd_op(qkv, dout, out, lse, seg_q, seg_k, *ctx.args)
    return dqkv, None, None, None, None, None, None, None


_flash_qkv_fwd_op.register_autograd(_flash_qkv_backward,
                                    setup_context=_flash_qkv_setup)

#: the op a selective checkpoint must save to keep the forward kernel out
#: of the recompute
FLASH_QKV_FWD_OP = torch.ops.apex_tpu_torch.flash_qkv_fwd.default


def flash_attention_qkv(
    qkv: torch.Tensor, num_heads: int,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    segment_ids: Optional[SegmentIds] = None,
) -> torch.Tensor:
    """Self-attention straight from the QKV projection output.

    ``qkv``: [b, s, num_heads*3*hn] in the Megatron interleaved layout
    (per head: hn q lanes, hn k lanes, hn v lanes).  Returns the context
    [b, s, num_heads*hn] in qkv's dtype, ready for the output projection;
    differentiable in ``qkv``, with dqkv in the same layout.

    ``dropout_rate`` > 0 drops attention probabilities inside the kernels
    with the counter hash of ``dropout_seed`` (an int), batch-head index
    ``b*num_heads + head``.  ``segment_ids``: int [s] or [b, s] packing
    ids, or a ``(seg_q, seg_k)`` pair of those; scores across segments are
    masked.  CUDA tensors run the kernels (head dims 64 and 128): bf16
    ones ``csrc/flash_qkv_fwd_sm90.cu`` and ``csrc/flash_qkv_bwd_sm90.cu``
    on the tensor cores, fp32 ones ``csrc/flash_qkv_fwd.cu`` and
    ``csrc/flash_qkv_bwd.cu``; CPU tensors run the plain versions."""
    b, s, three_h = qkv.shape
    hn = three_h // (3 * num_heads)
    if three_h != 3 * num_heads * hn:
        raise ValueError(f"qkv last dim {three_h} is not 3*num_heads*head_dim"
                         f" (num_heads={num_heads})")
    if scale is None:
        scale = 1.0 / math.sqrt(hn)
    rate = float(dropout_rate)
    _check_dropout(rate, dropout_seed)
    seg_q, seg_k = _normalize_qkv_segments(segment_ids, b, s)
    if seg_q is not None:
        seg_q, seg_k = seg_q.to(qkv.device), seg_k.to(qkv.device)
    ctx, _ = _flash_qkv_fwd_op(qkv, seg_q, seg_k, num_heads, float(scale),
                               bool(causal), rate,
                               0 if dropout_seed is None else int(dropout_seed))
    return ctx
