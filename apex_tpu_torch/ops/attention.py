"""Attention for the serving path: the prefill's flash attention and the
decode step's attention over a paged KV pool.

PyTorch port of the forward-only serving subset of the JAX package's
``apex_tpu/ops/attention.py``.  Each public function has two
implementations of one contract:

* a kernel written by hand for Hopper — ``csrc/flash_fwd.cu`` in place
  of the TPU kernel ``_flash_fwd_pallas``, ``csrc/flash_decode.cu`` in
  place of ``_flash_decode_pallas`` — which runs for CUDA tensors;
* a plain PyTorch version with the JAX package's math
  (:func:`_blockwise_fwd` for ``_blockwise_fwd_xla``,
  :func:`_paged_attention` for ``_paged_attention_xla``), which runs for
  CPU tensors.

Where the tensors lie picks the implementation, and nothing else does:
a CUDA tensor goes through the kernel or the call raises.  A failed
build or launch is an error, never a quiet switch to the plain version.

Inference only: no autograd.  Additive ``mask_bias`` runs on the plain
path only; attention dropout and the quantized pool are not ported yet
(ROADMAP.md).  The JAX package's TPU tiling knobs (``block_q``,
``block_k``) have no meaning here and are not taken.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from apex_tpu_torch.kernels import FLASH_DECODE, FLASH_FWD

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
    skipping it is exact.  ``csrc/flash_fwd.cu`` applies this rule per
    q-block inside the kernel, with its own 64-wide tiles; this function
    is the rule's statement in PyTorch (held against the JAX package's in
    the tests) and counts the tiles a run visits."""
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


def _blockwise_fwd(q, k, v, scale, causal, mask_bias, seg_q, seg_k):
    """The plain version of the flash forward: q [bh, sq, d], k/v
    [bh, sk, d] -> (o [bh, sq, d] in q's dtype, lse [bh, sq] fp32), the
    whole score matrix in fp32 (the JAX package's ``_blockwise_fwd_xla``,
    without dropout)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = _apply_masks(s, mask_bias, seg_q, seg_k, causal)
    m = s.amax(-1)
    p = _masked_exp(s, m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    l_safe = torch.where(l == 0, 1.0, l)
    o = o / l_safe[..., None]
    lse = torch.where(l == 0, _NEG_INF, m + torch.log(l_safe))
    return o.to(q.dtype), lse


# -- kernel wrappers -------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (8, 128)   # the toy config's and GPT-1.3B's


def _check_kernel_operand(name: str, t: torch.Tensor, like: torch.Tensor):
    """Device, dtype, and the 16-byte vector-load alignment the kernels
    read with: unit last stride, every other stride and the base address
    a multiple of 16 bytes."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {like.dtype}")
    unit = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % unit for s in t.stride()[:-1])
            or t.data_ptr() % 16):
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


def _flash_fwd_cuda(q, k, v, seg_q, seg_k, scale, causal):
    """Launch ``flash_fwd.cu``: q [B, H, sq, d], k/v [B, H, sk, d], any
    strides the kernel can vector-load; seg ids [rows, s] with rows in
    {1, B, B*H} or None.  Returns (o [B, H, sq, d] laid out as
    [B, sq, H, d], lse [B*H, sq] fp32)."""
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
    seg_div, seg_ptrs = 1, (None, None)
    if seg_q is not None:
        seg_q, seg_k = _int32_on(seg_q, q.device), _int32_on(seg_k, q.device)
        rows = seg_q.shape[0]
        if (rows not in (1, B, B * H) or tuple(seg_q.shape) != (rows, sq)
                or tuple(seg_k.shape) != (rows, sk)):
            raise ValueError(
                f"segment ids {tuple(seg_q.shape)}/{tuple(seg_k.shape)} do "
                f"not fit q {tuple(q.shape)} and k {tuple(k.shape)}")
        seg_div = (B * H) // rows
        seg_ptrs = (seg_q.data_ptr(), seg_k.data_ptr())
    o = torch.empty((B, sq, H, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((B * H, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *o.stride()[:3])
    FLASH_FWD(_KERNEL_DTYPES[q.dtype], d, q.device.index,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), *seg_ptrs, seg_div, B, H, sq, sk, strides,
              scale, int(causal),
              torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


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


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    mask_bias: Optional[torch.Tensor] = None,
    segment_ids: Optional[SegmentIds] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the fp32 log-sum-exp of
    every score row, ``lse`` [b*h, sq] (-1e30 for a row that sees no
    column, whose output is exact zeros)."""
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP.md, queue B)")
    seg_q, seg_k = _segments(segment_ids)
    three_d = q.ndim == 3
    if three_d:  # [bh, s, d] is [bh, 1, s, d] with per-row segment ids
        q, k, v = q[:, None], k[:, None], v[:, None]
    if q.ndim != 4:
        raise ValueError(f"q must be [b, h, s, d] or [bh, s, d], got "
                         f"{tuple(q.shape)}")
    B, H, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        if mask_bias is not None:
            raise NotImplementedError(
                "mask_bias has no CUDA kernel yet (ROADMAP.md, queue B); "
                "it runs on CPU tensors only")
        o, lse = _flash_fwd_cuda(q, k, v, seg_q, seg_k, float(scale),
                                 bool(causal))
    else:
        if mask_bias is not None and mask_bias.ndim == 4:
            mask_bias = mask_bias.broadcast_to(B, H, sq, sk).reshape(
                B * H, sq, sk)
        if seg_q is not None and seg_q.shape[0] == B and B > 1:
            # per-batch segments replicate across heads
            seg_q = seg_q.repeat_interleave(H, 0)
            seg_k = seg_k.repeat_interleave(H, 0)
        o, lse = _blockwise_fwd(q.reshape(B * H, sq, d),
                                k.reshape(B * H, sk, d),
                                v.reshape(B * H, sk, d), float(scale),
                                bool(causal), mask_bias, seg_q, seg_k)
        o = o.reshape(B, H, sq, d)
    return (o[:, 0] if three_d else o), lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    mask_bias: Optional[torch.Tensor] = None,
    segment_ids: Optional[SegmentIds] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Fused attention over [b, h, s, d] (or [bh, s, d]) tensors.

    ``causal`` aligns the mask to the END of the keys: row i sees columns
    ``<= i + sk - sq``.  ``segment_ids`` masks attention across segment
    boundaries (varlen packing): an int tensor [s] or [b, s] (or [bh, s]
    for the 3-D layout) for self-attention, or a ``(seg_q, seg_k)`` pair.
    ``mask_bias`` is an additive [mbh, sq, sk] or [b|1, h|1, sq, sk] mask
    (CPU only for now).  Scores are fp32 whatever the input dtype; the
    output has q's dtype.  CUDA tensors run ``csrc/flash_fwd.cu``; CPU
    tensors run :func:`_blockwise_fwd`."""
    o, _ = flash_attention_fwd(q, k, v, causal=causal, mask_bias=mask_bias,
                               segment_ids=segment_ids, scale=scale,
                               dropout_rate=dropout_rate)
    return o


def _paged_attention(q, k_pages, v_pages, page_table, kv_len, scale):
    """The plain version of the decode attention: gather each request's
    page list into a contiguous [b, p_max*page_size, h, d] view, then
    masked attention in fp32 (the JAX package's ``_paged_attention_xla``,
    without the quantized pool)."""
    b, h, q_len, d = q.shape
    page_size = k_pages.shape[1]
    p_max = page_table.shape[1]
    idx = page_table.long()
    kc = k_pages[idx].reshape(b, p_max * page_size, h, d)
    vc = v_pages[idx].reshape(b, p_max * page_size, h, d)
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


def _flash_decode_cuda(q, k_pages, v_pages, page_table, kv_len, scale):
    """Launch ``flash_decode.cu``; returns o [b, h, q_len, d] laid out as
    [b, q_len, h, d]."""
    B, H, q_len, d = q.shape
    n_pages, page_size = k_pages.shape[:2]
    if (tuple(k_pages.shape) != (n_pages, page_size, H, d)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    _check_kernel_dtype_and_dim(q)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check_kernel_operand(name, t, q)
    if k_pages.stride() != v_pages.stride():
        raise ValueError("k_pages and v_pages must share their strides")
    page_table = _int32_on(page_table, q.device)
    kv_len = _int32_on(kv_len, q.device)
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or tuple(kv_len.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not fit batch {B}")
    o = torch.empty((B, q_len, H, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k_pages.stride()[:3],
                                   *o.stride()[:3])
    FLASH_DECODE(_KERNEL_DTYPES[q.dtype], d, q.device.index,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 o.data_ptr(), page_table.data_ptr(), kv_len.data_ptr(),
                 B, H, q_len, page_table.shape[1], page_size, n_pages,
                 strides, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
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

    Deterministic and row-independent on both implementations: a row's
    result depends on its own request's pages only.  CUDA tensors run
    ``csrc/flash_decode.cu``; CPU tensors run :func:`_paged_attention`.
    The quantized pool (``k_scale``/``v_scale``) is not ported yet."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "the quantized KV pool is not ported yet (ROADMAP.md, queue B)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _flash_decode_cuda(q, k_pages, v_pages, page_table, kv_len,
                                  float(scale))
    return _paged_attention(q, k_pages, v_pages, page_table, kv_len,
                            float(scale))
