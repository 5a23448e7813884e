"""The bench's roofs and floor, measured on the card.

PyTorch port of ``bench.py::bench_hbm_roof``, ``bench_matmul_roof`` and
``_attention_dot_floor``: what this card demonstrably reaches, against
which a kernel's rate reads as a share.

* K9, :func:`hbm_copy` — a byte copy, ``csrc/hbm_copy.cu`` in place of the
  TPU kernel ``bench.py::bench_hbm_roof`` (``copy_kernel``);
  :func:`hbm_roof` times it on two 512 MiB fp32 buffers copied into each
  other in turn, so every launch reads and writes a whole buffer, as the
  JAX chain of copies does;
* :func:`matmul_roof` — one 8192^3 bf16 product with fp32 sums through
  cuBLAS, as the JAX package leaves it to XLA (no kernel of this
  repository);
* K10, :func:`attention_dots` — only the two attention products with the
  bench's static causal tile skip, ``csrc/attention_dots.cu`` (tensor
  cores) in place of the TPU kernel ``bench.py::_attention_dot_floor``;
  :func:`attention_dot_floor` times it.

Each kernel's plain PyTorch version sits beside it and runs for CPU
tensors; a CUDA tensor goes through the kernel or the call raises.  The
measuring functions run on the card only and raise without one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.kernels import ATTENTION_DOTS, HBM_COPY
from apex_tpu_torch.ops._gemm import mm_f32
from apex_tpu_torch.profiling.timing import ROOF_STEPS, device_time_ms

#: H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W): HBM
#: bytes/s, and flop/s by input type (bf16 on the tensor cores, fp32 on
#: the FMA units)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

Device = Optional[Union[str, torch.device]]


def bound(nbytes: float, flops: float,
          dtype=torch.bfloat16) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the HBM rate and the operations over the
    peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_device(device: Device) -> torch.device:
    """The card to measure on: ``None`` is the current one; no card, or
    a CPU device, raises ``RuntimeError``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the roofs and floors are measured on the card, "
                           f"not on {dev}")
    return dev


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- K9: the HBM copy --------------------------------------------------------


def copy_bytes(x: torch.Tensor) -> int:
    """Bytes one copy of ``x`` moves: read once, written once
    (``bench.py``'s ``2 * x.size * 4`` for its fp32 array)."""
    return 2 * x.numel() * x.element_size()


def _hbm_copy_plain(x: torch.Tensor,
                    out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return x.clone()
    return out.copy_(x)


def _check_copy(x: torch.Tensor, out: torch.Tensor) -> None:
    """What ``hbm_copy.cu`` needs: contiguous, 16-byte aligned (it moves
    16 bytes an access; a sliced tensor can break that), not
    overlapping."""
    for name, t in (("x", x), ("out", out)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"hbm_copy.cu needs a contiguous, 16-byte "
                             f"aligned {name}; pass a fresh tensor")
    nbytes = x.numel() * x.element_size()
    src, dst = x.data_ptr(), out.data_ptr()
    if nbytes and src < dst + nbytes and dst < src + nbytes:
        raise ValueError("hbm_copy: x and out overlap")


def _hbm_copy_cuda(x: torch.Tensor,
                   out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _check_copy(x, out)
    HBM_COPY(x.device.index, x.data_ptr(), out.data_ptr(),
             x.numel() * x.element_size(), _stream(x.device))
    return out


def hbm_copy(x: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` copied bit for bit into ``out`` (a new tensor if None), any
    dtype.  CUDA tensors run ``csrc/hbm_copy.cu`` (contiguous, 16-byte
    aligned, not overlapping, or it raises); CPU tensors ``x.clone()`` or ``out.copy_(x)``."""
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"out ({tuple(out.shape)}, {out.dtype}, "
                         f"{out.device}) does not match x "
                         f"({tuple(x.shape)}, {x.dtype}, {x.device})")
    fn = _hbm_copy_cuda if x.is_cuda else _hbm_copy_plain
    return fn(x, out)


def hbm_roof(rows: int = 16384, cols: int = 8192,
             device: Device = None) -> float:
    """Demonstrated HBM streaming rate in GB/s: two [rows, cols] fp32
    buffers (512 MiB each by default) copied into each other in turn by
    K9, ``copy_bytes / t`` per launch, ``t`` from :func:`device_time_ms`
    over ``ROOF_STEPS`` back-to-back pairs of launches."""
    dev = card_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, cols, generator=gen, device=dev)
    y = torch.empty_like(x)

    def pingpong():
        hbm_copy(x, y)
        hbm_copy(y, x)

    ms = device_time_ms(pingpong, steps=ROOF_STEPS) / 2
    return copy_bytes(x) / ms / 1e6


def matmul_roof(m: int = 8192, device: Device = None) -> float:
    """Demonstrated bf16 matmul rate in TFLOP/s: ``2 m^3 / t`` of one
    [m, m] x [m, m] bf16 product with fp32 sums and an fp32 result
    (cuBLAS, through ``ops._gemm.mm_f32``)."""
    dev = card_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randn(m, m, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    ms = device_time_ms(mm_f32, a, b, steps=ROOF_STEPS)
    return 2 * m ** 3 / ms / 1e9


# -- K10: the attention dot floor -------------------------------------------

DOTS_TILE = 64               # attention_dots.cu's q rows a block, keys a step
DOTS_HEAD_DIMS = (64, 128)
DOTS_SCALE = 1e-3            # bench.py's (sc * 1e-3)


def dots_blocks(s: int, block_q: int, block_k: int) -> Tuple[int, int]:
    """(bq, bk) as the JAX bench clips them, ``min(block, s)``; each must
    divide s (the JAX kernel leaves the rows past the last whole block
    unwritten)."""
    bq, bk = min(block_q, s), min(block_k, s)
    if bq <= 0 or bk <= 0 or s % bq or s % bk:
        raise ValueError(f"blocks ({block_q}, {block_k}) clipped to "
                         f"({bq}, {bk}) must divide s = {s}")
    return bq, bk


def dots_keep(s: int, block_q: int, block_k: int,
              device: Device = "cpu") -> torch.Tensor:
    """bool [s, s]: pair (i, j) is summed iff ``(i // bq) * bq + bq - 1 >=
    (j // bk) * bk`` (``bench.py``'s static causal tile skip, per tile:
    diagonal tiles are whole)."""
    bq, bk = dots_blocks(s, block_q, block_k)
    i = torch.arange(s, device=device)
    return (i // bq * bq + bq - 1)[:, None] >= (i // bk * bk)[None, :]


def dots_pairs(s: int, block_q: int, block_k: int) -> int:
    """(i, j) pairs one batch-head multiplies under the tile skip: each
    q block keeps the keys up to the end of the k block that holds its
    last row."""
    bq, bk = dots_blocks(s, block_q, block_k)
    return sum(bq * ((qb * bq + bq - 1) // bk + 1) * bk
               for qb in range(s // bq))


def dots_flops(bh: int, s: int, d: int) -> float:
    """The JAX bench's count, the useful causal work ``4 bh s^2 d / 2``."""
    return 4 * bh * s * s * d / 2


def _check_dots(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must be one [bh, s, d] shape")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError("the attention dot floor takes bf16 q, k, v")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v are on different devices")


def _attention_dots_plain(q, k, v, block_q, block_k):
    """Dense fp32 products with the skipped pairs' P set to 0: S = q k^T
    in fp32, P = bf16(S * 1e-3), o = bf16(P v in fp32)."""
    bh, s, d = q.shape
    keep = dots_keep(s, block_q, block_k, q.device)
    sc = torch.matmul(q.float(), k.float().transpose(1, 2))
    p = torch.where(keep, (sc * DOTS_SCALE).to(v.dtype), 0)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _attention_dots_cuda(q, k, v, block_q, block_k):
    bh, s, d = q.shape
    bq, bk = dots_blocks(s, block_q, block_k)
    if d not in DOTS_HEAD_DIMS:
        raise ValueError(f"attention_dots.cu takes head dims "
                         f"{DOTS_HEAD_DIMS}, got {d}")
    if bq % DOTS_TILE or bk % DOTS_TILE:
        raise ValueError(f"attention_dots.cu walks tiles of {DOTS_TILE}: "
                         f"blocks ({bq}, {bk}) must be multiples of it")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"attention_dots.cu needs a contiguous, 16-byte "
                             f"aligned {name}; pass {name}.contiguous()")
    o = torch.empty_like(q)
    ATTENTION_DOTS(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), bh, s, d, bq, bk, _stream(q.device))
    return o


def attention_dots(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   block_q: int, block_k: int) -> torch.Tensor:
    """``o = sum over kept tiles of bf16((q k^T) * 1e-3) v``, fp32 sums,
    bf16 out: the function the JAX bench's attention dot floor computes,
    over bf16 [bh, s, d] q, k, v (no softmax).  ``block_q``/``block_k``
    decide which pairs are summed (:func:`dots_keep`).  CUDA tensors run
    ``csrc/attention_dots.cu`` (head dims 64, 128; blocks multiples of
    64); CPU tensors the plain version."""
    _check_dots(q, k, v)
    fn = _attention_dots_cuda if q.is_cuda else _attention_dots_plain
    return fn(q, k, v, block_q, block_k)


class DotFloor(NamedTuple):
    """One timed run of K10: ``tflops`` under the JAX bench's count
    (:func:`dots_flops`), ``executed_tflops`` under the pairs multiplied
    (:func:`dots_pairs` over all batch-heads, 4 d flops each), the bound
    from the executed work."""
    tflops: float
    executed_tflops: float
    ms: float
    bound_ms: float


def attention_dot_floor(bh: int, s: int, d: int, block_q: int, block_k: int,
                        device: Device = None) -> DotFloor:
    """Time K10 on seeded bf16 [bh, s, d] q, k, v with
    :func:`device_time_ms` (its launches back to back)."""
    dev = card_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ms = device_time_ms(attention_dots, q, k, v, block_q, block_k)
    pairs = bh * dots_pairs(s, block_q, block_k)
    flops, executed = dots_flops(bh, s, d), 4 * d * pairs
    bound_ms, _ = bound(4 * q.numel() * q.element_size(), executed)
    return DotFloor(flops / ms / 1e9, executed / ms / 1e9, ms, bound_ms)
