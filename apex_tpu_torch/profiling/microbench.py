"""The kernel microbenches: the port's flash attention and LayerNorm
kernels against plain PyTorch and against the roofs, on the card.

PyTorch port of ``bench.py::bench_attention_kernel`` and
``bench_layernorm_kernel``, with the dot floor's fraction that
``bench.py::main`` adds (the matmul roof's fractions stay with the caller,
which holds the roof, as in ``main``).
Result keys follow ``bench.py`` where the quantity is the same; the
``xla_`` prefix and the ``timing`` field are gone (one timing method,
:func:`~apex_tpu_torch.profiling.timing.device_time_ms`), and the values
are not rounded.  Both run on the card only and raise without one.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.fused_layer_norm import layer_norm
from apex_tpu_torch.profiling.roofs import (Device, attention_dot_floor,
                                            card_device, hbm_roof)
from apex_tpu_torch.profiling.timing import device_time_ms, timed_pair

LN_ROWS, LN_COLS = 16384, 4096   # bench.py's LayerNorm working set
LN_EPS = 1e-5


def attention_flops(bh: int, s: int, d: int) -> Tuple[float, float]:
    """(forward, backward) flops of causal attention as ``bench.py``
    counts them: ``4 bh s^2 d / 2`` and 2.5 times that."""
    fwd = 4 * bh * s * s * d / 2
    return fwd, 2.5 * fwd


def layer_norm_bytes(rows: int = LN_ROWS,
                     cols: int = LN_COLS) -> Tuple[int, int]:
    """(forward, backward) bytes of the bf16 LayerNorm as ``bench.py``
    counts them: x read and y written; x, dy read, dx written and one
    more pass."""
    nbytes = rows * cols * 2
    return 2 * nbytes, 4 * nbytes


def _naive_attention(q, k, v):
    """``bench.py``'s ``naive``: fp32 scores from bf16 products, the causal
    fill, softmax, bf16 probabilities times v with fp32 sums."""
    s, d = q.shape[1], q.shape[2]
    sc = torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32) / d ** 0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(torch.where(causal, sc, -1e30), -1).to(torch.bfloat16)
    return torch.bmm(p, v, out_dtype=torch.float32).to(torch.bfloat16)


def attention_kernel(bh: int, s: int, d: int, block_q: int, block_k: int,
                     measure_floor: bool = False,
                     device: Device = None) -> dict:
    """Causal bf16 flash attention over seeded [bh, s, d] q, k, v:
    forward TFLOP/s (K1) against the naive forward, timed in turns;
    forward + backward TFLOP/s through autograd (K1 + K2, the gradient of
    ``sum(o * 1e-3)``); with ``measure_floor`` the dot floor (K10) at
    ``block_q``/``block_k`` and ``fwdbwd_frac_of_dot_floor``.  The
    fractions of the matmul roof are the caller's, as in ``bench.py::main``.
    The port's flash kernels take no block sizes: ``block_q``/``block_k``
    shape the floor only."""
    dev = card_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    fwd_flops, bwd_flops = attention_flops(bh, s, d)

    def fwd(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def train(q, k, v):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*qkv, causal=True)
        return torch.autograd.grad((o.float() * 1e-3).sum(), qkv)

    t_f, t_n = timed_pair(fwd, _naive_attention, (q, k, v), (q, k, v))
    t_fb = device_time_ms(train, q, k, v)
    out = {"fwd_tflops": fwd_flops / t_f / 1e9,
           "fwdbwd_tflops": (fwd_flops + bwd_flops) / t_fb / 1e9,
           "naive_fwd_tflops": fwd_flops / t_n / 1e9,
           "fwd_speedup_vs_naive": t_n / t_f}
    if measure_floor:
        floor = attention_dot_floor(bh, s, d, block_q, block_k, device=dev)
        out.update(dot_floor_tflops=floor.tflops,
                   dot_floor_executed_tflops=floor.executed_tflops,
                   dot_floor_ms=floor.ms, dot_floor_bound_ms=floor.bound_ms,
                   fwdbwd_frac_of_dot_floor=out["fwdbwd_tflops"]
                   / floor.tflops)
    return out


def _naive_layer_norm(x, w, b):
    """``bench.py``'s ``naive_ln``: fp32 statistics, output in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + LN_EPS) * w + b).to(x.dtype)


def layer_norm_kernel(device: Device = None) -> dict:
    """The fused LayerNorm (K6 forward, K6 + K7 under autograd) at
    ``bench.py``'s [16384, 4096] bf16 with fp32 weight and bias, against
    the naive formulation (forward, and its autograd backward), each pair
    timed in turns with a random cotangent; the fractions of an HBM roof
    sampled right after (``adjacent_hbm_gb_s``).  Keys: ``fwd_fused_gb_s``
    and ``fwd_naive_gb_s`` are ``bench.py``'s ``fwd_pallas_gb_s`` and
    ``fwd_xla_gb_s``."""
    dev = card_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, r = (torch.randn(LN_ROWS, LN_COLS, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    w = torch.ones(LN_COLS, device=dev)
    b = torch.zeros(LN_COLS, device=dev)
    fwd_bytes, bwd_bytes = layer_norm_bytes()

    def fused(x, w, b):
        return layer_norm(x, w, b, eps=LN_EPS)

    def grad_of(ln):
        def bwd(x, w, b, r):
            xx = x.detach().requires_grad_()
            y = ln(xx, w, b).float()
            return torch.autograd.grad((y * r.float()).sum(), xx)
        return bwd

    t_p, t_x = timed_pair(fused, _naive_layer_norm, (x, w, b), (x, w, b))
    t_fb, t_ab = timed_pair(grad_of(fused), grad_of(_naive_layer_norm),
                            (x, w, b, r), (x, w, b, r))
    out = {"fwd_fused_gb_s": fwd_bytes / t_p / 1e6,
           "fwd_naive_gb_s": fwd_bytes / t_x / 1e6,
           "fwd_speedup": t_x / t_p,
           "bwd_fused_gb_s": bwd_bytes / t_fb / 1e6,
           "bwd_ad_gb_s": bwd_bytes / t_ab / 1e6,
           "bwd_speedup": t_ab / t_fb}
    adjacent = hbm_roof(device=dev)
    out.update(adjacent_hbm_gb_s=adjacent,
               fwd_frac_of_hbm=out["fwd_fused_gb_s"] / adjacent,
               bwd_frac_of_hbm=out["bwd_fused_gb_s"] / adjacent)
    return out
