#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Drives the port only (it imports neither ``jax`` nor ``apex_tpu``).
It covers both ported paths: the serving engine (phases 4-5) and the GPT
training step of ``pretrain_gpt`` (phases 6-7).  Phases, each of which
fails the run (non-zero exit) on error:

1. device — a CUDA card is required; its name and power limit are read
   from ``nvidia-smi``;
2. build — ``apex_tpu_torch/csrc/*.cu`` are compiled with ``nvcc`` (in
   parallel, one process per source);
3. kernels — each kernel against its plain PyTorch version on the card,
   at its main path's shapes (bf16; the training kernels with and without
   dropout) and in fp32, with the tolerance stated; then timed (operands
   cold in L2) beside its plain version, one PyTorch library call
   computing the same function, and its bound;
4. toy engine — the same weights served at toy width in fp32 on the card
   (kernels) and on the CPU (plain versions) give identical greedy
   streams;
5. full-width engine — GPT-1.3B width (hidden 2048, 16 heads of 128, 24
   layers, vocab 51200, bf16, page 64, batch 8): ``warmup()`` then
   ``serve()`` of a seeded Poisson trace; every request finishes, the
   pool drains, the kernels' launch counts match the main path's
   prefills and decode steps exactly, the kernel path's logits agree
   with the plain path's, and batched == sequential at equal
   ``max_batch``; a full-batch decode step's host-enqueue and
   device-done times are reported beside the serve metrics;
6. toy training — ``pretrain_gpt.main`` at fp32, 2 layers, hidden 256,
   from the same weights and batches on the card (kernels) and on the CPU
   (plain versions): per-step losses and final weights agree;
7. full-width training — ``pretrain_gpt.main`` with the GPT-1.3B flags
   (24 layers, hidden 2048, 16 heads of 128, seq 2048, batch 4, bf16,
   default dropouts, clip and decay, remat ``attn_res``): 10 finite
   steps, step 1's loss near ln(vocab) + 0.41 (the init's logit variance
   0.02^2 x 2048, halved), exact launch counts of the four
   training kernels; then on a fixed batch the loss falls over 5 steps,
   one dropout-free step through the kernels agrees with the same step
   through the plain versions, and one step run twice from the same state
   gives bitwise-equal loss and weights; step time, tokens/s, model
   TFLOP/s, peak memory and a step's host-enqueue vs device-done time are
   reported.

The last three lines of standard output are the kernels' JSON record,
the ``nvidia-smi`` name/power line, and ``{"ok": true, "device": ...}``.
fp32 matrix products run in full fp32 (``allow_tf32`` off).
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from apex_tpu_torch import kernels  # noqa: E402
from apex_tpu_torch.examples.gpt import pretrain_gpt  # noqa: E402
from apex_tpu_torch.multi_tensor import multi_tensor_l2norm  # noqa: E402
from apex_tpu_torch.ops import attention as att  # noqa: E402
from apex_tpu_torch.ops import fused_layer_norm as ln  # noqa: E402
from apex_tpu_torch.transformer.testing import gpt_param_count  # noqa: E402
from apex_tpu_torch.serving import model as model_mod  # noqa: E402
from apex_tpu_torch.serving import (ServingEngine, ServingModelConfig,  # noqa: E402
                                    SimClock, init_params, poisson_trace)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and flop/s by
# input type (bf16 on the tensor cores, fp32 on the FMA units)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_TOL = 2.0 ** -7    # x max|ref|: one bf16 ulp at the output's scale
FP32_TOL = 1e-5         # x max(1, max|ref|)

# the serving main path's geometry (GPT-1.3B width, bench.py's serving cell)
FULL = dict(vocab_size=51200, hidden_size=2048, num_heads=16, num_layers=24,
            max_position=1024)
PAGE, BATCH, PAGES_PER_REQ = 64, 8, 5
NUM_PAGES = 1 + BATCH * PAGES_PER_REQ * 3 // 2


def log(msg: str) -> None:
    print(msg, flush=True)


L2_FLUSH_BYTES = 256 * 2 ** 20   # > 5x the H100's 50 MB L2


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn`` with its operands cold in L2,
    as the main path finds them (each layer's weights stream through L2
    between two attention calls).  Before each timed call a 256 MiB buffer
    is written, evicting L2, and the device sleeps ~0.5 ms so the host has
    enqueued the call before its start event fires.  CUDA events around
    each call, after ``warm`` untimed calls."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.mean(s.elapsed_time(e) for s, e in events)


def ptxas_report(text: str) -> list:
    """(function, registers, stack-frame bytes, spill-store bytes) of each
    kernel instance, from ``ptxas -v``'s output."""
    out, fn, stack, spill = [], None, 0, 0
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip()
        elif "bytes spill stores" in line:
            stack = int(line.split("bytes stack frame")[0].split()[-1])
            spill = int(line.split("bytes spill stores")[0].split()[-1])
        elif "Used " in line and " registers" in line and fn:
            out.append((fn, int(line.split("Used ")[1].split()[0]), stack,
                        spill))
            fn, stack, spill = None, 0, 0
    return out


def demangle(name: str) -> str:
    """``flash_decode_kernel<float, 128>`` from its mangled name."""
    try:
        full = subprocess.run(["c++filt", name], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return name
    found = re.search(r"\w+<[^()]*>", full)
    return found.group(0) if found else full.strip()


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tolerance(ref: torch.Tensor) -> float:
    scale = ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        return BF16_TOL * scale
    return FP32_TOL * max(1.0, scale)


def check(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    err = (got.float() - ref.float()).abs().max().item()
    tol = tolerance(ref)
    ok = math.isfinite(err) and err <= tol
    log(f"  {name}: max_abs_diff {err:.3e}  tol {tol:.3e}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol:.3e})")
    return err


# -- phase 3: the kernels against their plain versions ---------------------


def seg_row(s: int, lengths) -> torch.Tensor:
    """One packed row: segments 1..n of the given lengths, 0 = padding."""
    seg = torch.zeros(s, dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[at:at + n] = i + 1
        at += n
    return seg


def prefill_operands(gen, dtype, lengths, b=1, h=16, s=1024, d=128):
    """q/k/v as the prefill hands them in: strided [b, h, s, d] views of
    one fused [b, s, 3*h*d] projection."""
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.view(b, s, h, d).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    return q, k, v, seg_row(s, lengths)[None].cuda()


def flash_fwd_case(gen, name, dtype, lengths):
    q, k, v, seg = prefill_operands(gen, dtype, lengths)
    b, h, s, d = q.shape
    o, lse = att.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    ro, rlse = att._blockwise_fwd(
        q.reshape(b * h, s, d), k.reshape(b * h, s, d),
        v.reshape(b * h, s, d), 1 / math.sqrt(d), True, None, seg, seg)
    torch.cuda.synchronize()
    err = check(f"flash_fwd {name} o", o, ro.view(b, h, s, d))
    lerr = (lse - rlse).abs().max().item()
    log(f"  flash_fwd {name} lse: max_abs_diff {lerr:.3e}  tol 1e-4  "
        f"{'ok' if lerr <= 1e-4 else 'FAIL'}")
    if not lerr <= 1e-4:
        raise AssertionError(f"flash_fwd {name}: lse disagrees ({lerr:.3e})")
    return err, (q, k, v, seg)


def time_flash_fwd(dtype, q, k, v, seg) -> dict:
    b, h, s, d = q.shape
    scale = 1 / math.sqrt(d)
    ms = cuda_ms(lambda: att.flash_attention_fwd(q, k, v, causal=True,
                                                 segment_ids=seg))
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    plain_ms = cuda_ms(lambda: att._blockwise_fwd(qf, kf, vf, scale, True,
                                                  None, seg, seg))
    sid = seg[0]
    visible = (sid[:, None] == sid[None, :]) & torch.ones(
        s, s, dtype=torch.bool, device="cuda").tril()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=visible[None, None]))
    item = q.element_size()
    # q, k, v read once; o written once; lse out; the two seg-id rows in
    nbytes = 4 * b * h * s * d * item + b * h * s * 4 + 2 * s * 4
    flops = 4 * d * b * h * int(visible.sum().item())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    lohi = att._segment_block_bounds(seg, seg, 64, 64)[0]
    n_tiles = int((lohi[..., 1] - lohi[..., 0]).sum())
    log(f"  flash_fwd timing [{b},{h},{s},{d}] {dtype}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); live 64x64 tiles per head "
        f"(segment rule, before the causal cut) {n_tiles}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def decode_operands(gen, dtype, q_len, lengths, b=BATCH, h=16, d=128,
                    page_size=PAGE, p_max=PAGES_PER_REQ):
    n_pages = 1 + b * p_max
    kp = torch.randn(n_pages, page_size, h, d, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn(n_pages, page_size, h, d, generator=gen,
                     device="cuda").to(dtype)
    # shuffled, non-contiguous page ids: the indirection is under test
    free = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).tolist()
    table = torch.zeros(b, p_max, dtype=torch.int32)
    for i, n in enumerate(lengths):
        for p in range(-(-n // page_size)):
            table[i, p] = free.pop()
    qkv = torch.randn(b, q_len, 3 * h * d, generator=gen,
                      device="cuda").to(dtype)
    q = qkv[..., :h * d].view(b, q_len, h, d).transpose(1, 2)
    kv_len = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.cuda(), kv_len


def flash_decode_case(gen, name, dtype, q_len, lengths):
    q, kp, vp, table, kv_len = decode_operands(gen, dtype, q_len, lengths)
    o = att.flash_decode(q, kp, vp, table, kv_len)
    ro = att._paged_attention(q, kp, vp, table, kv_len,
                              1 / math.sqrt(q.shape[-1]))
    torch.cuda.synchronize()
    err = check(f"flash_decode {name}", o, ro)
    for i, n in enumerate(lengths):
        for r in range(q_len):
            if n - q_len + r < 0 and not bool((o[i, :, r] == 0).all()):
                raise AssertionError(
                    f"flash_decode {name}: row {r} of request {i} "
                    f"(kv_len {n} < q_len {q_len}) is not exact zeros")
    return err, (q, kp, vp, table, kv_len)


def time_flash_decode(dtype, q, kp, vp, table, kv_len) -> dict:
    b, h, q_len, d = q.shape
    page_size, p_max = kp.shape[1], table.shape[1]
    ms = cuda_ms(lambda: att.flash_decode(q, kp, vp, table, kv_len), 50)
    plain_ms = cuda_ms(lambda: att._paged_attention(
        q, kp, vp, table, kv_len, 1 / math.sqrt(d)), 50)
    cols = torch.arange(p_max * page_size, device="cuda")
    rows = torch.arange(q_len, device="cuda")[:, None]
    visible = cols <= (kv_len.long() - q_len)[:, None, None, None] + rows

    def library():
        idx = table.long()
        kc = kp[idx].reshape(b, -1, h, d).transpose(1, 2)
        vc = vp[idx].reshape(b, -1, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=visible)

    lib_ms = cuda_ms(library, 50)
    item = q.element_size()
    reach = p_max * page_size
    live_cols = sum(min(int(n), reach) for n in kv_len.tolist())
    seen = sum(max(0, min(int(n) - q_len + r + 1, reach))
               for n in kv_len.tolist() for r in range(q_len))
    # live K/V pages' rows read once, q in, o out, table and lengths in
    nbytes = (2 * live_cols * h * d * item + 2 * b * h * q_len * d * item
              + table.numel() * 4 + b * 4)
    flops = 4 * d * h * seen
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log(f"  flash_decode timing [{b},{h},{q_len},{d}] {dtype} kv_len "
        f"{kv_len.tolist()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"gather+sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# the training main path's attention and LayerNorm shapes (GPT-1.3B,
# pretrain_gpt at micro-batch 4, seq 2048)
TRAIN = dict(b=4, s=2048, heads=16, d=128, hidden=2048)
ATT_DROPOUT = 0.1            # arguments.py's default, on the main path
LSE_TOL = 1e-4               # absolute, fp32 log-sum-exp near 8
RATE_SEED = 1234


def check_lse(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    err = (got - ref).abs().max().item()
    ok = err <= LSE_TOL
    log(f"  {name}: max_abs_diff {err:.3e}  tol {LSE_TOL:.0e}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees ({err:.3e})")


def qkv_operands(gen, dtype, b=TRAIN["b"], s=TRAIN["s"]):
    h, d = TRAIN["heads"], TRAIN["d"]
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    dctx = torch.randn(b, s, h * d, generator=gen, device="cuda").to(dtype)
    return qkv, dctx


def flash_qkv_case(gen, name, dtype, rate, b=TRAIN["b"], s=TRAIN["s"],
                   seg=None):
    """K3 and K4 against their plain versions; returns (K3 error, K4
    error, operands)."""
    qkv, dctx = qkv_operands(gen, dtype, b, s)
    h = TRAIN["heads"]
    args = (seg, seg, h, TRAIN["d"] ** -0.5, True, rate, RATE_SEED)
    ctx, lse = att._flash_qkv_fwd_cuda(qkv, *args)
    rctx, rlse = att._flash_qkv_fwd_plain(qkv, *args)
    torch.cuda.synchronize()
    e3 = check(f"flash_qkv_fwd {name} ctx", ctx, rctx)
    check_lse(f"flash_qkv_fwd {name} lse", lse, rlse)
    del rctx, rlse
    dqkv = att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse, *args)
    rdqkv = att._flash_qkv_bwd_plain(qkv, dctx, ctx, lse, *args)
    torch.cuda.synchronize()
    e4 = check(f"flash_qkv_bwd {name} dqkv", dqkv, rdqkv)
    del rdqkv
    torch.cuda.empty_cache()
    return e3, e4, (qkv, dctx, ctx, lse)


def time_flash_qkv(qkv, dctx, ctx, lse, rate) -> tuple:
    b, s, _ = qkv.shape
    h, d = TRAIN["heads"], TRAIN["d"]
    args = (None, None, h, d ** -0.5, True, rate, RATE_SEED)
    fwd_ms = cuda_ms(lambda: att._flash_qkv_fwd_cuda(qkv, *args), 10)
    fwd_plain = cuda_ms(lambda: att._flash_qkv_fwd_plain(qkv, *args), 5, 1)
    bwd_ms = cuda_ms(lambda: att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse,
                                                     *args), 10)
    bwd_plain = cuda_ms(lambda: att._flash_qkv_bwd_plain(
        qkv, dctx, ctx, lse, *args), 5, 1)
    # the library yardstick: SDPA on the same strided per-head views
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(b, s, h, 3, d).permute(3, 0, 2, 1, 4))
    fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=rate, is_causal=True), 10)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=rate,
                                         is_causal=True)
    dout = dctx.view(b, s, h, d).transpose(1, 2)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        out, (q, k, v), dout, retain_graph=True), 10)
    item = qkv.element_size()
    pairs = b * h * s * (s + 1) // 2          # visible causal pairs
    fwd_bytes = b * s * 4 * h * d * item + b * h * s * 4  # qkv, ctx, lse
    bwd_bytes = (b * s * 3 * h * d * item * 2          # qkv in, dqkv out
                 + b * s * h * d * item * 2 + b * h * s * 4)  # dctx, ctx, lse
    fb, fby = bound(fwd_bytes, 4 * d * pairs, qkv.dtype)
    bb, bby = bound(bwd_bytes, 10 * d * pairs, qkv.dtype)
    log(f"  flash_qkv timing [{b},{s},{h}x3x{d}] {qkv.dtype} dropout {rate}:"
        f" fwd kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f}, sdpa "
        f"{fwd_lib:.4f}, bound {fb:.4f} ({fby}); bwd kernel {bwd_ms:.4f} ms, "
        f"plain {bwd_plain:.4f}, sdpa backward {bwd_lib:.4f}, bound "
        f"{bb:.4f} ({bby})")
    return (dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
                 bound_ms=fb, bound_by=fby),
            dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
                 bound_ms=bb, bound_by=bby))


def layer_norm_case(gen, name, dtype, rows=TRAIN["b"] * TRAIN["s"],
                    cols=TRAIN["hidden"]):
    """K6 and K7 against their plain versions (fp32 weights, as the
    main path's masters are)."""
    x = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(cols, generator=gen, device="cuda")
    b = 0.1 * torch.randn(cols, generator=gen, device="cuda")
    y, mean, invvar = ln._ln_fwd_cuda(x, w, b, 1e-5)
    ry, rmean, rinvvar = ln._ln_fwd_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    e6 = check(f"layer_norm_fwd {name} y", y, ry)
    check(f"layer_norm_fwd {name} mean", mean, rmean)
    check(f"layer_norm_fwd {name} invvar", invvar, rinvvar)
    dx, dw, db = ln._ln_bwd_cuda(x, dy, mean, invvar, w, True)
    rdx, rdw, rdb = ln._ln_bwd_plain(x, dy, mean, invvar, w, True)
    torch.cuda.synchronize()
    e7 = check(f"layer_norm_bwd {name} dx", dx, rdx)
    check(f"layer_norm_bwd {name} dweight", dw, rdw)
    check(f"layer_norm_bwd {name} dbias", db, rdb)
    return e6, e7, (x, dy, w, b, mean, invvar)


def time_layer_norm(x, dy, w, b, mean, invvar) -> tuple:
    rows, cols = x.shape
    fwd_ms = cuda_ms(lambda: ln._ln_fwd_cuda(x, w, b, 1e-5), 50)
    fwd_plain = cuda_ms(lambda: ln._ln_fwd_plain(x, w, b, 1e-5), 20)
    bwd_ms = cuda_ms(lambda: ln._ln_bwd_cuda(x, dy, mean, invvar, w, True),
                     50)
    bwd_plain = cuda_ms(lambda: ln._ln_bwd_plain(x, dy, mean, invvar, w,
                                                 True), 20)
    # the library yardstick in x's dtype throughout (F.layer_norm wants
    # one dtype), forward and its autograd backward
    xl = x.detach().requires_grad_()
    wl, bl = (t.to(x.dtype).requires_grad_() for t in (w, b))
    fwd_lib = cuda_ms(lambda: F.layer_norm(xl, (cols,), wl, bl), 50)
    yl = F.layer_norm(xl, (cols,), wl, bl)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        yl, (xl, wl, bl), dy, retain_graph=True), 50)
    item = x.element_size()
    # x in, y out, w and b in, mean and invvar out; ~7 fp32 ops an element
    fb, fby = bound(2 * rows * cols * item + 2 * cols * 4 + 2 * rows * 4,
                    7 * rows * cols, torch.float32)
    # x, dy in, dx out, w in, dw and db out, mean and invvar in
    bb, bby = bound(3 * rows * cols * item + 3 * cols * 4 + 2 * rows * 4,
                    12 * rows * cols, torch.float32)
    log(f"  layer_norm timing [{rows},{cols}] {x.dtype} (fp32 w): fwd kernel"
        f" {fwd_ms:.4f} ms, plain {fwd_plain:.4f}, F.layer_norm "
        f"{fwd_lib:.4f}, bound {fb:.4f} ({fby}); bwd kernel {bwd_ms:.4f} ms,"
        f" plain {bwd_plain:.4f}, F.layer_norm backward {bwd_lib:.4f}, bound"
        f" {bb:.4f} ({bby})")
    return (dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
                 bound_ms=fb, bound_by=fby),
            dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
                 bound_ms=bb, bound_by=bby))


def phase_training_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    flash_qkv_case(gen, "bf16 causal, no dropout", bf16, 0.0)
    e3, e4, ops = flash_qkv_case(gen, f"bf16 causal, dropout {ATT_DROPOUT}",
                                 bf16, ATT_DROPOUT)
    flash_qkv_case(gen, f"fp32 causal, dropout {ATT_DROPOUT}, b=1", fp32,
                   ATT_DROPOUT, b=1)
    seg = torch.stack([seg_row(512, [200, 250]), seg_row(512, [512])]).cuda()
    flash_qkv_case(gen, "bf16 causal + segment ids, dropout, b=2 s=512",
                   bf16, ATT_DROPOUT, b=2, s=512, seg=seg)
    fwd, bwd = time_flash_qkv(*ops, ATT_DROPOUT)
    del ops
    torch.cuda.empty_cache()
    e6, e7, lops = layer_norm_case(gen, "bf16 x", bf16)
    layer_norm_case(gen, "fp32 x", fp32)
    lfwd, lbwd = time_layer_norm(*lops)
    fwd["max_abs_err"], bwd["max_abs_err"] = e3, e4
    lfwd["max_abs_err"], lbwd["max_abs_err"] = e6, e7
    return {"flash_qkv_fwd": fwd, "flash_qkv_bwd": bwd,
            "layer_norm_fwd": lfwd, "layer_norm_bwd": lbwd}


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    err_fwd, fwd_ops = flash_fwd_case(gen, "bf16 one segment C=700 + pad",
                                      bf16, [700])
    flash_fwd_case(gen, "bf16 three segments", bf16, [300, 400, 200])
    flash_fwd_case(gen, "fp32 one segment C=700 + pad", fp32, [700])
    ragged = [1, 2, 63, 64, 65, 200, 320, 3]
    err_dec, dec_ops = flash_decode_case(gen, "bf16 q_len=1", bf16, 1, ragged)
    flash_decode_case(gen, "bf16 q_len=5 (kv_len < q_len rows)", bf16, 5,
                      ragged)
    flash_decode_case(gen, "bf16 q_len=20 (two row blocks)", bf16, 20,
                      ragged)
    flash_decode_case(gen, "fp32 q_len=1", fp32, 1, ragged)
    fwd = time_flash_fwd(bf16, *fwd_ops)
    dec = time_flash_decode(bf16, *dec_ops)
    # a full decode batch as the main path sees it mid-trace
    time_flash_decode(bf16, *decode_operands(gen, bf16, 1, [300] * BATCH))
    fwd["max_abs_err"], dec["max_abs_err"] = err_fwd, err_dec
    return {"flash_fwd": fwd, "flash_decode": dec, **phase_training_kernels()}


# -- phase 4: toy width, cuda vs cpu ---------------------------------------


def phase_toy() -> None:
    cfg = ServingModelConfig(vocab_size=64, hidden_size=32, num_heads=4,
                             num_layers=2, max_position=96)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = [[int(x) for x in np.random.RandomState(100 + i).randint(
        0, cfg.vocab_size, 5 + 3 * i)] for i in range(4)]

    def streams(device):
        eng = ServingEngine(cfg, params, num_pages=64, page_size=8,
                            max_batch=4, prefill_budget=cfg.max_position,
                            clock=SimClock(), device=device)
        reqs = [eng.submit(p, 12) for p in prompts]
        eng.run()
        return [list(r.generated) for r in reqs]

    on_card, on_cpu = streams("cuda"), streams("cpu")
    log(f"  toy fp32 streams, cuda (kernels): {on_card}")
    log(f"  toy fp32 streams, cpu (plain):    {on_cpu}")
    if on_card != on_cpu:
        raise AssertionError("toy engine: cuda and cpu streams differ")


# -- phase 5: the full-width engine ----------------------------------------


def full_engine(params, cfg, max_batch=BATCH) -> ServingEngine:
    return ServingEngine(cfg, params, num_pages=NUM_PAGES, page_size=PAGE,
                         max_batch=max_batch,
                         max_pages_per_request=PAGES_PER_REQ,
                         prefill_budget=cfg.max_position, device="cuda")


def trace(seed, n):
    # bench.py's serving trace shape at max_position 1024
    return poisson_trace(seed, n, rate=8.0, prompt_len=(64, 256),
                         max_new=(16, 64), vocab_size=FULL["vocab_size"])


def plain_attention():
    """The decoder with its two kernels swapped for their plain versions
    (the reference the kernel path's logits are held against)."""
    def fa(q, k, v, *, causal, segment_ids):
        b, h, s, d = q.shape
        o, _ = att._blockwise_fwd(q.reshape(b * h, s, d),
                                  k.reshape(b * h, s, d),
                                  v.reshape(b * h, s, d), 1 / math.sqrt(d),
                                  causal, None, segment_ids, segment_ids)
        return o.view(b, h, s, d)

    def fd(q, k_pages, v_pages, page_table, kv_len):
        return att._paged_attention(q, k_pages, v_pages, page_table, kv_len,
                                    1 / math.sqrt(q.shape[-1]))

    return mock.patch.multiple(model_mod, flash_attention=fa,
                               flash_decode=fd)


@torch.no_grad()
def logits_check(eng: ServingEngine, prompt) -> float:
    """Last-position prefill logits of ``prompt``, kernel path vs plain
    path, same weights.  bf16 rounds at every layer, so the bar is a few
    bf16 ulps of the logit scale (8 x 2^-8 x max|ref|), not one."""
    S, C = eng.prefill_budget, len(prompt)
    host = np.zeros((3, S), np.int32)
    host[0, :C], host[1, :C], host[2, :C] = prompt, 1, np.arange(C)
    dev = torch.from_numpy(host).cuda()
    got, _, _ = eng.decoder.prefill(eng.params, dev[0:1], dev[1:2],
                                    dev[2:3], C - 1)
    with plain_attention():
        ref, _, _ = eng.decoder.prefill(eng.params, dev[0:1], dev[1:2],
                                        dev[2:3], C - 1)
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()) or got.shape != (
            1, 1, FULL["vocab_size"]):
        raise AssertionError(f"prefill logits: shape {tuple(got.shape)} or "
                             "non-finite values")
    err = (got - ref).abs().max().item()
    tol = 8 * 2.0 ** -8 * ref.abs().max().item()
    log(f"  full-width prefill logits, kernels vs plain: max_abs_diff "
        f"{err:.3e}  tol {tol:.3e}  (logit scale {ref.abs().max().item():.3f},"
        f" argmax {int(got.argmax())} vs {int(ref.argmax())})")
    if not err <= tol:
        raise AssertionError("full-width logits: kernel path disagrees")
    return err


@torch.no_grad()
def decode_step_split(eng: ServingEngine, steps: int = 20) -> dict:
    """A full-batch decode step (every row at kv_len 256, its own 5
    pages) timed two ways: until the host has enqueued it, and until the
    device has finished it.  When the two are close the host, not the
    device, sets the step time.  Medians over ``steps`` steps; the pool
    is drained, so the writes land in free pages."""
    b, p_max = eng.max_batch, eng.cache.max_pages_per_request
    host = np.zeros(3 * b + b * p_max, np.int32)
    host[b:2 * b], host[2 * b:3 * b] = 255, 256      # positions, kv_len
    host[3 * b:] = 1 + np.arange(b * p_max)         # distinct pages
    dev = torch.from_numpy(host).cuda()
    args = (eng.params, eng.cache.k, eng.cache.v, dev[:b], dev[b:2 * b],
            dev[3 * b:].view(b, p_max), dev[2 * b:3 * b])
    eng.decoder.decode(*args)
    torch.cuda.synchronize()
    enqueue, done = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.decoder.decode(*args)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    split = {"decode_enqueue_ms_p50": statistics.median(enqueue),
             "decode_done_ms_p50": statistics.median(done)}
    log(f"  full-batch decode step: host enqueue "
        f"{split['decode_enqueue_ms_p50']:.3f} ms, device done "
        f"{split['decode_done_ms_p50']:.3f} ms (medians of {steps})")
    return split


def phase_full(smi: str) -> dict:
    cfg = ServingModelConfig(**FULL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    eng = full_engine(params, cfg)
    reqs = trace(0, 16)

    kernels.reset_launch_counts()
    warm_s = eng.warmup()
    t0 = time.perf_counter()
    finished = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}

    if len(finished) != len(reqs) or any(
            r.finish_reason != "length" or len(r.generated) != r.max_new_tokens
            for r in finished):
        raise AssertionError("full-width serve: not every request finished")
    if eng.cache.pages_used != 0:
        raise AssertionError(f"pool not drained: {eng.cache.pages_used} used")
    prefills = sum(1 + r.preemptions for r in finished)
    want = {"flash_fwd": cfg.num_layers * (prefills + 1),
            "flash_decode": cfg.num_layers * (eng.decode_steps + 1)}
    log(f"  launches {launches}, expected {want} ({prefills} prefills + "
        f"warmup, {eng.decode_steps} decode steps + warmup)")
    if launches != want:
        raise AssertionError("launch counts do not match the main path")
    tokens = sum(len(r.generated) for r in finished)
    ttft = [(r.first_token_t - r.arrival_t) * 1e3 for r in finished]
    tpot = [(r.finish_t - r.first_token_t) / (len(r.generated) - 1) * 1e3
            for r in finished if len(r.generated) > 1]
    metrics = {"requests": len(finished), "tokens": tokens,
               "wall_s": wall, "tok_per_s": tokens / wall,
               "ttft_p50_ms": statistics.median(ttft),
               "tpot_p50_ms": statistics.median(tpot),
               "warmup_s": warm_s, "decode_steps": eng.decode_steps,
               "prefills": prefills,
               "preemptions": sum(r.preemptions for r in finished),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "card": smi}
    log("  serve " + json.dumps(metrics))
    logits_check(eng, reqs[0].prompt)
    metrics.update(decode_step_split(eng))
    del eng
    torch.cuda.empty_cache()

    # batched == sequential at equal max_batch (and, recorded only, at
    # max_batch 1, where every GEMM has another shape)
    def stream_sets():
        together = full_engine(params, cfg)
        handles = [together.submit(r.prompt, r.max_new_tokens)
                   for r in trace(1, 3)]
        together.run()
        out = {"together": [h.generated for h in handles]}
        del together
        one = full_engine(params, cfg)
        out["one_at_a_time"] = []
        for r in trace(1, 3):
            h = one.submit(r.prompt, r.max_new_tokens)
            one.run()
            out["one_at_a_time"].append(h.generated)
        del one
        batch1 = full_engine(params, cfg, max_batch=1)
        handles = [batch1.submit(r.prompt, r.max_new_tokens)
                   for r in trace(1, 3)]
        batch1.run()
        out["max_batch_1"] = [h.generated for h in handles]
        return out

    s = stream_sets()
    same = s["together"] == s["one_at_a_time"]
    same_b1 = s["together"] == s["max_batch_1"]
    log(f"  batched == sequential at max_batch {BATCH}: {same}; "
        f"max_batch {BATCH} == max_batch 1: {same_b1} (recorded, not "
        f"required)")
    if not same:
        raise AssertionError("batched and sequential streams differ")
    metrics.update(launches=launches, batched_eq_sequential=same,
                   batch8_eq_batch1=same_b1)
    return metrics


# -- phase 6: toy training, cuda vs cpu -------------------------------------

TOY_TRAIN = ["--num-layers", "2", "--hidden-size", "256",
             "--num-attention-heads", "2", "--seq-length", "128",
             "--max-position-embeddings", "128", "--micro-batch-size", "2",
             "--vocab-size", "256", "--attention-dropout", "0",
             "--hidden-dropout", "0", "--train-iters", "5",
             "--log-interval", "5"]
TOY_LOSS_TOL = 1e-5     # x |loss|: fp32 throughout, sums in another order
# final weights, card vs CPU, absolute: ten times the largest gap measured
# on an H100 (9.6e-6); five Adam steps at lr 1.5e-4 move a weight by up to
# 7.5e-4, so a card path that skipped an update would fail it
TOY_WEIGHT_TOL = 1e-4


def toy_run(device, state, batches):
    losses, final = [], {}

    def record(it, loss, model):
        losses.append(float(loss))
        final.update({k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()})

    pretrain_gpt.main(TOY_TRAIN, device=device, state_dict=state,
                      batches=batches, on_step=record)
    return losses, final


def phase_toy_training() -> dict:
    args, model, _ = pretrain_gpt.setup(TOY_TRAIN, "cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    batches = [b for b, _ in zip(pretrain_gpt.synthetic_batches(args, gen),
                                 range(5))]
    on_card, w_card = toy_run("cuda", state, batches)
    on_cpu, w_cpu = toy_run("cpu", state, batches)
    log(f"  toy fp32 losses, cuda (kernels): {on_card}")
    log(f"  toy fp32 losses, cpu (plain):    {on_cpu}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
    w_err = max((w_card[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
    w_mean = statistics.mean((w_card[k] - w_cpu[k]).abs().mean().item()
                             for k in w_cpu)
    moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
    log(f"  toy training: loss rel diff {loss_err:.3e} (tol "
        f"{TOY_LOSS_TOL:.0e}); final weights max diff {w_err:.3e} (tol "
        f"{TOY_WEIGHT_TOL:.0e}), mean over tensors of the mean diff "
        f"{w_mean:.3e}; the largest update on the CPU {moved:.3e}")
    if not (loss_err <= TOY_LOSS_TOL and w_err <= TOY_WEIGHT_TOL
            and moved > 2 * TOY_WEIGHT_TOL):
        raise AssertionError("toy training: card and CPU disagree")
    return {"toy_loss_rel_diff": loss_err, "toy_weight_max_diff": w_err}


# -- phase 7: full-width training (GPT-1.3B) --------------------------------

FULL_TRAIN = ["--num-layers", "24", "--hidden-size", "2048",
              "--num-attention-heads", "16", "--seq-length", "2048",
              "--max-position-embeddings", "2048", "--micro-batch-size", "4",
              "--bf16"]
STEP_LOSS_TOL = 0.3          # step 1 within this of its expected value
# kernel vs plain step: bf16 activations at 24 layers, the kernels' and
# the plain versions' fp32 sums in other orders flip a bf16 rounding now
# and then; each bar is ten times the largest gap measured on an H100
PLAIN_LOSS_TOL = 1.5e-3      # absolute, on a loss near 8-11 (read 1.5e-4)
PLAIN_NORM_TOL = 5e-4        # relative, global grad norm (read 4.9e-5)
# relative, |g - g_plain| / |g_plain| on the worst leaf (read 4.6e-3, on
# the last layer's dense_h_to_4h weight; the median leaf reads 1.3e-3)
PLAIN_LEAF_TOL = 5e-2

# kernel-name fragments -> the part of the step they belong to
STEP_KINDS = (("flash_fwd_kernel", "K3 flash_qkv_fwd"),
              ("dkdv_kernel", "K4 flash_qkv_bwd"),
              ("dq_kernel", "K4 flash_qkv_bwd"),
              ("delta_kernel", "K4 flash_qkv_bwd"),
              ("ln_fwd_kernel", "K6 layer_norm_fwd"),
              ("ln_bwd", "K7 layer_norm_bwd"),
              ("gemm", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
              ("nvjet", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"),
              ("foreach", "optimizer + clip (foreach)"),
              ("multi_tensor", "optimizer + clip (foreach)"))


def plain_kernels():
    """The training step with its four kernels swapped for their plain
    versions, on the card (the reference of the kernel-vs-plain check)."""
    return mock.patch.multiple(
        att, _flash_qkv_fwd_cuda=att._flash_qkv_fwd_plain,
        _flash_qkv_bwd_cuda=att._flash_qkv_bwd_plain), mock.patch.multiple(
        ln, _ln_fwd_cuda=ln._ln_fwd_plain, _ln_bwd_cuda=ln._ln_bwd_plain)


def step_profile(step) -> dict:
    """Device time of one call of ``step`` by part, from a
    ``torch.profiler`` trace (CUPTI): kernel durations summed by kind and
    the ten longest kernels by name; the device's busy time is the union
    of the kernels' intervals, and its idle share is the rest of the
    step's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds, names, spans = {}, {}, []
    for e in prof.events():
        # kernels, copies and sets only: the GPU-side ranges of user
        # annotations (Optimizer.step#...) overlap the kernels they cover
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        kind = next((k for frag, k in STEP_KINDS if frag in e.name.lower()),
                    "other elementwise, copies, reductions")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        n, t = names.get(e.name[:60], (0, 0.0))
        names[e.name[:60]] = (n + 1, t + ms)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels": [(k, n, t) for k, (n, t) in top]}


def loss_and_grads(model, tokens, labels):
    loss = model(tokens, labels=labels).mean()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach().item(), grads


def phase_full_training(smi: str) -> dict:
    L = 24
    want = {"flash_qkv_fwd": L, "flash_qkv_bwd": L,
            "layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1}
    steps, losses, times = 10, [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_last = [time.perf_counter()]

    def record(it, loss, model):
        losses.append(float(loss))      # synchronises: the step is done
        now = time.perf_counter()
        times.append((now - t_last[0]) * 1e3)
        t_last[0] = now

    kernels.reset_launch_counts()
    pretrain_gpt.main(FULL_TRAIN + ["--train-iters", str(steps),
                                    "--log-interval", "5"],
                      device="cuda", on_step=record)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    per_step = {k: v / steps for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # at init the logits are h . w_emb with h the final LayerNorm's output
    # (unit variance) and w_emb ~ N(0, 0.02^2): Gaussian logits of variance
    # v = 0.02^2 x 2048, whose cross-entropy on random labels averages
    # ln(vocab) + v / 2 = 10.843 + 0.410
    expect = math.log(51200) + 0.02 ** 2 * 2048 / 2
    log(f"  losses {losses}")
    log(f"  launches over {steps} steps {launches}; per step {per_step}, "
        f"expected {want} (remat attn_res: K3 L, K4 L, K6 4L+1, K7 2L+1)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("full-width training: non-finite loss")
    if abs(losses[0] - expect) > STEP_LOSS_TOL:
        raise AssertionError(f"step 1 loss {losses[0]} is not within "
                             f"{STEP_LOSS_TOL} of ln(51200) + 0.02^2 x 2048 "
                             f"/ 2 = {expect:.3f}")
    if per_step != want:
        raise AssertionError("training launch counts do not match the "
                             "main path")
    step_ms = statistics.median(times[1:])
    args, model, opt = pretrain_gpt.setup(FULL_TRAIN, "cuda")
    n_params = gpt_param_count(model.cfg)
    b, s, h = 4, 2048, 2048
    tokens_per_step = b * s
    # model flops: 6 N T for the GEMMs, plus the causal attention's two
    # products (QK^T, PV) forward and backward, 6 b s^2 h L; no recompute
    flops = 6 * n_params * tokens_per_step + 6 * b * s * s * h * L
    metrics = {"train_step_ms_p50": step_ms,
               "train_tok_per_s": tokens_per_step / step_ms * 1e3,
               "model_tflops": flops / step_ms / 1e9,
               "peak_mem_gib": peak, "params": n_params,
               "step1_loss": losses[0], "launches_per_step": per_step,
               "card": smi}
    log("  train " + json.dumps(metrics))

    # fixed batch: the loss falls; then a step's enqueue vs done time
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens, labels = next(pretrain_gpt.synthetic_batches(args, gen))
    fixed = [float(pretrain_gpt.train_step(args, model, opt, tokens, labels,
                                           it)) for it in range(5)]
    log(f"  fixed-batch losses {fixed}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError("full-width training: the loss does not fall "
                             "on a fixed batch")
    enqueue, done = [], []
    for it in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pretrain_gpt.train_step(args, model, opt, tokens, labels, 5 + it)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    metrics.update(step_enqueue_ms=statistics.median(enqueue),
                   step_done_ms=statistics.median(done))
    log(f"  one step: host enqueue {metrics['step_enqueue_ms']:.1f} ms, "
        f"device done {metrics['step_done_ms']:.1f} ms (medians of 3)")
    prof = step_profile(lambda: pretrain_gpt.train_step(
        args, model, opt, tokens, labels, 8))
    metrics["step_profile"] = prof
    if prof["device_busy_ms"] > 0:
        log("  one step under torch.profiler: " + ", ".join(
            f"{k} {v:.1f} ms ({v / prof['wall_ms']:.1%})"
            for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
        for name, n, t in prof["top_kernels"]:
            log(f"    {t:8.1f} ms  x{n:<5d} {name}")
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(breakdown not measured)")

    # kernels vs plain versions, one dropout-free step from the same weights
    loss, grads = loss_and_grads(model, tokens, labels)
    patches = plain_kernels()
    with patches[0], patches[1]:
        ref_loss, ref_grads = loss_and_grads(model, tokens, labels)
    norm = multi_tensor_l2norm(list(grads.values())).item()
    ref_norm = multi_tensor_l2norm(list(ref_grads.values())).item()
    dl, dn = abs(loss - ref_loss), abs(norm - ref_norm) / ref_norm
    leaf = {n: ((grads[n] - g).norm() / g.norm()).item()
            for n, g in ref_grads.items()}
    worst = max(leaf, key=leaf.get)
    log(f"  dropout-free step, kernels vs plain: loss {loss:.6f} vs "
        f"{ref_loss:.6f} (diff {dl:.3e}, tol {PLAIN_LOSS_TOL:.1e}); grad "
        f"norm {norm:.6f} vs {ref_norm:.6f} (rel diff {dn:.3e}, tol "
        f"{PLAIN_NORM_TOL:.0e}); worst leaf {worst} |g - g_plain| / "
        f"|g_plain| {leaf[worst]:.3e} (tol {PLAIN_LEAF_TOL:.0e}), median "
        f"over {len(leaf)} leaves {statistics.median(leaf.values()):.3e}")
    if not (dl <= PLAIN_LOSS_TOL and dn <= PLAIN_NORM_TOL
            and leaf[worst] <= PLAIN_LEAF_TOL):
        raise AssertionError("full-width step: kernel path disagrees with "
                             "the plain path")
    del model, opt, grads, ref_grads
    torch.cuda.empty_cache()

    # determinism: the same step (dropout on) twice from the same state
    def one_step():
        a, m, o = pretrain_gpt.setup(FULL_TRAIN, "cuda")
        loss = pretrain_gpt.train_step(a, m, o, tokens, labels, 0)
        return float(loss), [p.detach().clone() for p in m.parameters()]

    loss1, w1 = one_step()
    torch.cuda.empty_cache()
    loss2, w2 = one_step()
    same = loss1 == loss2 and all(torch.equal(x, y) for x, y in zip(w1, w2))
    log(f"  same step twice from the same state (dropout on): losses "
        f"{loss1!r} / {loss2!r}, weights bitwise equal: {same}")
    if not same:
        raise AssertionError("full-width step is not deterministic")
    metrics.update(kernel_vs_plain_loss_diff=dl,
                   kernel_vs_plain_grad_norm_rel_diff=dn,
                   kernel_vs_plain_worst_leaf_rel_diff=leaf[worst],
                   deterministic=same,
                   launches={k: v for k, v in launches.items()})
    return metrics


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    log("phase 2 build")
    build_s = kernels.build_all()
    for src, text in sorted(kernels.build_log.items()):
        report = ptxas_report(text)
        regs = [r for _, r, _, _ in report]
        log(f"  {src}: {len(report)} kernel instances, registers "
            f"{min(regs)}..{max(regs)}")
        for fn, r, stack, spill in report:
            if stack or spill:
                log(f"    {demangle(fn)}: {r} registers, {stack} bytes stack "
                    f"frame, {spill} bytes spill stores")
    log(f"  build {build_s:.1f} s")

    log("phase 3 kernels vs plain versions on the card")
    timings = phase_kernels()

    log("phase 4 toy engine, cuda vs cpu")
    phase_toy()

    log("phase 5 full-width engine (GPT-1.3B width, 24 layers, bf16)")
    metrics = phase_full(smi)
    torch.cuda.empty_cache()

    log("phase 6 toy training, cuda vs cpu")
    phase_toy_training()

    log("phase 7 full-width training (GPT-1.3B, 24 layers, bf16, batch 4 "
        "x 2048)")
    train = phase_full_training(smi)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd.cu",
             replaces="apex_tpu/ops/attention.py:738",
             launches=metrics["launches"]["flash_fwd"],
             **timings["flash_fwd"]),
        dict(name="flash_decode", route="cuda",
             source="apex_tpu_torch/csrc/flash_decode.cu",
             replaces="apex_tpu/ops/attention.py:2239",
             launches=metrics["launches"]["flash_decode"],
             **timings["flash_decode"]),
    ] + [
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=train["launches"][name],
             **timings[name])
        for name, src, where in (
            ("flash_qkv_fwd", "flash_qkv_fwd.cu",
             "apex_tpu/ops/attention.py:1766"),
            ("flash_qkv_bwd", "flash_qkv_bwd.cu",
             "apex_tpu/ops/attention.py:1800"),
            ("layer_norm_fwd", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:75"),
            ("layer_norm_bwd", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:150"))
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
