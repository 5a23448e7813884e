#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Drives the port only (it imports neither ``jax`` nor ``apex_tpu``).
It covers the five ported paths: the serving engine (phases 4-5), the GPT
training step of ``pretrain_gpt`` (phases 6-7), the contrib multi-head
attention training path (phases 8-9), GPT training on the flat
superblock with ``FlatFusedAdam`` (phases 10-11) and the kernel
microbenches with their HBM roof and attention dot floor (phase 12).
Phases, each of which fails the run (non-zero exit) on error:

1. device — a CUDA card is required; its name and power limit are read
   from ``nvidia-smi``;
2. build — ``apex_tpu_torch/csrc/*.cu`` are compiled with ``nvcc`` (in
   parallel, one process per source);
3. kernels — each kernel against its plain PyTorch version on the card,
   at its main path's shapes (bf16; the training kernels with and without
   dropout) and in fp32, with the tolerance stated; then timed (operands
   cold in L2) beside its plain version, one PyTorch library call
   computing the same function, and its bound.  The generic attention
   kernels (K1 with its additive mask, dropout and head dim 64; K2) are
   checked at the multi-head attention path's three shapes, with each
   feature alone and combined at head dims 8, 64 and 128 in both dtypes,
   a zero-stride mask against the same mask materialised, K2 run twice
   (bitwise), the tiles K2 walks against the plain statement of its skip
   rule, and ``flash_attention_varlen`` on a BERT-large-shaped packed
   batch.  K8 (``flat_adam``) runs over the GPT-1.3B superblock (its init
   weights) and must give its plain version's bits for p, m and v over 3
   steps in four variants (AdamW decay 0.01, L2 decay 0.05, decay 0, no
   bias correction); a ``plan_buckets`` walk and a hand-built 3-span walk
   must give the single launch's bits; a step must run under
   ``set_sync_debug_mode("error")``; padding of a ragged superblock stays
   exactly 0; it is timed beside ``torch._fused_adamw_``;
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
   reported;
8. toy multi-head attention — the encoder-decoder stack of
   ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` at toy width (4 heads
   of 8), fp32, five ``FusedAdam`` steps from the same weights on the card
   and on the CPU: losses and final weights agree, and the weights moved;
9. full-width multi-head attention — the same stack at Transformer-big
   width (d_model 1024, 16 heads of 64, 6 encoder and 6 decoder layers,
   dropout 0.1, bias, pre-norm), 32 sentence pairs padded to 256 / 192,
   bf16 with fp32 masters, MSE against a fixed target, ``FusedAdam``:
   exact launch counts (K1 = K2 = K6 = K7 = 18 a step), the loss falls
   over 5 steps, a dropout-free step through the kernels agrees with the
   plain path, a step run twice is bitwise equal; step time, tokens/s,
   peak memory and a step's device time by part are reported;
10. toy flat training — phase 6's toy GPT on the superblock
    (``SuperblockTrainer``: weights and grads are views of two flat fp32
    buffers, the step is ``FlatFusedAdam``), five steps from the same
    weights and batches on the card (K8) and on the CPU (plain): losses
    and final weights within phase 6's bars, and the weights moved;
11. full-width flat training — phase 7's GPT-1.3B on the superblock: five
    finite steps on a fixed batch with a falling loss, exact launch counts
    (K3/K4/K6/K7 as in phase 7, K8 once a step), every weight and grad
    still a view of the flat buffers; from one shared state a step run
    twice is bitwise equal, the ``plan_buckets`` walk gives the single
    launch's bits, and the tree ``FusedAdam`` step agrees within
    ``FLAT_TREE_TOL``; step time, tokens/s, peak memory and the
    optimizer's device time (K8 + clip) are reported beside phase 7's.

12. roofs and floors — K9 (``hbm_copy``) bit for bit against its plain
    version at the HBM roof's 16384 x 8192 fp32 and at a ragged bf16
    length, and a misaligned destination refused; K10
    (``attention_dots``) within ``tolerance`` of its plain version and bitwise across two runs at
    bench.py's (128, 1024, 64, blocks 512), GPT-1.3B's (64, 2048, 128,
    blocks 64) and Transformer-big's encoder (512, 256, 64, blocks 64)
    shapes; the count of ``HMMA`` instructions in K10's SASS
    (``cuobjdump``), which must not be 0; K1/K2 and K6/K7 against their
    plain versions at the microbenches' shapes.  Then the main path, the
    port of bench.py's kernel-microbench path: ``hbm_roof``,
    ``matmul_roof``, ``attention_kernel`` at bench.py's two shapes (the
    first with the dot floor) and ``layer_norm_kernel``, each printed with
    the card, with exact launch counts; then K9 and K10 timed cold beside
    their plain versions, ``copy_`` and two dense ``torch.bmm``; last,
    every kernel row read against what the card demonstrably reaches
    (the HBM roof, or the dot floor at its shape).

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
from apex_tpu_torch.contrib.multihead_attn import (  # noqa: E402
    EncdecMultiheadAttn, SelfMultiheadAttn)
from apex_tpu_torch.examples.gpt import pretrain_gpt  # noqa: E402
from apex_tpu_torch.multi_tensor import (BucketPlan, flatten,  # noqa: E402
                                         multi_tensor_l2norm, plan_buckets,
                                         unflatten)
from apex_tpu_torch.ops import attention as att  # noqa: E402
from apex_tpu_torch.ops import fused_layer_norm as ln  # noqa: E402
from apex_tpu_torch.optimizers import (FlatAdamState,  # noqa: E402
                                       FlatFusedAdam, FusedAdam)
from apex_tpu_torch.optimizers import flat as flat_opt  # noqa: E402
from apex_tpu_torch.profiling import microbench, roofs, timing  # noqa: E402
from apex_tpu_torch.profiling.roofs import (HBM_BYTES_PER_S,  # noqa: E402
                                            PEAK_FLOPS, bound)
from apex_tpu_torch.profiling.timing import cold_ms  # noqa: E402
from apex_tpu_torch.transformer.testing import gpt_param_count  # noqa: E402
from apex_tpu_torch.serving import model as model_mod  # noqa: E402
from apex_tpu_torch.serving import (ServingEngine, ServingModelConfig,  # noqa: E402
                                    SimClock, init_params, poisson_trace)

BF16_TOL = 2.0 ** -7    # x max|ref|: one bf16 ulp at the output's scale
FP32_TOL = 1e-5         # x max(1, max|ref|)

# the serving main path's geometry (GPT-1.3B width, bench.py's serving cell)
FULL = dict(vocab_size=51200, hidden_size=2048, num_heads=16, num_layers=24,
            max_position=1024)
PAGE, BATCH, PAGES_PER_REQ = 64, 8, 5
NUM_PAGES = 1 + BATCH * PAGES_PER_REQ * 3 // 2


def log(msg: str) -> None:
    print(msg, flush=True)


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
    ms = cold_ms(lambda: att.flash_attention_fwd(q, k, v, causal=True,
                                                 segment_ids=seg))
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    plain_ms = cold_ms(lambda: att._blockwise_fwd(qf, kf, vf, scale, True,
                                                  None, seg, seg))
    sid = seg[0]
    visible = (sid[:, None] == sid[None, :]) & torch.ones(
        s, s, dtype=torch.bool, device="cuda").tril()
    lib_ms = cold_ms(lambda: F.scaled_dot_product_attention(
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
    ms = cold_ms(lambda: att.flash_decode(q, kp, vp, table, kv_len), 50)
    plain_ms = cold_ms(lambda: att._paged_attention(
        q, kp, vp, table, kv_len, 1 / math.sqrt(d)), 50)
    cols = torch.arange(p_max * page_size, device="cuda")
    rows = torch.arange(q_len, device="cuda")[:, None]
    visible = cols <= (kv_len.long() - q_len)[:, None, None, None] + rows

    def library():
        idx = table.long()
        kc = kp[idx].reshape(b, -1, h, d).transpose(1, 2)
        vc = vp[idx].reshape(b, -1, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=visible)

    lib_ms = cold_ms(library, 50)
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
    fwd_ms = cold_ms(lambda: att._flash_qkv_fwd_cuda(qkv, *args), 10)
    fwd_plain = cold_ms(lambda: att._flash_qkv_fwd_plain(qkv, *args), 5, 1)
    bwd_ms = cold_ms(lambda: att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse,
                                                     *args), 10)
    bwd_plain = cold_ms(lambda: att._flash_qkv_bwd_plain(
        qkv, dctx, ctx, lse, *args), 5, 1)
    # the library yardstick: SDPA on the same strided per-head views
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(b, s, h, 3, d).permute(3, 0, 2, 1, 4))
    fwd_lib = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=rate, is_causal=True), 10)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=rate,
                                         is_causal=True)
    dout = dctx.view(b, s, h, d).transpose(1, 2)
    bwd_lib = cold_ms(lambda: torch.autograd.grad(
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
                 bound_ms=fb, bound_by=fby, flops=4 * d * pairs),
            dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
                 bound_ms=bb, bound_by=bby, flops=10 * d * pairs))


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
    fwd_ms = cold_ms(lambda: ln._ln_fwd_cuda(x, w, b, 1e-5), 50)
    fwd_plain = cold_ms(lambda: ln._ln_fwd_plain(x, w, b, 1e-5), 20)
    bwd_ms = cold_ms(lambda: ln._ln_bwd_cuda(x, dy, mean, invvar, w, True),
                     50)
    bwd_plain = cold_ms(lambda: ln._ln_bwd_plain(x, dy, mean, invvar, w,
                                                 True), 20)
    # the library yardstick in x's dtype throughout (F.layer_norm wants
    # one dtype), forward and its autograd backward
    xl = x.detach().requires_grad_()
    wl, bl = (t.to(x.dtype).requires_grad_() for t in (w, b))
    fwd_lib = cold_ms(lambda: F.layer_norm(xl, (cols,), wl, bl), 50)
    yl = F.layer_norm(xl, (cols,), wl, bl)
    bwd_lib = cold_ms(lambda: torch.autograd.grad(
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


# -- phase 3, slice 3: the generic attention kernels K1 (mask, dropout,
# d = 64) and K2 ------------------------------------------------------------

# the multi-head attention main path (phase 9): Transformer-big, the "big"
# row of Table 3 of Vaswani et al. 2017 (d_model 1024, 16 heads of 64)
MHA = dict(hidden=1024, heads=16, layers=6, batch=32, src=256, tgt=192,
           dropout=0.1)
MASK_FILL = -10000.0         # the modules' fill for a boolean mask


def bert_lengths(n, seq=512, seed=7):
    """bench.py::bert_lengths: ~25 % at the full window, the rest uniform
    in [seq/8, seq) rounded to 8 (copied: the port imports no JAX)."""
    rng = np.random.RandomState(seed)
    lens = np.where(rng.rand(n) < 0.25, seq,
                    (rng.randint(seq // 8, seq, size=n) // 8) * 8)
    return np.maximum(lens, 8).astype(np.int64)


def mha_lengths(seed, b, lo, hi):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        lo, hi + 1, size=b)).cuda()


def mha_operands(gen, dtype, sq, sk, b, d, h=16):
    """q, k, v as the attention modules hand them to the kernels: strided
    [b, h, s, d] views of a [s, b, 3*h*d] projection (sq == sk) or of
    [sq, b, h*d] and [sk, b, 2*h*d] ones; do in the [s, b, h, d] order
    autograd hands it back."""
    def heads(t, s):
        return t.view(s, b, h, d).permute(1, 2, 0, 3)

    if sq == sk:
        qkv = torch.randn(sq, b, 3 * h * d, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (heads(t, sq) for t in qkv.split(h * d, -1))
    else:
        q = heads(torch.randn(sq, b, h * d, generator=gen,
                              device="cuda").to(dtype), sq)
        kv = torch.randn(sk, b, 2 * h * d, generator=gen,
                         device="cuda").to(dtype)
        k, v = (heads(t, sk) for t in kv.split(h * d, -1))
    do = heads(torch.randn(sq, b, h * d, generator=gen,
                           device="cuda").to(dtype), sq)
    return q, k, v, do


def key_padding(lengths, sk):
    """[b, sk] bool, True = padded (the modules' key_padding_mask)."""
    return torch.arange(sk, device="cuda")[None] >= lengths[:, None]


def segments_of(pad, sq):
    """The modules' segment route: all-ones query ids, key ids 1 = real."""
    keep = (~pad).to(torch.int32)
    return torch.ones(pad.shape[0], sq, dtype=torch.int32,
                      device="cuda"), keep


def causal_fill(sq, sk):
    """[1, 1, sq, sk] additive causal mask, as the decoder's bool
    attn_mask becomes on the module's mask_bias route."""
    tri = torch.ones(sq, sk, dtype=torch.bool, device="cuda").triu(
        1 + sk - sq)
    return torch.where(tri, MASK_FILL, 0.0)[None, None]


def check_bitwise(name, a, b):
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"  {name}: bitwise equal {same}")
    if not same:
        raise AssertionError(f"{name}: not bitwise equal")


def flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, block=64):
    """The tiles ``csrc/flash_bwd_kernel.cuh`` walks (K2's backward, which
    K4 runs on packed strides), as [lo, hi) ranges: ([rows, n_kb, 2]
    q-tiles of each k-tile's dk/dv block, [rows, n_qb, 2] k-tiles of each
    q-tile's dq block), rows being the segment-id rows (one without
    segments); an empty range has lo == hi.  The dk/dv pass takes the
    transposed segment rule (``_segment_block_bounds``' second output)
    and, under the causal mask, starts at the tile of row k0 - (sk - sq),
    the first row that sees its first column; the dq pass takes the
    forward's rule and stops at the causal limit.  Tiles of ``block``; a
    ragged last tile counts its valid ids only.  The kernel's own count
    (``visits``) is held against this in phase 3, and this against the
    JAX package's rule in the tests."""
    n_qb, n_kb = -(-sq // block), -(-sk // block)
    if seg_q is None:
        q_lo, q_hi = torch.zeros(1, n_kb, dtype=torch.int64), torch.full(
            (1, n_kb), n_qb)
        k_lo, k_hi = torch.zeros(1, n_qb, dtype=torch.int64), torch.full(
            (1, n_qb), n_kb)
    else:
        def pad(ids, n):  # repeat the last id: min and max stay the same
            ids = ids.to(torch.int64).cpu()
            return torch.cat([ids, ids[:, -1:].expand(-1, n * block
                                                      - ids.shape[1])], 1)

        lohi_q, lohi_k = att._segment_block_bounds(
            pad(seg_q, n_qb), pad(seg_k, n_kb), block, block)
        k_lo, k_hi = lohi_q[..., 0].long(), lohi_q[..., 1].long()
        q_lo, q_hi = lohi_k[..., 0].long(), lohi_k[..., 1].long()
    if causal:
        first = torch.arange(n_kb) * block - (sk - sq)
        q_lo = torch.maximum(q_lo, torch.where(
            first <= 0, 0, (first // block).clamp(max=n_qb)))
        q0 = torch.arange(n_qb) * block
        last = q0 + (sq - q0).clamp(max=block) - 1 + (sk - sq)
        k_hi = torch.minimum(k_hi, torch.where(last >= 0, last // block + 1,
                                               0))
    return (torch.stack([q_lo, torch.maximum(q_hi, q_lo)], -1),
            torch.stack([k_lo, torch.maximum(k_hi, k_lo)], -1))


def generic_case(gen, name, dtype, sq, sk, *, b, d, h=16, causal=False,
                 mask=None, seg=None, rate=0.0, repeat=False):
    """K1 and K2 against their plain versions on the same inputs (K2 gets
    K1's o and lse), and K2's tiles walked against the plain statement
    of its skip rule (:func:`flash_bwd_tiles`).  Returns (K1 error, K2
    error, operands)."""
    q, k, v, do = mha_operands(gen, dtype, sq, sk, b, d, h)
    seg_q, seg_k = seg if seg is not None else (None, None)
    args = (mask, seg_q, seg_k, d ** -0.5, causal, rate, RATE_SEED)
    o, lse = att._flash_fwd_cuda(q, k, v, *args)
    ro, rlse = att._flash_fwd_plain(q, k, v, *args)
    torch.cuda.synchronize()
    e1 = check(f"flash_fwd {name} o", o, ro)
    check_lse(f"flash_fwd {name} lse", lse, rlse)
    n_kb, n_qb = -(-sk // 64), -(-sq // 64)
    visits = torch.full((b * h * (n_kb + n_qb),), -1, dtype=torch.int32,
                        device="cuda")
    grads = att._flash_bwd_cuda(q, k, v, o, lse, do, *args, visits=visits)
    ref = att._flash_bwd_plain(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    e2 = max(check(f"flash_bwd {name} {n}", g, r)
             for n, g, r in zip(("dq", "dk", "dv"), grads, ref))
    want_kv, want_q = (r[..., 1] - r[..., 0] for r in flash_bwd_tiles(
        seg_q, seg_k, sq, sk, causal))
    rows = want_kv.shape[0]
    want = torch.cat([want_kv.repeat_interleave(b * h // rows, 0).flatten(),
                      want_q.repeat_interleave(b * h // rows, 0).flatten()])
    got = visits.cpu().long()
    full = b * h * (2 * n_kb * n_qb)
    log(f"  flash_bwd {name} tiles walked: {int(got.sum())} of {full} "
        f"(dk/dv {int(got[:b * h * n_kb].sum())}, dq "
        f"{int(got[b * h * n_kb:].sum())}); the plain rule's "
        f"{int(want.sum())}: {'ok' if torch.equal(got, want) else 'FAIL'}")
    if not torch.equal(got, want):
        raise AssertionError(f"flash_bwd {name}: tiles walked differ from "
                             "flash_bwd_tiles")
    if repeat:
        again = att._flash_bwd_cuda(q, k, v, o, lse, do, *args)
        check_bitwise(f"flash_bwd {name} run twice", grads, again)
    del ro, rlse, ref
    return e1, e2, (q, k, v, do, o, lse, args)


def phase_generic_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, fp32 = torch.bfloat16, torch.float32
    B, S, T = MHA["batch"], MHA["src"], MHA["tgt"]
    src_pad = key_padding(mha_lengths(5, B, 32, S), S)
    tgt_pad = key_padding(mha_lengths(6, B, 32, T), T)
    # the main path's three attention calls, at their shapes
    e1, e2, enc = generic_case(
        gen, "encoder self [32,16,256,64] bf16 key-padding segments", bf16,
        S, S, b=B, d=64, seg=segments_of(src_pad, S))
    dec_mask = (torch.where(tgt_pad, MASK_FILL, 0.0)[:, None, None, :]
                + causal_fill(T, T))                    # [b, 1, sq, sk]
    _, _, dec = generic_case(
        gen, "decoder self [32,16,192,64] bf16 pad + causal mask", bf16, T,
        T, b=B, d=64, mask=dec_mask, repeat=True)
    generic_case(gen, "cross [32,16,192x256,64] bf16 segments", bf16, T, S,
                 b=B, d=64, seg=segments_of(src_pad, T))
    # the mask read through its strides equals the mask materialised
    q, k, v, do, o, lse, args = dec
    full = dec_mask.expand(B, 16, T, T).contiguous()
    o_full, lse_full = att._flash_fwd_cuda(q, k, v, full, *args[1:])
    check_bitwise("flash_fwd zero-stride [b,1,sq,sk] mask vs materialised "
                  "[b,h,sq,sk]", (o, lse), (o_full, lse_full))
    check_bitwise("flash_bwd zero-stride mask vs materialised",
                  att._flash_bwd_cuda(q, k, v, o, lse, do, *args),
                  att._flash_bwd_cuda(q, k, v, o, lse, do, full, *args[1:]))
    del full, o_full, lse_full
    pad8 = src_pad[:8]
    generic_case(gen, "key padding [8,1,1,256] + attn mask [1,1,256,256], "
                 "zero strides", bf16, S, S, b=8, d=64,
                 mask=torch.where(pad8, MASK_FILL, 0.0)[:, None, None, :]
                 + causal_fill(S, S))
    generic_case(gen, "full [b,h,sq,sk] random mask, fp32", fp32, 128, 128,
                 b=2, d=64, mask=torch.randn(2, 16, 128, 128, generator=gen,
                                              device="cuda"))
    # each feature alone and combined, at other shapes, both dtypes
    generic_case(gen, "causal sq < sk (192 x 256) bf16", bf16, 192, 256, b=4,
                 d=64, causal=True)
    generic_case(gen, "causal sq > sk (256 x 192) + segments fp32", fp32, 256,
                 192, b=4, d=64, causal=True,
                 seg=segments_of(key_padding(mha_lengths(7, 4, 1, 192), 192),
                                 256))
    generic_case(gen, f"dropout {MHA['dropout']} + segments bf16", bf16, S, S,
                 b=8, d=64, rate=MHA["dropout"],
                 seg=segments_of(src_pad[:8], S))
    lens = mha_lengths(8, 4, 1, 200)
    lens[1] = 0   # every key of batch row 1 padded: its rows see nothing
    e_pad = generic_case(gen, "all-padded rows (segment route) fp32", fp32,
                         200, 200, b=4, d=64,
                         seg=segments_of(key_padding(lens, 200), 200))[2]
    q, k, v, do, o, lse, args = e_pad
    dq = att._flash_bwd_cuda(q, k, v, o, lse, do, *args)[0]
    zero = bool((o[1] == 0).all()) and bool((dq[1] == 0).all()) and bool(
        (lse.view(4, 16, 200)[1] == -1e30).all())
    log(f"  all-padded batch row: o, dq exactly 0 and lse -1e30: {zero}")
    if not zero:
        raise AssertionError("all-padded rows are not exact zeros")
    varied = segments_of(key_padding(mha_lengths(9, 4, 1, 200), 200), 200)
    for dtype in (fp32, bf16):
        for d in (8, 64, 128):
            generic_case(gen, f"combined mask + segments + causal + dropout "
                         f"d={d} {dtype}", dtype, 200, 200, b=4, d=d, h=4,
                         causal=True, mask=torch.randn(
                             4, 1, 200, 200, generator=gen, device="cuda"),
                         seg=varied, rate=MHA["dropout"], repeat=d == 64)
    varlen_case(gen)
    timing = time_generic(enc, dec, gen)
    timing["flash_fwd_mha"]["max_abs_err"] = e1
    timing["flash_bwd"]["max_abs_err"] = e2
    return timing


def varlen_case(gen) -> None:
    """flash_attention_varlen forward and backward on a BERT-large-shaped
    packed batch: [total, 16, 64] bf16, bench.py's 16 sequence lengths
    concatenated and padded to whole rows of 512, kernels vs plain."""
    lens = bert_lengths(16)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      device="cuda")
    total = -(-int(lens.sum()) // 512) * 512
    qkv = torch.randn(total, 3, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    dout = torch.randn(total, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16)

    def run():
        q, k, v = (t.detach().requires_grad_() for t in qkv.unbind(1))
        o = att.flash_attention_varlen(q, k, v, cu)
        return (o, *torch.autograd.grad(o, (q, k, v), dout))

    got = run()
    with plain_kernels()[0]:
        ref = run()
    torch.cuda.synchronize()
    for n, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
        check(f"flash_attention_varlen [{total},16,64] bf16 {n}", g, r)


def mha_bound(q, k, mask, fwd, live_q, live_k, visible) -> tuple:
    """(bound ms, what bounds it) of one K1 (fwd) or K2 call.  Bytes: the
    rows of q (and for K2 o, do and lse) that see some key, and the rows
    of k and v that some query sees, read once (``live_q``, ``live_k``:
    counts over all batch*heads; a padded key is never read); o and lse
    (K2: dq, dk and dv) written once in full; the mask's own elements.
    Operations: 4 d (K1) or 10 d (K2) flops per ``visible`` pair."""
    B, H, sq, d = q.shape
    q_rows, k_rows = B * H * sq, B * H * k.shape[2]
    item = q.element_size()
    m = 0 if mask is None else mask.untyped_storage().nbytes()
    if fwd:
        nbytes = (live_q + 2 * live_k + q_rows) * d * item + q_rows * 4 + m
        flops = 4 * d * visible
    else:
        nbytes = ((3 * live_q + 2 * live_k + q_rows + 2 * k_rows) * d * item
                  + live_q * 4 + m)
        flops = 10 * d * visible
    return bound(nbytes, flops, q.dtype)


def time_generic(enc, dec, gen) -> dict:
    """K1 and K2 at the main path's encoder shape (segments) and K1's
    mask, dropout and K2 at the decoder's (pad + causal mask): kernel,
    plain, SDPA with the same float mask (forward; backward through
    autograd) and the bound."""
    out = {}
    for name, ops in (("encoder", enc), ("decoder", dec)):
        q, k, v, do, o, lse, args = ops
        mask, seg_q, seg_k, scale = args[:4]
        B, H, sq, d = q.shape
        sk = k.shape[2]
        if seg_q is not None:   # key padding: -inf at padded keys
            fmask = torch.where(seg_k.bool(), 0.0, float("-inf"))[
                :, None, None, :].to(q.dtype)
            pairs = seg_q[:, :, None] == seg_k[:, None, :]  # [rows, sq, sk]
            per_row = B * H // seg_q.shape[0]
            visible = per_row * int(pairs.sum())
            live_q = per_row * int(pairs.any(2).sum())
            live_k = per_row * int(pairs.any(1).sum())
        else:
            fmask = mask.to(q.dtype)
            visible, live_q, live_k = B * H * sq * sk, B * H * sq, B * H * sk
        fwd_ms = cold_ms(lambda: att._flash_fwd_cuda(q, k, v, *args), 20)
        drop_ms = cold_ms(lambda: att._flash_fwd_cuda(
            q, k, v, *args[:5], MHA["dropout"], RATE_SEED), 20)
        fwd_plain = cold_ms(lambda: att._flash_fwd_plain(q, k, v, *args), 5, 1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        fwd_lib = cold_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=fmask), 20)
        bwd_ms = cold_ms(lambda: att._flash_bwd_cuda(q, k, v, o, lse, do,
                                                     *args), 20)
        bwd_plain = cold_ms(lambda: att._flash_bwd_plain(
            q, k, v, o, lse, do, *args), 5, 1)
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=fmask)
        bwd_lib = cold_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), 20)
        fb, fby = mha_bound(q, k, mask, True, live_q, live_k, visible)
        bb, bby = mha_bound(q, k, mask, False, live_q, live_k, visible)
        log(f"  generic attention timing, {name} [{B},{H},{sq}x{sk},{d}] "
            f"{q.dtype} ({'segments' if seg_q is not None else 'mask'}): "
            f"fwd kernel {fwd_ms:.4f} ms (dropout {MHA['dropout']}: "
            f"{drop_ms:.4f}), plain {fwd_plain:.4f}, sdpa {fwd_lib:.4f}, "
            f"bound {fb:.4f} ({fby}); bwd kernel {bwd_ms:.4f} ms, plain "
            f"{bwd_plain:.4f}, sdpa backward {bwd_lib:.4f}, bound {bb:.4f} "
            f"({bby})")
        out[name] = dict(fwd=dict(ms=fwd_ms, ms_dropout=drop_ms,
                                  plain_ms=fwd_plain, library_ms=fwd_lib,
                                  bound_ms=fb, bound_by=fby,
                                  flops=4 * d * visible),
                         bwd=dict(ms=bwd_ms, plain_ms=bwd_plain,
                                  library_ms=bwd_lib, bound_ms=bb,
                                  bound_by=bby, flops=10 * d * visible))
        del ql, kl, vl, ol
    return {"flash_fwd_mha": out["encoder"]["fwd"],
            "flash_fwd_mha_mask": out["decoder"]["fwd"],
            "flash_bwd": out["encoder"]["bwd"],
            "flash_bwd_mask": out["decoder"]["bwd"]}


# -- phase 3, slice 4: K8, Adam over the GPT-1.3B superblock ---------------

FLAT_LR = 1.5e-4     # pretrain_gpt's default, the main path's
FLAT_STEPS = 3
FLAT_GRAD_SCALE = 3e-5   # x randn: a global norm near 1 over 1.3e9 elements
FLAT_VARIANTS = (("AdamW, decay 0.01", dict(weight_decay=0.01)),
                 ("L2, decay 0.05", dict(weight_decay=0.05,
                                         adam_w_mode=False)),
                 ("decay 0", dict(weight_decay=0.0)),
                 ("bias correction off", dict(weight_decay=0.01,
                                              bias_correction=False)))


def plain_flat_adam():
    """K8 swapped for its plain version, on the card."""
    return mock.patch.object(flat_opt, "_flat_adam_cuda",
                             flat_opt._flat_adam_plain)


def gpt_superblock():
    """The GPT-1.3B main path's superblock (its seeded init weights, the
    model's unique parameters by name) and its schema."""
    _, model, _ = pretrain_gpt.setup(FULL_TRAIN, "cuda")
    with torch.no_grad():
        return flatten(dict(model.named_parameters()), dtype=torch.float32,
                       total_multiple_of=1024)


def flat_grad(gen, n):
    return torch.randn(n, generator=gen, device="cuda").mul_(FLAT_GRAD_SCALE)


def flat_adam_walk(opt, p0, seed, plan=None):
    """FLAT_STEPS in-place steps from ``p0`` and fresh moments, gradients
    drawn from ``seed``; returns (p, state)."""
    p = p0.clone()
    state = opt.init(p)
    run = opt.jit_step(plan=plan)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(FLAT_STEPS):
        _, state = run(flat_grad(gen, p.numel()), state, p)
    return p, state


def pmv(p, state):
    return p, state.exp_avg, state.exp_avg_sq


def flat_padding_case() -> None:
    """Leaves of ragged sizes, so the superblock has gaps and a tail: after
    three steps in either decay mode every padding element of p, m and v
    is still exactly 0."""
    rng = np.random.RandomState(4)
    shapes = [(1000,), (3, 7), (5,), (64, 65), (4096 + 7,)]

    def tree():
        return {f"w{i}": torch.from_numpy(rng.randn(*s).astype(np.float32)
                                          ).cuda() for i, s in enumerate(shapes)}

    p, schema = flatten(tree(), total_multiple_of=1024)
    pad = schema.segment_ids().cuda() == schema.num_tensors
    for name, kw in FLAT_VARIANTS[:2]:
        opt = FlatFusedAdam(lr=1e-2, **kw)
        q, state = p.clone(), opt.init(p)
        for _ in range(FLAT_STEPS):
            _, state = opt.jit_step()(flatten(tree(), schema)[0], state, q)
        zero = all(bool((t[pad] == 0).all()) for t in pmv(q, state))
        tail = schema.total - schema.offsets[-1] - schema.sizes[-1]
        log(f"  flat_adam {name}: {int(pad.sum())} padding elements of "
            f"{schema.total} (tail {tail}) exactly 0 in p, m, v after "
            f"{FLAT_STEPS} steps: {zero}")
        if not zero:
            raise AssertionError("flat_adam wrote into the padding")


def phase_flat_adam() -> dict:
    """K8 at the GPT-1.3B superblock's length: bitwise against its plain
    version over FLAT_STEPS steps in every decay variant; bucketed walks
    bitwise against the single launch; no host sync in a step; padding
    stays 0; then timed beside its plain version, ``torch._fused_adamw_``
    on the same one-tensor lists, and its bound."""
    p0, schema = gpt_superblock()
    n = p0.numel()
    log(f"  superblock: {schema.num_tensors} leaves, {n} elements")
    timing, err = None, 0.0
    for name, kw in FLAT_VARIANTS:
        opt = FlatFusedAdam(lr=FLAT_LR, **kw)
        got = flat_adam_walk(opt, p0, 21)
        with plain_flat_adam():
            ref = flat_adam_walk(opt, p0, 21)
        check_bitwise(f"flat_adam [{n}] {name}, {FLAT_STEPS} steps: p, m, v "
                      "vs plain", pmv(*got), pmv(*ref))
        err = max([err] + [(a - b).abs().max().item()
                           for a, b in zip(pmv(*got), pmv(*ref))])
        del ref
        if timing is None:   # the main path's variant
            timing = flat_adam_plans(opt, p0, schema, got)
        del got
        torch.cuda.empty_cache()
    del p0
    torch.cuda.empty_cache()
    flat_padding_case()
    timing["max_abs_err"] = err   # over p, m, v in every variant
    return timing


def flat_adam_plans(opt, p0, schema, got) -> dict:
    """Bucketed walks against the single launch ``got``, the sync check,
    and the timings (``got`` is consumed)."""
    n = p0.numel()
    third = n // 3 // 1024 * 1024
    plans = (plan_buckets(schema, 1, span_align=1024),
             BucketPlan(spans=((0, third), (third, 2 * third), (2 * third, n)),
                        shard=n, world=1, bucket_bytes=None))
    for plan, what in zip(plans, ("plan_buckets(span_align=1024)",
                                  "hand-built")):
        bucketed = flat_adam_walk(opt, p0, 21, plan)
        check_bitwise(f"flat_adam {what} plan, {plan.num_buckets} spans, vs "
                      "one launch", pmv(*got), pmv(*bucketed))
        del bucketed
    p, state = got
    g = flat_grad(torch.Generator(device="cuda").manual_seed(22), n)
    run = opt.jit_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(g, state, p)
        opt.jit_step(plan=plans[0])(g, state, p)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  flat_adam step, one launch and bucketed, under "
        "set_sync_debug_mode('error'): no host sync")
    ms = cold_ms(lambda: run(g, state, p), 20)
    with plain_flat_adam():
        plain_ms = cold_ms(lambda: run(g, state, p), 5, 1)
    # the library yardstick: PyTorch's fused AdamW on the same one-tensor
    # lists (the same function, its arithmetic in another order); its
    # state_steps hold the step after the increment, as K8's c1, c2 do
    t = (state.step + 1).float()

    def library(p, m, v):
        torch._fused_adamw_([p], [g], [m], [v], [], [t], lr=opt.lr,
                            beta1=opt.beta1, beta2=opt.beta2,
                            weight_decay=opt.weight_decay, eps=opt.eps,
                            amsgrad=False, maximize=False)

    lib_ms = cold_ms(lambda: library(*pmv(p, state)), 20)
    # its gap to K8: one step of each from the same state
    twin = [x.clone() for x in pmv(p, state)]
    run(g, state, p)
    library(*twin)
    lib_diff = (p - twin[0]).abs().max().item()
    del twin
    # p, g, m, v read, p, m, v written; 16 fp32 operations an element
    bound_ms, bound_by = bound(28 * n, 16 * n, torch.float32)
    log(f"  flat_adam timing [{n}] fp32 AdamW: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch._fused_adamw_ {lib_ms:.4f} ms (max |p - "
        f"p_lib| after one step from the same state {lib_diff:.3e}), bound "
        f"{bound_ms:.4f} ms ({bound_by}); {28 * n / ms / 1e9:.3f} TB/s")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_max_abs_diff=lib_diff)


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
    del fwd_ops, dec_ops
    out = {"flash_fwd": fwd, "flash_decode": dec, **phase_training_kernels(),
           **phase_generic_kernels()}
    torch.cuda.empty_cache()
    out["flat_adam"] = phase_flat_adam()
    torch.cuda.empty_cache()
    return out


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
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
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
              ("attn_bwd", "K4 flash_qkv_bwd"),   # K2's kernels, packed strides
              ("ln_fwd_kernel", "K6 layer_norm_fwd"),
              ("ln_bwd", "K7 layer_norm_bwd"),
              ("gemm", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
              ("nvjet", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"),
              ("foreach", "optimizer + clip (foreach)"),
              ("multi_tensor", "optimizer + clip (foreach)"),
              ("lpnorm", "optimizer + clip (foreach)"))


def plain_kernels():
    """A training step with its kernels swapped for their plain versions,
    on the card (the reference of the kernel-vs-plain checks)."""
    return mock.patch.multiple(
        att, _flash_qkv_fwd_cuda=att._flash_qkv_fwd_plain,
        _flash_qkv_bwd_cuda=att._flash_qkv_bwd_plain,
        _flash_fwd_cuda=att._flash_fwd_plain,
        _flash_bwd_cuda=att._flash_bwd_plain), mock.patch.multiple(
        ln, _ln_fwd_cuda=ln._ln_fwd_plain, _ln_bwd_cuda=ln._ln_bwd_plain)


def step_profile(step, parts=STEP_KINDS) -> dict:
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
        kind = next((k for frag, k in parts if frag in e.name.lower()),
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


# -- phases 8-9: the multi-head attention training path ---------------------


class MHAStack(torch.nn.Module):
    """An attention-only encoder-decoder of the contrib modules, stacked as
    the reference's multi-head attention perf script stacks them: ``layers``
    pre-norm self-attention layers over the source (boolean source key
    padding: the segment route), then ``layers`` decoder layers of
    self-attention (target key padding plus a boolean causal attn_mask:
    the mask_bias route) and encoder-decoder attention over the encoder's
    output (source key padding, sq != sk: the cross-length segment
    route)."""

    def __init__(self, hidden, heads, layers, dropout, device, seed=0):
        super().__init__()
        kw = dict(dropout=dropout, bias=True, include_norm_add=True,
                  device=device)
        self.enc = torch.nn.ModuleList(
            SelfMultiheadAttn(hidden, heads, seed=seed + i, **kw)
            for i in range(layers))
        self.dec_self = torch.nn.ModuleList(
            SelfMultiheadAttn(hidden, heads, seed=seed + 100 + i, **kw)
            for i in range(layers))
        self.dec_cross = torch.nn.ModuleList(
            EncdecMultiheadAttn(hidden, heads, seed=seed + 200 + i, **kw)
            for i in range(layers))

    def forward(self, src, tgt, src_pad, tgt_pad, causal, generator=None):
        x = src
        for m in self.enc:
            x = m(x, key_padding_mask=src_pad, generator=generator)
        y = tgt
        for s, c in zip(self.dec_self, self.dec_cross):
            y = s(y, key_padding_mask=tgt_pad, attn_mask=causal,
                  generator=generator)
            y = c(y, x, key_padding_mask=src_pad, generator=generator)
        return y


def mha_batch(device, dtype, hidden, b, s_src, s_tgt, lo, seed):
    """Source and target activations [s, b, hidden] (the embeddings'
    output), a fixed random regression target, key-padding masks from
    lengths uniform in [lo, s], and the decoder's causal mask."""
    rng = np.random.RandomState(seed)
    src_len = rng.randint(lo, s_src + 1, size=b)
    tgt_len = rng.randint(lo, s_tgt + 1, size=b)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device)

    src, tgt = t(s_src, b, hidden).to(dtype), t(s_tgt, b, hidden).to(dtype)
    target = t(s_tgt, b, hidden)
    src_pad = (torch.arange(s_src)[None] >= torch.from_numpy(src_len)[:, None])
    tgt_pad = (torch.arange(s_tgt)[None] >= torch.from_numpy(tgt_len)[:, None])
    causal = torch.ones(s_tgt, s_tgt, dtype=torch.bool).triu(1)
    return dict(src=src, tgt=tgt, target=target, src_pad=src_pad.to(device),
                tgt_pad=tgt_pad.to(device), causal=causal.to(device),
                real_tokens=int(src_len.sum() + tgt_len.sum()))


def mha_loss(model, batch, generator=None):
    y = model(batch["src"], batch["tgt"], batch["src_pad"], batch["tgt_pad"],
              batch["causal"], generator=generator)
    return ((y.float() - batch["target"]) ** 2).mean()


def mha_step(model, opt, batch, generator=None):
    loss = mha_loss(model, batch, generator)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


TOY_MHA = dict(hidden=32, heads=4, layers=2, batch=4, src=40, tgt=24)
TOY_MHA_LOSS_TOL = 1e-5      # x |loss|: fp32 throughout, sums in another order
# final weights card vs CPU, absolute: ten times the largest gap read on
# an H100 (1.23e-5, and 9.83e-5 on the key biases); five Adam steps at lr
# 1e-3 move a weight by up to 5e-3, so a skipped update would fail it
TOY_MHA_WEIGHT_TOL = 1.3e-4
# the key part of a packed projection bias: softmax ignores a constant
# added to a row's scores, so its exact gradient is 0 and Adam steps on
# rounding noise (up to lr a step) on either device
TOY_MHA_KEY_BIAS_TOL = 1e-3
MHA_LR = 5e-4


def key_bias_part(name: str, hidden: int):
    """The slice of the key projection's bias in a packed bias, or None."""
    if name.endswith("in_proj_bias"):
        return slice(hidden, 2 * hidden)
    if name.endswith("kv_bias"):
        return slice(0, hidden)
    return None


def phase_toy_mha() -> dict:
    """The toy-width stack (4 heads of 8), fp32, five FusedAdam steps on a
    fixed batch from the same weights on the card (kernels) and on the
    CPU (plain versions)."""
    c = TOY_MHA
    cpu = MHAStack(c["hidden"], c["heads"], c["layers"], 0.0, "cpu", seed=1)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = MHAStack(c["hidden"], c["heads"], c["layers"], 0.0, "cpu", seed=1)
    card.load_state_dict(state)
    card.cuda()

    def run(model, device):
        batch = mha_batch(device, torch.float32, c["hidden"], c["batch"],
                          c["src"], c["tgt"], 8, seed=2)
        opt = FusedAdam(model.parameters(), lr=1e-3)
        losses = [float(mha_step(model, opt, batch)) for _ in range(5)]
        return losses, {k: v.detach().cpu() for k, v in
                        model.state_dict().items()}

    on_card, w_card = run(card, "cuda")
    on_cpu, w_cpu = run(cpu, "cpu")
    log(f"  toy fp32 losses, cuda (kernels): {on_card}")
    log(f"  toy fp32 losses, cpu (plain):    {on_cpu}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
    diff = {k: (w_card[k] - w_cpu[k]).abs() for k in w_cpu}
    kb_err = 0.0
    for k, d in diff.items():
        part = key_bias_part(k, c["hidden"])
        if part is not None:
            kb_err = max(kb_err, d[part].max().item())
            d[part] = 0.0
    worst = max(diff, key=lambda k: diff[k].max().item())
    w_err = diff[worst].max().item()
    moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
    log(f"  toy MHA training: loss rel diff {loss_err:.3e} (tol "
        f"{TOY_MHA_LOSS_TOL:.0e}); final weights max diff {w_err:.3e} on "
        f"{worst} (tol {TOY_MHA_WEIGHT_TOL:.1e}), key biases {kb_err:.3e} "
        f"(tol {TOY_MHA_KEY_BIAS_TOL:.0e}); the largest update on the CPU "
        f"{moved:.3e}")
    if not (loss_err <= TOY_MHA_LOSS_TOL and w_err <= TOY_MHA_WEIGHT_TOL
            and kb_err <= TOY_MHA_KEY_BIAS_TOL
            and moved > 2 * TOY_MHA_KEY_BIAS_TOL):
        raise AssertionError("toy MHA training: card and CPU disagree")
    return {"toy_mha_loss_rel_diff": loss_err,
            "toy_mha_weight_max_diff": w_err,
            "toy_mha_key_bias_max_diff": kb_err}


# kernel vs plain, one dropout-free full-width step: bf16 activations
# through 12 layers, so a one-ulp difference in a K1 output or a LayerNorm
# moves every later gradient a little; each bar is ten times the largest
# gap read on an H100
MHA_PLAIN_LOSS_TOL = 7e-7    # relative, on the loss (read 6.2e-8)
MHA_PLAIN_NORM_TOL = 8e-4    # relative, global grad norm (read 7.3e-5)
# relative, |g - g_plain| / |g_plain| on the worst leaf (read 1.05e-2, on
# encoder layer 5's in_proj_weight; the median leaf reads 8.7e-3)
MHA_PLAIN_LEAF_TOL = 1.1e-1
MHA_KINDS = (("flash_fwd_kernel", "K1 flash_fwd"),
             ("attn_bwd", "K2 flash_bwd"),
             ("ln_fwd_kernel", "K6 layer_norm_fwd"),
             ("ln_bwd", "K7 layer_norm_bwd"),
             ("gemm", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
             ("nvjet", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"),
             ("foreach", "optimizer (foreach)"),
             ("multi_tensor", "optimizer (foreach)"))


def mha_grads(model, batch):
    loss = mha_loss(model, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_mha(smi: str) -> dict:
    c = MHA
    L, steps = c["layers"], 5
    per_step = {"flash_fwd": 3 * L, "flash_bwd": 3 * L,
                "layer_norm_fwd": 3 * L, "layer_norm_bwd": 3 * L}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = mha_batch("cuda", torch.bfloat16, c["hidden"], c["batch"],
                      c["src"], c["tgt"], 32, seed=3)
    model = MHAStack(c["hidden"], c["heads"], L, c["dropout"], "cuda")
    opt = FusedAdam(model.parameters(), lr=MHA_LR)
    gen = torch.Generator(device="cuda")
    losses, times = [], []
    kernels.reset_launch_counts()
    for it in range(steps):
        gen.manual_seed(1000 + it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(mha_step(model, opt, batch, gen)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    want = {k: v * steps for k, v in per_step.items()}
    log(f"  fixed-batch losses {losses}")
    log(f"  launches over {steps} steps {launches}, expected {want} (per "
        f"step K1 = K2 = K6 = K7 = {3 * L}: {L} encoder, {L} decoder self, "
        f"{L} cross)")
    if launches != want:
        raise AssertionError("MHA launch counts do not match the main path")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError("MHA stack: the loss is not finite or does not "
                             "fall on a fixed batch")
    step_ms = statistics.median(times[1:])
    padded = c["batch"] * (c["src"] + c["tgt"])
    metrics = {"mha_step_ms_p50": step_ms,
               "mha_tok_per_s": padded / step_ms * 1e3,
               "mha_real_tok_per_s": batch["real_tokens"] / step_ms * 1e3,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "params": sum(p.numel() for p in model.parameters()),
               "card": smi}
    log("  mha " + json.dumps(metrics))
    prof = step_profile(lambda: mha_step(model, opt, batch, gen), MHA_KINDS)
    metrics["step_profile"] = prof
    if prof["device_busy_ms"] > 0:
        log("  one step under torch.profiler: " + ", ".join(
            f"{k} {v:.2f} ms ({v / prof['wall_ms']:.1%})"
            for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms, idle {prof['idle_share']:.1%}")
        for name, n, t in prof["top_kernels"]:
            log(f"    {t:8.2f} ms  x{n:<5d} {name}")
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(breakdown not measured)")

    # kernels vs plain versions, one dropout-free step from the same weights
    loss, grads = mha_grads(model, batch)
    patches = plain_kernels()
    with patches[0], patches[1]:
        ref_loss, ref_grads = mha_grads(model, batch)
    norm = multi_tensor_l2norm(list(grads.values())).item()
    ref_norm = multi_tensor_l2norm(list(ref_grads.values())).item()
    dl, dn = abs(loss - ref_loss) / abs(ref_loss), abs(norm - ref_norm) / ref_norm
    leaf = {n: ((grads[n] - g).norm() / g.norm()).item()
            for n, g in ref_grads.items()}
    worst = max(leaf, key=leaf.get)
    log(f"  dropout-free step, kernels vs plain: loss {loss:.6f} vs "
        f"{ref_loss:.6f} (rel diff {dl:.3e}, tol {MHA_PLAIN_LOSS_TOL:.1e}); "
        f"grad norm {norm:.6f} vs {ref_norm:.6f} (rel diff {dn:.3e}, tol "
        f"{MHA_PLAIN_NORM_TOL:.1e}); worst leaf {worst} |g - g_plain| / "
        f"|g_plain| {leaf[worst]:.3e} (tol {MHA_PLAIN_LEAF_TOL:.1e}), median "
        f"over {len(leaf)} leaves {statistics.median(leaf.values()):.3e}")
    if not (dl <= MHA_PLAIN_LOSS_TOL and dn <= MHA_PLAIN_NORM_TOL
            and leaf[worst] <= MHA_PLAIN_LEAF_TOL):
        raise AssertionError("MHA step: kernel path disagrees with the plain "
                             "path")
    del model, opt, grads, ref_grads
    torch.cuda.empty_cache()

    # determinism: the same step (dropout on) twice from the same state
    def one_step():
        m = MHAStack(c["hidden"], c["heads"], L, c["dropout"], "cuda")
        o = FusedAdam(m.parameters(), lr=MHA_LR)
        g = torch.Generator(device="cuda").manual_seed(1000)
        loss = float(mha_step(m, o, batch, g))
        return loss, [p.detach().clone() for p in m.parameters()]

    loss1, w1 = one_step()
    loss2, w2 = one_step()
    same = loss1 == loss2 and all(torch.equal(x, y) for x, y in zip(w1, w2))
    log(f"  same step twice from the same state (dropout on): losses "
        f"{loss1!r} / {loss2!r}, weights bitwise equal: {same}")
    if not same:
        raise AssertionError("MHA step is not deterministic")
    metrics.update(launches=launches, kernel_vs_plain_loss_rel_diff=dl,
                   kernel_vs_plain_grad_norm_rel_diff=dn,
                   kernel_vs_plain_worst_leaf_rel_diff=leaf[worst],
                   deterministic=same)
    return metrics


# -- phases 10-11: GPT training on the flat superblock (K8) -----------------


class SuperblockTrainer:
    """GPT training with the model's weights in one fp32 superblock: the
    PyTorch form of the JAX package's flatten -> ``FlatFusedAdam.step``
    -> unflatten.  The model's unique parameters (the tied embedding
    once), packed by name with ``total_multiple_of=1024``, are rebound to
    their ``unflatten`` views, so the weights ARE the superblock, and each
    ``.grad`` is a view of one flat grad buffer of the same layout.  A
    step zeroes that buffer (dropping the grads would cut the views), runs
    ``pretrain_gpt.forward_backward``, whose clip scales the grad views
    and so the flat buffer, then the in-place ``FlatFusedAdam`` step: K8,
    one launch."""

    def __init__(self, args, model):
        params = dict(model.named_parameters())
        with torch.no_grad():
            self.flat_p, self.schema = flatten(
                params, dtype=torch.float32, total_multiple_of=1024)
        self.flat_g = torch.zeros_like(self.flat_p)
        weights = unflatten(self.flat_p, self.schema)
        grads = unflatten(self.flat_g, self.schema)
        for name, p in params.items():
            p.data = weights[name]
            p.grad = grads[name]
        self.args, self.model = args, model
        self.opt = FlatFusedAdam(lr=args.lr,
                                 betas=(args.adam_beta1, args.adam_beta2),
                                 eps=args.adam_eps,
                                 weight_decay=args.weight_decay)
        self.state = self.opt.init(self.flat_p)
        self.run = self.opt.jit_step()

    def step(self, tokens, labels, it: int):
        self.flat_g.zero_()
        loss = pretrain_gpt.forward_backward(self.args, self.model, tokens,
                                             labels, it)
        _, self.state = self.run(self.flat_g, self.state, self.flat_p)
        return loss


def flat_toy_run(device, state, batches):
    args, model, _ = pretrain_gpt.setup(TOY_TRAIN, device)
    model.load_state_dict(state)
    trainer = SuperblockTrainer(args, model)
    losses = [float(trainer.step(*(t.to(device) for t in b), it))
              for it, b in enumerate(batches)]
    return losses, {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}


def phase_flat_toy() -> dict:
    """Phase 6's toy GPT (fp32) trained on the superblock from the same
    weights and batches on the card (kernels, K8) and on the CPU (plain
    versions), held to phase 6's bars."""
    args, model, _ = pretrain_gpt.setup(TOY_TRAIN, "cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    batches = [b for b, _ in zip(pretrain_gpt.synthetic_batches(args, gen),
                                 range(5))]
    kernels.FLAT_ADAM.launches = 0
    on_card, w_card = flat_toy_run("cuda", state, batches)
    k8 = kernels.FLAT_ADAM.launches
    on_cpu, w_cpu = flat_toy_run("cpu", state, batches)
    log(f"  toy fp32 flat losses, cuda (kernels, {k8} K8 launches): {on_card}")
    log(f"  toy fp32 flat losses, cpu (plain):                 {on_cpu}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
    w_err = max((w_card[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
    moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
    log(f"  toy flat training: loss rel diff {loss_err:.3e} (tol "
        f"{TOY_LOSS_TOL:.0e}); final weights max diff {w_err:.3e} (tol "
        f"{TOY_WEIGHT_TOL:.0e}); the largest update on the CPU {moved:.3e}")
    if not (k8 == len(batches) and loss_err <= TOY_LOSS_TOL
            and w_err <= TOY_WEIGHT_TOL and moved > 2 * TOY_WEIGHT_TOL):
        raise AssertionError("toy flat training: card and CPU disagree")
    return {"toy_flat_loss_rel_diff": loss_err,
            "toy_flat_weight_max_diff": w_err}


# the superblock step against the tree FusedAdam step from one state and
# one gradient: the same fp32 Adam in another order of operations (and c1,
# c2 from the host there); absolute.  Read on an H100: 1.19e-7, one fp32
# ulp at 1.0 (the LayerNorm gains); ten times that is looser than 1e-6,
# so the bar stays 1e-6.  One step moves a weight by up to ~1.5e-4
FLAT_TREE_TOL = 1e-6
FLAT_KINDS = (("flat_adam", "K8 flat_adam"),) + tuple(
    (frag, "clip (foreach)" if kind.startswith("optimizer") else kind)
    for frag, kind in STEP_KINDS)


def optimizer_ms(prof, kinds) -> float:
    return sum(prof["by_kind_ms"].get(k, 0.0) for k in kinds)


def phase_flat_training(smi: str, train: dict) -> dict:
    L, steps = 24, 5
    per_step = {"flash_qkv_fwd": L, "flash_qkv_bwd": L,
                "layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
                "flat_adam": 1}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args, model, _ = pretrain_gpt.setup(FULL_TRAIN, "cuda")
    tr = SuperblockTrainer(args, model)
    if tr.schema.total != -(-gpt_param_count(model.cfg) // 1024) * 1024:
        raise AssertionError("superblock length is not phase 3's")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens, labels = next(pretrain_gpt.synthetic_batches(args, gen))
    losses, times = [], []
    kernels.reset_launch_counts()
    for it in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(tr.step(tokens, labels, it)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: v * steps for k, v in per_step.items()}
    log(f"  superblock: {tr.schema.num_tensors} leaves, {tr.schema.total} "
        f"elements; fixed-batch losses {losses}")
    log(f"  launches over {steps} steps {launches}, expected {want} (K8 one "
        "launch a step)")
    if launches != want:
        raise AssertionError("flat training launch counts do not match the "
                             "main path")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError("flat training: the loss is not finite or does "
                             "not fall on a fixed batch")
    lo_p, lo_g = tr.flat_p.data_ptr(), tr.flat_g.data_ptr()
    nbytes = tr.flat_p.numel() * 4
    alias = all(lo_p <= p.data_ptr() < lo_p + nbytes
                and lo_g <= p.grad.data_ptr() < lo_g + nbytes
                for p in model.parameters())
    log(f"  after backward every weight and .grad is a view of the "
        f"superblock / flat grad buffer: {alias}")
    if not alias:
        raise AssertionError("a parameter or its grad left the superblock")
    step_ms = statistics.median(times[1:])
    tokens_per_step = args.global_batch_size * args.seq_length
    prof = step_profile(lambda: tr.step(tokens, labels, steps), FLAT_KINDS)
    opt_ms = optimizer_ms(prof, ("K8 flat_adam", "clip (foreach)"))
    tree_ms = optimizer_ms(train["step_profile"],
                           ("optimizer + clip (foreach)",))
    metrics = {"flat_step_ms_p50": step_ms,
               "flat_tok_per_s": tokens_per_step / step_ms * 1e3,
               "peak_mem_gib": peak, "superblock_elements": tr.schema.total,
               "optimizer_clip_device_ms": opt_ms,
               "tree_optimizer_clip_device_ms": tree_ms,
               "tree_step_ms_p50": train["train_step_ms_p50"],
               "tree_peak_mem_gib": train["peak_mem_gib"],
               "step_profile": prof, "card": smi}
    log(f"  flat step {step_ms:.1f} ms ({metrics['flat_tok_per_s']:,.0f} "
        f"tok/s), peak {peak:.2f} GiB; phase 7 (tree FusedAdam, this run): "
        f"{train['train_step_ms_p50']:.1f} ms, peak "
        f"{train['peak_mem_gib']:.2f} GiB")
    log("  one flat step under torch.profiler: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in prof["by_kind_ms"].items())
        + f"; wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
    log(f"  optimizer + clip device time: K8 + clip {opt_ms:.2f} ms; phase 7's"
        f" FusedAdam + clip {tree_ms:.2f} ms")
    for name, n, t in prof["top_kernels"]:
        log(f"    {t:8.1f} ms  x{n:<5d} {name}")
    metrics.update(flat_checks(tr, steps + 1))
    metrics["launches"] = launches
    return metrics


def flat_checks(tr: SuperblockTrainer, it: int) -> dict:
    """From one shared state S: a whole step run twice is bitwise equal;
    the bucketed plan gives the single launch's bits; and the tree
    ``FusedAdam`` step over the same weights, moments and gradient agrees
    within FLAT_TREE_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens, labels = next(pretrain_gpt.synthetic_batches(tr.args, gen))
    saved = [x.clone() for x in pmv(tr.flat_p, tr.state)]
    step0 = tr.state.step.clone()

    def restore():
        for dst, src in zip(pmv(tr.flat_p, tr.state), saved):
            dst.copy_(src)
        tr.state = tr.state._replace(step=step0.clone())

    loss1 = float(tr.step(tokens, labels, it))
    # the bucketed walk from S with the same (clipped) gradient
    plan = plan_buckets(tr.schema, 1, span_align=1024)
    bucketed = [x.clone() for x in saved]
    before = kernels.FLAT_ADAM.launches
    tr.opt.jit_step(plan=plan)(tr.flat_g, FlatAdamState(step0.clone(),
                                                        *bucketed[1:]),
                               bucketed[0])
    spans = kernels.FLAT_ADAM.launches - before
    check_bitwise(f"flat step, plan_buckets ({plan.num_buckets} spans, "
                  f"{spans} launches) vs one launch: p, m, v",
                  pmv(tr.flat_p, tr.state), bucketed)
    if spans != plan.num_buckets:
        raise AssertionError("the bucketed walk's launches are not its spans")
    restore()
    loss2 = float(tr.step(tokens, labels, it))
    same = loss1 == loss2 and all(torch.equal(a, b) for a, b in zip(
        pmv(tr.flat_p, tr.state), bucketed))
    log(f"  same flat step twice from the same state (dropout on): losses "
        f"{loss1!r} / {loss2!r}, p, m, v bitwise equal: {same}")
    if not same:
        raise AssertionError("the flat step is not deterministic")
    del bucketed
    torch.cuda.empty_cache()
    # the tree FusedAdam over views of S, with the flat step's gradient
    p_s, m_s, v_s = saved
    leaves = [torch.nn.Parameter(w) for w in unflatten(p_s, tr.schema).values()]
    tree = FusedAdam(leaves, lr=tr.opt.lr, betas=(tr.opt.beta1, tr.opt.beta2),
                     eps=tr.opt.eps, weight_decay=tr.opt.weight_decay)
    t0 = int(step0)
    for leaf, g, m, v in zip(leaves, *(unflatten(x, tr.schema).values()
                                       for x in (tr.flat_g, m_s, v_s))):
        leaf.grad = g
        tree.state[leaf] = {"step": t0, "exp_avg": m, "exp_avg_sq": v}
    moved = (p_s - tr.flat_p).abs().max().item()
    tree.step()
    gap = (p_s - tr.flat_p).abs().max().item()
    log(f"  one step, superblock (K8) vs tree FusedAdam from the same state: "
        f"max |dw| {gap:.3e} (tol {FLAT_TREE_TOL:.0e}); the step moved a "
        f"weight by up to {moved:.3e}")
    if not (gap <= FLAT_TREE_TOL and moved > 10 * FLAT_TREE_TOL):
        raise AssertionError("the superblock step disagrees with FusedAdam")
    return {"flat_vs_tree_max_abs_dw": gap, "flat_deterministic": same,
            "flat_bucketed_spans": plan.num_buckets}


# -- phase 12: the bench's roofs and floor (K9, K10) and the kernel
# microbenches ---------------------------------------------------------------

# K10 at three shapes (bh, s, d, block_q, block_k): bench.py's microbench;
# K3/K4's GPT-1.3B attention at the port's key tile of 64
# (csrc/flash_tile.cuh); K1/K2's Transformer-big encoder
DOT_SHAPES = (
    ("bench", (128, 1024, 64, 512, 512)),
    ("GPT-1.3B (K3/K4)", (TRAIN["b"] * TRAIN["heads"], TRAIN["s"],
                          TRAIN["d"], 64, 64)),
    ("Transformer-big encoder (K1/K2)", (MHA["batch"] * MHA["heads"],
                                        MHA["src"],
                                        MHA["hidden"] // MHA["heads"], 64,
                                        64)),
)
# the physical ceilings a demonstrated rate must stay under (a timer that
# lost a launch would read above them)
ROOF_SLACK = 1.05


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


def hbm_copy_checks(gen) -> tuple:
    """K9 bit for bit against its plain version: the roof's 16384 x 8192
    fp32 buffer; a ragged bf16 length (2^20 + 3 elements: a 6-byte tail).
    A destination 2 bytes off 16-byte alignment is refused before any
    launch.  Returns (max |kernel - plain|, the roof's buffer)."""
    x = torch.randn(16384, 8192, generator=gen, device="cuda")
    got = roofs.hbm_copy(x)
    ref = roofs._hbm_copy_plain(x, None)
    torch.cuda.synchronize()
    check_bitwise("hbm_copy [16384, 8192] fp32 vs plain", (bits(got),),
                  (bits(ref),))
    err = (got - ref).abs().max().item()
    del got, ref
    r = torch.randn(2 ** 20 + 3, generator=gen, device="cuda").to(
        torch.bfloat16)
    check_bitwise("hbm_copy [2^20 + 3] bf16 (byte tail) vs plain",
                  (bits(roofs.hbm_copy(r)),),
                  (bits(roofs._hbm_copy_plain(r, None)),))
    out = torch.zeros(r.numel() + 1, dtype=r.dtype, device="cuda")[1:]
    launches = kernels.HBM_COPY.launches
    try:
        roofs.hbm_copy(r, out)
    except ValueError as e:
        log(f"  hbm_copy into a destination 2 bytes off alignment: refused "
            f"({e})")
    else:
        raise AssertionError("hbm_copy took a misaligned destination")
    if kernels.HBM_COPY.launches != launches:
        raise AssertionError("hbm_copy launched on a misaligned destination")
    return err, x


def dots_case(gen, what, shape) -> tuple:
    """K10 against its plain version within ``tolerance`` (bf16), and run
    twice, bitwise."""
    bh, s, d, bq, bk = shape
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    o = roofs.attention_dots(q, k, v, bq, bk)
    ref = roofs._attention_dots_plain(q, k, v, bq, bk)
    torch.cuda.synchronize()
    name = f"attention_dots {what} [{bh}, {s}, {d}] blocks ({bq}, {bk})"
    err = check(name, o, ref)
    del ref
    check_bitwise(f"{name} run twice", (o,),
                  (roofs.attention_dots(q, k, v, bq, bk),))
    return err, (q, k, v)


def hmma_count(source: str = "attention_dots.cu") -> int:
    """Tensor-core instructions (``HMMA``) in the SASS of a built source's
    library, from ``cuobjdump -sass``."""
    tool = kernels._build.cuda_tool("cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(kernels._build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def time_hbm_copy(x) -> dict:
    y = torch.empty_like(x)
    ms = cold_ms(lambda: roofs.hbm_copy(x, y))
    plain_ms = cold_ms(lambda: roofs._hbm_copy_plain(x, None))
    lib_ms = cold_ms(lambda: y.copy_(x))    # a device-to-device memcpy
    nbytes = roofs.copy_bytes(x)
    bound_ms, bound_by = bound(nbytes, 0, torch.float32)
    log(f"  hbm_copy timing {list(x.shape)} fp32: kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e9:.3f} TB/s), plain (clone) {plain_ms:.4f}, "
        f"copy_ {lib_ms:.4f} ({nbytes / lib_ms / 1e9:.3f} TB/s), bound "
        f"{bound_ms:.4f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def time_dots(what, shape, q, k, v) -> dict:
    """K10 timed cold beside its plain version, its bound from the executed
    pairs, and cuBLAS's reading: two ``torch.bmm`` over the DENSE pair
    (more work than the kernel's: no tile is skipped, no scale)."""
    bh, s, d, bq, bk = shape
    ms = cold_ms(lambda: roofs.attention_dots(q, k, v, bq, bk))
    plain_ms = cold_ms(lambda: roofs._attention_dots_plain(q, k, v, bq, bk),
                       5, 1)
    lib_ms = cold_ms(lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v))
    pairs = bh * roofs.dots_pairs(s, bq, bk)
    executed = 4 * d * pairs
    bound_ms, bound_by = bound(4 * q.numel() * q.element_size(), executed)
    dense = 4 * bh * s * s * d
    log(f"  attention_dots timing {what} [{bh}, {s}, {d}] blocks ({bq}, "
        f"{bk}): kernel {ms:.4f} ms ({executed / ms / 1e9:.1f} TFLOP/s "
        f"executed, {roofs.dots_flops(bh, s, d) / ms / 1e9:.1f} under the "
        f"JAX count; {pairs / (bh * s * s):.4f} of the dense pairs), plain "
        f"{plain_ms:.4f}, two dense torch.bmm {lib_ms:.4f} "
        f"({dense / lib_ms / 1e9:.1f} TFLOP/s, {dense / executed:.2f}x the "
        f"work), bound {bound_ms:.4f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, executed_flops=executed,
                library_note="two torch.bmm over the dense pair, "
                             f"{dense / executed:.2f}x the kernel's work")


def phase_roofs(smi: str) -> dict:
    """K9 and K10 against their plain versions, K10's tensor-core
    instructions, K1/K2 and K6/K7 against theirs at the microbenches'
    shapes; then the main path, bench.py's kernel-microbench path, with
    exact launch counts; then the kernel rows, timed cold."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    err9, x = hbm_copy_checks(gen)
    cases = {what: dots_case(gen, what, shape) for what, shape in DOT_SHAPES}
    hmma = hmma_count()
    log(f"  attention_dots.cu SASS: {hmma} HMMA (tensor-core) instructions")
    if hmma == 0:
        raise AssertionError("attention_dots.cu runs no tensor-core "
                             "instruction")
    # the microbenches' kernels at shapes they have not run at elsewhere
    for bh, s, d in ((128, 1024, 64), (16, 4096, 128)):
        generic_case(gen, f"microbench causal [{bh}, 1, {s}, {d}] bf16", bf16,
                     s, s, b=bh, d=d, h=1, causal=True)
        torch.cuda.empty_cache()
    layer_norm_case(gen, "bf16 x [16384, 4096] (the LN microbench's)", bf16,
                    rows=microbench.LN_ROWS, cols=microbench.LN_COLS)
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    hbm = roofs.hbm_roof()
    mm = roofs.matmul_roof()
    att_s1024 = microbench.attention_kernel(128, 1024, 64, 512, 512,
                                            measure_floor=True)
    att_s4096 = microbench.attention_kernel(16, 4096, 128, 512, 512)
    lnk = microbench.layer_norm_kernel()
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    for att_k in (att_s1024, att_s4096):   # as bench.py::main adds them
        att_k.update(fwd_frac_of_roof=att_k["fwd_tflops"] / mm,
                     fwdbwd_frac_of_roof=att_k["fwdbwd_tflops"] / mm)
    calls = timing.WARM + timing.STEPS
    pingpongs = 2 * (timing.WARM + timing.ROOF_STEPS)  # two roofs, two copies
    want = {"hbm_copy": 2 * pingpongs, "attention_dots": calls,
            "flash_fwd": 2 * 3 * calls, "flash_bwd": 2 * calls,
            "layer_norm_fwd": 4 * calls, "layer_norm_bwd": 2 * calls}
    log(f"  hbm_roof {hbm:.1f} GB/s  [{smi}]")
    log(f"  matmul_roof {mm:.1f} TFLOP/s  [{smi}]")
    log(f"  attention_kernel(128, 1024, 64, 512, 512, measure_floor=True) "
        f"{json.dumps(att_s1024)}  [{smi}]")
    log(f"  attention_kernel(16, 4096, 128, 512, 512) "
        f"{json.dumps(att_s4096)}  [{smi}]")
    log(f"  layer_norm_kernel() {json.dumps(lnk)}  [{smi}]")
    log(f"  launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError("the microbench path's launch counts do not "
                             "match its calls")
    results = [hbm, mm, *att_s1024.values(), *att_s4096.values(),
               *lnk.values()]
    sane = (all(math.isfinite(r) and r > 0 for r in results)
            and hbm <= ROOF_SLACK * HBM_BYTES_PER_S / 1e9
            and lnk["adjacent_hbm_gb_s"] <= ROOF_SLACK * HBM_BYTES_PER_S / 1e9
            and mm <= ROOF_SLACK * PEAK_FLOPS[bf16] / 1e12
            and att_s1024["dot_floor_executed_tflops"]
            <= ROOF_SLACK * PEAK_FLOPS[bf16] / 1e12)
    if not sane:
        raise AssertionError("a roof, floor or rate is not finite and "
                             "positive, or exceeds the card's data sheet")

    rows = {"hbm_copy": time_hbm_copy(x)}
    del x
    torch.cuda.empty_cache()
    for what, shape in DOT_SHAPES:
        err, ops = cases.pop(what)
        rows[what] = time_dots(what, shape, *ops)
        rows[what]["max_abs_err"] = err
        del ops
        torch.cuda.empty_cache()
    rows["hbm_copy"]["max_abs_err"] = err9
    return {"rows": rows, "launches": launches, "hbm_roof_gb_s": hbm,
            "matmul_roof_tflops": mm, "flash_attention_s1024": att_s1024,
            "flash_attention_s4096": att_s4096, "layer_norm": lnk,
            "hmma": hmma, "card": smi}


# the attention rows at one of K10's shapes (DOT_SHAPES: the same bh, s
# and d)
FLOOR_OF = {"flash_qkv_fwd": "GPT-1.3B (K3/K4)",
            "flash_qkv_bwd": "GPT-1.3B (K3/K4)",
            "flash_fwd_mha": "Transformer-big encoder (K1/K2)",
            "flash_bwd": "Transformer-big encoder (K1/K2)"}


def demonstrated(timings: dict, probes: dict) -> dict:
    """Each kernel row's least time as demonstrated on this card in this
    run, beside its data-sheet bound: for an attention row at a K10 shape,
    the row's own flops (its visible pairs, 4 d each forward, 10 d
    backward) at the rate K10 reached on the pairs it executed there; for
    any other row bound by bytes, its bytes over the HBM roof
    (``hbm_roof``, K9).  A row bound by operations at no K10 shape gets
    none."""
    roof = probes["hbm_roof_gb_s"] * 1e9
    out = {}
    for name, t in {**timings, "hbm_copy": probes["rows"]["hbm_copy"]}.items():
        if name in FLOOR_OF:
            k10 = probes["rows"][FLOOR_OF[name]]
            work = t["flops"] / k10["executed_flops"]
            ms = work * k10["ms"]
            by = (f"dot floor x {work:.4f}, its flops over K10's executed "
                  f"({FLOOR_OF[name]})")
        elif t["bound_by"] == "bytes":
            ms = t["bound_ms"] * HBM_BYTES_PER_S / roof
            by = "bytes at hbm_roof"
        else:
            continue
        out[name] = dict(demonstrated_ms=ms, demonstrated_by=by,
                         share_of_demonstrated=ms / t["ms"])
        log(f"  {name}: {t['ms']:.4f} ms; demonstrated least time "
            f"{ms:.4f} ms ({by}): {ms / t['ms']:.1%} of it; data-sheet "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}): "
            f"{t['bound_ms'] / t['ms']:.1%}")
    return out


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
    torch.cuda.empty_cache()

    log("phase 8 toy multi-head attention stack, cuda vs cpu")
    phase_toy_mha()

    log("phase 9 full-width multi-head attention stack (Transformer-big, 6 + "
        "6 layers, bf16, batch 32 x 256 / 192)")
    mha = phase_mha(smi)
    torch.cuda.empty_cache()

    log("phase 10 toy training on the flat superblock, cuda vs cpu")
    phase_flat_toy()

    log("phase 11 full-width training on the flat superblock (GPT-1.3B, "
        "FlatFusedAdam)")
    flat = phase_flat_training(smi, train)
    torch.cuda.empty_cache()

    log("phase 12 roofs and floors: K9 (hbm_copy) and K10 (attention_dots), "
        "the kernel microbenches")
    probes = phase_roofs(smi)
    log("  each kernel row against what this card demonstrably reaches:")
    shares = demonstrated(timings, probes)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd.cu",
             replaces="apex_tpu/ops/attention.py:738",
             launches=metrics["launches"]["flash_fwd"],
             launches_mha=mha["launches"]["flash_fwd"],
             **timings["flash_fwd"]),
        dict(name="flash_bwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_bwd.cu",
             replaces="apex_tpu/ops/attention.py:1139",
             launches=mha["launches"]["flash_bwd"],
             **timings["flash_bwd"]),
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
    ] + [
        dict(name="flat_adam", route="cuda",
             source="apex_tpu_torch/csrc/flat_adam.cu",
             replaces="apex_tpu/optimizers/flat.py:161",
             launches=flat["launches"]["flat_adam"],
             **timings["flat_adam"]),
        dict(name="hbm_copy", route="cuda",
             source="apex_tpu_torch/csrc/hbm_copy.cu", replaces="bench.py:188",
             launches=probes["launches"]["hbm_copy"],
             **probes["rows"]["hbm_copy"]),
        dict(name="attention_dots", route="cuda",
             source="apex_tpu_torch/csrc/attention_dots.cu",
             replaces="bench.py:2671",
             launches=probes["launches"]["attention_dots"],
             **probes["rows"]["bench"]),
    ]}
    for entry in record["kernels"]:
        entry.update(shares.get(entry["name"], {}))
    record["kernels"][0].update({f"{k}_mha": v for k, v in
                                 shares["flash_fwd_mha"].items()})
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
