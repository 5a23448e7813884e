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
   parallel, one process per source); the tensor-core sources of K3/K4
   (``flash_qkv_*_sm90.cu``), K2 (``flash_bwd_sm90.cu``), K1
   (``flash_fwd_sm90.cu``) and K10 (``attention_dots_sm90.cu``) must show
   no spill or stack in ``ptxas -v``'s report and hold ``HGMMA`` (wgmma)
   and ``UTMALDG`` (TMA loads) in their SASS (ptxas's performance
   advisories, such as serialized wgmma, are printed); K6/K7's
   ``layer_norm_sm90.cu``, whose rows and dgamma/dbeta sums live in
   registers, must show no spill or stack either, nor K5's
   ``flash_decode_sm90.cu``, whose SASS must hold 16-byte global loads
   (``LDG.E.128``);
3. kernels — each kernel against its plain PyTorch version on the card,
   at its main path's shapes (bf16; the training kernels with and without
   dropout) and in fp32, with the tolerance stated; then timed (operands
   cold in L2) beside its plain version, one PyTorch library call
   computing the same function, and its bound.  K5 (paged decode) routes
   by pool: the bf16, int8 and fp8 pools at head dim 128 to
   ``flash_decode_sm90.cu`` (one entry point a pool), the fp32 pool to
   ``flash_decode.cu``; each pool is held to the plain version at q_len
   1, 5 (windows shorter than q_len: exact zeros) and 20 over ragged
   lengths (the fp32 pool at q_len 1 and 5), each case naming the entry
   point that ran, ``flash_decode_sm90.cu``'s run twice (bitwise), then
   timed cold at the ragged batch, 8 x 300 and 8 x 1024 (16 pages a
   request); ``flash_decode.cu`` is also called directly on the bf16
   pool at the three q_len and at each timed shape, held to the plain
   version there and timed cold and in turns beside
   ``flash_decode_sm90.cu``; the card's ``quantize_tokens`` must give the CPU's codes
   and scales bit for bit.  K3/K4 route by dtype:
   bf16 to the tensor-core kernels, held to their plain versions causal
   and not, with segment ids, and at a ragged s = 1000, run twice
   (bitwise), with K4's tiles walked against :func:`flash_bwd_tiles` at
   its own tiles; fp32 to the scalar kernels.  The scalar kernels' bf16
   instances are timed against the tensor-core ones, cold and in turns
   (``timed_pair``).  The generic attention kernels (K1 and K2, whose bf16
   routes at head dims 64 and 128 are the tensor-core
   ``flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu`` and whose fp32 and
   head dim 8 routes are the scalar ``flash_fwd.cu`` and
   ``flash_bwd.cu``; each case names the kernel that ran) are checked at
   the prefill's shape and at the
   multi-head attention path's three shapes, with each feature alone and
   combined at head dims 8, 64 and 128 in both dtypes, causal with sq <
   sk and sq > sk, an all-padded batch row (exact zeros) in both dtypes,
   an additive mask that hides every key of a batch row at a ragged key
   length, causal with a -300 mask hiding every key of a batch row (the
   tensor-core K1's FMA-chain path for mask-dominated rows), a
   zero-stride mask against the same mask materialised, K1 and
   K2 run twice (bitwise: the prefill, the encoder and the decoder's mask
   shapes), the tiles each walks against the plain statement of its skip
   rule at its route's tiles (:func:`flash_fwd_tiles`,
   :func:`flash_bwd_tiles`), and ``flash_attention_varlen`` on a
   BERT-large-shaped packed batch; K1's (at the prefill and encoder
   shapes) and K2's (encoder) scalar bf16 instances are timed against
   the tensor-core ones, cold and in turns.  K6/K7 (LayerNorm) route by
   width: fp32 and bf16 at 1024, 2048 and 4096 columns to
   ``layer_norm_sm90.cu``, other widths to ``layer_norm.cu``; each case
   names the kernels that ran and is held to the plain versions (y, mean,
   invvar, dx, dweight, dbias) at the GPT-1.3B shape in bf16 and fp32,
   the MHA decoder's rows, a ragged row count, no weight or bias, fp32 at
   4096 with ragged rows and bf16 at 1536 (the old route), the new route's
   cases run twice (bitwise); the two routes are timed against each
   other at the GPT-1.3B shape, cold and in turns.  K8 (``flat_adam``) runs
   over the GPT-1.3B superblock (its init weights) and must give its plain version's bits for p, m and v over 3
   steps in four variants (AdamW decay 0.01, L2 decay 0.05, decay 0, no
   bias correction); a ``plan_buckets`` walk and a hand-built 3-span walk
   must give the single launch's bits; a step must run under
   ``set_sync_debug_mode("error")``; padding of a ragged superblock stays
   exactly 0; it is timed beside ``torch._fused_adamw_``;
4. toy engine — the same weights served at toy width in fp32 on the card
   (kernels) and on the CPU (plain versions) give identical greedy
   streams, the attention on the scalar K1 (its fp32 route);
5. full-width engine — GPT-1.3B width (hidden 2048, 16 heads of 128, 24
   layers, vocab 51200, bf16, page 64, batch 8), on the bf16 pool and on
   the quantized ones (``kv_quant="int8"``, ``"fp8"``): ``warmup()`` then
   ``serve()`` of a seeded Poisson trace; every request finishes, the
   pool drains, the kernels' launch counts match the main path's
   prefills (the tensor-core K1) and decode steps (the pool's
   ``flash_decode_sm90`` entry point, ``flash_decode.cu`` never)
   exactly, the kernel path's prefill (bf16) and full-batch decode
   logits agree with the plain path's, and batched == sequential == a
   re-run at equal ``max_batch``, bitwise (the quantized streams are not
   held to the bf16 ones); a full-batch decode step's host-enqueue and
   device-done times and its device time by part under
   ``torch.profiler`` are reported beside the serve metrics;
6. toy training — ``pretrain_gpt.main`` at fp32, 2 layers, hidden 256,
   from the same weights and batches on the card (kernels) and on the CPU
   (plain versions): per-step losses and final weights agree, and the
   fp32 attention ran the scalar K3/K4 (their fp32 route);
7. full-width training — ``pretrain_gpt.main`` with the GPT-1.3B flags
   (24 layers, hidden 2048, 16 heads of 128, seq 2048, batch 4, bf16,
   default dropouts, clip and decay, remat ``attn_res``): 10 finite
   steps, step 1's loss near ln(vocab) + 0.41 (the init's logit variance
   0.02^2 x 2048, halved), exact launch counts of the four
   training kernels (K3/K4 the tensor-core ones, K6/K7
   ``layer_norm_sm90.cu``'s; the scalar K3/K4 and ``layer_norm.cu``
   never);
   then on a fixed batch the loss falls over 5 steps,
   one dropout-free step through the kernels agrees with the same step
   through the plain versions, and one step run twice from the same state
   gives bitwise-equal loss and weights; step time, tokens/s, model
   TFLOP/s, peak memory and a step's host-enqueue vs device-done time are
   reported, and one step's device time by kind, with the kernels no kind
   names split by the ATen op that launched them (also in phases 9 and
   11);
8. toy multi-head attention — the encoder-decoder stack of
   ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` at toy width (4 heads
   of 8), fp32, five ``FusedAdam`` steps from the same weights on the card
   and on the CPU: losses and final weights agree, the weights moved, and
   K1 and K2 ran their scalar routes (fp32);
9. full-width multi-head attention — the same stack at Transformer-big
   width (d_model 1024, 16 heads of 64, 6 encoder and 6 decoder layers,
   dropout 0.1, bias, pre-norm), 32 sentence pairs padded to 256 / 192,
   bf16 with fp32 masters, MSE against a fixed target, ``FusedAdam``:
   exact launch counts (K1 = K2 = K6 = K7 = 18 a step, K1 and K2 the
   tensor-core kernels and the scalar ones never, K6 and K7
   ``layer_norm_sm90.cu``'s and ``layer_norm.cu``'s never), the loss falls
   over 5 steps, a dropout-free step through the kernels agrees with the
   plain path (loss, grad norm, worst leaf) at the seeded initial weights
   and again at the weights six training steps leave, a step run twice
   is bitwise equal; step time, tokens/s,
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
    (``attention_dots``, its route ``attention_dots_sm90.cu``) within
    ``tolerance`` of its plain version and bitwise across two runs at
    bench.py's (128, 1024, 64, blocks 512), GPT-1.3B's (64, 2048, 128,
    blocks 64) and Transformer-big's encoder (512, 256, 64, blocks 64)
    shapes, and at q tails (s = 192 and 320, blocks 64) and unequal
    blocks ((64, 128), (128, 64)) at head dims 64 and 128, the 64 x 64
    sub-tiles each block multiplied equal to its walk
    (:func:`roofs.dots_walk`) and to the rule's pairs / 4096; the route
    before it, ``attention_dots.cu`` (``mma.sync``, called through its
    ``Kernel``), within ``tolerance`` at the three shapes and its ``HMMA``
    count in the SASS (``cuobjdump``), which must not be 0; K1/K2 and
    K6/K7 against their plain versions at the microbenches' shapes.  Then
    the main path, the port of bench.py's kernel-microbench path:
    ``hbm_roof``, ``matmul_roof``,
    ``attention_kernel`` at bench.py's two shapes (the first with the dot
    floor) and ``layer_norm_kernel``, each printed with the card, with
    exact launch counts (``attention_dots_sm90`` only, ``attention_dots``
    never); then K9 and K10 timed cold beside their plain versions,
    ``copy_`` and two dense ``torch.bmm``, K10's two routes also in turns
    (``timed_pair``) at the three shapes; last, every kernel row read
    against what the card demonstrably reaches (the HBM roof, or the dot
    floor at its shape; attention rows also at ``matmul_roof``'s rate).

The last three lines of standard output are the kernels' JSON record,
the ``nvidia-smi`` name/power line, and ``{"ok": true, "device": ...}``.
A failure prints ``chip_smoke: FAILED in phase N (<name>): <type>:
<message>`` and the traceback on standard error, and the run exits 1.
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
import traceback
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
                                    SimClock, init_params, poisson_trace,
                                    quant_pool_dtype, quantize_tokens)

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


def launched(fn):
    """(``fn()``, the symbols of the kernels it launched)."""
    before = {k.symbol: k.launches for k in kernels.KERNELS}
    out = fn()
    return out, [k.symbol for k in kernels.KERNELS
                 if k.launches != before[k.symbol]]


def flash_fwd_case(gen, name, dtype, lengths):
    """K1 at the prefill's shape through ``flash_attention_fwd`` against
    its plain version, naming the kernel that ran (bf16 at head dim 128:
    ``flash_fwd_sm90``; fp32: the scalar ``flash_fwd``); on the tensor
    cores also run again (bitwise) counting its tiles walked, against
    :func:`flash_fwd_tiles`."""
    q, k, v, seg = prefill_operands(gen, dtype, lengths)
    b, h, s, d = q.shape
    (o, lse), ran = launched(lambda: att.flash_attention_fwd(
        q, k, v, causal=True, segment_ids=seg))
    ro, rlse = att._blockwise_fwd(
        q.reshape(b * h, s, d), k.reshape(b * h, s, d),
        v.reshape(b * h, s, d), 1 / math.sqrt(d), True, None, seg, seg)
    torch.cuda.synchronize()
    err = check(f"{ran[0]} {name} o", o, ro.view(b, h, s, d))
    lerr = (lse - rlse).abs().max().item()
    log(f"  {ran[0]} {name} lse: max_abs_diff {lerr:.3e}  tol 1e-4  "
        f"{'ok' if lerr <= 1e-4 else 'FAIL'}")
    if not lerr <= 1e-4:
        raise AssertionError(f"{ran[0]} {name}: lse disagrees ({lerr:.3e})")
    if att._fwd_on_tensor_cores(q):
        visits = fwd_visits(q)
        again = att._flash_fwd_cuda(q, k, v, None, seg, seg, 1 / math.sqrt(d),
                                    True, 0.0, 0, visits=visits)
        check_bitwise(f"{ran[0]} {name} run twice", (o, lse), again)
        check_fwd_visits(f"{ran[0]} {name}", visits, seg, seg, s, s, True,
                         b * h)
    return err, (q, k, v, seg)


def scalar_fwd(fn):
    """``fn`` with K1 routed to its scalar kernel (``flash_fwd.cu``, the
    bf16 route before ``flash_fwd_sm90.cu``)."""
    def old():
        with mock.patch.object(att, "_fwd_on_tensor_cores", lambda t: False):
            return fn()
    return old


def time_flash_fwd(dtype, q, k, v, seg) -> tuple:
    """K1 at the prefill's shape (the tensor-core kernel, through
    ``flash_attention_fwd``) timed cold beside its plain version, SDPA
    and its bound; the scalar kernel it replaced on bf16 timed cold too,
    and the two in turns (a, b, b, a) in this one call
    (``timing.timed_pair``).  Returns (tensor-core row, scalar row)."""
    b, h, s, d = q.shape
    scale = 1 / math.sqrt(d)
    new = lambda: att.flash_attention_fwd(  # noqa: E731
        q, k, v, causal=True, segment_ids=seg)
    old = scalar_fwd(new)
    ms = cold_ms(new)
    old_ms = cold_ms(old, 10)
    pair = timing.timed_pair(old, new, (), ())
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
    bq, bk = att.flash_fwd_tiles_of(q)
    walk = flash_fwd_tiles(seg, seg, s, s, True, bq, bk)
    n_tiles = int((walk[..., 1] - walk[..., 0]).sum())
    log(f"  flash_fwd_sm90 timing [{b},{h},{s},{d}] {dtype}: kernel "
        f"{ms:.4f} ms (scalar flash_fwd {old_ms:.4f}: {old_ms / ms:.2f}x), "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); {bq}x{bk} tiles walked per head "
        f"{n_tiles}")
    log(f"  in turns (timed_pair, warm): scalar {pair[0]:.4f} ms vs "
        f"tensor-core {pair[1]:.4f} ms ({pair[0] / pair[1]:.2f}x)")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, warm_pair_ms=pair[1])
    return row, {**row, "ms": old_ms, "warm_pair_ms": pair[0]}


# the decode step's pools, each with the flash_decode_sm90.cu entry point
# it runs: the default bf16 pool and the quantized ones (kv_quant)
DECODE_POOLS = (("bf16", None, "flash_decode_sm90"),
                ("int8", "int8", "flash_decode_sm90_int8"),
                ("fp8", "fp8", "flash_decode_sm90_fp8"))
# K5's timed shapes (name, kv lengths, pages a request): the ragged batch,
# a full batch mid-trace, and a full batch at FULL's max_position
DECODE_RAGGED = [1, 2, 63, 64, 65, 200, 320, 3]
DECODE_SHAPES = (("ragged", DECODE_RAGGED, PAGES_PER_REQ),
                 ("8x300", [300] * BATCH, PAGES_PER_REQ),
                 ("8x1024", [1024] * BATCH, FULL["max_position"] // PAGE))


def decode_operands(gen, dtype, q_len, lengths, b=BATCH, h=16, d=128,
                    page_size=PAGE, p_max=PAGES_PER_REQ, quant=None):
    """(q, k_pages, v_pages, table, kv_len, k_scale, v_scale) as the decode
    step hands them in: q a view of a fused qkv projection, a pool of
    random K/V in ``dtype`` or, with ``quant``, quantized by the port's
    ``quantize_tokens`` (codes and fp32 scales; the scales are None for an
    unquantized pool), a shuffled page table."""
    n_pages = 1 + b * p_max
    kp = torch.randn(n_pages, page_size, h, d, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn(n_pages, page_size, h, d, generator=gen,
                     device="cuda").to(dtype)
    ks = vs = None
    if quant:
        codes = quant_pool_dtype(quant)
        kp, ks = quantize_tokens(kp, codes, model_mod.quant_qmax(codes))
        vp, vs = quantize_tokens(vp, codes, model_mod.quant_qmax(codes))
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
    return q, kp, vp, table.cuda(), kv_len, ks, vs


def decode_plain(q, kp, vp, table, kv_len, ks, vs):
    return att._paged_attention(q, kp, vp, table, kv_len,
                                1 / math.sqrt(q.shape[-1]), ks, vs)


def flash_decode_case(gen, name, dtype, q_len, lengths, quant=None,
                      scalar=False):
    """K5 through ``flash_decode`` (with ``scalar``, ``flash_decode.cu``
    called directly, as on a bf16 pool before ``flash_decode_sm90.cu``)
    against its plain version, naming the entry point that ran;
    ``flash_decode_sm90.cu``'s run again (bitwise).  Returns (max error,
    operands, the entry point)."""
    ops = decode_operands(gen, dtype, q_len, lengths, quant=quant)
    q, kp, vp, table, kv_len, ks, vs = ops

    def run():
        if scalar:
            return att._flash_decode_cuda(q, kp, vp, table, kv_len,
                                          1 / math.sqrt(q.shape[-1]))
        return att.flash_decode(q, kp, vp, table, kv_len, k_scale=ks,
                                v_scale=vs)

    o, ran = launched(run)
    ro = decode_plain(*ops)
    torch.cuda.synchronize()
    err = check(f"{ran[0]} {name}", o, ro)
    for i, n in enumerate(lengths):
        for r in range(q_len):
            if n - q_len + r < 0 and not bool((o[i, :, r] == 0).all()):
                raise AssertionError(
                    f"{ran[0]} {name}: row {r} of request {i} "
                    f"(kv_len {n} < q_len {q_len}) is not exact zeros")
    if ran[0] != "flash_decode":
        check_bitwise(f"{ran[0]} {name} run twice", (o,), (run(),))
    return err, ops, ran[0]


def time_flash_decode(name, ops) -> dict:
    """K5 at one shape, cold: the kernel ``flash_decode`` runs for this
    pool, its plain version, a page gather + SDPA (the codes dequantized
    to q's dtype first) and the bound: the live pages' rows (codes and
    scales) read once, q in, o out, the table and lengths in.  On a bf16
    pool ``flash_decode.cu``, the route before ``flash_decode_sm90.cu``,
    is held to the plain version on the same operands and timed cold too,
    and the two in turns (``timing.timed_pair``)."""
    q, kp, vp, table, kv_len, ks, vs = ops
    b, h, q_len, d = q.shape
    page_size, p_max = kp.shape[1], table.shape[1]

    def new():
        return att.flash_decode(q, kp, vp, table, kv_len, k_scale=ks,
                                v_scale=vs)

    ms = cold_ms(new, 50)
    plain_ms = cold_ms(lambda: decode_plain(*ops), 50)
    cols = torch.arange(p_max * page_size, device="cuda")
    rows = torch.arange(q_len, device="cuda")[:, None]
    visible = cols <= (kv_len.long() - q_len)[:, None, None, None] + rows

    def library():
        idx = table.long()
        kc, vc = att._gather_pages(kp, idx), att._gather_pages(vp, idx)
        if ks is not None:
            kc = (kc.float() * ks[idx][..., None]).to(q.dtype)
            vc = (vc.float() * vs[idx][..., None]).to(q.dtype)
        kc = kc.reshape(b, -1, h, d).transpose(1, 2)
        vc = vc.reshape(b, -1, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=visible)

    lib_ms = cold_ms(library, 50)
    reach = p_max * page_size
    live_cols = sum(min(int(n), reach) for n in kv_len.tolist())
    seen = sum(max(0, min(int(n) - q_len + r + 1, reach))
               for n in kv_len.tolist() for r in range(q_len))
    nbytes = (2 * live_cols * h * d * kp.element_size()
              + 2 * b * h * q_len * d * q.element_size()
              + table.numel() * 4 + b * 4)
    flops = 4 * d * h * seen
    op_dtype = q.dtype
    if ks is not None:
        # the scales, and the dequantizing products, in fp32
        nbytes += 2 * live_cols * h * 4
        flops += 2 * d * h * live_cols
        op_dtype = torch.float32
    bound_ms, bound_by = bound(nbytes, flops, op_dtype)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    old = ""
    if ks is None:
        scale = 1 / math.sqrt(d)

        def scalar():
            return att._flash_decode_cuda(q, kp, vp, table, kv_len, scale)

        old_err = check(f"flash_decode on the {name} operands", scalar(),
                        decode_plain(*ops))
        pair = timing.timed_pair(scalar, new, (), ())
        row.update(old_ms=cold_ms(scalar, 50), old_warm_pair_ms=pair[0],
                   warm_pair_ms=pair[1], old_max_abs_err=old_err)
        old = (f"; flash_decode.cu {row['old_ms']:.4f} ms cold; in turns, "
               f"warm: flash_decode.cu {pair[0]:.4f} vs {pair[1]:.4f} ms")
    log(f"  {name} timing [{b},{h},{q_len},{d}] {kp.dtype} kv_len "
        f"{kv_len.tolist()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"gather+sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}): {bound_ms / ms:.1%} of it" + old)
    return row


# K5's checked q_len: the decode step's, windows shorter than q_len, and
# two of flash_decode.cu's 16-row tiles
DECODE_Q_LENS = ((1, ""), (5, " (kv_len < q_len rows)"),
                 (20, " (two 16-row tiles)"))


def phase_decode_kernels(gen) -> dict:
    """K5 on each pool: held to its plain version at :data:`DECODE_Q_LENS`
    over the ragged lengths, then timed at :data:`DECODE_SHAPES`;
    ``flash_decode.cu``, the fp32 pool's route, held to it on the fp32
    pool at q_len 1 and 5 and, called directly, on the bf16 pool at every
    q_len, then timed on bf16 as the kernel ``flash_decode_sm90.cu``
    replaced there; the card's ``quantize_tokens`` against the CPU's."""
    bf16 = torch.bfloat16
    out = {}
    for pool, quant, name in DECODE_POOLS:
        cases = [flash_decode_case(gen, f"{pool} pool q_len={q_len}{what}",
                                   bf16, q_len, DECODE_RAGGED, quant)
                 for q_len, what in DECODE_Q_LENS]
        if any(ran != name for _, _, ran in cases):
            raise AssertionError(f"the {pool} pool did not run {name}")
        shapes = {shape: time_flash_decode(
            f"{name} {shape}", cases[0][1] if shape == "ragged" else
            decode_operands(gen, bf16, 1, lengths, p_max=p_max, quant=quant))
            for shape, lengths, p_max in DECODE_SHAPES}
        out[name] = dict(shapes["ragged"], max_abs_err=max(
            e for e, _, _ in cases), shapes=shapes)
    scalar = [flash_decode_case(gen, f"fp32 pool q_len={q_len}{what}",
                                torch.float32, q_len, DECODE_RAGGED)
              for q_len, what in DECODE_Q_LENS[:2]]
    scalar += [flash_decode_case(gen, f"bf16 pool q_len={q_len}{what}",
                                 bf16, q_len, DECODE_RAGGED, scalar=True)
               for q_len, what in DECODE_Q_LENS]
    if any(ran != "flash_decode" for _, _, ran in scalar):
        raise AssertionError("the fp32 pool or the direct call did not run "
                             "flash_decode")
    # the record's numbers from the bf16 run that is timed
    sm90 = out["flash_decode_sm90"]
    new = {k: v for k, v in sm90.items() if not k.startswith("old_")}
    out["flash_decode"] = dict(
        new, ms=sm90["old_ms"], max_abs_err=sm90["old_max_abs_err"],
        warm_pair_ms=sm90["old_warm_pair_ms"],
        cases_max_abs_err=max(e for e, _, _ in scalar),
        shapes={k: dict(v, ms=v["old_ms"], max_abs_err=v["old_max_abs_err"])
                for k, v in sm90["shapes"].items()})
    quantize_card_vs_cpu(gen)
    return out


def quantize_card_vs_cpu(gen, tokens=4096) -> None:
    """``quantize_tokens`` on the card against the CPU, bit for bit, codes
    and scales, on one seeded [tokens, 16, 128] input over six decades."""
    x = torch.randn(tokens, 16, 128, generator=gen, device="cuda") * 10.0 ** (
        torch.rand(tokens, 16, 1, generator=gen, device="cuda") * 6 - 3)
    for mode in ("int8", "fp8"):
        codes = quant_pool_dtype(mode)
        qmax = model_mod.quant_qmax(codes)
        c, sc = quantize_tokens(x, codes, qmax)
        cc, csc = quantize_tokens(x.cpu(), codes, qmax)
        same = (torch.equal(c.view(torch.uint8).cpu(), cc.view(torch.uint8))
                and torch.equal(sc.cpu().view(torch.int32),
                                csc.view(torch.int32)))
        log(f"  quantize_tokens {mode} [{tokens}, 16, 128], card vs CPU: "
            f"bitwise equal {same}")
        if not same:
            raise AssertionError(f"quantize_tokens {mode}: the card's codes "
                                 "or scales differ from the CPU's")


# the training main path's attention and LayerNorm shapes (GPT-1.3B,
# pretrain_gpt at micro-batch 4, seq 2048)
TRAIN = dict(b=4, s=2048, heads=16, d=128, hidden=2048)
ATT_DROPOUT = 0.1            # arguments.py's default, on the main path
# absolute, fp32 log-sum-exp near 8; raised elementwise to one fp32
# spacing at |ref| where that is larger (rows an additive mask hides
# whole, lse near -1e4, spacing 2^-10): scripts/lse_masked_rows.py, 150
# draws a head dim on an NVIDIA H100 80GB HBM3 at 700 W, read every miss
# of 1e-4 there as exactly one spacing (flash_fwd_sm90 9 rows at d 64, 8
# at d 128; the scalar flash_fwd 6 and 6)
LSE_TOL = 1e-4
RATE_SEED = 1234


def fp32_spacing(t: torch.Tensor) -> torch.Tensor:
    """The gap from |t| to the next float32 above it, elementwise."""
    a = t.float().abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def check_lse(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    gap = (got - ref).abs()
    tol = torch.clamp(fp32_spacing(ref), min=LSE_TOL)
    err, worst = gap.max().item(), (gap / tol).max().item()
    ok = worst <= 1.0
    log(f"  {name}: max_abs_diff {err:.3e}  tol max({LSE_TOL:.0e}, one fp32 "
        f"spacing at |ref|): worst gap {worst:.3f} of its bar  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees ({err:.3e}, {worst:.3f} "
                             "of its bar)")


def qkv_operands(gen, dtype, b=TRAIN["b"], s=TRAIN["s"]):
    h, d = TRAIN["heads"], TRAIN["d"]
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    dctx = torch.randn(b, s, h * d, generator=gen, device="cuda").to(dtype)
    return qkv, dctx


def sm90_visits_want(seg, b, s, causal):
    """The tiles ``flash_qkv_bwd_sm90.cu`` walks, from the plain statement
    of its skip rule (:func:`flash_bwd_tiles` at its two passes' tiles,
    ``att.QKV_SM90_BWD_TILES``), in the layout of its ``visits``: the dk/dv
    pass's blocks, then the dq pass's, each [b*h, n_blocks] flattened."""
    h = TRAIN["heads"]
    seg_q = seg_k = seg
    (bq2, bk2), (bq3, bk3) = (att.QKV_SM90_BWD_TILES[k] for k in ("dkdv",
                                                                   "dq"))
    kv = flash_bwd_tiles(seg_q, seg_k, s, s, causal, bq2, bk2)[0]
    q = flash_bwd_tiles(seg_q, seg_k, s, s, causal, bq3, bk3)[1]
    per = [(r[..., 1] - r[..., 0]) for r in (kv, q)]
    return torch.cat([w.repeat_interleave(b * h // w.shape[0], 0).flatten()
                      for w in per])


def flash_qkv_case(gen, name, dtype, rate, b=TRAIN["b"], s=TRAIN["s"],
                   seg=None, causal=True):
    """K3 and K4 against their plain versions; for bf16 (the tensor-core
    kernels) also K4's tiles walked against the plain statement of its
    skip rule and K3 and K4 run twice (bitwise).  Returns (K3 error, K4
    error, operands)."""
    qkv, dctx = qkv_operands(gen, dtype, b, s)
    h = TRAIN["heads"]
    args = (seg, seg, h, TRAIN["d"] ** -0.5, causal, rate, RATE_SEED)
    ctx, lse = att._flash_qkv_fwd_cuda(qkv, *args)
    rctx, rlse = att._flash_qkv_fwd_plain(qkv, *args)
    torch.cuda.synchronize()
    e3 = check(f"flash_qkv_fwd {name} ctx", ctx, rctx)
    check_lse(f"flash_qkv_fwd {name} lse", lse, rlse)
    del rctx, rlse
    visits = None
    if dtype == torch.bfloat16:
        want = sm90_visits_want(seg, b, s, causal)
        visits = torch.full((want.numel(),), -1, dtype=torch.int32,
                            device="cuda")
    dqkv = att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse, *args, visits=visits)
    rdqkv = att._flash_qkv_bwd_plain(qkv, dctx, ctx, lse, *args)
    torch.cuda.synchronize()
    e4 = check(f"flash_qkv_bwd {name} dqkv", dqkv, rdqkv)
    del rdqkv
    if visits is not None:
        got = visits.cpu().long()
        n_kv = b * h * -(-s // att.QKV_SM90_BWD_TILES["dkdv"][1])
        log(f"  flash_qkv_bwd {name} tiles walked: dk/dv "
            f"{int(got[:n_kv].sum())}, dq {int(got[n_kv:].sum())}; the plain "
            f"rule's {int(want[:n_kv].sum())}, {int(want[n_kv:].sum())}: "
            f"{'ok' if torch.equal(got, want) else 'FAIL'}")
        if not torch.equal(got, want):
            raise AssertionError(f"flash_qkv_bwd {name}: tiles walked differ "
                                 "from flash_bwd_tiles")
        again = att._flash_qkv_fwd_cuda(qkv, *args)
        check_bitwise(f"flash_qkv_fwd {name} run twice", (ctx, lse), again)
        check_bitwise(f"flash_qkv_bwd {name} run twice", (dqkv,),
                      (att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse, *args),))
    torch.cuda.empty_cache()
    return e3, e4, (qkv, dctx, ctx, lse)


def scalar_qkv(qkv, dctx, ctx, lse, rate):
    """Calls of the scalar kernels' bf16 instances (``flash_qkv_fwd.cu``,
    ``flash_qkv_bwd.cu``, the bf16 route before the tensor-core kernels)
    straight through their ``Kernel`` objects: the wrappers send bf16 to
    the tensor-core kernels only.  Returns (forward, backward) callables."""
    b, s, _ = qkv.shape
    h, d = TRAIN["heads"], TRAIN["d"]
    seed, thresh, keep, inv = att._dropout_launch_args(rate, RATE_SEED)
    out, out_lse = torch.empty_like(ctx), torch.empty_like(lse)
    delta, dqkv = torch.empty_like(lse), torch.empty_like(qkv)
    code, dev = kernels.DTYPE_CODES[qkv.dtype], qkv.device.index

    def fwd():
        kernels.FLASH_QKV_FWD(
            code, d, dev, qkv.data_ptr(), out.data_ptr(), out_lse.data_ptr(),
            None, None, 1, b, h, s, d ** -0.5, 1, seed, thresh, keep,
            torch.cuda.current_stream().cuda_stream)

    def bwd():
        kernels.FLASH_QKV_BWD(
            code, d, dev, qkv.data_ptr(), dctx.data_ptr(), ctx.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), None, None, 1,
            b, h, s, d ** -0.5, 1, seed, thresh, inv,
            torch.cuda.current_stream().cuda_stream)

    return fwd, bwd


def time_flash_qkv(qkv, dctx, ctx, lse, rate) -> tuple:
    """K3 and K4 (the tensor-core kernels, through the wrappers) timed cold
    beside their plain versions, SDPA and the scalar kernels they replace
    on bf16 (cold too); then the scalar and the tensor-core kernel of each
    in turns (a, b, b, a) in this one call (``timing.timed_pair``)."""
    b, s, _ = qkv.shape
    h, d = TRAIN["heads"], TRAIN["d"]
    args = (None, None, h, d ** -0.5, True, rate, RATE_SEED)
    new_fwd = lambda: att._flash_qkv_fwd_cuda(qkv, *args)  # noqa: E731
    new_bwd = lambda: att._flash_qkv_bwd_cuda(  # noqa: E731
        qkv, dctx, ctx, lse, *args)
    old_fwd, old_bwd = scalar_qkv(qkv, dctx, ctx, lse, rate)
    fwd_ms = cold_ms(new_fwd, 10)
    fwd_old = cold_ms(old_fwd, 5, 1)
    fwd_plain = cold_ms(lambda: att._flash_qkv_fwd_plain(qkv, *args), 5, 1)
    bwd_ms = cold_ms(new_bwd, 10)
    bwd_old = cold_ms(old_bwd, 5, 1)
    bwd_plain = cold_ms(lambda: att._flash_qkv_bwd_plain(
        qkv, dctx, ctx, lse, *args), 5, 1)
    pair_fwd = timing.timed_pair(old_fwd, new_fwd, (), ())
    pair_bwd = timing.timed_pair(old_bwd, new_bwd, (), ())
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
        f" fwd kernel {fwd_ms:.4f} ms (scalar {fwd_old:.4f}: "
        f"{fwd_old / fwd_ms:.2f}x), plain {fwd_plain:.4f}, sdpa "
        f"{fwd_lib:.4f}, bound {fb:.4f} ({fby}); bwd kernel {bwd_ms:.4f} ms "
        f"(scalar {bwd_old:.4f}: {bwd_old / bwd_ms:.2f}x), plain "
        f"{bwd_plain:.4f}, sdpa backward {bwd_lib:.4f}, bound {bb:.4f} "
        f"({bby})")
    log(f"  in turns (timed_pair, warm): fwd scalar {pair_fwd[0]:.4f} ms vs "
        f"tensor-core {pair_fwd[1]:.4f} ms ({pair_fwd[0] / pair_fwd[1]:.2f}x);"
        f" bwd scalar {pair_bwd[0]:.4f} vs {pair_bwd[1]:.4f} "
        f"({pair_bwd[0] / pair_bwd[1]:.2f}x)")
    fwd = dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
               bound_ms=fb, bound_by=fby, flops=4 * d * pairs)
    bwd = dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
               bound_ms=bb, bound_by=bby, flops=10 * d * pairs)
    scalar = ({**fwd, "ms": fwd_old, "warm_pair_ms": pair_fwd[0]},
              {**bwd, "ms": bwd_old, "warm_pair_ms": pair_bwd[0]})
    fwd["warm_pair_ms"], bwd["warm_pair_ms"] = pair_fwd[1], pair_bwd[1]
    return fwd, bwd, scalar


def layer_norm_case(gen, name, dtype, rows=TRAIN["b"] * TRAIN["s"],
                    cols=TRAIN["hidden"], affine=True):
    """K6 and K7 against their plain versions (fp32 weights, as the
    main path's masters are), naming the kernels that ran; on the
    ``layer_norm_sm90.cu`` route both run again (bitwise)."""
    x = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(cols, generator=gen, device="cuda")
    b = 0.1 * torch.randn(cols, generator=gen, device="cuda")
    if not affine:
        w = b = None
    (y, mean, invvar), ran6 = launched(lambda: ln._ln_fwd_cuda(x, w, b,
                                                               1e-5))
    ry, rmean, rinvvar = ln._ln_fwd_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    route = ln._ln_route(dtype, cols)
    want = (["layer_norm_fwd_sm90"] if route == "sm90"
            else ["layer_norm_fwd"])
    log(f"  {name} [{rows}, {cols}]: route {route}, ran {ran6}")
    if ran6 != want:
        raise AssertionError(f"layer_norm {name}: ran {ran6}, expected "
                             f"{want}")
    e6 = check(f"{ran6[0]} {name} y", y, ry)
    check(f"{ran6[0]} {name} mean", mean, rmean)
    check(f"{ran6[0]} {name} invvar", invvar, rinvvar)
    (dx, dw, db), ran7 = launched(lambda: ln._ln_bwd_cuda(
        x, dy, mean, invvar, w, affine))
    rdx, rdw, rdb = ln._ln_bwd_plain(x, dy, mean, invvar, w, affine)
    torch.cuda.synchronize()
    if ran7 != [k.replace("fwd", "bwd") for k in want]:
        raise AssertionError(f"layer_norm {name}: backward ran {ran7}")
    e7 = check(f"{ran7[0]} {name} dx", dx, rdx)
    if affine:
        check(f"{ran7[0]} {name} dweight", dw, rdw)
        check(f"{ran7[0]} {name} dbias", db, rdb)
    elif dw is not None or db is not None:
        raise AssertionError(f"layer_norm {name}: gradients of no weight")
    if route == "sm90":
        check_bitwise(f"{ran6[0]} {name} run twice", (y, mean, invvar),
                      ln._ln_fwd_cuda(x, w, b, 1e-5))
        again = ln._ln_bwd_cuda(x, dy, mean, invvar, w, affine)
        check_bitwise(f"{ran7[0]} {name} run twice",
                      [t for t in (dx, dw, db) if t is not None],
                      [t for t in again if t is not None])
    return e6, e7, (x, dy, w, b, mean, invvar)


def ln_kernel_calls(kernel_fwd, kernel_bwd, x, dy, w, b, mean, invvar):
    """Calls of one route's two kernels straight through their ``Kernel``
    objects on preallocated outputs (the wrappers pick the route by width
    and allocate on every call): (forward, backward) callables."""
    rows, cols = x.shape
    y, dx = torch.empty_like(x), torch.empty_like(x)
    out_mean, out_inv = torch.empty_like(mean), torch.empty_like(invvar)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    part = torch.empty(ln.ln_bwd_workspace(rows, cols), device="cuda")
    code, dev = kernels.DTYPE_CODES[x.dtype], x.device.index

    def fwd():
        kernel_fwd(code, dev, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                   y.data_ptr(), out_mean.data_ptr(), out_inv.data_ptr(),
                   rows, cols, 1e-5, torch.cuda.current_stream().cuda_stream)

    def bwd():
        kernel_bwd(code, dev, x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                   invvar.data_ptr(), w.data_ptr(), dx.data_ptr(),
                   dw.data_ptr(), db.data_ptr(), part.data_ptr(), rows, cols,
                   torch.cuda.current_stream().cuda_stream)

    return fwd, bwd


def time_layer_norm(x, dy, w, b, mean, invvar) -> tuple:
    """K6 and K7 on ``layer_norm_sm90.cu`` (through the wrappers) timed
    cold beside their plain versions, ``F.layer_norm`` and the kernels of
    ``layer_norm.cu`` they replace at this width (cold too); then the old
    and the new kernel of each in turns (a, b, b, a) in this one call
    (``timing.timed_pair``, both straight through their ``Kernel``
    objects).  Returns (new forward, new backward, old forward, old
    backward) rows."""
    rows, cols = x.shape
    fwd_ms = cold_ms(lambda: ln._ln_fwd_cuda(x, w, b, 1e-5), 50)
    fwd_plain = cold_ms(lambda: ln._ln_fwd_plain(x, w, b, 1e-5), 20)
    bwd_ms = cold_ms(lambda: ln._ln_bwd_cuda(x, dy, mean, invvar, w, True),
                     50)
    bwd_plain = cold_ms(lambda: ln._ln_bwd_plain(x, dy, mean, invvar, w,
                                                 True), 20)
    new_fwd, new_bwd = ln_kernel_calls(kernels.LAYER_NORM_FWD_SM90,
                                       kernels.LAYER_NORM_BWD_SM90, x, dy, w,
                                       b, mean, invvar)
    old_fwd, old_bwd = ln_kernel_calls(kernels.LAYER_NORM_FWD,
                                       kernels.LAYER_NORM_BWD, x, dy, w, b,
                                       mean, invvar)
    fwd_old, bwd_old = cold_ms(old_fwd, 50), cold_ms(old_bwd, 50)
    pair_fwd = timing.timed_pair(old_fwd, new_fwd, (), ())
    pair_bwd = timing.timed_pair(old_bwd, new_bwd, (), ())
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
        f" {fwd_ms:.4f} ms (layer_norm.cu {fwd_old:.4f}: "
        f"{fwd_old / fwd_ms:.2f}x), plain {fwd_plain:.4f}, F.layer_norm "
        f"{fwd_lib:.4f}, bound {fb:.4f} ({fby}, {fb / fwd_ms:.1%} of it); "
        f"bwd kernel {bwd_ms:.4f} ms (layer_norm.cu {bwd_old:.4f}: "
        f"{bwd_old / bwd_ms:.2f}x), plain {bwd_plain:.4f}, F.layer_norm "
        f"backward {bwd_lib:.4f}, bound {bb:.4f} ({bby}, {bb / bwd_ms:.1%} "
        f"of it)")
    log(f"  in turns (timed_pair, warm): fwd layer_norm.cu {pair_fwd[0]:.4f}"
        f" ms vs layer_norm_sm90.cu {pair_fwd[1]:.4f} ms "
        f"({pair_fwd[0] / pair_fwd[1]:.2f}x); bwd {pair_bwd[0]:.4f} vs "
        f"{pair_bwd[1]:.4f} ({pair_bwd[0] / pair_bwd[1]:.2f}x)")
    fwd = dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
               bound_ms=fb, bound_by=fby, warm_pair_ms=pair_fwd[1])
    bwd = dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
               bound_ms=bb, bound_by=bby, warm_pair_ms=pair_bwd[1])
    return (fwd, bwd, {**fwd, "ms": fwd_old, "warm_pair_ms": pair_fwd[0]},
            {**bwd, "ms": bwd_old, "warm_pair_ms": pair_bwd[0]})


def phase_training_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    flash_qkv_case(gen, "bf16 causal, no dropout", bf16, 0.0)
    e3, e4, ops = flash_qkv_case(gen, f"bf16 causal, dropout {ATT_DROPOUT}",
                                 bf16, ATT_DROPOUT)
    s3, s4, _ = flash_qkv_case(gen, f"fp32 causal, dropout {ATT_DROPOUT}, "
                               "b=1", fp32, ATT_DROPOUT, b=1)
    seg = torch.stack([seg_row(512, [200, 250]), seg_row(512, [512])]).cuda()
    flash_qkv_case(gen, "bf16 causal + segment ids, dropout, b=2 s=512",
                   bf16, ATT_DROPOUT, b=2, s=512, seg=seg)
    flash_qkv_case(gen, f"bf16 non-causal, dropout {ATT_DROPOUT}, b=2 s=512",
                   bf16, ATT_DROPOUT, b=2, s=512, causal=False)
    seg = torch.stack([seg_row(1000, [300, 450]),
                       seg_row(1000, [1000])]).cuda()
    flash_qkv_case(gen, "bf16 causal + segment ids, dropout, b=2 ragged "
                   "s=1000", bf16, ATT_DROPOUT, b=2, s=1000, seg=seg)
    fwd, bwd, (sfwd, sbwd) = time_flash_qkv(*ops, ATT_DROPOUT)
    del ops
    torch.cuda.empty_cache()
    e6, e7, lops = layer_norm_case(gen, "bf16 x", bf16)
    layer_norm_case(gen, "fp32 x", fp32)
    layer_norm_case(gen, "bf16 x, the MHA decoder's rows", bf16,
                    rows=MHA["batch"] * MHA["tgt"], cols=MHA["hidden"])
    layer_norm_case(gen, "bf16 x, ragged rows", bf16, rows=8191)
    layer_norm_case(gen, "bf16 x, no weight or bias", bf16, rows=37,
                    affine=False)
    layer_norm_case(gen, "fp32 x at 4096, ragged rows", fp32, rows=1001,
                    cols=4096)
    # a width outside SM90_WIDTHS: layer_norm.cu's route
    o6, o7, _ = layer_norm_case(gen, "bf16 x at 1536", bf16, rows=4096,
                                cols=1536)
    lfwd, lbwd, ofwd, obwd = time_layer_norm(*lops)
    fwd["max_abs_err"], bwd["max_abs_err"] = e3, e4
    sfwd["max_abs_err"], sbwd["max_abs_err"] = s3, s4  # their fp32 route
    lfwd["max_abs_err"], lbwd["max_abs_err"] = e6, e7
    ofwd["max_abs_err"], obwd["max_abs_err"] = o6, o7  # their route
    return {"flash_qkv_fwd_sm90": fwd, "flash_qkv_bwd_sm90": bwd,
            "flash_qkv_fwd": sfwd, "flash_qkv_bwd": sbwd,
            "layer_norm_fwd_sm90": lfwd, "layer_norm_bwd_sm90": lbwd,
            "layer_norm_fwd": ofwd, "layer_norm_bwd": obwd}


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


def flash_fwd_tiles(seg_q, seg_k, sq, sk, causal, block_q=128,
                    block_k=128):
    """The key tiles each q-tile block of a flash forward walks, as
    [rows, n_qb, 2] [lo, hi) ranges: the segment rule
    (``_segment_block_bounds``' first output), cut at the tile of the
    last key the block's last query sees under the causal mask.  The
    backward's dq pass walks the same rule (:func:`flash_bwd_tiles`).
    ``csrc/flash_fwd_sm90.cu`` walks 128 x 128; its ``visits`` are held
    against this in phase 3, and this against the JAX package's rule in
    the tests."""
    return flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, block_q, block_k)[1]


def fwd_visits(q):
    """A ``visits`` tensor for the tensor-core K1 on operands like ``q``."""
    return torch.full((att.flash_fwd_visits_len(q),), -1, dtype=torch.int32,
                      device="cuda")


def check_fwd_visits(name, visits, seg_q, seg_k, sq, sk, causal, bh):
    """The tensor-core K1's tiles walked, per block, against
    :func:`flash_fwd_tiles` at its tiles."""
    bq, bk = att.FLASH_FWD_SM90_TILES
    want = flash_fwd_tiles(seg_q, seg_k, sq, sk, causal, bq, bk)
    want = want[..., 1] - want[..., 0]
    want = want.repeat_interleave(bh // want.shape[0], 0).flatten()
    got = visits.cpu().long()
    ok = torch.equal(got, want)
    log(f"  {name} tiles walked ({bq} x {bk}): {int(got.sum())} of "
        f"{bh * -(-sq // bq) * -(-sk // bk)}; the plain rule's "
        f"{int(want.sum())}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: tiles walked differ from "
                             "flash_fwd_tiles")


def flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, block_q=64,
                    block_k=64):
    """The tiles a three-pass flash backward walks, as [lo, hi) ranges:
    ([rows, n_kb, 2] q-tiles of each k-tile's dk/dv block, [rows, n_qb, 2]
    k-tiles of each q-tile's dq block), rows being the segment-id rows
    (one without segments); an empty range has lo == hi.  The dk/dv pass
    takes the transposed segment rule (``_segment_block_bounds``' second
    output) and, under the causal mask, starts at the tile of row k0 - (sk
    - sq), the first row that sees its first column; the dq pass takes the
    forward's rule and stops at the causal limit.  Tiles of ``block_q``
    rows and ``block_k`` columns (64 and 64: ``csrc/flash_bwd_kernel.cuh``,
    K2's scalar route; ``csrc/flash_bwd_sm90.cu``, K2's tensor-core route,
    and ``csrc/flash_qkv_bwd_sm90.cu``, K4, walk 32 x 128 in their dk/dv
    pass and 128 x 64 in their dq pass); a ragged last tile counts its
    valid ids only.  The kernels' own counts (``visits``) are held against this in
    phase 3, and this against the JAX package's rule in the tests."""
    n_qb, n_kb = -(-sq // block_q), -(-sk // block_k)
    if seg_q is None:
        q_lo, q_hi = torch.zeros(1, n_kb, dtype=torch.int64), torch.full(
            (1, n_kb), n_qb)
        k_lo, k_hi = torch.zeros(1, n_qb, dtype=torch.int64), torch.full(
            (1, n_qb), n_kb)
    else:
        def pad(ids, n, block):  # repeat the last id: min and max stay
            ids = ids.to(torch.int64).cpu()
            return torch.cat([ids, ids[:, -1:].expand(-1, n * block
                                                      - ids.shape[1])], 1)

        lohi_q, lohi_k = att._segment_block_bounds(
            pad(seg_q, n_qb, block_q), pad(seg_k, n_kb, block_k), block_q,
            block_k)
        k_lo, k_hi = lohi_q[..., 0].long(), lohi_q[..., 1].long()
        q_lo, q_hi = lohi_k[..., 0].long(), lohi_k[..., 1].long()
    if causal:
        first = torch.arange(n_kb) * block_k - (sk - sq)
        q_lo = torch.maximum(q_lo, torch.where(
            first <= 0, 0, (first // block_q).clamp(max=n_qb)))
        q0 = torch.arange(n_qb) * block_q
        last = q0 + (sq - q0).clamp(max=block_q) - 1 + (sk - sq)
        k_hi = torch.minimum(k_hi, torch.where(last >= 0,
                                               last // block_k + 1, 0))
    return (torch.stack([q_lo, torch.maximum(q_hi, q_lo)], -1),
            torch.stack([k_lo, torch.maximum(k_hi, k_lo)], -1))


def generic_case(gen, name, dtype, sq, sk, *, b, d, h=16, causal=False,
                 mask=None, seg=None, rate=0.0, repeat=False):
    """K1 and K2 against their plain versions on the same inputs (K2 gets
    K1's o and lse), and the tiles each walked against the plain
    statement of its skip rule (bf16 at head dims 64 and 128 runs
    ``flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu``, held to
    :func:`flash_fwd_tiles` and :func:`flash_bwd_tiles` at their tiles;
    the rest the scalar ``flash_fwd.cu`` and ``flash_bwd.cu``, K2 held to
    its rule at its tiles; the launch counts name the kernel that ran).
    ``repeat`` runs both again (bitwise).  Returns (K1 error, K2 error,
    operands)."""
    q, k, v, do = mha_operands(gen, dtype, sq, sk, b, d, h)
    seg_q, seg_k = seg if seg is not None else (None, None)
    args = (mask, seg_q, seg_k, d ** -0.5, causal, rate, RATE_SEED)
    tensor_cores = att._fwd_on_tensor_cores(q)
    visits = fwd_visits(q) if tensor_cores else None
    (o, lse), ran = launched(lambda: att._flash_fwd_cuda(q, k, v, *args,
                                                         visits=visits))
    ro, rlse = att._flash_fwd_plain(q, k, v, *args)
    torch.cuda.synchronize()
    e1 = check(f"{ran[0]} {name} o", o, ro)
    check_lse(f"{ran[0]} {name} lse", lse, rlse)
    if tensor_cores:
        check_fwd_visits(f"{ran[0]} {name}", visits, seg_q, seg_k, sq, sk,
                         causal, b * h)
    if repeat:
        check_bitwise(f"{ran[0]} {name} run twice", (o, lse),
                      att._flash_fwd_cuda(q, k, v, *args))
    tiles = att.flash_bwd_tiles_of(q)
    (bq2, bk2), (bq3, bk3) = tiles["dkdv"], tiles["dq"]
    n_kb = -(-sk // bk2)
    visits = torch.full((att.flash_bwd_visits_len(q, sk),), -1,
                        dtype=torch.int32, device="cuda")
    grads, ran = launched(lambda: att._flash_bwd_cuda(q, k, v, o, lse, do,
                                                      *args, visits=visits))
    ref = att._flash_bwd_plain(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    e2 = max(check(f"{ran[0]} {name} {n}", g, r)
             for n, g, r in zip(("dq", "dk", "dv"), grads, ref))
    want_kv = flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, bq2, bk2)[0]
    want_q = flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, bq3, bk3)[1]
    want_kv, want_q = (r[..., 1] - r[..., 0] for r in (want_kv, want_q))
    rows = want_kv.shape[0]
    want = torch.cat([want_kv.repeat_interleave(b * h // rows, 0).flatten(),
                      want_q.repeat_interleave(b * h // rows, 0).flatten()])
    got = visits.cpu().long()
    full = b * h * (n_kb * -(-sq // bq2) + -(-sq // bq3) * -(-sk // bk3))
    log(f"  {ran[0]} {name} tiles walked ({bq2} x {bk2}, {bq3} x {bk3}): "
        f"{int(got.sum())} of {full} (dk/dv {int(got[:b * h * n_kb].sum())}"
        f", dq {int(got[b * h * n_kb:].sum())}); the plain rule's "
        f"{int(want.sum())}: {'ok' if torch.equal(got, want) else 'FAIL'}")
    if not torch.equal(got, want):
        raise AssertionError(f"{ran[0]} {name}: tiles walked differ from "
                             "flash_bwd_tiles")
    if repeat:
        again = att._flash_bwd_cuda(q, k, v, o, lse, do, *args)
        check_bitwise(f"{ran[0]} {name} run twice", grads, again)
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
        S, S, b=B, d=64, seg=segments_of(src_pad, S), repeat=True)
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
    e1_fp32, e2_fp32, _ = generic_case(
        gen, "full [b,h,sq,sk] random mask, fp32", fp32, 128, 128, b=2, d=64,
        mask=torch.randn(2, 16, 128, 128, generator=gen, device="cuda"))
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
    all_padded_case(gen, fp32, lens)
    varied = segments_of(key_padding(mha_lengths(9, 4, 1, 200), 200), 200)
    for dtype in (fp32, bf16):
        for d in (8, 64, 128):
            generic_case(gen, f"combined mask + segments + causal + dropout "
                         f"d={d} {dtype}", dtype, 200, 200, b=4, d=d, h=4,
                         causal=True, mask=torch.randn(
                             4, 1, 200, 200, generator=gen, device="cuda"),
                         seg=varied, rate=MHA["dropout"], repeat=d == 64)
    # the tensor-core K2's cases the scalar one had alone (fp32 above)
    all_padded_case(gen, bf16, lens)
    generic_case(gen, "causal sq > sk (256 x 192) + segments bf16", bf16, 256,
                 192, b=4, d=64, causal=True,
                 seg=segments_of(key_padding(mha_lengths(7, 4, 1, 192), 192),
                                 256))
    # a mask that hides every key of batch row 1 at a ragged key length:
    # its lse is near MASK_FILL, and the key tile past the end must stay
    # hidden in the dq pass (exp(-lse) overflows there)
    hidden = key_padding(lens, 200)[:, None, None, :]   # row 1: all keys
    for d in (64, 128):
        generic_case(gen, f"mask hides every key of a row, sk 200, d={d} "
                     "bf16", bf16, 200, 200, b=4, d=d, h=4,
                     mask=torch.where(hidden, MASK_FILL, 0.0))
    # the causal masked instances without dropout (at d = 64 the one that
    # takes two 64-key steps a tile), with a batch row whose every key a
    # mask of -300 hides: its scores take the tensor-core K1's FMA-chain
    # path (|row max| >= 256), where fp32's spacing (3e-5) is under
    # LSE_TOL; a generator of their own keeps the later cases' data
    gen_c = torch.Generator(device="cuda").manual_seed(4)
    for d in (64, 128):
        generic_case(gen_c, f"causal + mask of -300 hiding every key of a row,"
                     f" d={d} bf16", bf16, 200, 200, b=4, d=d, h=4,
                     causal=True, mask=torch.where(hidden, -300.0, 0.0))
    varlen_case(gen)
    timing = time_generic(enc, dec, gen)
    timing["flash_fwd_sm90_mha"]["max_abs_err"] = e1
    timing["flash_fwd_mha"]["max_abs_err"] = e1_fp32  # its route: fp32, d = 8
    timing["flash_bwd_sm90"]["max_abs_err"] = e2
    timing["flash_bwd"]["max_abs_err"] = e2_fp32  # its route: fp32, d = 8
    return timing


def all_padded_case(gen, dtype, lens) -> None:
    """A batch row whose keys are all padded (segment route, b = 4, s =
    200, d = 64): its o and dq are exact zeros and its lse K1's -1e30."""
    e_pad = generic_case(gen, f"all-padded rows (segment route) {dtype}",
                         dtype, 200, 200, b=4, d=64,
                         seg=segments_of(key_padding(lens, 200), 200))[2]
    q, k, v, do, o, lse, args = e_pad
    dq = att._flash_bwd_cuda(q, k, v, o, lse, do, *args)[0]
    zero = bool((o[1] == 0).all()) and bool((dq[1] == 0).all()) and bool(
        (lse.view(4, 16, 200)[1] == -1e30).all())
    log(f"  all-padded batch row, {dtype}: o, dq exactly 0 and lse -1e30: "
        f"{zero}")
    if not zero:
        raise AssertionError("all-padded rows are not exact zeros")


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
    autograd) and the bound.  At the encoder shape K1's and K2's scalar
    bf16 instances are also timed cold, and each against its tensor-core
    kernel in turns (a, b, b, a) in this one call
    (``timing.timed_pair``)."""
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
        new_fwd = lambda: att._flash_fwd_cuda(q, k, v, *args)  # noqa: E731
        fwd_ms = cold_ms(new_fwd, 20)
        drop_ms = cold_ms(lambda: att._flash_fwd_cuda(
            q, k, v, *args[:5], MHA["dropout"], RATE_SEED), 20)
        fwd_plain = cold_ms(lambda: att._flash_fwd_plain(q, k, v, *args), 5, 1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        fwd_lib = cold_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=fmask), 20)
        new_bwd = lambda: att._flash_bwd_cuda(  # noqa: E731
            q, k, v, o, lse, do, *args)
        bwd_ms = cold_ms(new_bwd, 20)
        bwd_plain = cold_ms(lambda: att._flash_bwd_plain(
            q, k, v, o, lse, do, *args), 5, 1)
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=fmask)
        bwd_lib = cold_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), 20)
        fb, fby = mha_bound(q, k, mask, True, live_q, live_k, visible)
        bb, bby = mha_bound(q, k, mask, False, live_q, live_k, visible)
        log(f"  generic attention timing, {name} [{B},{H},{sq}x{sk},{d}] "
            f"{q.dtype} ({'segments' if seg_q is not None else 'mask'}): "
            f"fwd kernel (tensor cores) {fwd_ms:.4f} ms (dropout "
            f"{MHA['dropout']}: "
            f"{drop_ms:.4f}), plain {fwd_plain:.4f}, sdpa {fwd_lib:.4f}, "
            f"bound {fb:.4f} ({fby}); bwd kernel (tensor cores) "
            f"{bwd_ms:.4f} ms, plain {bwd_plain:.4f}, sdpa backward "
            f"{bwd_lib:.4f}, bound {bb:.4f} ({bby})")
        out[name] = dict(fwd=dict(ms=fwd_ms, ms_dropout=drop_ms,
                                  plain_ms=fwd_plain, library_ms=fwd_lib,
                                  bound_ms=fb, bound_by=fby,
                                  flops=4 * d * visible),
                         bwd=dict(ms=bwd_ms, plain_ms=bwd_plain,
                                  library_ms=bwd_lib, bound_ms=bb,
                                  bound_by=bby, flops=10 * d * visible))
        if name == "encoder":
            old_fwd = scalar_fwd(new_fwd)
            old_fwd_ms = cold_ms(old_fwd, 10)
            pair_fwd = timing.timed_pair(old_fwd, new_fwd, (), ())
            log(f"  K1 at the encoder shape, scalar bf16 instance (flash_fwd"
                f".cu) {old_fwd_ms:.4f} ms cold ({old_fwd_ms / fwd_ms:.2f}x "
                f"the tensor-core kernel's); in turns (timed_pair, warm): "
                f"scalar {pair_fwd[0]:.4f} ms vs tensor-core "
                f"{pair_fwd[1]:.4f} ms ({pair_fwd[0] / pair_fwd[1]:.2f}x)")
            out["scalar_fwd"] = {
                **{k: v for k, v in out[name]["fwd"].items()
                   if k != "ms_dropout"},
                "ms": old_fwd_ms, "warm_pair_ms": pair_fwd[0]}
            out[name]["fwd"]["warm_pair_ms"] = pair_fwd[1]

            def old_bwd():  # the scalar K2's bf16 instance (flash_bwd.cu)
                with mock.patch.object(att, "_bwd_on_tensor_cores",
                                       lambda t: False):
                    return att._flash_bwd_cuda(q, k, v, o, lse, do, *args)
            old_ms = cold_ms(old_bwd, 5, 1)
            pair = timing.timed_pair(old_bwd, new_bwd, (), ())
            log(f"  K2 at the encoder shape, scalar bf16 instance (flash_bwd"
                f".cu) {old_ms:.4f} ms cold ({old_ms / bwd_ms:.2f}x the "
                f"tensor-core kernel's); in turns (timed_pair, warm): scalar "
                f"{pair[0]:.4f} ms vs tensor-core {pair[1]:.4f} ms "
                f"({pair[0] / pair[1]:.2f}x)")
            out["scalar_bwd"] = {**out[name]["bwd"], "ms": old_ms,
                                 "warm_pair_ms": pair[0]}
            out[name]["bwd"]["warm_pair_ms"] = pair[1]
        del ql, kl, vl, ol
    return {"flash_fwd_sm90_mha": out["encoder"]["fwd"],
            "flash_fwd_mha": out["scalar_fwd"],
            "flash_fwd_sm90_mha_mask": out["decoder"]["fwd"],
            "flash_bwd_sm90": out["encoder"]["bwd"],
            "flash_bwd_sm90_mask": out["decoder"]["bwd"],
            "flash_bwd": out["scalar_bwd"]}


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
    err_fwd32 = flash_fwd_case(gen, "fp32 one segment C=700 + pad", fp32,
                               [700])[0]
    fwd, sfwd = time_flash_fwd(bf16, *fwd_ops)
    fwd["max_abs_err"] = err_fwd
    sfwd["max_abs_err"] = err_fwd32   # the scalar K1's route: fp32, d = 8
    del fwd_ops
    out = {"flash_fwd_sm90": fwd, "flash_fwd": sfwd,
           **phase_decode_kernels(gen),
           **phase_training_kernels(),
           **phase_generic_kernels()}
    torch.cuda.empty_cache()
    out["flat_adam"] = phase_flat_adam()
    torch.cuda.empty_cache()
    return out


# -- phase 4: toy width, cuda vs cpu ---------------------------------------


def phase_toy() -> dict:
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

    kernels.reset_launch_counts()
    on_card = streams("cuda")
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    on_cpu = streams("cpu")
    log(f"  toy fp32 launches {launches}")
    if not (launches.get("flash_fwd") and "flash_fwd_sm90" not in launches):
        raise AssertionError("toy engine: fp32 attention did not take the "
                             "scalar K1 (the fp32 route)")
    log(f"  toy fp32 streams, cuda (kernels): {on_card}")
    log(f"  toy fp32 streams, cpu (plain):    {on_cpu}")
    if on_card != on_cpu:
        raise AssertionError("toy engine: cuda and cpu streams differ")
    return {"launches": launches}


# -- phase 5: the full-width engine ----------------------------------------


def full_engine(params, cfg, max_batch=BATCH, kv_quant=None) -> ServingEngine:
    return ServingEngine(cfg, params, num_pages=NUM_PAGES, page_size=PAGE,
                         max_batch=max_batch,
                         max_pages_per_request=PAGES_PER_REQ,
                         prefill_budget=cfg.max_position, kv_quant=kv_quant,
                         device="cuda")


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

    def fd(q, k_pages, v_pages, page_table, kv_len, k_scale=None,
           v_scale=None):
        return decode_plain(q, k_pages, v_pages, page_table, kv_len,
                            k_scale, v_scale)

    return mock.patch.multiple(model_mod, flash_attention=fa,
                               flash_decode=fd)


def logits_close(what, got, ref, shape) -> float:
    """Kernel-path logits against the plain path's.  bf16 rounds at every
    layer, so the bar is a few bf16 ulps of the logit scale (8 x 2^-8 x
    max|ref|), not one."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()) or tuple(got.shape) != shape:
        raise AssertionError(f"{what} logits: shape {tuple(got.shape)} or "
                             "non-finite values")
    err = (got - ref).abs().max().item()
    tol = 8 * 2.0 ** -8 * ref.abs().max().item()
    log(f"  {what} logits, kernels vs plain: max_abs_diff {err:.3e}  tol "
        f"{tol:.3e}  (logit scale {ref.abs().max().item():.3f}, argmax "
        f"{got.argmax(-1).flatten().tolist()} vs "
        f"{ref.argmax(-1).flatten().tolist()})")
    if not err <= tol:
        raise AssertionError(f"{what} logits: kernel path disagrees")
    return err


@torch.no_grad()
def logits_check(eng: ServingEngine, prompt) -> float:
    """Last-position prefill logits of ``prompt``, kernel path vs plain
    path, same weights."""
    S, C = eng.prefill_budget, len(prompt)
    host = np.zeros((3, S), np.int32)
    host[0, :C], host[1, :C], host[2, :C] = prompt, 1, np.arange(C)
    dev = torch.from_numpy(host).cuda()
    got, _, _ = eng.decoder.prefill(eng.params, dev[0:1], dev[1:2],
                                    dev[2:3], C - 1)
    with plain_attention():
        ref, _, _ = eng.decoder.prefill(eng.params, dev[0:1], dev[1:2],
                                        dev[2:3], C - 1)
    return logits_close("full-width prefill", got, ref,
                        (1, 1, FULL["vocab_size"]))


def full_batch_operands(eng: ServingEngine) -> torch.Tensor:
    """The engine's decode operand row for a full batch: every row at
    kv_len 256 on its own 5 pages (the pool is drained, so the appends
    land in free pages)."""
    b, p_max = eng.max_batch, eng.cache.max_pages_per_request
    host = np.zeros(3 * b + b * p_max, np.int32)
    host[b:2 * b], host[2 * b:3 * b] = 255, 256      # positions, kv_len
    host[3 * b:] = 1 + np.arange(b * p_max)         # distinct pages
    return torch.from_numpy(host).cuda()


@torch.no_grad()
def decode_logits_check(eng: ServingEngine) -> float:
    """A full-batch decode step's logits through K5 against the same step
    through its plain version, on the same pool (each run appends its own
    token's K/V before reading)."""
    dev = full_batch_operands(eng)
    got = eng._decode(dev)
    with plain_attention():
        ref = eng._decode(dev)
    return logits_close(f"full-batch decode ({eng.kv_quant or 'bf16'} "
                        "pool)", got, ref, (BATCH, FULL["vocab_size"]))


@torch.no_grad()
def decode_step_split(eng: ServingEngine, steps: int = 20) -> dict:
    """A full-batch decode step timed two ways: until the host has
    enqueued it, and until the device has finished it.  When the two are
    close the host, not the device, sets the step time.  Medians over
    ``steps`` steps."""
    dev = full_batch_operands(eng)
    eng._decode(dev)
    torch.cuda.synchronize()
    enqueue, done = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng._decode(dev)
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


# kernel-name fragments of a decode step -> its parts (step_profile)
DECODE_KINDS = (("decode_split", "K5 flash_decode_sm90"),
                ("decode_merge", "K5 flash_decode_sm90 (split merge)"),
                ("gemm", "GEMMs (cuBLAS)"), ("gemv", "GEMMs (cuBLAS)"),
                ("xmma", "GEMMs (cuBLAS)"), ("nvjet", "GEMMs (cuBLAS)"),
                ("cutlass", "GEMMs (cuBLAS)"))


@torch.no_grad()
def decode_step_profile(eng: ServingEngine) -> dict:
    """One full-batch decode step's device time by part under
    ``torch.profiler``: K5, the GEMMs, the elementwise rest (also by the
    ATen op that launched each kernel), and busy against wall (the wall
    holds the host's enqueue)."""
    dev = full_batch_operands(eng)
    eng._decode(dev)
    prof = step_profile(lambda: eng._decode(dev), DECODE_KINDS)
    k5 = sum(t for k, t in prof["by_kind_ms"].items() if k.startswith("K5"))
    log(f"  full-batch decode step under torch.profiler "
        f"({eng.kv_quant or 'bf16'} pool): busy "
        f"{prof['device_busy_ms']:.3f} of a {prof['wall_ms']:.3f} ms wall "
        f"(idle {prof['idle_share']:.1%}); K5 {k5:.3f} ms, "
        f"{k5 / prof['device_busy_ms']:.1%} of busy; by kind "
        + ", ".join(f"{k} {t:.3f}" for k, t in prof["by_kind_ms"].items()))
    log_other_ops(prof)
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                 "by_kind_ms", "top_other_ops")}


def stream_sets(params, cfg, kv_quant) -> dict:
    """Three requests of a seeded trace served together, again, one at a
    time at the same ``max_batch``, and (recorded only) at ``max_batch``
    1, where every GEMM has another shape."""
    def run(max_batch=BATCH, one_at_a_time=False):
        eng = full_engine(params, cfg, max_batch, kv_quant)
        handles = []
        for r in trace(1, 3):
            handles.append(eng.submit(r.prompt, r.max_new_tokens))
            if one_at_a_time:
                eng.run()
        eng.run()
        return [h.generated for h in handles]

    return {"together": run(), "again": run(),
            "one_at_a_time": run(one_at_a_time=True),
            "max_batch_1": run(max_batch=1)}


def serve_full(params, cfg, pool, kv_quant, decode_kernel, smi) -> dict:
    """``warmup()`` and ``serve()`` of the seeded trace on one pool, with
    exact launch counts (the tensor-core K1 and the pool's K5 entry
    point, nothing else), the kernel path's decode logits against the
    plain path's, the decode step's host/device split and device profile,
    and batched == sequential == a re-run, bitwise."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = full_engine(params, cfg, kv_quant=kv_quant)
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
        raise AssertionError(f"{pool} serve: not every request finished")
    if eng.cache.pages_used != 0:
        raise AssertionError(f"pool not drained: {eng.cache.pages_used} used")
    prefills = sum(1 + r.preemptions for r in finished)
    want = {"flash_fwd_sm90": cfg.num_layers * (prefills + 1),
            decode_kernel: cfg.num_layers * (eng.decode_steps + 1)}
    log(f"  {pool} pool: launches {launches}, expected {want} ({prefills} "
        f"prefills + warmup, {eng.decode_steps} decode steps + warmup)")
    if launches != want:
        raise AssertionError("launch counts do not match the main path")
    tokens = sum(len(r.generated) for r in finished)
    ttft = [(r.first_token_t - r.arrival_t) * 1e3 for r in finished]
    tpot = [(r.finish_t - r.first_token_t) / (len(r.generated) - 1) * 1e3
            for r in finished if len(r.generated) > 1]
    metrics = {"pool": pool, "requests": len(finished), "tokens": tokens,
               "wall_s": wall, "tok_per_s": tokens / wall,
               "ttft_p50_ms": statistics.median(ttft),
               "tpot_p50_ms": statistics.median(tpot),
               "warmup_s": warm_s, "decode_steps": eng.decode_steps,
               "prefills": prefills,
               "preemptions": sum(r.preemptions for r in finished),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "card": smi}
    log("  serve " + json.dumps(metrics))
    if kv_quant is None:
        logits_check(eng, reqs[0].prompt)
    metrics["decode_logits_err"] = decode_logits_check(eng)
    metrics.update(decode_step_split(eng))
    metrics["decode_step_profile"] = decode_step_profile(eng)
    del eng
    torch.cuda.empty_cache()

    s = stream_sets(params, cfg, kv_quant)
    same = s["together"] == s["one_at_a_time"]
    rerun = s["together"] == s["again"]
    same_b1 = s["together"] == s["max_batch_1"]
    log(f"  {pool} pool: batched == sequential at max_batch {BATCH}: "
        f"{same}; a re-run equal to itself: {rerun}; max_batch {BATCH} == "
        f"max_batch 1: {same_b1} (recorded, not required)")
    if not (same and rerun):
        raise AssertionError(f"{pool} pool: batched, sequential and re-run "
                             "streams differ")
    metrics.update(launches=launches, batched_eq_sequential=same,
                   rerun_eq=rerun, batch8_eq_batch1=same_b1)
    return metrics


def phase_full(smi: str) -> dict:
    """The full-width engine on each pool (:data:`DECODE_POOLS`); the
    quantized streams are not held equal to the bf16 ones."""
    cfg = ServingModelConfig(**FULL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    return {pool: serve_full(params, cfg, pool, quant, name, smi)
            for pool, quant, name in DECODE_POOLS}


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
    kernels.reset_launch_counts()
    on_card, w_card = toy_run("cuda", state, batches)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    on_cpu, w_cpu = toy_run("cpu", state, batches)
    log(f"  toy fp32 launches over 5 steps {launches}")
    if not (launches.get("flash_qkv_fwd") and launches.get("flash_qkv_bwd")
            and "flash_qkv_fwd_sm90" not in launches
            and "flash_qkv_bwd_sm90" not in launches):
        raise AssertionError("toy training: fp32 attention did not take the "
                             "scalar kernels (the fp32 route)")
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
    return {"toy_loss_rel_diff": loss_err, "toy_weight_max_diff": w_err,
            "launches": launches}


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
STEP_KINDS = (("qkv_fwd_sm90", "K3 flash_qkv_fwd"),
              ("qkv_bwd_", "K4 flash_qkv_bwd"),   # its three passes
              # the scalar kernels (the fp32 route): none in a bf16 step
              ("flash_fwd_kernel", "K3/K4 scalar"), ("attn_bwd", "K3/K4 scalar"),
              # both routes: layer_norm_sm90.cu's ln_fwd_rows, ln_bwd_rows
              # and ln_bwd_cols, layer_norm.cu's ln_fwd_kernel, ln_bwd_*
              ("ln_fwd", "K6 layer_norm_fwd"),
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


OTHER_KIND = "other elementwise, copies, reductions"


def step_profile(step, parts=STEP_KINDS) -> dict:
    """Device time of one call of ``step`` by part, from a
    ``torch.profiler`` trace (CUPTI): kernel durations summed by kind and
    the ten longest kernels by name; the device's busy time is the union
    of the kernels' intervals, and its idle share is the rest of the
    step's wall time.  The kernels that ``parts`` does not name (the
    ``OTHER_KIND`` bucket) are also split by the ATen op that launched
    each (the CPU op the profiler correlates the launch with), the ten
    largest in ``top_other_ops``; what no op launched is
    ``"(no ATen op)"``."""
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
                    OTHER_KIND)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        n, t = names.get(e.name[:160], (0, 0.0))
        names[e.name[:160]] = (n + 1, t + ms)
    ops = {}
    for e in prof.events():     # CPU ops, each with the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in e.kernels:
            if any(frag in k.name.lower() for frag, _ in parts):
                continue
            n, t = ops.get(e.name, (0, 0.0))
            ops[e.name] = (n + 1, t + k.duration / 1e3)
    unclaimed = kinds.get(OTHER_KIND, 0.0) - sum(t for _, t in ops.values())
    if unclaimed > 1e-3:
        ops["(no ATen op)"] = (0, unclaimed)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:10]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels": [(k, n, t) for k, (n, t) in top],
            "top_other_ops": [(k, n, t) for k, (n, t) in top_ops]}


def log_other_ops(prof: dict) -> None:
    """The ``OTHER_KIND`` bucket of :func:`step_profile`, by ATen op."""
    log(f"  {OTHER_KIND} ({prof['by_kind_ms'].get(OTHER_KIND, 0.0):.2f} "
        "ms) by the ATen op that launched each kernel, the ten largest:")
    for name, n, t in prof["top_other_ops"]:
        log(f"    {t:8.2f} ms  x{n:<5d} {name}")


def loss_and_grads(model, tokens, labels):
    loss = model(tokens, labels=labels).mean()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach().item(), grads


def phase_full_training(smi: str) -> dict:
    L = 24
    # bf16: the tensor-core K3/K4 and layer_norm_sm90.cu's K6/K7, and not
    # one launch of the scalar K3/K4 or of layer_norm.cu
    want = {"flash_qkv_fwd_sm90": L, "flash_qkv_bwd_sm90": L,
            "layer_norm_fwd_sm90": 4 * L + 1, "layer_norm_bwd_sm90": 2 * L + 1}
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
        f"expected {want} (remat attn_res: K3 L, K4 L, K6 4L+1, K7 2L+1; "
        f"the scalar K3/K4 and layer_norm.cu never)")
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
        log_other_ops(prof)
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

    kernels.reset_launch_counts()
    on_card, w_card = run(card, "cuda")
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    on_cpu, w_cpu = run(cpu, "cpu")
    log(f"  toy fp32 launches over 5 steps {launches}")
    if not (launches.get("flash_fwd") and launches.get("flash_bwd")
            and "flash_fwd_sm90" not in launches
            and "flash_bwd_sm90" not in launches):
        raise AssertionError("toy MHA training: fp32 attention did not take "
                             "the scalar K1 and K2 (the fp32 route)")
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
            "toy_mha_key_bias_max_diff": kb_err, "launches": launches}


# kernel vs plain, one dropout-free full-width step: bf16 activations
# through 12 layers, so a one-ulp difference in a K1 output or a LayerNorm
# moves every later gradient a little; each bar is ten times the largest
# gap read on an H100
# relative, on the loss, held at the seeded initial weights and at the
# trained ones: scripts/mha_step_gaps.py read 11 states on the scalar K2
# (the seeded initial weights and after each of ten training steps) on an
# NVIDIA H100 80GB HBM3 at 700 W, 6.2e-8 to 4.31e-6, the largest at the
# initial weights
MHA_PLAIN_LOSS_TOL = 4.31e-5
MHA_PLAIN_NORM_TOL = 8e-4    # relative, global grad norm (read 7.3e-5)
# relative, |g - g_plain| / |g_plain| on the worst leaf (read 1.05e-2, on
# encoder layer 5's in_proj_weight; the median leaf reads 8.7e-3)
MHA_PLAIN_LEAF_TOL = 1.1e-1
MHA_KINDS = (("ln_fwd", "K6 layer_norm_fwd"),   # before K2's "_sm90"
             ("ln_bwd", "K7 layer_norm_bwd"),
             ("attn_fwd_sm90", "K1 flash_fwd_sm90"),   # before K2's "_sm90"
             ("flash_fwd_kernel", "K1 flash_fwd (scalar)"),
             # K2's three passes: attn_bwd_{delta,dkdv,dq}_sm90 on the
             # tensor cores; the scalar attn_bwd_* are the fp32 route
             ("_sm90", "K2 flash_bwd_sm90"),
             ("attn_bwd", "K2 flash_bwd (scalar)"),
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


def mha_gaps(model, batch) -> dict:
    """Kernels vs plain versions on one dropout-free step at the model's
    weights: the loss and the global grad norm of each, their relative
    gaps, and each leaf's |g - g_plain| / |g_plain| (``leaf``, by name)."""
    loss, grads = mha_grads(model, batch)
    patches = plain_kernels()
    with patches[0], patches[1]:
        ref_loss, ref_grads = mha_grads(model, batch)
    norm = multi_tensor_l2norm(list(grads.values())).item()
    ref_norm = multi_tensor_l2norm(list(ref_grads.values())).item()
    leaf = {n: ((grads[n] - g).norm() / g.norm()).item()
            for n, g in ref_grads.items()}
    return {"loss": loss, "ref_loss": ref_loss,
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "norm": norm, "ref_norm": ref_norm,
            "norm_rel": abs(norm - ref_norm) / ref_norm, "leaf": leaf}


def check_mha_vs_plain(model, batch, state: str) -> dict:
    """:func:`mha_gaps` at one state of the weights, held to the three
    bars; returns the three gaps."""
    g = mha_gaps(model, batch)
    leaf, dl, dn = g["leaf"], g["loss_rel"], g["norm_rel"]
    worst = max(leaf, key=leaf.get)
    log(f"  dropout-free step at the {state}, kernels vs plain: loss "
        f"{g['loss']:.6f} vs {g['ref_loss']:.6f} (rel diff {dl:.3e}, tol "
        f"{MHA_PLAIN_LOSS_TOL:.2e}); grad norm {g['norm']:.6f} vs "
        f"{g['ref_norm']:.6f} (rel diff {dn:.3e}, tol "
        f"{MHA_PLAIN_NORM_TOL:.1e}); worst leaf {worst} |g - g_plain| / "
        f"|g_plain| {leaf[worst]:.3e} (tol {MHA_PLAIN_LEAF_TOL:.1e}), median "
        f"over {len(leaf)} leaves {statistics.median(leaf.values()):.3e}")
    if not (dl <= MHA_PLAIN_LOSS_TOL and dn <= MHA_PLAIN_NORM_TOL
            and leaf[worst] <= MHA_PLAIN_LEAF_TOL):
        raise AssertionError(f"MHA step at the {state}: kernel path "
                             "disagrees with the plain path")
    return {"loss_rel_diff": dl, "grad_norm_rel_diff": dn,
            "worst_leaf_rel_diff": leaf[worst]}


def phase_mha(smi: str) -> dict:
    c = MHA
    L, steps = c["layers"], 5
    per_step = {"flash_fwd_sm90": 3 * L, "flash_bwd_sm90": 3 * L,
                "layer_norm_fwd_sm90": 3 * L, "layer_norm_bwd_sm90": 3 * L}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = mha_batch("cuda", torch.bfloat16, c["hidden"], c["batch"],
                      c["src"], c["tgt"], 32, seed=3)
    model = MHAStack(c["hidden"], c["heads"], L, c["dropout"], "cuda")
    # kernels vs plain at the seeded initial weights, which no backward
    # kernel has moved yet; the trained state is held after the steps
    initial = check_mha_vs_plain(model, batch, "seeded initial weights")
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
        f"{L} cross; K1 and K2 the tensor-core kernels, the scalar ones "
        f"never; K6 and K7 layer_norm_sm90.cu's, layer_norm.cu's never)")
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
        log_other_ops(prof)
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(breakdown not measured)")

    # kernels vs plain at the weights the six training steps above left
    trained = check_mha_vs_plain(model, batch, "weights after six steps")
    del model, opt
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
    metrics.update(launches=launches, kernel_vs_plain_initial=initial,
                   kernel_vs_plain_trained=trained, deterministic=same)
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
    per_step = {"flash_qkv_fwd_sm90": L, "flash_qkv_bwd_sm90": L,
                "layer_norm_fwd_sm90": 4 * L + 1,
                "layer_norm_bwd_sm90": 2 * L + 1, "flat_adam": 1}
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
        "launch a step; layer_norm.cu never)")
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
    log_other_ops(prof)
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
# K10's new route at the edges of its walk, each at head dims 64 and 128
# (q tiles of 128 and 192 rows): q tails (s = 192: half the last 128-row
# tile past s, none of a 192-row one; s = 320: the last warpgroup of
# either tile past s), and blocks that differ (warpgroups of a tile
# keeping one prefix, or prefixes 128 keys apart; at s = 512 a 192-row
# tile's last warpgroup also past s)
DOT_EDGE_SHAPES = tuple(
    (f"{what} d {d}", (8, s, d, bq, bk))
    for d in roofs.DOTS_HEAD_DIMS
    for what, s, bq, bk in (("q tail s 192", 192, 64, 64),
                            ("q tail s 320", 320, 64, 64),
                            ("bq < bk", 512, 64, 128),
                            ("bq > bk", 512, 128, 64)))
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


def old_dots(q, k, v, bq, bk) -> torch.Tensor:
    """K10's route before ``attention_dots_sm90.cu``: ``attention_dots.cu``
    (``mma.sync``) called through its ``Kernel`` object, as the wrapper
    called it."""
    bh, s, d = q.shape
    o = torch.empty_like(q)
    kernels.ATTENTION_DOTS(q.device.index, q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), o.data_ptr(), bh, s, d, bq, bk,
                           torch.cuda.current_stream().cuda_stream)
    return o


def check_dots_visits(name, visits, bh, s, d, bq, bk) -> None:
    """The 64 x 64 sub-tiles each block of ``attention_dots_sm90.cu``
    multiplied, against its walk as :func:`roofs.dots_walk` states it, and
    their sum against the pairs the skip rule keeps."""
    want = torch.tensor([sum(map(len, wgs))
                         for wgs in roofs.dots_walk(s, bq, bk, d)],
                        dtype=torch.int32)
    got = visits.view(bh, -1).cpu()
    pairs = roofs.dots_pairs(s, bq, bk)
    ok = (bool((got == want).all())
          and bool((got.sum(1) * 4096 == pairs).all()))
    log(f"  {name}: sub-tiles {int(got[0].sum())} a batch-head, the rule's "
        f"pairs / 4096 = {pairs // 4096}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the sub-tiles multiplied "
                             f"{got[0].tolist()} are not the walk's "
                             f"{want.tolist()}")


def dots_case(gen, what, shape, old=True) -> tuple:
    """K10's kernel (``attention_dots_sm90.cu``, through the wrapper)
    against its plain version within ``tolerance`` (bf16), its sub-tiles
    against the walk, and run twice, bitwise; with ``old``, the route before
    it (``attention_dots.cu``) against the plain version too.  Returns
    (error of the new route, of the old one or None, the operands)."""
    bh, s, d, bq, bk = shape
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    visits = torch.full((roofs.dots_visits_len(bh, s, d),), -1,
                        dtype=torch.int32, device="cuda")
    o = roofs._attention_dots_cuda(q, k, v, bq, bk, visits=visits)
    ref = roofs._attention_dots_plain(q, k, v, bq, bk)
    torch.cuda.synchronize()
    name = f"attention_dots_sm90 {what} [{bh}, {s}, {d}] blocks ({bq}, {bk})"
    err = check(name, o, ref)
    check_dots_visits(name, visits, bh, s, d, bq, bk)
    check_bitwise(f"{name} run twice", (o,),
                  (roofs.attention_dots(q, k, v, bq, bk),))
    err_old = None
    if old:
        err_old = check(f"attention_dots.cu {what} (the route before)",
                        old_dots(q, k, v, bq, bk), ref)
    del ref
    return err, err_old, (q, k, v)


def sass_count(source: str, opcode: str) -> int:
    """Lines of one instruction (``HMMA``: ``mma.sync`` on the tensor cores,
    ``HGMMA``: ``wgmma``, ``UTMALDG``: a TMA load; a regular expression,
    matched as a word) in the SASS of a built source's library, from
    ``cuobjdump -sass``."""
    tool = kernels._build.cuda_tool("cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(kernels._build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    return sum(re.search(rf"\b{opcode}\b", line) is not None
               for line in sass.splitlines())


SM90_SOURCES = ("flash_qkv_fwd_sm90.cu", "flash_qkv_bwd_sm90.cu",
                "flash_bwd_sm90.cu", "flash_fwd_sm90.cu",
                "attention_dots_sm90.cu")
#: the sources held to no spill and no stack: the tensor-core ones, K6/K7's,
#: whose rows and dgamma/dbeta sums live in registers, and K5's, whose
#: lanes hold q, a tile's K/V vectors and their partial sums in registers
SPILL_FREE_SOURCES = SM90_SOURCES + ("layer_norm_sm90.cu",
                                     "flash_decode_sm90.cu")
#: the instructions each source's SASS must hold: wgmma (HGMMA) and TMA
#: loads (UTMALDG) in the tensor-core sources; 16-byte global loads of the
#: pool's K/V rows in K5's
#: (as a name and the pattern ``sass_count`` searches for)
SASS_WANT = {**{src: {"HGMMA": "HGMMA", "UTMALDG": "UTMALDG"}
                for src in SM90_SOURCES},
             "flash_decode_sm90.cu": {"LDG.E.128": r"LDG\.E(?:\.\w+)*\.128"}}


def sm90_build_checks() -> dict:
    """The tensor-core sources (K3/K4's, K2's and K1's bf16 routes, K10's),
    ``layer_norm_sm90.cu`` (K6/K7) and ``flash_decode_sm90.cu`` (K5) as
    built: every instance free of spills and stack in ``ptxas -v``'s
    report, and each source's SASS holding the instructions of
    :data:`SASS_WANT`."""
    out = {}
    for src in SPILL_FREE_SOURCES:
        text = kernels.build_log.get(src)
        if text is None:  # built by an earlier run: ask ptxas again
            out_so = kernels._build.BUILD_DIR / f"{src}.report.so"
            text = subprocess.run(
                [kernels._build.cuda_tool(), *kernels._build.NVCC_FLAGS,
                 "-o", str(out_so), str(kernels._build.CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                check=True).stdout
            out_so.unlink()
        report = ptxas_report(text)
        spills = [(demangle(fn), stack, spill)
                  for fn, _, stack, spill in report if stack or spill]
        regs = [r for _, r, _, _ in report] or [0]
        counts = {op: sass_count(src, rx)
                  for op, rx in SASS_WANT.get(src, {}).items()}
        log(f"  {src}: {len(report)} instances, registers {min(regs)}.."
            f"{max(regs)}, spills or stack in {len(spills)}"
            + "".join(f"; SASS {n} {op}" for op, n in counts.items()))
        for line in text.splitlines():   # e.g. wgmma serialized by ptxas
            if "Performance Loss" in line:
                log(f"    {line.strip()}")
        if spills or not report:
            raise AssertionError(f"{src}: ptxas reports spills {spills}")
        if not all(counts.values()):
            raise AssertionError(f"{src}: its SASS lacks an instruction of "
                                 f"{list(counts)} ({counts})")
        out[src] = dict(counts, instances=len(report), max_registers=max(regs))
    return out


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
    (more work than the kernel's: no tile is skipped, no scale); the route
    before it (``attention_dots.cu``) cold, and the two in turns
    (``timing.timed_pair``, warm)."""
    bh, s, d, bq, bk = shape
    ms = cold_ms(lambda: roofs.attention_dots(q, k, v, bq, bk))
    old_ms = cold_ms(lambda: old_dots(q, k, v, bq, bk))
    pair = timing.timed_pair(old_dots, roofs.attention_dots,
                             (q, k, v, bq, bk), (q, k, v, bq, bk))
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
        f"JAX count; {pairs / (bh * s * s):.4f} of the dense pairs; "
        f"{bound_ms / ms:.1%} of its bound), plain "
        f"{plain_ms:.4f}, two dense torch.bmm {lib_ms:.4f} "
        f"({dense / lib_ms / 1e9:.1f} TFLOP/s, {dense / executed:.2f}x the "
        f"work), bound {bound_ms:.4f} ({bound_by}); attention_dots.cu (the "
        f"route before) {old_ms:.4f} ({executed / old_ms / 1e9:.1f} TFLOP/s "
        f"executed); in turns (timed_pair, warm): attention_dots.cu "
        f"{pair[0]:.4f} vs attention_dots_sm90.cu {pair[1]:.4f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, executed_flops=executed,
                old_ms=old_ms, pair_old_ms=pair[0], pair_ms=pair[1],
                library_note="two torch.bmm over the dense pair, "
                             f"{dense / executed:.2f}x the kernel's work")


def phase_roofs(smi: str) -> dict:
    """K9 and K10 against their plain versions (K10's new route also at the
    edges of its walk, its sub-tiles against the walk; the route before it
    at the three shapes), the tensor-core instructions of K10's route
    before, K1/K2 and K6/K7 against theirs at the microbenches' shapes;
    then the main path, bench.py's kernel-microbench path, with exact
    launch counts; then the kernel rows, timed cold, K10's two routes also
    in turns."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    err9, x = hbm_copy_checks(gen)
    cases = {what: dots_case(gen, what, shape) for what, shape in DOT_SHAPES}
    for what, shape in DOT_EDGE_SHAPES:
        dots_case(gen, what, shape, old=False)
    hmma = sass_count("attention_dots.cu", "HMMA")
    log(f"  attention_dots.cu (the route before) SASS: {hmma} HMMA "
        f"(mma.sync) instructions")
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
    want = {"hbm_copy": 2 * pingpongs, "attention_dots_sm90": calls,
            "flash_fwd_sm90": 2 * 3 * calls, "flash_bwd_sm90": 2 * calls,
            "layer_norm_fwd_sm90": 4 * calls, "layer_norm_bwd_sm90": 2 * calls}
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
        err, err_old, ops = cases.pop(what)
        rows[what] = time_dots(what, shape, *ops)
        rows[what].update(max_abs_err=err, old_max_abs_err=err_old)
        del ops
        torch.cuda.empty_cache()
    rows["hbm_copy"]["max_abs_err"] = err9
    # the route before, launched only to be compared: its timed calls
    launches["attention_dots (comparison)"] = kernels.ATTENTION_DOTS.launches
    return {"rows": rows, "launches": launches, "hbm_roof_gb_s": hbm,
            "matmul_roof_tflops": mm, "flash_attention_s1024": att_s1024,
            "flash_attention_s4096": att_s4096, "layer_norm": lnk,
            "hmma": hmma, "card": smi}


# the attention rows at one of K10's shapes (DOT_SHAPES: the same bh, s
# and d)
FLOOR_OF = {"flash_qkv_fwd_sm90": "GPT-1.3B (K3/K4)",
            "flash_qkv_bwd_sm90": "GPT-1.3B (K3/K4)",
            "flash_qkv_fwd": "GPT-1.3B (K3/K4)",
            "flash_qkv_bwd": "GPT-1.3B (K3/K4)",
            "flash_fwd_sm90_mha": "Transformer-big encoder (K1/K2)",
            "flash_fwd_mha": "Transformer-big encoder (K1/K2)",
            "flash_bwd_sm90": "Transformer-big encoder (K1/K2)",
            "flash_bwd": "Transformer-big encoder (K1/K2)"}


def demonstrated(timings: dict, probes: dict) -> dict:
    """Each kernel row's least time as demonstrated on this card in this
    run, beside its data-sheet bound: for an attention row at a K10 shape,
    the row's own flops (its visible pairs, 4 d each forward, 10 d
    backward) at the rate K10 reached on the pairs it executed there, and
    the same flops at ``matmul_roof``'s rate (cuBLAS, 8192^3 bf16); for
    any other row bound by bytes, its bytes over the HBM roof
    (``hbm_roof``, K9).  A row bound by operations at no K10 shape gets
    none.  K10 runs on ``wgmma`` fed by TMA, as K1-K4 do, without their
    softmax, so an attention row should not outrun its floor; a share
    above 100 % says the floor is still stale at that shape (logged, not
    hidden), and the matmul roof is the bar there."""
    roof = probes["hbm_roof_gb_s"] * 1e9
    mm_flops = probes["matmul_roof_tflops"] * 1e12
    out = {}
    for name, t in {**timings, "hbm_copy": probes["rows"]["hbm_copy"]}.items():
        extra = {}
        if name in FLOOR_OF:
            k10 = probes["rows"][FLOOR_OF[name]]
            work = t["flops"] / k10["executed_flops"]
            ms = work * k10["ms"]
            by = (f"dot floor x {work:.4f}, its flops over K10's executed "
                  f"({FLOOR_OF[name]})")
            mm_ms = t["flops"] / mm_flops * 1e3
            extra = dict(matmul_roof_ms=mm_ms,
                         share_of_matmul_roof=mm_ms / t["ms"])
        elif t["bound_by"] == "bytes":
            ms = t["bound_ms"] * HBM_BYTES_PER_S / roof
            by = "bytes at hbm_roof"
        else:
            continue
        out[name] = dict(demonstrated_ms=ms, demonstrated_by=by,
                         share_of_demonstrated=ms / t["ms"], **extra)
        log(f"  {name}: {t['ms']:.4f} ms; demonstrated least time "
            f"{ms:.4f} ms ({by}): {ms / t['ms']:.1%} of it; data-sheet "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}): "
            f"{t['bound_ms'] / t['ms']:.1%}")
        if extra:
            log(f"    its flops at matmul_roof ({mm_flops / 1e12:.1f} "
                f"TFLOP/s): {extra['matmul_roof_ms']:.4f} ms, "
                f"{extra['share_of_matmul_roof']:.1%} of it")
        if extra and ms > t["ms"]:
            log(f"    over 100 % of K10's floor: the wgmma floor is still "
                f"stale for {name} at this shape (the kernel outruns the "
                f"two products alone), not a limit")
    return out


#: the phase running now, named in the failure line
PHASE = {"n": 0, "name": "start"}


def begin(n: int, name: str, detail: str = "") -> None:
    PHASE.update(n=n, name=name)
    log(f"phase {n} {name}{detail}")


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
    begin(1, "device", f": {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}")

    begin(2, "build")
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
    sm90_build = sm90_build_checks()

    begin(3, "kernels vs plain versions on the card")
    timings = phase_kernels()

    begin(4, "toy engine, cuda vs cpu")
    toy = phase_toy()

    begin(5, "full-width engine (GPT-1.3B width, 24 layers, bf16)")
    serving = phase_full(smi)
    torch.cuda.empty_cache()

    begin(6, "toy training, cuda vs cpu")
    toy_train = phase_toy_training()

    begin(7, "full-width training (GPT-1.3B, 24 layers, bf16, batch 4 x "
          "2048)")
    train = phase_full_training(smi)
    torch.cuda.empty_cache()

    begin(8, "toy multi-head attention stack, cuda vs cpu")
    toy_mha = phase_toy_mha()

    begin(9, "full-width multi-head attention stack (Transformer-big, 6 + 6 "
          "layers, bf16, batch 32 x 256 / 192)")
    mha = phase_mha(smi)
    torch.cuda.empty_cache()

    begin(10, "toy training on the flat superblock, cuda vs cpu")
    phase_flat_toy()

    begin(11, "full-width training on the flat superblock (GPT-1.3B, "
          "FlatFusedAdam)")
    flat = phase_flat_training(smi, train)
    torch.cuda.empty_cache()

    begin(12, "roofs and floors: K9 (hbm_copy) and K10 (attention_dots), "
          "the kernel microbenches")
    probes = phase_roofs(smi)
    log("  each kernel row against what this card demonstrably reaches:")
    shares = demonstrated(timings, probes)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    PHASE.update(n=13, name="record")

    record = {"kernels": [
        # K1: the bf16 route at head dims 64 and 128 on the tensor cores
        # runs the serving prefill (phase 5), the multi-head attention step
        # (phase 9) and the microbenches (phase 12); the scalar kernel is
        # the fp32 and head dim 8 route (phases 4 and 8) and is timed on
        # bf16 as the kernel it replaced there
        dict(name="flash_fwd_sm90", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="apex_tpu/ops/attention.py:738",
             launches=serving["bf16"]["launches"]["flash_fwd_sm90"],
             launches_mha=mha["launches"]["flash_fwd_sm90"],
             launches_microbench=probes["launches"]["flash_fwd_sm90"],
             **timings["flash_fwd_sm90"]),
        dict(name="flash_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd.cu",
             replaces="apex_tpu/ops/attention.py:738",
             launches=toy_mha["launches"]["flash_fwd"],
             launches_toy_engine=toy["launches"]["flash_fwd"],
             **timings["flash_fwd"]),
        # K2: the bf16 route on the tensor cores runs the multi-head
        # attention step (phase 9); the scalar kernel is the fp32 and head
        # dim 8 route (phase 8's toy step) and is timed on bf16 as the
        # kernel it replaced there
        dict(name="flash_bwd_sm90", route="cuda",
             source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
             replaces="apex_tpu/ops/attention.py:1139",
             launches=mha["launches"]["flash_bwd_sm90"],
             **timings["flash_bwd_sm90"]),
        dict(name="flash_bwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_bwd.cu",
             replaces="apex_tpu/ops/attention.py:1139",
             launches=toy_mha["launches"]["flash_bwd"],
             **timings["flash_bwd"]),
    ] + [
        # K5: flash_decode_sm90.cu is the route at head dim 128, one entry
        # point a pool (phase 5 serves on each); flash_decode.cu is the
        # fp32 and head dim 8 route (phase 4's toy) and is timed on bf16
        # as the kernel it replaced there
        dict(name=name, route="cuda",
             source="apex_tpu_torch/csrc/flash_decode_sm90.cu",
             replaces="apex_tpu/ops/attention.py:2239",
             launches=serving[pool]["launches"][name], **timings[name])
        for pool, _, name in DECODE_POOLS
    ] + [
        dict(name="flash_decode", route="cuda",
             source="apex_tpu_torch/csrc/flash_decode.cu",
             replaces="apex_tpu/ops/attention.py:2239",
             launches=toy["launches"]["flash_decode"],
             **timings["flash_decode"]),
    ] + [
        # K3/K4: the bf16 route on the tensor cores runs the GPT-1.3B step
        # (phase 7); the scalar kernels are the fp32 route (phase 6's toy
        # step) and are timed on bf16 as the kernels they replaced there
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=runs["launches"][name],
             **timings[name])
        for name, src, where, runs in (
            ("flash_qkv_fwd_sm90", "flash_qkv_fwd_sm90.cu",
             "apex_tpu/ops/attention.py:1766", train),
            ("flash_qkv_bwd_sm90", "flash_qkv_bwd_sm90.cu",
             "apex_tpu/ops/attention.py:1800", train),
            ("flash_qkv_fwd", "flash_qkv_fwd.cu",
             "apex_tpu/ops/attention.py:1766", toy_train),
            ("flash_qkv_bwd", "flash_qkv_bwd.cu",
             "apex_tpu/ops/attention.py:1800", toy_train))
    ] + [
        # K6/K7: layer_norm_sm90.cu is the route at 1024, 2048 and 4096
        # columns: the GPT-1.3B steps (phases 7 and 11), the multi-head
        # attention step (phase 9) and the LayerNorm microbench (phase 12);
        # layer_norm.cu takes every other width (the toys' 256 and 32,
        # phases 6, 8 and 10) and is timed at 2048 as the kernel it replaced
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=runs["launches"][name],
             **({} if runs is toy_train else dict(
                 launches_mha=mha["launches"][name],
                 launches_flat=flat["launches"][name],
                 launches_microbench=probes["launches"][name])),
             **timings[name])
        for name, src, where, runs in (
            ("layer_norm_fwd_sm90", "layer_norm_sm90.cu",
             "apex_tpu/ops/fused_layer_norm.py:75", train),
            ("layer_norm_bwd_sm90", "layer_norm_sm90.cu",
             "apex_tpu/ops/fused_layer_norm.py:150", train),
            ("layer_norm_fwd", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:75", toy_train),
            ("layer_norm_bwd", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:150", toy_train))
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
        # K10: attention_dots_sm90.cu is the route of every input (the
        # microbench path, phase 12); attention_dots.cu, the route before,
        # is launched only to be compared with it (its launches are those
        # of the comparison), timed at the same shapes cold and in turns
        dict(name="attention_dots_sm90", route="cuda",
             source="apex_tpu_torch/csrc/attention_dots_sm90.cu",
             replaces="bench.py:2671",
             launches=probes["launches"]["attention_dots_sm90"],
             **probes["rows"]["bench"],
             at_shapes={what: probes["rows"][what]
                        for what, _ in DOT_SHAPES[1:]}),
        dict(name="attention_dots", route="cuda",
             source="apex_tpu_torch/csrc/attention_dots.cu",
             replaces="bench.py:2671",
             launches=probes["launches"]["attention_dots (comparison)"],
             **{**probes["rows"]["bench"],
                "ms": probes["rows"]["bench"]["old_ms"],
                "max_abs_err": probes["rows"]["bench"]["old_max_abs_err"]},
             at_shapes={what: dict(ms=probes["rows"][what]["old_ms"],
                                   max_abs_err=probes["rows"][what][
                                       "old_max_abs_err"])
                        for what, _ in DOT_SHAPES[1:]}),
    ]}
    for entry in record["kernels"]:
        entry.update(shares.get(entry["name"], {}))
        src = entry["source"].rsplit("/", 1)[1]
        if src in sm90_build:
            entry["sass"] = sm90_build[src]
    for entry, at in zip(record["kernels"][:2], ("flash_fwd_sm90_mha",
                                                 "flash_fwd_mha")):
        entry.update({f"{k}_mha": v for k, v in
                      {**timings[at], **shares[at]}.items()
                      if k not in ("bound_by", "flops")})
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # named on stderr, then the run fails
        print(f"chip_smoke: FAILED in phase {PHASE['n']} ({PHASE['name']}): "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        traceback.print_exc()
        code = 1
    sys.exit(code)
