#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Drives the port only (it imports neither ``jax`` nor ``apex_tpu``).
Phases, each of which fails the run (non-zero exit) on error:

1. device — a CUDA card is required; its name and power limit are read
   from ``nvidia-smi``;
2. build — ``apex_tpu_torch/csrc/*.cu`` are compiled with ``nvcc`` (in
   parallel, one process per source);
3. kernels — each kernel against its plain PyTorch version on the card,
   at the serving main path's shapes (bf16) and in fp32, with the
   tolerance stated; then timed (operands cold in L2) beside its plain
   version, one PyTorch library call computing the same function, and its
   bound;
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
   device-done times are reported beside the serve metrics.

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
from apex_tpu_torch.ops import attention as att  # noqa: E402
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
    return {"flash_fwd": fwd, "flash_decode": dec}


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
    launches = {k.symbol: k.launches for k in kernels.KERNELS}

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
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
