"""K1's tensor-core kernel (``csrc/flash_fwd_sm90.cu``) against variants
of its schedule at head dim 64, timed in turns on one card.

    python3 scripts/flash_fwd_sm90_ab.py [--out FILE.json]

The variants are the committed source with one decision changed, made by
exact text substitution (the script stops if a pattern is missing):

* ``one_block`` — one block an SM where the kernel runs two (head dim
  64 without dropout or a non-causal additive mask), the 128-key tile
  still taken in two 64-key softmax steps;
* ``whole_tile`` — there too one softmax step of 128 keys a tile and one
  block an SM, as at head dim 128 (the S accumulators 64 registers a
  thread);
* ``mask_two_steps`` — two steps and two blocks an SM for the non-causal
  additive mask too, which ptxas spills at 128 registers (the decoder's
  mask shape runs that instance).

Each is built with the package's ``nvcc`` flags into the git-ignored
``apex_tpu_torch/_build/ab/`` (its ``ptxas -v`` spills printed) and
called through the package's wrapper at the multi-head attention path's
encoder shape ([32, 16, 256, 64] bf16, key-padding segments), the
decoder's ([32, 16, 192, 64], padding + causal additive mask) and the
serving prefill's ([1, 16, 1024, 128] causal, segments; head dim 128,
where the variants change nothing).  Every variant is held against the
plain version within one bf16 ulp at the output's scale (2^-7 x
max|ref|) and 1e-4 on lse.  Each shape is timed warm
(``timing.device_time_ms``, ten calls) in the order a, b, c, c, b, a and
averaged, then once cold (``timing.cold_ms``).  Prints the card and one
JSON line; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from apex_tpu_torch import kernels  # noqa: E402
from apex_tpu_torch.kernels import _build  # noqa: E402
from apex_tpu_torch.ops import attention as att  # noqa: E402
from apex_tpu_torch.profiling import timing  # noqa: E402

SRC = "flash_fwd_sm90.cu"
ONE_BLOCK = ("__launch_bounds__(kThreads, two_steps(D, CAUSAL, MASK, DROP) ? 2 : 1)",
             "__launch_bounds__(kThreads, 1)")
VARIANTS = {
    "kept": [],
    "one_block": [ONE_BLOCK],
    "whole_tile": [ONE_BLOCK,
                   ("constexpr int kSub = two_steps(D, CAUSAL, MASK, DROP) ? 64 : 128;",
                    "constexpr int kSub = 128;")],
    "mask_two_steps": [("  return d == 64 && !drop && (causal || !mask);",
                        "  return d == 64 && !drop;")],
}


def build(variants):
    """Each variant's source under _build/ab/<name>/, all compiled at once
    with the package's flags; returns {name: (loaded library, ptxas
    spill lines)}."""
    procs = {}
    for name, edits in variants.items():
        out = _build.BUILD_DIR / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            shutil.copy(f, out / f.name)
        text = (_build.CSRC / SRC).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: pattern not found once:\n{old}")
            text = text.replace(old, new)
        (out / SRC).write_text(text)
        procs[name] = (out, subprocess.Popen(
            [_build.cuda_tool(), *_build.NVCC_FLAGS, "-o", str(out / f"{SRC}.so"),
             str(out / SRC)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        spills = [(cs.demangle(fn), regs, stack, spill)
                  for fn, regs, stack, spill in cs.ptxas_report(log)
                  if stack or spill]
        built[name] = (ctypes.CDLL(str(out / f"{SRC}.so")), spills)
    return built


def bind(lib):
    kernel = kernels.FLASH_FWD_SM90
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

    def call(*args):
        code = fn(*args)
        if code:
            raise RuntimeError(f"{kernel.symbol}: CUDA error {code}")
    return call


def shapes(gen):
    """(name, q, k, v, the _flash_fwd_cuda arguments after v)."""
    B, S, T = cs.MHA["batch"], cs.MHA["src"], cs.MHA["tgt"]
    src_pad = cs.key_padding(cs.mha_lengths(5, B, 32, S), S)
    tgt_pad = cs.key_padding(cs.mha_lengths(6, B, 32, T), T)
    q, k, v, _ = cs.mha_operands(gen, torch.bfloat16, S, S, B, 64)
    seg_q, seg_k = cs.segments_of(src_pad, S)
    yield "encoder", q, k, v, (None, seg_q, seg_k, 0.125, False, 0.0, 0)
    q, k, v, _ = cs.mha_operands(gen, torch.bfloat16, T, T, B, 64)
    mask = (torch.where(tgt_pad, cs.MASK_FILL, 0.0)[:, None, None, :]
            + cs.causal_fill(T, T))
    yield "decoder_mask", q, k, v, (mask, None, None, 0.125, False, 0.0, 0)
    q, k, v, seg = cs.prefill_operands(gen, torch.bfloat16, [700])
    yield "prefill", q, k, v, (None, seg, seg, 128 ** -0.5, True, 0.0, 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()
    timing.require_card()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    calls, record = {}, {"card": card, "spills": {}}
    for name, (lib, spills) in build(VARIANTS).items():
        calls[name] = bind(lib)
        record["spills"][name] = spills
        print(f"{name}: spills or stack in {spills}", flush=True)
    names = list(VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for what, q, k, v, op_args in shapes(gen):
        ro, rlse = att._flash_fwd_plain(q, k, v, *op_args)
        tol = cs.tolerance(ro)
        runs, row = {}, {}
        for name in names:
            def run(name=name):
                with mock.patch.object(att, "FLASH_FWD_SM90", calls[name]):
                    return att._flash_fwd_cuda(q, k, v, *op_args)
            o, lse = run()
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            lerr = (lse - rlse).abs().max().item()
            if not (err <= tol and lerr <= cs.LSE_TOL):
                raise SystemExit(f"{what} {name}: o {err:.3e} (tol {tol:.3e}), "
                                 f"lse {lerr:.3e}")
            runs[name] = run
            row[name] = {"max_abs_err": err, "lse_err": lerr}
        warm = {n: [] for n in names}
        for n in names + names[::-1]:
            warm[n].append(timing.device_time_ms(runs[n], steps=10))
        for n in names:
            row[n]["warm_ms"] = sum(warm[n]) / 2
            row[n]["cold_ms"] = timing.cold_ms(runs[n], 20)
        record[what] = row
        print(f"{what}: " + ", ".join(
            f"{n} cold {row[n]['cold_ms']:.4f} warm {row[n]['warm_ms']:.4f} ms"
            for n in names), flush=True)
    print(card)
    line = json.dumps(record)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
