"""K10's Hopper kernel (``csrc/attention_dots_sm90.cu``) against variants
of its schedule, and against probes that each take one cost away, timed
in turns on one card.

    python3 scripts/attention_dots_sm90_ab.py [--out FILE.json]

The variants are the committed source with its constants changed, made by
exact text substitution (the script stops if a pattern is missing):

* ``kept`` — the source as committed;
* ``two_wg128`` — at head dim 128 two consumer warpgroups a block (128
  query rows) and six stages, in place of three;
* ``four_wg64`` — at head dim 64 four warpgroups a block (256 rows), one
  block an SM and eight stages, in place of two blocks of two;
* ``ungrouped`` — one group of every batch-head: the q tiles with the
  longest walks first across all batch-heads (each wave of blocks reads
  every batch-head's K and V again);
* ``shallow`` — three stages at both head dims, the fewest the pipelined
  walk allows (a stage is held one step past its products).

The probes compute something else, so they are timed but not checked:

* ``same_keys`` — every step loads the first 64 keys of its batch-head
  (the same walk, barriers and products, with K and V from L2);
* ``no_pv`` — no P V product (S, the convert and the walk as kept);
* ``no_s`` — no S product (P converted from a stale accumulator).

Designs measured before and dropped (units of 128 keys, Q held in
registers, an eager refill, a persistent kernel) are listed in PERF.md
with the sources they ran.

Each is built with the package's ``nvcc`` flags into the git-ignored
``apex_tpu_torch/_build/ab/`` (its ``ptxas -v`` spills printed) and called
through the package's wrapper at ``chip_smoke.DOT_SHAPES`` (bench.py's
microbench, GPT-1.3B's attention at blocks of 64, Transformer-big's
encoder).  A variant changes only the schedule, not the order of any sum,
so each must give the plain version's result within one bf16 ulp at the
output's scale (2^-7 x max|ref|) and the committed kernel's bits.  Each
shape is timed warm (``timing.device_time_ms``, ten calls) in the order of
the variants and back (a, b, ..., b, a) and averaged, then once cold
(``timing.cold_ms``).
Prints the card and one JSON line; needs one CUDA card.
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
from apex_tpu_torch.profiling import roofs, timing  # noqa: E402

SRC = "attention_dots_sm90.cu"
D64 = "constexpr int kWarpgroupsD64 = 2, kStagesD64 = 5, kBlocksD64 = 2;"
D128 = "constexpr int kWarpgroupsD128 = 3, kStagesD128 = 5;"
GROUP = "constexpr int64_t kGroupBytes = 16ll << 20;"
VARIANTS = {
    "kept": [],
    "two_wg128": [(D128, "constexpr int kWarpgroupsD128 = 2, "
                         "kStagesD128 = 6;")],
    "four_wg64": [(D64, "constexpr int kWarpgroupsD64 = 4, kStagesD64 = 8, "
                        "kBlocksD64 = 1;")],
    "ungrouped": [(GROUP, "constexpr int64_t kGroupBytes = 1ll << 62;")],
    "shallow": [(D64, "constexpr int kWarpgroupsD64 = 2, kStagesD64 = 3, "
                      "kBlocksD64 = 2;"),
                (D128, "constexpr int kWarpgroupsD128 = 3, kStagesD128 = 3;")],
    "same_keys": [(f"{kv}, 64 * x, i * kStep, bh);", f"{kv}, 64 * x, 0, bh);")
                  for kv in ("&tm_k, &kv_full[st]", "&tm_v, &kv_full[st]")],
    "no_pv": [("for (int kk = 0; kk < kStep / 16; ++kk) mma_rs<D>(o, p[kk], "
               "v_box, kk, SM::kXBytes);",
               "for (int kk = 0; kk < kStep / 16; ++kk) (void)v_box;")],
    "no_s": [("      sm90::wgmma_ss_n64<0>(sacc, da, db, kk > 0);",
              "      (void)da, (void)db;")],
}
PROBES = ("same_keys", "no_pv", "no_s")


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
            [_build.cuda_tool(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{SRC}.so"), str(out / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
    kernel = kernels.ATTENTION_DOTS_SM90
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

    def call(*args):
        code = fn(*args)
        if code:
            raise RuntimeError(f"{kernel.symbol}: CUDA error {code}")
    return call


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
    gen = torch.Generator(device="cuda").manual_seed(13)
    for what, (bh, s, d, bq, bk) in cs.DOT_SHAPES:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        ref = roofs._attention_dots_plain(q, k, v, bq, bk)
        tol = cs.tolerance(ref)
        runs, row, kept = {}, {}, None
        for name in names:
            def run(name=name):
                with mock.patch.object(roofs, "ATTENTION_DOTS_SM90",
                                       calls[name]):
                    return roofs._attention_dots_cuda(q, k, v, bq, bk)
            o = run()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            kept = o if kept is None else kept
            if name in PROBES:
                err = None
            elif not (err <= tol and torch.equal(o, kept)):
                raise SystemExit(f"{what} {name}: {err:.3e} (tol {tol:.3e}), "
                                 f"bitwise to kept {torch.equal(o, kept)}")
            runs[name] = run
            row[name] = {"max_abs_err": err}
        del ref
        warm = {n: [] for n in names}
        for n in names + names[::-1]:
            warm[n].append(timing.device_time_ms(runs[n], steps=10))
        # the kernel's executed flops (a probe does less work)
        flops = 4 * d * bh * roofs.dots_pairs(s, bq, bk)
        for n in names:
            row[n]["warm_ms"] = sum(warm[n]) / 2
            row[n]["cold_ms"] = timing.cold_ms(runs[n], 20)
            row[n]["cold_executed_tflops"] = flops / row[n]["cold_ms"] / 1e9
        record[what] = row
        print(f"{what}: " + ", ".join(
            f"{n} cold {row[n]['cold_ms']:.4f} warm {row[n]['warm_ms']:.4f} ms"
            for n in names), flush=True)
        del q, k, v, runs
        torch.cuda.empty_cache()
    print(card)
    line = json.dumps(record)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
