"""K3/K4's tensor-core kernels (``csrc/flash_qkv_{fwd,bwd}_sm90.cu``)
against two variants of their schedule, timed in turns on one card.

    python3 scripts/flash_qkv_sm90_ab.py [--out FILE.json]

The variants are the committed sources with one decision changed, made by
exact text substitution (the script stops if a pattern is missing):

* ``tile_major`` — the grid's x is the tile and y the batch*head, so the
  blocks resident at once belong to few heads and share their K/V (or
  Q/dO) through L2, instead of the heavy causal tiles of every head
  first;
* ``lag_one`` — warp 0 refills the stage of the tile before the one it
  has just finished (one more stage in the forward and the dq pass), so
  the two warpgroups may drift a tile apart.

Each is built with the package's ``nvcc`` flags into the git-ignored
``apex_tpu_torch/_build/ab/`` and called through the package's wrappers
at the GPT-1.3B training shape ([4, 2048, 16·3·128] bf16, causal), with
dropout 0.1 and without.  Every variant must give the committed build's
bits.  The forward and the backward of the three are timed warm
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

from apex_tpu_torch import kernels  # noqa: E402
from apex_tpu_torch.kernels import _build  # noqa: E402
from apex_tpu_torch.ops import attention as att  # noqa: E402
from apex_tpu_torch.profiling import timing  # noqa: E402

FWD, BWD = "flash_qkv_fwd_sm90.cu", "flash_qkv_bwd_sm90.cu"

# (source, old text, new text) a variant applies, each exactly once
VARIANTS = {
    "kept": [],
    "tile_major": [
        (FWD, "  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;\n"
              "  const int qb = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;",
         "  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;\n"
         "  const int qb = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;"),
        (FWD, "const dim3 grid(a.B * a.H, (a.s + kBQ - 1) / kBQ);",
         "const dim3 grid((a.s + kBQ - 1) / kBQ, a.B * a.H);"),
        (BWD, "  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;\n"
              "  const int kb = blockIdx.y, k0 = kb * kKV2;",
         "  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;\n"
         "  const int kb = blockIdx.x, k0 = kb * kKV2;"),
        (BWD, "a.visits[static_cast<int64_t>(bh) * gridDim.y + kb]",
         "a.visits[static_cast<int64_t>(bh) * gridDim.x + kb]"),
        (BWD, "  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;\n"
              "  const int n_qb = gridDim.y;\n"
              "  const int qb = CAUSAL ? n_qb - 1 - blockIdx.y : blockIdx.y;",
         "  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;\n"
         "  const int n_qb = gridDim.x;\n"
         "  const int qb = CAUSAL ? n_qb - 1 - blockIdx.x : blockIdx.x;"),
        (BWD, "<<<dim3(a.B * a.H, (a.s + kKV2 - 1) / kKV2),",
         "<<<dim3((a.s + kKV2 - 1) / kKV2, a.B * a.H),"),
        (BWD, "<<<dim3(a.B * a.H, (a.s + kQ3 - 1) / kQ3),",
         "<<<dim3((a.s + kQ3 - 1) / kQ3, a.B * a.H),"),
    ],
    "lag_one": [
        (FWD, "constexpr int kStages = 2;", "constexpr int kStages = 3;"),
        (FWD, "    if (warp == 0 && i + kStages < n_tiles) {\n"
              "      sm90::mbar_wait(&kv_empty[st], (i / kStages) & 1);",
         "    if (warp == 0 && i >= 1 && i - 1 + kStages < n_tiles) {\n"
         "      sm90::mbar_wait(&kv_empty[(i - 1) % kStages], ((i - 1) / kStages) & 1);"),
        (FWD, "      issue(i + kStages);", "      issue(i - 1 + kStages);"),
        (BWD, "kK3 = 64, kStages3 = 3;", "kK3 = 64, kStages3 = 4;"),
    ] + [
        (BWD, f"    if (warp == 0 && i + {n} < n_tiles) {{\n"
              f"      sm90::mbar_wait(&t_empty[st], (i / {n}) & 1);",
         f"    if (warp == 0 && i >= 1 && i - 1 + {n} < n_tiles) {{\n"
         f"      sm90::mbar_wait(&t_empty[(i - 1) % {n}], ((i - 1) / {n}) & 1);")
        for n in ("kStages2", "kStages3")
    ] + [(BWD, f"      issue(i + {n});", f"      issue(i - 1 + {n});")
         for n in ("kStages2", "kStages3")],
}


def build(name: str, edits) -> dict:
    """Write the variant's sources under _build/ab/<name>/, compile both
    with the package's flags; returns {source: loaded library}."""
    out = _build.BUILD_DIR / "ab" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    for src in (FWD, BWD):
        text = (_build.CSRC / src).read_text()
        for where, old, new in edits:
            if where != src:
                continue
            if text.count(old) != 1:
                raise SystemExit(f"{name}: pattern not found once in {src}:\n{old}")
            text = text.replace(old, new)
        (out / src).write_text(text)
    procs = {src: subprocess.Popen(
        [_build.cuda_tool(), *_build.NVCC_FLAGS, "-o", str(out / f"{src}.so"),
         str(out / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in (FWD, BWD)}
    libs = {}
    for src, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed on {src}:\n{log}")
        libs[src] = ctypes.CDLL(str(out / f"{src}.so"))
    return libs


def bind(libs, kernel):
    fn = getattr(libs[kernel.source], kernel.symbol)
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
    calls = {}
    for name, edits in VARIANTS.items():
        libs = build(name, edits)
        calls[name] = dict(
            FLASH_QKV_FWD_SM90=bind(libs, kernels.FLASH_QKV_FWD_SM90),
            FLASH_QKV_BWD_SM90=bind(libs, kernels.FLASH_QKV_BWD_SM90))
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, d = 4, 2048, 16, 128
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
    dctx = torch.randn(b, s, h * d, generator=gen, device="cuda").bfloat16()
    record = {"card": card, "shape": [b, s, h, d], "causal": True}
    names = list(VARIANTS)
    for rate in (0.1, 0.0):
        op_args = (None, None, h, d ** -0.5, True, rate, 1234)
        outs, runs = {}, {}
        for name in names:
            with mock.patch.multiple(att, **calls[name]):
                ctx, lse = att._flash_qkv_fwd_cuda(qkv, *op_args)
                dqkv = att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse, *op_args)
            outs[name] = (ctx, lse, dqkv)

            def fwd(name=name):
                with mock.patch.multiple(att, **calls[name]):
                    att._flash_qkv_fwd_cuda(qkv, *op_args)

            def bwd(name=name, ctx=ctx, lse=lse):
                with mock.patch.multiple(att, **calls[name]):
                    att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse, *op_args)
            runs[name] = {"fwd": fwd, "bwd": bwd}
        torch.cuda.synchronize()
        same = {n: all(torch.equal(x, y) for x, y in zip(outs["kept"], outs[n]))
                for n in names}
        if not all(same.values()):
            raise SystemExit(f"dropout {rate}: a variant's bits differ: {same}")
        row = {}
        for part in ("fwd", "bwd"):
            warm = {n: [] for n in names}
            for n in names + names[::-1]:
                warm[n].append(timing.device_time_ms(runs[n][part], steps=10))
            for n in names:
                row.setdefault(n, {})[f"{part}_warm_ms"] = sum(warm[n]) / 2
                row[n][f"{part}_cold_ms"] = timing.cold_ms(runs[n][part], 10)
        record[f"dropout_{rate}"] = row
    print(card)
    line = json.dumps(record)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
