"""How often K1's lse misses its plain version's by more than
``chip_smoke.LSE_TOL`` on rows whose every key an additive mask hides,
over many seeded draws, on both of K1's bf16 routes.

    python3 scripts/lse_masked_rows.py [--draws 150] [--out FILE.json]

Phase 3 of ``chip_smoke.py`` holds one draw of this case ("mask hides
every key of a row", b = 4, 4 heads, s = 200, the keys of batch row 1
all at ``MASK_FILL``) at head dims 64 and 128.  Such a row's lse lies
near -1e4, where fp32's spacing (2^-10, ~9.8e-4) is ten times
``LSE_TOL`` (1e-4): a score or a row sum rounded another way moves lse
by a whole step there.  This script's readings (every miss one spacing)
set ``chip_smoke.check_lse``'s bar to max(``LSE_TOL``, one fp32 spacing
at |ref|) elementwise; it still counts the misses of ``LSE_TOL`` alone.
This script draws the case ``--draws`` times a head dim (q, k, v from
one seeded generator, the other rows' key lengths from seeds 100 + i)
and counts, for the tensor-core kernel (``flash_fwd_sm90.cu``) and the
scalar one (``flash_fwd.cu``, patched in through
``att._fwd_on_tensor_cores``), the draws and the rows whose lse gap
exceeds ``LSE_TOL``.  Each such row's gap is also recorded in fp32
spacings at |ref| (the distance from |ref| to the next float32 above
it): ``miss_spacings`` counts the misses by that size, and
``miss_draws`` names the draws (the key-length seed) that had one.
Prints the card and one JSON line; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from apex_tpu_torch.ops import attention as att  # noqa: E402
from apex_tpu_torch.profiling import timing  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=150)
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()
    timing.require_card()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(77)
    record = {"card": card, "draws": args.draws, "lse_tol": cs.LSE_TOL}
    for d in (64, 128):
        over = {"flash_fwd_sm90": [0, 0], "flash_fwd": [0, 0]}  # draws, rows
        sizes = {n: {} for n in over}      # spacings -> misses of that size
        missed = {n: [] for n in over}     # seeds of the draws with a miss
        for i in range(args.draws):
            lens = cs.mha_lengths(100 + i, 4, 1, 200)
            lens[1] = 0   # every key of batch row 1 masked
            mask = torch.where(cs.key_padding(lens, 200)[:, None, None, :],
                               cs.MASK_FILL, 0.0)
            q, k, v, _ = cs.mha_operands(gen, torch.bfloat16, 200, 200, 4, d, 4)
            op_args = (mask, None, None, d ** -0.5, False, 0.0, 0)
            _, ref = att._flash_fwd_plain(q, k, v, *op_args)
            _, new = att._flash_fwd_cuda(q, k, v, *op_args)
            with mock.patch.object(att, "_fwd_on_tensor_cores",
                                   lambda t: False):
                _, old = att._flash_fwd_cuda(q, k, v, *op_args)
            spacing = cs.fp32_spacing(ref)
            for name, lse in (("flash_fwd_sm90", new), ("flash_fwd", old)):
                gap = (lse - ref).abs()
                miss = gap > cs.LSE_TOL
                rows = int(miss.sum())
                over[name][0] += rows > 0
                over[name][1] += rows
                if rows:
                    missed[name].append(100 + i)
                for n in (gap[miss] / spacing[miss]).tolist():
                    key = f"{n:g}"
                    sizes[name][key] = sizes[name].get(key, 0) + 1
        record[f"d{d}"] = {n: {"draws_over": c[0], "rows_over": c[1],
                               "miss_spacings": sizes[n],
                               "miss_draws": missed[n]}
                           for n, c in over.items()}
        print(f"d={d}: draws (rows) over LSE_TOL of {args.draws}: " + ", ".join(
            f"{n} {c[0]} ({c[1]}; misses by fp32 spacings at |ref| "
            f"{sizes[n]})" for n, c in over.items()), flush=True)
    print(card)
    line = json.dumps(record)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
