"""The three kernel-vs-plain gaps of ``chip_smoke.py`` phase 9 (the
Transformer-big multi-head attention step), read over many states of the
weights instead of one.

    python3 scripts/mha_step_gaps.py [--steps 10] [--out FILE.json]

Phase 9 holds one dropout-free step through the kernels against the same
step through the plain versions (``chip_smoke.mha_gaps``): the loss
(relative), the global grad norm (relative) and the worst leaf's
|g - g_plain| / |g_plain|, each against a bar of ten times the largest gap
read on an H100.  The loss is the forward's alone (K1's and the
LayerNorms' bf16 outputs against the fp32 plain versions through 12
layers), so its gap is rounding noise that changes with every weight:
one reading says little about the next state.  This script builds phase
9's stack (``MHAStack(seed=0)``) and batch, reads the three gaps at the
seeded initial weights, then trains ``--steps`` steps with phase 9's
generator seeds (1000 + i for the first five, then the generator runs
on) and reads them after each step, on whatever route the kernels take
now.

At each state it also reads the loss gap of two controls, forwards made
worse on purpose: the LayerNorm forward computed in bf16 (statistics and
normalisation in the activations' dtype, no fp32), and K1 replaced by its
plain version with the scores rounded to bf16 before the masks and the
softmax.  They say how far a loss bar sits from a forward of lower
precision.  Prints the card's name and power limit and one JSON line
(the readings by state, their maxima and minima, and phase 9's bars);
needs one CUDA card.
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
from apex_tpu_torch.ops import fused_layer_norm as ln  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam  # noqa: E402

BARS = {"loss": cs.MHA_PLAIN_LOSS_TOL, "grad_norm": cs.MHA_PLAIN_NORM_TOL,
        "worst_leaf": cs.MHA_PLAIN_LEAF_TOL}


def ln_fwd_bf16(x2d, weight, bias, eps):
    """The LayerNorm forward in the activations' dtype throughout (a
    control): ``_ln_fwd_plain`` without its fp32."""
    mean = x2d.mean(-1)
    xc = x2d - mean[:, None]
    invvar = torch.rsqrt((xc * xc).mean(-1) + eps)
    y = xc * invvar[:, None]
    if weight is not None:
        y = y * weight.to(y.dtype)[None, :]
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :]
    return y, mean.float(), invvar.float()


def fwd_scores_bf16(*args):
    """K1's plain version with the scores rounded to bf16 before the masks
    and the softmax (a control)."""
    apply = att._apply_masks
    with mock.patch.object(att, "_apply_masks", lambda s, *rest: apply(
            s.bfloat16().float(), *rest)):
        return att._flash_fwd_plain(*args)


CONTROLS = {
    "control_layer_norm_bf16": lambda: mock.patch.object(
        ln, "_ln_fwd_cuda", ln_fwd_bf16),
    "control_scores_bf16": lambda: mock.patch.object(
        att, "_flash_fwd_cuda", fwd_scores_bf16)}


def gaps(model, batch) -> dict:
    """Phase 9's three gaps at the model's weights, and each control's
    loss gap against the same plain loss."""
    g = cs.mha_gaps(model, batch)
    out = {"loss": g["loss_rel"], "grad_norm": g["norm_rel"],
           "worst_leaf": max(g["leaf"].values())}
    for name, patch in CONTROLS.items():
        with patch(), torch.no_grad():
            control = cs.mha_loss(model, batch).item()
        out[name] = abs(control - g["ref_loss"]) / abs(g["ref_loss"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mha_step_gaps: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    c = cs.MHA
    batch = cs.mha_batch("cuda", torch.bfloat16, c["hidden"], c["batch"],
                         c["src"], c["tgt"], 32, seed=3)
    model = cs.MHAStack(c["hidden"], c["heads"], c["layers"], c["dropout"],
                        "cuda")
    opt = FusedAdam(model.parameters(), lr=cs.MHA_LR)
    gen = torch.Generator(device="cuda")
    states = [gaps(model, batch)]
    for it in range(args.steps):
        if it < 5:
            gen.manual_seed(1000 + it)
        cs.mha_step(model, opt, batch, gen)
        states.append(gaps(model, batch))
    keys = list(states[0])
    result = {"card": smi, "bars": BARS, "steps": args.steps,
              "by_state": states,
              "max": {k: max(s[k] for s in states) for k in keys},
              "min": {k: min(s[k] for s in states) for k in keys},
              "states_over_bar": {k: sum(s[k] > BARS[k] for s in states)
                                  for k in BARS}}
    for k in keys:
        print(f"{k}: " + " ".join(f"{s[k]:.3e}" for s in states), flush=True)
    print(smi)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
