"""Per-step accounting: wall-time split, batched scalars, goodput (port
of the JAX package's ``apex_tpu/telemetry/accounting.py``).

Two disciplines, both about *not* paying for observability:

1. **No extra device syncs.**  Scalar metrics (loss, grad norm, loss
   scale, skip counters) are device tensors; reading one per step would
   serialize the asynchronous launch queue the train loop keeps full.
   :meth:`StepAccountant.step_done` therefore only *holds the latest
   device references*; at every ``window``-th step it reads them back
   together — the same synchronisation the loop's ``log_interval``
   print already pays — and attaches the values to that step's event.

2. **Time is bucketed, not just summed.**  Each step's wall is split
   into data-wait / step / checkpoint-fence stall, and pauses the loop
   knows about (restore, rebuild, compile) are booked to their own
   buckets.  **Goodput** is the productive fraction: time spent in
   non-skipped train steps over total wall — skips, restores and
   checkpoint fences all drag it below 1 even when the run finished
   fine.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

#: Non-step time buckets ``pause`` accepts (the JAX package's set;
#: ``profile`` is its profile sampler's own overhead, not ported yet).
PAUSE_KINDS = ("ckpt_fence", "restore", "rebuild", "compile", "data_wait",
               "profile", "other")


def _to_scalar(v: Any):
    """Best-effort native-typing of a fetched scalar."""
    try:
        a = np.asarray(v.float() if isinstance(v, torch.Tensor)
                       and v.dtype == torch.bfloat16 else v)
        if a.size != 1:
            return a.tolist()
        if a.dtype.kind in "fc":
            return float(a.reshape(()))
        if a.dtype.kind in "iub":
            x = a.reshape(())
            return bool(x) if a.dtype.kind == "b" else int(x)
    except Exception:
        pass
    return v


class StepAccountant:
    """Goodput ledger + windowed scalar fetcher over a TelemetryBus.

    One per run (get it via ``bus.accountant()`` so every loop over the
    bus shares the ledger).  The loop calls :meth:`step_done` once per step,
    :meth:`pause` for known non-step time, :meth:`finish` on exit.
    """

    def __init__(self, bus, window: int = 10):
        self.bus = bus
        self.window = max(1, int(window))
        self.t_start = time.monotonic()
        self.buckets: Dict[str, float] = {"step": 0.0, "skipped": 0.0}
        for k in PAUSE_KINDS:
            self.buckets.setdefault(k, 0.0)
        self.steps = 0
        self.skips = 0
        self._pending: Dict[str, Any] = {}

    # -- per-step --------------------------------------------------------

    def step_done(self, step: int, *, step_s: float,
                  data_wait_s: float = 0.0, skipped: bool = False,
                  compile_s: float = 0.0,
                  scalars: Optional[Dict[str, Any]] = None,
                  **extra: Any) -> Dict[str, Any]:
        """Book one completed step and emit its ``step`` event.

        ``scalars`` — device references (or host values) to surface;
        held until the window boundary, then fetched in one batch.
        ``compile_s`` — compile wall observed *inside* this step's
        measurement (kernels built at first use): booked to the
        ``compile`` bucket instead of productive step time, so a
        first-step build cannot inflate goodput.
        ``step_ms`` on the event stays the full measured wall — that IS
        the step time the operator saw — with ``compile_ms`` alongside.
        ``extra`` — host-side payload merged into the event as-is
        (e.g. ``timing="amortized"`` for bench loops that only sync per
        trial)."""
        self.steps += 1
        compile_s = min(float(compile_s), float(step_s))
        self.buckets["compile"] += compile_s
        productive_s = float(step_s) - compile_s
        self.buckets["skipped" if skipped else "step"] += productive_s
        self.buckets["data_wait"] += float(data_wait_s)
        if scalars:
            self._pending.update(
                {k: v for k, v in scalars.items() if v is not None})
        payload: Dict[str, Any] = {"step_ms": round(step_s * 1e3, 3)}
        if compile_s > 0:
            payload["compile_ms"] = round(compile_s * 1e3, 3)
        if data_wait_s > 0:
            payload["data_wait_ms"] = round(data_wait_s * 1e3, 3)
        if skipped:
            payload["skipped"] = True
            self.skips += 1
        payload.update(extra)
        if self.steps % self.window == 0:
            fetched = self.fetch_scalars()
            if fetched:
                payload["scalars"] = fetched
        return self.bus.emit("step", step=step, **payload)

    def fetch_scalars(self) -> Dict[str, Any]:
        """Read every pending device scalar back to the host, together."""
        if not self._pending:
            return {}
        refs, self._pending = self._pending, {}
        vals = {k: v.detach().to("cpu") if isinstance(v, torch.Tensor)
                else v for k, v in refs.items()}
        return {k: _to_scalar(v) for k, v in vals.items()}

    def pause(self, seconds: float, kind: str) -> None:
        """Book non-step time the loop can attribute (see
        :data:`PAUSE_KINDS`)."""
        if kind not in PAUSE_KINDS:
            raise ValueError(
                f"unknown pause kind {kind!r}; known: {PAUSE_KINDS}")
        self.buckets[kind] += float(seconds)

    # -- aggregates ------------------------------------------------------

    def wall(self) -> float:
        return time.monotonic() - self.t_start

    def goodput(self) -> float:
        """Productive-step fraction of total wall so far (skips,
        restores, rebuilds, fences, and idle all count against it).
        Clamped to 1.0: the buckets are host-measured slices of the
        same wall, so only clock rounding could push the ratio over."""
        return min(1.0, self.buckets["step"] / max(self.wall(), 1e-9))

    def totals(self) -> Dict[str, Any]:
        wall = self.wall()
        out = {"wall_s": round(wall, 3), "steps": self.steps,
               "skips": self.skips,
               "goodput": round(self.goodput(), 4),
               "steps_per_sec": round(self.steps / max(wall, 1e-9), 3)}
        out["buckets_s"] = {k: round(v, 3)
                            for k, v in self.buckets.items() if v > 0}
        return out

    def finish(self, step: Optional[int] = None,
               reason: str = "completed") -> Dict[str, Any]:
        """Emit the ``run_end`` event carrying the ledger (and any
        scalars still pending from a partial window)."""
        payload = dict(self.totals(), reason=reason)
        fetched = self.fetch_scalars()
        if fetched:
            payload["scalars"] = fetched
        return self.bus.emit("run_end", step=step, **payload)
