"""Deterministic fault injection for the serving engine (port of the
serving part of the JAX package's ``apex_tpu/resilience/chaos.py``).

Faults are reproduced against the engine's fault hook,
:func:`apex_tpu_torch.serving.engine.set_fault_hook`:

- :class:`SlowDecode` — sleep at a chosen decode step (a wedged/slow
  device step); the engine's step watchdog must escalate instead of
  the trace hanging;
- :class:`ServingDeviceLoss` — raise :class:`DeviceLossError` at a
  chosen decode step, mid-serve; the engine must rebuild the pool,
  restore the live requests, and continue with the token streams of an
  uninterrupted run;
- :func:`corrupt_page` / :class:`CorruptLivePage` — flip a byte inside
  a pool page's K bytes (an HBM bit flip); the opt-in per-page CRC
  read-back validation must catch it as
  :class:`~apex_tpu_torch.serving.kv_cache.PagePoolCorruption` (and the
  engine recovers the same way — page content is rebuildable).

Test-only by design: nothing here is imported by production modules at
module scope, and the hook slot is cleared by the context managers even
when the simulated crash propagates.  The checkpoint, data and fleet
faults are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Optional


class DeviceLossError(RuntimeError):
    """One or more mesh devices disappeared (preempted chip, failed host).

    Carries ``device_ids`` so a harness knows which devices survive.
    The chaos tier raises it deterministically
    (:class:`ServingDeviceLoss`); a deployment raises it from its
    platform's failure signal at the step boundary.  A CUDA error the
    runtime raises is NOT mapped to it: a sticky CUDA error leaves the
    context unusable, so it must reach the caller."""

    def __init__(self, device_ids, detail: str = ""):
        self.device_ids = sorted(getattr(d, "id", d) for d in device_ids)
        msg = f"lost device(s) {self.device_ids}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class _ServingFault:
    """Base for serving fault injectors: installs itself on
    :func:`apex_tpu_torch.serving.set_fault_hook` as a context manager,
    chaining to any previously-installed hook.  Subclasses implement
    ``_on_event(event, info)``; ``event`` is ``"decode"`` (info = the
    engine's decode-step count so far) or ``"prefill"`` (info = rid)."""

    def __init__(self, *, telemetry=None):
        self.telemetry = telemetry
        self.events = 0
        self._prev_hook = None

    def _hook(self, event: str, info: int) -> None:
        if self._prev_hook is not None:
            self._prev_hook(event, info)
        self.events += 1
        self._on_event(event, info)

    def _on_event(self, event: str, info: int) -> None:
        raise NotImplementedError

    def __enter__(self):
        from apex_tpu_torch.serving import engine as _eng

        self._prev_hook = _eng.set_fault_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        from apex_tpu_torch.serving import engine as _eng

        _eng.set_fault_hook(self._prev_hook)
        self._prev_hook = None


class SlowDecode(_ServingFault):
    """Sleep ``delay`` seconds before the ``at_step``-th decode launch
    (1-based over this injector's lifetime) — a wedged or straggling
    decode step as seen from the host.  The engine's decode-loop
    watchdog must overrun and escalate; without one the trace would
    simply hang for ``delay``."""

    def __init__(self, *, at_step: int, delay: float, times: int = 1,
                 telemetry=None):
        super().__init__(telemetry=telemetry)
        self.at_step = at_step
        self.delay = float(delay)
        self.times = times
        self.decodes = 0
        self.slowed = 0

    def _on_event(self, event: str, info: int) -> None:
        if event != "decode":
            return
        self.decodes += 1
        if self.decodes < self.at_step or self.slowed >= self.times:
            return
        self.slowed += 1
        if self.telemetry is not None:
            self.telemetry.emit("fault_injected", kind="slow_decode",
                                at_decode_step=self.decodes,
                                delay_s=self.delay)
        time.sleep(self.delay)


class ServingDeviceLoss(_ServingFault):
    """Raise :class:`DeviceLossError` at the ``at_step``-th decode
    launch — a chip disappearing MID-DECODE, after requests are
    admitted and holding pool pages.  Fires once: the engine's
    rebuild + restore must sail past the same point on the retry."""

    def __init__(self, *, at_step: int, device_ids=(0,), telemetry=None):
        super().__init__(telemetry=telemetry)
        self.at_step = at_step
        self.device_ids = list(device_ids)
        self.decodes = 0
        self.fired = False

    def _on_event(self, event: str, info: int) -> None:
        if event != "decode":
            return
        self.decodes += 1
        if self.fired or self.decodes < self.at_step:
            return
        self.fired = True
        if self.telemetry is not None:
            self.telemetry.emit(
                "fault_injected", kind="device_loss",
                device_ids=[getattr(d, "id", d) for d in self.device_ids],
                at_decode_step=self.decodes)
        raise DeviceLossError(
            self.device_ids,
            detail=f"injected mid-decode at step {self.decodes}")


def corrupt_page(cache, page: int, *, which: str = "k") -> None:
    """Flip one byte inside pool page ``page``'s stored bytes (layer 0,
    middle row, head 0, the first element's lowest byte), in place — an
    HBM bit flip / bad DMA stand-in.  A cache built with per-page CRC
    validation (``crc_pages=True``) must catch it on the next read-back
    as :class:`~apex_tpu_torch.serving.kv_cache.PagePoolCorruption`;
    without CRCs the damage silently perturbs that request's
    attention."""
    import torch

    pool = getattr(cache, which)
    raw = pool.view(torch.uint8)    # the element's bytes, last axis
    r = cache.page_size // 2
    raw[0, page, r, 0, 0] ^= 0xFF


class CorruptLivePage(_ServingFault):
    """Corrupt the lowest-index LIVE pool page just before the
    ``at_step``-th decode launch — mid-serve damage, so the CRC
    read-back check (which runs after this hook in the decode path)
    catches it on exactly the step it happened."""

    def __init__(self, cache, *, at_step: int, telemetry=None):
        super().__init__(telemetry=telemetry)
        self.cache = cache
        self.at_step = at_step
        self.decodes = 0
        self.corrupted_page: Optional[int] = None

    def _on_event(self, event: str, info: int) -> None:
        if event != "decode":
            return
        self.decodes += 1
        if self.corrupted_page is not None or self.decodes < self.at_step:
            return
        live = sorted(self.cache._owner)
        if not live:
            return  # nothing to damage yet; try the next decode step
        self.corrupted_page = live[0]
        if self.telemetry is not None:
            self.telemetry.emit("fault_injected", kind="corrupt_page",
                                page=self.corrupted_page,
                                at_decode_step=self.decodes)
        corrupt_page(self.cache, self.corrupted_page)
