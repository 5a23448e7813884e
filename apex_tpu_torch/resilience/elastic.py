"""The step watchdog (port of ``WatchdogTimeout`` and ``Watchdog`` from
the JAX package's ``apex_tpu/resilience/elastic.py``; host threads only).

:class:`Watchdog` arms a deadline around each step; on overrun its
monitor thread logs per-device last-heartbeat ages and step-duration
percentiles (the straggler diagnostic) and escalates: an ``on_hang``
callback, a grace handler's ``request_stop``, or — neither configured —
:class:`WatchdogTimeout` raised at the next step's entry.  The serving
engine arms it around every step (``ServingEngine(watchdog=...)``).

Escalation is cooperative: a watchdog firing flips a flag, and the loop
(presumed stuck *slow*, not stuck *dead*) acts at the next step
boundary.  A truly wedged device needs an external watchdog.

Not ported yet (ROADMAP.md): the elastic training loop and the ZeRO
checkpoint helpers.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Sequence

log = logging.getLogger("apex_tpu_torch.resilience")


class WatchdogTimeout(RuntimeError):
    """A watched step overran its deadline and no escalation target
    (handler / on_hang) was configured to absorb it."""


def _percentiles(durations: Sequence[float]) -> dict:
    if not durations:
        return {}
    s = sorted(durations)
    pick = lambda q: s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]
    return {"p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99),
            "max": s[-1], "n": len(s)}


class Watchdog:
    """Deadline monitor for device steps.

    Arm it around each step::

        wd = Watchdog(timeout=30.0, handler=grace_handler)
        for step, batch in enumerate(batches):
            with wd.step(step):
                state = train_step(state, batch)

    A single daemon monitor thread checks the armed deadline.  On
    overrun it fires **once** per armed step: builds a diagnostic
    :meth:`report` (per-device last-heartbeat ages — a straggling or
    lost device shows up as the stale one — plus step-duration
    percentiles over the last ``history`` steps), logs it, and
    escalates, in order of availability:

    1. ``on_hang(report)`` callback, if given;
    2. ``handler.request_stop(reason=...)`` — a grace handler's path:
       the loop stops cleanly at the next step boundary;
    3. neither configured: :class:`WatchdogTimeout` is raised at the
       next :meth:`step` entry (a hang must never be silent).

    ``timeout`` may be a number (seconds) or a callable
    ``durations -> seconds`` for an adaptive deadline (e.g. ``lambda d:
    10 * max(d[-20:])``); an adaptive deadline is UNARMED (infinite)
    until the first step completes and its duration history exists.

    Heartbeat granularity: the host observes step *completion*, which
    is a whole-mesh barrier — so by default every device in ``devices``
    (default: every local card, or device 0 without one) is stamped together at each successful step,
    and the per-device ages diverge only via :meth:`mark_lost` (stops
    expecting a device, annotating it as gone rather than stale) or
    :meth:`beat` (integrations with a genuine per-device liveness
    signal — e.g. a platform health poller — call it to give the hang
    report real per-device resolution).
    """

    def __init__(self, timeout, *, handler=None,
                 on_hang: Optional[Callable[[dict], None]] = None,
                 devices: Optional[Sequence] = None,
                 history: int = 256, poll_interval: Optional[float] = None,
                 telemetry=None,
                 mesh_axes: Optional[dict] = None,
                 device_coords: Optional[dict] = None):
        self.timeout = timeout
        self.handler = handler
        self.on_hang = on_hang
        # optional TelemetryBus: every fire emits a typed `watchdog`
        # event (the report rides the flight-recorder ring into any
        # postmortem); emitted from the monitor thread — the bus is
        # thread-safe by contract
        self.telemetry = telemetry
        # per-axis attribution: give the watchdog the mesh decomposition
        # (``mesh_axes`` {axis: size}, mesh order, and ``device_coords``
        # {device id: coordinate tuple}) and its hang report names the
        # group that stalled, not just the device
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.device_coords = dict(device_coords) if device_coords else None
        if devices is None:
            import torch

            devices = list(range(max(1, torch.cuda.device_count())))
        self.device_ids = [getattr(d, "id", d) for d in devices]
        self.history = int(history)
        self.poll_interval = poll_interval
        self.durations: list = []
        self.last_beat = {d: None for d in self.device_ids}
        self.lost: set = set()
        self.fired_steps: list = []
        self.last_report: Optional[dict] = None
        self._armed_step: Optional[int] = None
        self._deadline: Optional[float] = None
        self._fired_this_arm = False
        self._pending_raise: Optional[dict] = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- arming ----------------------------------------------------------

    def _current_timeout(self) -> float:
        if callable(self.timeout):
            if not self.durations:
                # adaptive deadlines have nothing to adapt to before
                # the first completed step: stay unarmed rather than
                # crash the documented `lambda d: 10 * max(d[-20:])`
                return float("inf")
            return float(self.timeout(self.durations))
        return float(self.timeout)

    def step(self, step_index: int):
        """Context manager arming the deadline for one train step."""
        return _ArmedStep(self, int(step_index))

    def _arm(self, step_index: int) -> None:
        with self._lock:
            if self._pending_raise is not None:
                report, self._pending_raise = self._pending_raise, None
                raise WatchdogTimeout(
                    f"step {report['step']} overran the "
                    f"{report['timeout']:.3g}s watchdog deadline "
                    f"(report: {report})")
            self._armed_step = step_index
            self._fired_this_arm = False
            self._deadline = time.monotonic() + self._current_timeout()
        self._ensure_thread()
        self._wake.set()

    def _disarm(self, step_index: int, duration: float, ok: bool) -> None:
        with self._lock:
            self._armed_step = None
            self._deadline = None
            if ok:
                self.durations.append(duration)
                del self.durations[: -self.history]
                now = time.monotonic()
                for d in self.device_ids:
                    if d not in self.lost:
                        self.last_beat[d] = now

    # -- diagnosis -------------------------------------------------------

    def mark_lost(self, device_ids) -> None:
        """Stop expecting heartbeats from ``device_ids`` (they are gone,
        not straggling)."""
        self.lost.update(getattr(d, "id", d) for d in device_ids)

    def beat(self, device_id) -> None:
        """Record a genuine per-device liveness observation (platform
        health poller, per-device completion event).  Without these,
        the host only sees whole-mesh step completion and all live
        devices carry the same age."""
        self.last_beat[getattr(device_id, "id", device_id)] = (
            time.monotonic())

    def step_percentiles(self) -> dict:
        """Duration percentiles over the retained step history."""
        return _percentiles(self.durations)

    def max_heartbeat_age(self) -> Optional[float]:
        """Age in seconds of the STALEST live device's last heartbeat
        (None before any step completes).  The log-line stall signal:
        a climbing age means the mesh stopped completing steps well
        before the deadline escalates."""
        now = time.monotonic()
        ages = [now - t for d, t in self.last_beat.items()
                if t is not None and d not in self.lost]
        return max(ages) if ages else None

    def axis_report(self) -> Optional[dict]:
        """Per-axis stall attribution (requires mesh_axes/device_coords):
        for every mesh axis, each coordinate group's stalest live
        heartbeat age and lost-device list, plus ``suspect`` — per axis,
        the group index holding the overall stalest (or a lost) device.
        A tp group whose collective wedged shows up as ONE suspect
        tensor index with every data index implicated symmetrically —
        the signature that distinguishes a tp-leg fault from a dp
        straggler."""
        if not self.mesh_axes or not self.device_coords:
            return None
        now = time.monotonic()
        axes = list(self.mesh_axes)
        groups: dict = {a: {} for a in axes}
        never = {a: set() for a in axes}
        for d, coords in self.device_coords.items():
            age = None
            t = self.last_beat.get(d)
            if t is not None and d not in self.lost:
                age = round(now - t, 3)
            for ai, a in enumerate(axes):
                g = groups[a].setdefault(int(coords[ai]),
                                         {"max_age_s": None, "lost": []})
                if d in self.lost:
                    g["lost"].append(d)
                elif age is not None and (g["max_age_s"] is None
                                          or age > g["max_age_s"]):
                    g["max_age_s"] = age
                elif age is None:
                    # a live device that NEVER heartbeat is infinitely
                    # stale, not infinitely fresh — score it as such so
                    # a group wedged before its first completed step
                    # cannot make a healthy, freshly-beaten group the
                    # suspect (the report keeps max_age_s None: "no
                    # observation", JSON-safe)
                    never[a].add(int(coords[ai]))
        suspect = {}
        for a in axes:
            scored = [(gi, (len(g["lost"]),
                            float("inf") if gi in never[a]
                            else g["max_age_s"] or 0.0))
                      for gi, g in sorted(groups[a].items())]
            if not scored:
                continue
            worst = max(scored, key=lambda x: x[1])
            best = min(scored, key=lambda x: x[1])
            # only name a suspect when the axis actually DIVERGES —
            # identical ages on every group (the healthy whole-mesh
            # barrier case) implicate nothing
            if worst[1] > best[1]:
                suspect[a] = worst[0]
        return {"mesh_axes": dict(self.mesh_axes),
                "groups": {a: {str(k): v for k, v in sorted(gs.items())}
                           for a, gs in groups.items()},
                "suspect": suspect}

    def report(self) -> dict:
        """Straggler diagnostic: per-device heartbeat age + percentiles
        (+ per-axis group attribution when the mesh decomposition is
        configured)."""
        now = time.monotonic()
        ages = {d: (None if t is None else round(now - t, 3))
                for d, t in self.last_beat.items()}
        out = {
            "step": self._armed_step,
            "timeout": self._current_timeout(),
            "device_heartbeat_age_s": ages,
            "lost_devices": sorted(self.lost),
            "step_duration_percentiles": self.step_percentiles(),
        }
        ax = self.axis_report()
        if ax is not None:
            out["axis_groups"] = ax
        return out

    @property
    def expired(self) -> bool:
        """True once any armed step has overrun its deadline."""
        return bool(self.fired_steps)

    # -- monitor thread --------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="apex-tpu-torch-watchdog", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while not self._stop:
            with self._lock:
                deadline = self._deadline
                armed = (self._armed_step is not None
                         and not self._fired_this_arm)
            if not armed or deadline is None:
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            wait = deadline - time.monotonic()
            if wait > 0:
                quantum = self.poll_interval or max(0.005, min(wait, 0.05))
                time.sleep(min(wait, quantum))
                continue
            self._fire()

    def _fire(self) -> None:
        with self._lock:
            if self._fired_this_arm or self._armed_step is None:
                return
            self._fired_this_arm = True
            step = self._armed_step
        report = self.report()
        report["step"] = step
        self.fired_steps.append(step)
        self.last_report = report
        log.error("watchdog: step %d overran its %.3gs deadline — %s",
                  step, report["timeout"], report)
        if self.telemetry is not None:
            try:
                self.telemetry.emit("watchdog", step=step, report=report)
            except Exception:  # pragma: no cover — never break escalation
                log.exception("watchdog telemetry emit failed")
        if self.on_hang is not None:
            self.on_hang(report)
        elif self.handler is not None:
            self.handler.request_stop(
                reason=f"watchdog_timeout(step={step})")
        else:
            with self._lock:
                self._pending_raise = report

    def close(self) -> None:
        self._stop = True
        self._wake.set()

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _ArmedStep:
    def __init__(self, wd: Watchdog, step_index: int):
        self.wd = wd
        self.step_index = step_index
        self.t0 = 0.0

    def __enter__(self):
        self.wd._arm(self.step_index)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc):
        self.wd._disarm(self.step_index, time.monotonic() - self.t0,
                        ok=exc_type is None)
