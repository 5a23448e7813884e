"""Telemetry bus: typed events, pluggable sinks, postmortem flushing
(port of the JAX package's ``apex_tpu/telemetry/bus.py``).

A long-running process emits one structured event stream instead of
scattered ``print`` lines:

    bus = TelemetryBus(run_id="serve-0", sinks=[JsonlSink(path)])
    bus.emit("decode_step", step=12, batch=8, new_tokens=8, ...)
    ...
    bus.flush_postmortem(reason="SIGTERM")  # ring -> postmortem_*.jsonl
    bus.close()

Every event is stamped with the run id, the global step (when known),
monotonic time since bus creation (``t``), wall-clock time (``ts``),
and the mesh topology — so a reader can always answer *which run,
which step, which mesh, when* without joining against out-of-band
logs.

Emission is cheap by construction (a dict build plus per-sink append;
no device syncs) and thread-safe (the
:class:`~apex_tpu_torch.resilience.elastic.Watchdog` monitor thread emits
``watchdog`` events from outside the loop it watches).

The JAX package's recompile listener, which hooks XLA's compile events,
has no counterpart: eager PyTorch compiles nothing per step.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, Optional

from apex_tpu_torch.telemetry.schema import EVENT_TYPES  # noqa: F401

log = logging.getLogger("apex_tpu_torch.telemetry")

# The typed event vocabulary (``EVENT_TYPES``) is DERIVED from the
# single-sourced field-spec table in :mod:`apex_tpu_torch.telemetry.schema`:
# ``emit`` rejects anything outside it, and — because the set is
# ``frozenset(EVENT_FIELDS)`` — an event type cannot be added without
# its field spec, so the schema and the runtime validator can never
# drift apart.
# Each type's meaning is documented next to its field spec there.


class TelemetryError(ValueError):
    """Raised on emit of an unknown event type (typo-guard: a stream
    with free-form types cannot be validated or diffed)."""


class JsonlSink:
    """Append events to a JSONL file, one line per event, flushed per
    write — the file must be parseable right up to a crash (it feeds
    the postmortem story, not just offline analysis)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, event: Dict[str, Any]) -> None:
        self._f.write(json.dumps(event) + "\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class MemorySink:
    """Keep events in a list — the test tier's sink."""

    def __init__(self):
        self.events: list = []

    def write(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class StdoutSink:
    """Print events as JSON lines (operator tailing a run live)."""

    def write(self, event: Dict[str, Any]) -> None:
        print(json.dumps(event), flush=True)

    def close(self) -> None:
        pass


def default_mesh_topology() -> Dict[str, Any]:
    """Mesh stamp: the card count and ``"gpu"`` when a card is present,
    else one ``"cpu"`` device (the CPU engine's)."""
    import torch

    if torch.cuda.is_available():
        return {"n_devices": torch.cuda.device_count(), "platform": "gpu"}
    return {"n_devices": 1, "platform": "cpu"}


class TelemetryBus:
    """Low-overhead structured event stream for a long-running process.

    ``sinks`` — any objects with ``write(event_dict)`` / ``close()``
    (:class:`JsonlSink`, :class:`MemorySink`, :class:`StdoutSink`).
    ``recorder`` — a :class:`~apex_tpu_torch.telemetry.recorder.FlightRecorder`
    holding the last-N events for crash postmortems; one is created by
    default so every bus can flush a postmortem.  ``mesh`` — the
    topology stamp applied to every event; update it via
    :meth:`set_mesh` when a rebuild changes the devices.
    ``postmortem_dir`` — where :meth:`flush_postmortem` writes; defaults
    to the first JsonlSink's directory, else the cwd.
    """

    def __init__(self, run_id: Optional[str] = None, *,
                 sinks: Iterable = (), recorder: Any = None,
                 mesh: Optional[Dict[str, Any]] = None,
                 postmortem_dir: Optional[str] = None):
        if recorder is None:
            from apex_tpu_torch.telemetry.recorder import FlightRecorder

            recorder = FlightRecorder()
        self.run_id = run_id or f"run-{os.getpid()}-{int(time.time())}"
        self.sinks = list(sinks)
        self.recorder = recorder
        self.mesh = dict(mesh) if mesh is not None else (
            default_mesh_topology())
        self.counts: Dict[str, int] = {}
        self.t0 = time.monotonic()
        self._postmortem_dir = postmortem_dir
        self._postmortems = 0
        self._watchdog = None
        self._accountant = None
        self._lock = threading.Lock()

    # -- emission --------------------------------------------------------

    def _stamp(self, type: str, step: Optional[int],
               payload: Dict[str, Any]) -> Dict[str, Any]:
        ev = {
            "type": type,
            "run_id": self.run_id,
            "step": int(step) if step is not None else None,
            "t": round(time.monotonic() - self.t0, 6),
            "ts": round(time.time(), 3),
            "mesh": self.mesh,
        }
        ev.update(payload)
        return ev

    def emit(self, type: str, *, step: Optional[int] = None,
             **payload: Any) -> Dict[str, Any]:
        """Stamp and fan out one event; returns the stamped dict."""
        if type not in EVENT_TYPES:
            raise TelemetryError(
                f"unknown event type {type!r}; known: "
                f"{sorted(EVENT_TYPES)}")
        ev = self._stamp(type, step, payload)
        with self._lock:
            self.counts[type] = self.counts.get(type, 0) + 1
            if self.recorder is not None:
                self.recorder.record(ev)
            for s in list(self.sinks):
                try:
                    s.write(ev)
                except Exception:
                    # observability must never kill the run it observes
                    # (ENOSPC on the stream file, a broken pipe): log,
                    # drop the sink, keep running.  The in-memory
                    # recorder still holds the ring for a postmortem.
                    log.exception("telemetry sink %s failed; dropping it",
                                  s.__class__.__name__)
                    self.sinks.remove(s)
        return ev

    def set_mesh(self, mesh: Dict[str, Any]) -> None:
        """Update the topology stamp (a rebuild on fewer devices).
        Applies to events emitted from now on."""
        with self._lock:
            self.mesh = dict(mesh)

    # -- shared accounting / watchdog attachment -------------------------

    def accountant(self, window: int = 10):
        """The bus's shared
        :class:`~apex_tpu_torch.telemetry.accounting.StepAccountant`
        (created on first call), so every loop over this bus keeps one
        goodput ledger."""
        if self._accountant is None:
            from apex_tpu_torch.telemetry.accounting import StepAccountant

            self._accountant = StepAccountant(self, window=window)
        return self._accountant

    def attach_watchdog(self, watchdog) -> None:
        """Remember the run's watchdog so postmortems include its
        per-device heartbeat ages, and give the watchdog this bus to
        emit ``watchdog`` events on escalation."""
        self._watchdog = watchdog
        if getattr(watchdog, "telemetry", None) is None:
            watchdog.telemetry = self

    # -- postmortem ------------------------------------------------------

    @property
    def postmortem_dir(self) -> str:
        if self._postmortem_dir:
            return self._postmortem_dir
        for s in self.sinks:
            if isinstance(s, JsonlSink):
                return os.path.dirname(s.path)
        return os.getcwd()

    def flush_postmortem(self, reason: str, *, step: Optional[int] = None,
                         watchdog: Any = None,
                         extra: Optional[Dict[str, Any]] = None
                         ) -> Optional[str]:
        """Write the flight-recorder ring to ``postmortem_*.jsonl``.

        The file is a header event (``type="postmortem"``: reason, ring
        size, watchdog heartbeat-age report when available) followed by
        the recorded last-N events, oldest first.  The header (with the
        file path, without the ring) is also emitted to the live sinks
        so the main stream records that — and where — a postmortem was
        taken.  Returns the path, or None when no recorder is attached.
        """
        if self.recorder is None:
            return None
        wd = watchdog if watchdog is not None else self._watchdog
        payload: Dict[str, Any] = {"reason": reason}
        if wd is not None:
            try:
                payload["watchdog"] = wd.report()
            except Exception:
                pass
        if extra:
            payload.update(extra)
        with self._lock:
            ring = self.recorder.snapshot()
            self._postmortems += 1
            n = self._postmortems
        payload["ring_events"] = len(ring)
        path = os.path.join(
            self.postmortem_dir,
            f"postmortem_{self.run_id}_{n:02d}.jsonl")
        header = self._stamp("postmortem", step, payload)
        os.makedirs(self.postmortem_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps(dict(header, path=path)) + "\n")
            for ev in ring:
                f.write(json.dumps(ev) + "\n")
        # announce on the live stream too (ring stays in the file only)
        self.emit("postmortem", step=step, reason=reason, path=path,
                  ring_events=len(ring))
        return path

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def __enter__(self) -> "TelemetryBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
