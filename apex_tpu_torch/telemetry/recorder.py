"""Crash flight recorder: a bounded ring of the most recent events.

When the watchdog escalates, a SIGTERM lands, or a chaos
``DeviceLossError`` fires, a run would die with whatever happened to
be on stdout.  The recorder keeps the last N bus events in memory —
every type, so a postmortem shows the interleaving of steps, skips,
checkpoint saves, and watchdog heartbeats that led up to the crash —
and :meth:`TelemetryBus.flush_postmortem` dumps them to a
``postmortem_*.jsonl`` on the way down.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List


class FlightRecorder:
    """Bounded in-memory ring of telemetry events.

    ``capacity`` — events retained (default 256: at one step event per
    step plus occasional ckpt/skip events, roughly the last couple of
    hundred steps of context — enough to see a divergence spiral or a
    stall, small enough to never matter for memory)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)

    def record(self, event: Dict[str, Any]) -> None:
        self._ring.append(event)

    def snapshot(self) -> List[Dict[str, Any]]:
        """The retained events, oldest first (a copy — safe to flush
        while the loop keeps emitting)."""
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()
