"""Graceful-shutdown handling for preemptible workers (port of the JAX
package's ``apex_tpu/resilience/preemption.py``).

Preemptible/spot machines get a SIGTERM and a short grace window before
the machine disappears. :class:`GracePeriodHandler` converts the signal
into a cooperative flag the train loop polls at step boundaries, so the
loop can finish the current step, write a final checkpoint, and exit
cleanly:

    with GracePeriodHandler() as preempt:
        for step in range(start, n_steps):
            state = train_step(state, batch)
            if preempt.should_stop:
                save_checkpoint(ckpt_dir, state, step=step + 1)
                break

The handler never raises from inside the signal context (async-signal-safe:
it only flips a flag), restores the previous handlers on exit, and degrades
to a manual :meth:`request_stop`-only object off the main thread (Python
only delivers signals to the main thread; worker threads and tests use
``request_stop`` — which is also what the chaos harness's simulated
preemption calls).
"""

from __future__ import annotations

import signal
import threading
from typing import Optional, Tuple


class GracePeriodHandler:
    """Catch SIGTERM/SIGINT and expose them as a pollable stop flag."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = tuple(signals)
        self._stop = threading.Event()
        self._signum: Optional[int] = None
        self._reason: Optional[str] = None
        self._count = 0
        self._prev: dict = {}
        self._installed = False

    # -- signal side (must stay trivial: runs in the signal context) --
    def _on_signal(self, signum, frame) -> None:
        self._signum = signum
        self._count += 1
        self._stop.set()
        if self._count >= 3 and signum in self._prev:
            # operator insists (third signal): fall back to the previous
            # handler so a stuck loop can still be killed with ^C ^C ^C
            signal.signal(signum, self._prev[signum])

    # -- train-loop side --
    @property
    def should_stop(self) -> bool:
        """True once a termination signal (or :meth:`request_stop`) arrived.
        Poll this at step boundaries."""
        return self._stop.is_set()

    @property
    def reason(self) -> Optional[str]:
        """Why stop was requested: signal name, the caller-supplied
        :meth:`request_stop` reason, "requested", or None."""
        if not self._stop.is_set():
            return None
        if self._signum is None:
            return self._reason or "requested"
        try:
            return signal.Signals(self._signum).name
        except ValueError:  # pragma: no cover — unknown signal number
            return f"signal {self._signum}"

    def request_stop(self, reason: Optional[str] = None) -> None:
        """Programmatic preemption: same effect as receiving a signal.
        Used by tests/chaos, by schedulers that know shutdown is coming
        (e.g. a maintenance-event notification poller), and by the
        collective watchdog's escalation
        (:class:`~apex_tpu_torch.resilience.elastic.Watchdog`) — ``reason``
        makes the *source* of the stop visible in logs/LoopResult."""
        if reason is not None and not self._stop.is_set():
            self._reason = reason
        self._stop.set()

    def reset(self) -> None:
        """Clear the flag (e.g. after handling a stop and deciding to
        continue anyway)."""
        self._stop.clear()
        self._signum = None
        self._reason = None
        self._count = 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until stop is requested (or timeout). Returns the flag."""
        return self._stop.wait(timeout)

    # -- installation --
    def install(self) -> "GracePeriodHandler":
        """Install signal handlers.  Off the main thread Python forbids
        ``signal.signal`` — then the handler still works, but only via
        :meth:`request_stop`."""
        if self._installed:
            return self
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError:  # not the main thread
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                try:
                    signal.signal(s, prev)
                except ValueError:  # pragma: no cover
                    pass
            self._prev.clear()
            self._installed = False

    def __enter__(self) -> "GracePeriodHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
