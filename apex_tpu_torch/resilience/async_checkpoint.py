"""Background checkpoint writer with fence-on-next-save semantics (port
of the JAX package's ``apex_tpu/resilience/async_checkpoint.py``).

:func:`apex_tpu_torch.checkpoint.save_checkpoint` with ``blocking=False``
copies the tree to host memory on the caller's thread (so tensors the
optimizer then updates in place cannot corrupt the save) and hands the
disk phase to the single writer thread owned by this module.

Semantics (the "fence" rules, Orbax AsyncCheckpointer-style):

- at most ONE write is ever in flight: any subsequent save — async or
  blocking — first waits for the previous write to land;
- :func:`wait_for_save` is the explicit fence (call it before reading the
  checkpoint back, before exiting a training context, or at a step you
  must be sure is durable);
- interpreter exit fences automatically (``atexit``), so a run that
  finishes right after an async save does not lose it;
- a write that fails *after retries* parks its exception and re-raises it
  at the next fence (save/wait/exit) — errors are never silently dropped.
"""

from __future__ import annotations

import atexit
import threading
from typing import Callable, Optional


class AsyncSaveError(RuntimeError):
    """A background checkpoint write failed; raised at the next fence.

    ``__cause__`` carries the original storage exception."""


class _SerialWriter:
    """One daemon thread executing at most one submitted job at a time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._done.set()
        self._error: Optional[BaseException] = None
        self._label: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

    def submit(self, fn: Callable[[], object], *, label: str = "") -> None:
        """Run ``fn`` on the writer thread. Caller must hold no pending
        write (use :meth:`wait` first — ``save_checkpoint`` does)."""
        self.wait()
        with self._lock:
            self._done.clear()
            self._label = label

            def _run():
                try:
                    fn()
                except BaseException as e:  # parked; re-raised at the fence
                    with self._lock:
                        self._error = e
                finally:
                    self._done.set()

            self._thread = threading.Thread(
                target=_run, name="apex-tpu-torch-ckpt-writer", daemon=True)
            self._thread.start()

    @property
    def in_flight(self) -> bool:
        return not self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Fence: block until the pending write (if any) completes; re-raise
        a parked failure from the previous write."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"checkpoint write {self._label!r} still in flight after "
                f"{timeout}s")
        with self._lock:
            err, self._error = self._error, None
            label = self._label
        if err is not None:
            raise AsyncSaveError(
                f"background checkpoint write {label!r} failed: {err}"
            ) from err


_writer: Optional[_SerialWriter] = None
_writer_lock = threading.Lock()


def _get_writer() -> _SerialWriter:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = _SerialWriter()
            atexit.register(_exit_fence)
        return _writer


def submit_save(fn: Callable[[], object], *, label: str = "") -> None:
    """Enqueue the disk phase of a save (internal; used by
    ``save_checkpoint(blocking=False)``)."""
    _get_writer().submit(fn, label=label)


def wait_for_save(timeout: Optional[float] = None) -> None:
    """Fence on any in-flight async checkpoint write.

    No-op when nothing is pending.  Re-raises (as :class:`AsyncSaveError`)
    a background write failure that has not yet been surfaced."""
    if _writer is not None:
        _writer.wait(timeout)


def in_flight() -> bool:
    """True while an async checkpoint write is still running."""
    return _writer is not None and _writer.in_flight


def drain(*, ignore_errors: bool = False) -> None:
    """Test harness helper: fence, optionally swallowing parked errors so
    one test's injected failure cannot leak into the next test."""
    try:
        wait_for_save()
    except Exception:
        if not ignore_errors:
            raise


def _exit_fence() -> None:  # pragma: no cover — exercised at interpreter exit
    try:
        wait_for_save()
    except Exception as e:
        import sys

        print(f"apex_tpu_torch.resilience: async checkpoint write failed "
              f"at exit: {e}", file=sys.stderr)
