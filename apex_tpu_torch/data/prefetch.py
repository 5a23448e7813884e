"""Double-buffered async host→device prefetcher (port of the JAX
package's ``apex_tpu/data/prefetch.py``).

A background thread pulls batches from the source iterator (disk read +
decode + an optional ``transfer``, so the host-to-card copy overlaps the
previous step's compute) into a bounded queue; the train loop's
``next()`` only blocks when the queue runs dry — and that blocked time
is exactly the ``data_wait`` the telemetry ledger books.

:func:`to_device` is the transfer to the card: on the loader thread it
pins each host array, copies it with ``non_blocking=True`` on a side
stream and records an event; ``next()`` then makes the consumer's
current stream wait on that event and records the tensors
onto it (``record_stream``), so the copy overlaps the step without a
synchronisation.

Fault surface:

- **backpressure** — the queue is bounded (``depth``, default 2: double
  buffering); a fast producer parks instead of ballooning host memory;
- **stall telemetry** — a ``next()`` that waits longer than
  ``stall_threshold_s`` emits a ``data_stall`` event (cause
  ``queue_dry``) and counts toward :attr:`stalls`;
- **loader death is loud** — an exception in the worker (shard
  unreadable past re-assignment, quarantine overflow, decode bug)
  is captured and re-raised at the consumer's next ``next()`` as
  :class:`DataLoaderError` chained to the original, so the train
  loop's crash path (postmortem flush) sees it like any step failure;
- **exactly-once state** — the worker snapshots the source's
  ``state_dict()`` *after producing each batch* and the snapshot rides
  the queue; :meth:`state_dict` returns the snapshot of the last batch
  the consumer actually took, so in-flight (prefetched but unconsumed)
  batches are never marked consumed.  On restore they are simply
  regenerated — the source's deterministic addressing makes the replay
  bitwise identical.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

_END = "end"
_ERROR = "error"
_ITEM = "item"


class DataLoaderError(RuntimeError):
    """The background loader thread died; the original exception is
    chained (``__cause__``)."""


class DeviceBatch:
    """Tensors copied to the card on the loader thread, with the event
    recorded on the copy's stream (what :func:`to_device` produces)."""

    def __init__(self, tensors: tuple, event, host: list):
        self.tensors = tensors
        self.event = event
        self._host = host      # the pinned sources, alive until taken

    def ready(self) -> tuple:
        """The tensors, usable on the caller's current stream: that
        stream waits for the copy (no host synchronisation), and the
        allocator learns the tensors are used there."""
        stream = torch.cuda.current_stream(self.tensors[0].device)
        stream.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(stream)
        self._host = None
        return self.tensors


def to_device(device) -> Callable[[Sequence], Any]:
    """A ``transfer`` for :class:`AsyncPrefetcher` moving a tuple of host
    arrays to ``device``: on a CUDA device a :class:`DeviceBatch` (pinned
    memory, a non-blocking copy on a side stream, an event), elsewhere a
    tuple of tensors."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return lambda batch: tuple(torch.from_numpy(np.ascontiguousarray(x))
                                   .to(dev) for x in batch)
    streams: dict = {}

    def transfer(batch):
        stream = streams.get("s")
        if stream is None:
            stream = streams["s"] = torch.cuda.Stream(dev)
        host = [torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                for x in batch]
        with torch.cuda.stream(stream):
            out = tuple(h.to(dev, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(stream)
        return DeviceBatch(out, event, host)

    return transfer


class AsyncPrefetcher:
    """Wrap an iterator with a background producer thread + bounded
    queue.

    ``source`` — any iterator; if it has ``state_dict``/
    ``load_state_dict`` (the checkpointable-iterator protocol) the
    prefetcher is checkpointable too, with consumed-cursor semantics
    (see module doc).  ``transfer`` — optional callable applied to each
    batch ON THE WORKER THREAD (e.g. :func:`to_device`; the overlap is
    the point); a :class:`DeviceBatch` it returns is made ready on the
    consumer's stream by ``next()``.  ``depth`` — queue bound (2 =
    double buffering).
    """

    def __init__(self, source: Any, *, depth: int = 2,
                 transfer: Optional[Callable[[Any], Any]] = None,
                 stall_threshold_s: float = 0.1,
                 telemetry=None, start: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.source = source
        self.depth = int(depth)
        self.transfer = transfer
        self.stall_threshold_s = float(stall_threshold_s)
        self.telemetry = telemetry
        self._q: queue.Queue = queue.Queue(self.depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._checkpointable = hasattr(source, "state_dict")
        self._consumed_state: Optional[dict] = (
            source.state_dict() if self._checkpointable else None)
        self._exhausted = False
        self.wait_s = 0.0
        self.stalls = 0
        self.batches = 0
        if start:
            self.start()

    # -- worker ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        # fresh per-generation stop flag + queue: a worker that outlived
        # a _halt() join timeout still holds ITS generation's (set) event
        # and orphaned queue, so it can never observe the restart and
        # produce into the new stream as a duplicate producer
        self._stop = threading.Event()
        self._q = queue.Queue(self.depth)
        self._thread = threading.Thread(
            target=self._run, args=(self._stop, self._q),
            name="apex-tpu-torch-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item, stop, q) -> bool:
        """Backpressured put that stays responsive to stop()."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, stop, q) -> None:
        try:
            while not stop.is_set():
                try:
                    batch = next(self.source)
                except StopIteration:
                    self._put((_END, None, None), stop, q)
                    return
                if self.transfer is not None:
                    batch = self.transfer(batch)
                snap = (self.source.state_dict()
                        if self._checkpointable else None)
                if not self._put((_ITEM, batch, snap), stop, q):
                    return
        except BaseException as e:  # loader death must be LOUD
            self._put((_ERROR, e, None), stop, q)

    # -- consumer --------------------------------------------------------

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        t0 = time.monotonic()
        kind, payload, snap = self._q.get()
        wait = time.monotonic() - t0
        self.wait_s += wait
        if wait > self.stall_threshold_s:
            self.stalls += 1
            if self.telemetry is not None:
                try:
                    self.telemetry.emit(
                        "data_stall", wait_ms=round(wait * 1e3, 3),
                        cause="queue_dry", depth=self.depth)
                except Exception:
                    pass
        if kind == _ERROR:
            self._exhausted = True
            raise DataLoaderError(
                f"data loader thread died: {type(payload).__name__}: "
                f"{payload}") from payload
        if kind == _END:
            self._exhausted = True
            raise StopIteration
        self._consumed_state = snap
        self.batches += 1
        return payload.ready() if isinstance(payload, DeviceBatch) \
            else payload

    def __iter__(self):
        return self

    def take_wait(self) -> float:
        """Accumulated consumer wait since the last call (seconds) —
        the train loop books this into the ``data_wait`` bucket."""
        w, self.wait_s = self.wait_s, 0.0
        return w

    # -- checkpointable-iterator protocol --------------------------------

    def state_dict(self) -> dict:
        """Position of the last CONSUMED batch (in-flight prefetched
        batches are not consumed; a restore regenerates them)."""
        if not self._checkpointable:
            raise TypeError(
                f"source {type(self.source).__name__} is not "
                "checkpointable (no state_dict)")
        return self._consumed_state

    def load_state_dict(self, state: dict) -> None:
        """Stop the worker, drop every prefetched batch, restore the
        source position, restart."""
        if not self._checkpointable:
            raise TypeError(
                f"source {type(self.source).__name__} is not "
                "checkpointable (no load_state_dict)")
        if not self._halt():
            # the worker may still be INSIDE next(source); mutating the
            # source's cursors under it would silently break exactly-once
            raise DataLoaderError(
                "loader thread did not stop within 5s (wedged in a "
                "shard read?) — cannot safely restore the iterator "
                "position under a live reader")
        self.source.load_state_dict(state)
        self._consumed_state = self.source.state_dict()
        self._exhausted = False
        self.start()

    # -- lifecycle -------------------------------------------------------

    def _halt(self) -> bool:
        """Stop the worker; True when it actually exited.  A worker that
        outlives the join timeout (wedged in a shard read) is abandoned —
        its generation's stop event stays set and its queue orphaned, so
        it can never produce again — but the source must then be treated
        as possibly still in use (the False return)."""
        self._stop.set()
        # drain so a parked producer's put() can observe the stop flag
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        t, self._thread = self._thread, None
        stopped = True
        if t is not None:
            t.join(timeout=5.0)
            stopped = not t.is_alive()
        while True:  # anything the worker flushed while joining
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        return stopped

    def close(self) -> None:
        self._halt()
        close = getattr(self.source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def __enter__(self) -> "AsyncPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
