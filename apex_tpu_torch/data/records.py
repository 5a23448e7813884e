"""Record files and fault-aware shard readers (port of the JAX
package's ``apex_tpu/data/records.py``; numpy and the standard library).

The on-disk dataset model (shared with the native loader,
``_native/dataloader.cpp``): a *shard* is one file holding a contiguous
array of fixed-size ``record_bytes`` records.  This module adds the two
properties the fault-tolerant pipeline needs on top of raw reads:

- **per-record integrity** — :func:`write_checksummed_records` frames
  each record as ``payload || crc32(payload)`` (4-byte little-endian
  trailer).  A flipped bit anywhere in the payload fails the CRC at
  read time, which is what lets the iterator *quarantine* a damaged
  record instead of training on garbage (or crashing);
- **degraded reads** — :class:`RecordFileSet.read` survives flaky and
  dead shard serving: transient read errors retry with the checkpoint
  layer's exponential-backoff :class:`~apex_tpu_torch.checkpoint.RetryPolicy`,
  an optional ``read_timeout`` turns a *hung* read (straggler host)
  into a retryable failure, and when a handle's retries are exhausted
  the shard is **re-assigned** — the file is reopened through a fresh
  handle (in a real deployment: a different serving replica of the same
  shard) and the read retried once more before :class:`DataShardError`
  gives up.  Every degradation is surfaced through the reader's
  ``on_fault`` callback so the iterator can count and emit telemetry.

Test-only fault hook: like ``checkpoint.set_fault_hook``, the chaos
tier installs :func:`set_read_hook` to raise/sleep at named events
(``"read_record"`` before each record read, ``"reopen_shard"`` at
re-assignment) — see ``apex_tpu_torch.resilience.chaos`` (``DropShard``,
``SlowShardRead``).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Callable, Optional, Sequence

import numpy as np

from apex_tpu_torch.checkpoint.checkpoint import RetryPolicy

#: Byte length of the CRC32 trailer a checksummed record carries.
RECORD_CRC_BYTES = 4


def write_records(path: str, records: np.ndarray) -> None:
    """Write [n, record_bytes] uint8 rows as one raw record file (no
    per-record framing — the native loader's format)."""
    arr = np.ascontiguousarray(records, np.uint8)
    assert arr.ndim == 2
    with open(path, "wb") as f:
        f.write(arr.tobytes())


def write_checksummed_records(path: str, payloads: np.ndarray) -> int:
    """Write [n, payload_bytes] uint8 rows each framed as
    ``payload || crc32(payload)``; returns the on-disk ``record_bytes``
    (``payload_bytes + RECORD_CRC_BYTES``)."""
    arr = np.ascontiguousarray(payloads, np.uint8)
    assert arr.ndim == 2
    framed = np.empty((arr.shape[0], arr.shape[1] + RECORD_CRC_BYTES),
                      np.uint8)
    framed[:, : arr.shape[1]] = arr
    for i in range(arr.shape[0]):
        crc = zlib.crc32(arr[i].tobytes()) & 0xFFFFFFFF
        framed[i, arr.shape[1]:] = np.frombuffer(
            crc.to_bytes(RECORD_CRC_BYTES, "little"), np.uint8)
    write_records(path, framed)
    return int(framed.shape[1])


def check_record_crc(record: bytes) -> bool:
    """True when a checksummed record's payload matches its trailer."""
    payload, trailer = record[:-RECORD_CRC_BYTES], record[-RECORD_CRC_BYTES:]
    return (zlib.crc32(payload) & 0xFFFFFFFF
            == int.from_bytes(trailer, "little"))


class DataShardError(OSError):
    """A shard read failed past retries AND past re-assignment — the
    record is unreachable from this host."""


# Test-only fault-injection point (see apex_tpu_torch.resilience.chaos).  When
# set, called as hook(event, path) at each shard I/O event; it may raise
# (dead shard serving) or sleep (slow shard).  Events: "read_record"
# (before each record read), "reopen_shard" (after a re-assignment
# reopened the file through a fresh handle).
_read_hook: Optional[Callable[[str, str], None]] = None


def set_read_hook(hook: Optional[Callable[[str, str], None]]):
    """Install (or clear, with None) the shard read hook.  Returns the
    previous hook so tests can restore it."""
    global _read_hook
    prev, _read_hook = _read_hook, hook
    return prev


def _hook(event: str, path: str) -> None:
    if _read_hook is not None:
        _read_hook(event, path)


class RecordFileSet:
    """Fixed-size records across one or more shard files, with degraded
    reads (retry → re-assign → fail; see module doc).

    ``on_fault(kind, **info)`` — called on every degradation event:
    ``kind`` in ``{"read_retry", "shard_reassign", "slow_read"}``.
    ``slow_read_threshold`` — seconds a single successful read may take
    before it is reported as a ``slow_read`` fault (None disables).
    ``read_timeout`` — seconds before an in-flight read is abandoned
    and counted as a failed attempt (None = wait forever).
    """

    def __init__(self, paths: Sequence[str], record_bytes: int, *,
                 retry: Optional[RetryPolicy] = None,
                 read_timeout: Optional[float] = None,
                 slow_read_threshold: Optional[float] = None,
                 on_fault: Optional[Callable[..., None]] = None):
        if record_bytes <= 0:
            raise ValueError(f"record_bytes must be > 0, got {record_bytes}")
        self.paths = [os.fspath(p) for p in paths]
        if not self.paths:
            raise ValueError("RecordFileSet needs at least one shard file")
        self.record_bytes = int(record_bytes)
        self.retry = retry or RetryPolicy(max_attempts=3, base_delay=0.01,
                                          max_delay=0.5)
        self.read_timeout = read_timeout
        self.slow_read_threshold = slow_read_threshold
        self.on_fault = on_fault
        self._files: list = []
        self._base: list = []
        self.num_records = 0
        for p in self.paths:
            n = os.path.getsize(p) // self.record_bytes
            self._files.append(open(p, "rb"))
            self._base.append(self.num_records)
            self.num_records += int(n)
        if self.num_records == 0:
            raise ValueError(
                f"no complete {self.record_bytes}-byte records in "
                f"{self.paths}")
        self.reassigns = 0
        self.retries = 0
        self.slow_reads = 0

    def _fault(self, kind: str, **info) -> None:
        if self.on_fault is not None:
            try:
                self.on_fault(kind, **info)
            except Exception:  # observability must not kill the read
                pass

    def locate(self, rec: int) -> tuple:
        """(file index, byte offset) of global record id ``rec``."""
        if not 0 <= rec < self.num_records:
            raise IndexError(f"record {rec} out of range "
                             f"[0, {self.num_records})")
        f = 0
        while f + 1 < len(self._base) and self._base[f + 1] <= rec:
            f += 1
        return f, (rec - self._base[f]) * self.record_bytes

    def _raw_read(self, f: int, off: int) -> bytes:
        _hook("read_record", self.paths[f])
        fh = self._files[f]
        data = os.pread(fh.fileno(), self.record_bytes, off)
        if len(data) != self.record_bytes:
            raise OSError(
                f"short read at {self.paths[f]}:{off}: got {len(data)} of "
                f"{self.record_bytes} bytes (truncated/rotated shard)")
        return data

    def _read_once(self, f: int, off: int) -> bytes:
        if self.read_timeout is None:
            return self._raw_read(f, off)
        # a dedicated daemon thread per timed read: a hung read leaks
        # exactly one parked thread (bounded by the number of timed-out
        # attempts) instead of poisoning a shared pool — a wedged shard
        # must never make reads of HEALTHY shards queue behind it and
        # spuriously time out
        result: dict = {}
        done = threading.Event()

        def _work():
            try:
                result["data"] = self._raw_read(f, off)
            except BaseException as e:
                result["err"] = e
            finally:
                done.set()

        threading.Thread(target=_work, daemon=True,
                         name="apex-tpu-torch-data-read").start()
        if not done.wait(self.read_timeout):
            # the thread stays parked on the hung read; the caller moves
            # on — exactly the straggler-host semantics we want
            raise OSError(
                f"read of {self.paths[f]}:{off} exceeded the "
                f"{self.read_timeout}s read_timeout (straggling shard)")
        if "err" in result:
            raise result["err"]
        return result["data"]

    def _reassign(self, f: int) -> None:
        """Reopen shard ``f`` through a fresh handle — the local stand-in
        for re-assigning the shard to a different serving replica."""
        try:
            self._files[f].close()
        except Exception:
            pass
        self._files[f] = open(self.paths[f], "rb")
        self.reassigns += 1
        _hook("reopen_shard", self.paths[f])
        self._fault("shard_reassign", path=self.paths[f],
                    reassigns=self.reassigns)

    def read(self, rec: int) -> bytes:
        """Read one record, surviving transient errors (retry/backoff),
        hung reads (timeout), and a dead handle (re-assign + one more
        retry round).  Raises :class:`DataShardError` only when the
        re-assigned handle fails its whole retry round too."""
        f, off = self.locate(rec)
        last: Optional[BaseException] = None
        for generation in range(2):
            for attempt in range(self.retry.max_attempts):
                t0 = time.monotonic()
                try:
                    data = self._read_once(f, off)
                except self.retry.retryable as e:
                    last = e
                    self.retries += 1
                    self._fault("read_retry", path=self.paths[f],
                                record=rec, attempt=attempt,
                                error=repr(e)[:120])
                    time.sleep(self.retry.delay(attempt))
                    continue
                dt = time.monotonic() - t0
                if (self.slow_read_threshold is not None
                        and dt > self.slow_read_threshold):
                    self.slow_reads += 1
                    self._fault("slow_read", path=self.paths[f],
                                record=rec, seconds=round(dt, 4))
                return data
            if generation == 0:
                self._reassign(f)
        raise DataShardError(
            f"record {rec} ({self.paths[f]}:{off}) unreadable after "
            f"{self.retry.max_attempts} attempts on each of 2 handles "
            f"(original + re-assigned): {last!r}")

    def close(self) -> None:
        for fh in self._files:
            try:
                fh.close()
            except Exception:
                pass
        self._files = []

    def __enter__(self) -> "RecordFileSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
