"""Checkpointable sharded deterministic record iterator (port of the JAX
package's ``apex_tpu/data/iterator.py``; numpy, hashlib and the
standard library: the same record order and the same ``state_dict()``,
bit for bit, from the same paths and seed).

The exactly-once design (docs/data.md "Exactly-once resume") in three
layers:

1. **Deterministic addressing.**  An epoch is a seeded permutation of
   all record ids, computed lazily per *shuffle window*: position ``i``
   of epoch ``e`` lives in window ``w = i // W``, and window ``w``'s
   order is ``Philox(seed, e, w)``'s permutation of its record range —
   every record exactly once per epoch, O(W) state, any position
   addressable without replaying the stream.  Epochs concatenate into
   one infinite global position stream.

2. **Slot substreams.**  A global batch has ``batch_size`` *slots*;
   slot ``j`` owns the global positions ``{k·B + j}`` (round-robin).
   Each slot pulls records from its own substream, skipping quarantined
   records independently, so one damaged record shifts only its own
   slot's cursor — never the composition of other slots (or other
   hosts' shards).  The full iterator position is the ``[B]`` vector of
   per-slot cursors plus the consumed-batch count — the compact
   ``data_state`` record that rides the checkpoint manifest.

3. **Shard ownership = a slot range.**  Data-parallel rank ``r`` of
   ``dp`` materializes slots ``[r·B/dp, (r+1)·B/dp)`` (it reads and
   decodes only those records).  The slot→record mapping is global and
   rank-independent, so re-partitioning across an elastic dp→dp'
   restart is pure re-slicing — the C-order slot linearization is the
   same contract ``multi_tensor.flat`` applies to flat-buffer stacks,
   and the consumed sample-id stream (the union over ranks, per batch)
   is bitwise identical for every dp that divides B.

Degradation: records that fail their CRC (or the caller's
``validate_record``) are **quarantined** — skipped, counted, reported
as a ``data_quarantine`` telemetry event — and the run hard-fails with
:class:`QuarantineOverflowError` only past
:class:`QuarantinePolicy.max_rate`.  Slow/dead shard reads ride
:class:`~apex_tpu_torch.data.records.RecordFileSet`'s retry → re-assign
ladder; the iterator surfaces those as ``data_stall`` events.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from apex_tpu_torch.checkpoint.checkpoint import RetryPolicy
from apex_tpu_torch.data.records import (
    RECORD_CRC_BYTES,
    RecordFileSet,
    check_record_crc,
)

#: data_state schema version (manifest ``data_state.version``).
DATA_STATE_VERSION = 1


class QuarantineOverflowError(RuntimeError):
    """Quarantined-record rate exceeded the policy's ceiling — the
    dataset (or its storage) is damaged beyond what silent skipping
    should paper over."""


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """When to keep skipping vs when to hard-fail.

    ``max_rate`` — quarantined / pulled ceiling; above it the iterator
    raises :class:`QuarantineOverflowError`.  ``min_count`` — never
    hard-fail before this many quarantined records (a tiny sample must
    not kill a run over one bad record)."""

    max_rate: float = 0.01
    min_count: int = 8


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class ShardedRecordIterator:
    """Deterministic, checkpointable batch iterator over record shards.

    Yields ``decode(batch)`` where ``batch`` is the
    ``[local_batch, payload_bytes]`` uint8 matrix of this rank's slots
    (``local_batch = batch_size // dp_size``); the stream is infinite
    unless ``num_batches`` bounds it.  See the module doc for the
    position/exactly-once model and docs/data.md for the state format.

    ``checksummed`` — records carry the :mod:`~apex_tpu_torch.data.records`
    CRC trailer; failures are quarantined.  ``validate_record`` —
    optional ``payload -> bool`` for app-level validation (undecodable
    records); False quarantines.  ``on_ids(batch_index, ids)`` — test /
    audit tap: the record ids this rank consumed for each batch.
    ``telemetry`` — a :class:`~apex_tpu_torch.telemetry.TelemetryBus`;
    quarantines emit ``data_quarantine``, shard degradations emit
    ``data_stall``.
    """

    def __init__(self, paths: Sequence[str], record_bytes: int,
                 batch_size: int, *,
                 checksummed: bool = False,
                 shuffle_window: int = 4096,
                 seed: int = 0,
                 num_batches: Optional[int] = None,
                 dp_rank: int = 0,
                 dp_size: int = 1,
                 decode: Optional[Callable[[np.ndarray], object]] = None,
                 validate_record: Optional[Callable[[bytes], bool]] = None,
                 quarantine: Optional[QuarantinePolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 read_timeout: Optional[float] = None,
                 slow_read_threshold: Optional[float] = None,
                 telemetry=None,
                 on_ids: Optional[Callable[[int, list], None]] = None):
        _require(batch_size > 0, f"batch_size must be > 0: {batch_size}")
        _require(dp_size > 0 and 0 <= dp_rank < dp_size,
                 f"need 0 <= dp_rank ({dp_rank}) < dp_size ({dp_size})")
        _require(batch_size % dp_size == 0,
                 f"batch_size {batch_size} must divide evenly over "
                 f"dp_size {dp_size} (slot ownership is a contiguous "
                 "per-rank slot range)")
        _require(shuffle_window > 0,
                 f"shuffle_window must be > 0: {shuffle_window}")
        self.telemetry = telemetry
        self.files = RecordFileSet(
            paths, record_bytes, retry=retry, read_timeout=read_timeout,
            slow_read_threshold=slow_read_threshold,
            on_fault=self._shard_fault)
        self.record_bytes = int(record_bytes)
        self.batch_size = int(batch_size)
        self.checksummed = bool(checksummed)
        self.payload_bytes = self.record_bytes - (
            RECORD_CRC_BYTES if self.checksummed else 0)
        _require(self.payload_bytes > 0,
                 f"record_bytes {record_bytes} leaves no payload after "
                 "the CRC trailer")
        self.shuffle_window = int(shuffle_window)
        self.seed = int(seed)
        self.num_batches = num_batches if num_batches is None \
            else int(num_batches)
        self.dp_rank, self.dp_size = int(dp_rank), int(dp_size)
        self.decode = decode
        self.validate_record = validate_record
        self.quarantine = quarantine or QuarantinePolicy()
        self.on_ids = on_ids
        n = self.files.num_records
        _require(n >= batch_size,
                 f"dataset has {n} records < batch_size {batch_size}")
        local = self.batch_size // self.dp_size
        self.slots = list(range(self.dp_rank * local,
                                (self.dp_rank + 1) * local))
        # position state: per-slot substream cursors (this rank's slots
        # only; a global dp_size=1 iterator owns the full vector) + the
        # consumed-batch count.  THIS is the whole resumable position.
        self._cursors = {j: 0 for j in self.slots}
        self.batches_consumed = 0
        self.quarantined = 0
        self.pulled = 0
        self.last_ids: list = []
        self._perm_cache: dict = {}

    # -- deterministic addressing ---------------------------------------

    def _window_perm(self, epoch: int, w: int) -> np.ndarray:
        key = (epoch, w)
        hit = self._perm_cache.get(key)
        if hit is not None:
            return hit
        n = self.files.num_records
        size = min(self.shuffle_window, n - w * self.shuffle_window)
        # Philox takes a 2x64-bit key: (seed, epoch||window) — counter-
        # based, so any (epoch, window) permutation is addressable
        # without sequential state
        rng = np.random.Generator(np.random.Philox(
            key=[self.seed & 0xFFFFFFFFFFFFFFFF,
                 ((epoch & 0xFFFFFFFF) << 32) | (w & 0xFFFFFFFF)]))
        perm = rng.permutation(size)
        if len(self._perm_cache) > 16:  # small LRU-ish bound
            self._perm_cache.pop(next(iter(self._perm_cache)))
        self._perm_cache[key] = perm
        return perm

    def record_at(self, pos: int) -> int:
        """Record id at global stream position ``pos`` (epochs
        concatenate; pure function of (seed, pos))."""
        n = self.files.num_records
        epoch, i = divmod(int(pos), n)
        w, j = divmod(i, self.shuffle_window)
        return w * self.shuffle_window + int(self._window_perm(epoch, w)[j])

    # -- degradation surfacing ------------------------------------------

    def _shard_fault(self, kind: str, **info) -> None:
        if self.telemetry is None:
            return
        if kind in ("slow_read", "shard_reassign"):
            wait_ms = round(float(info.get("seconds", 0.0)) * 1e3, 3)
            self.telemetry.emit("data_stall", wait_ms=wait_ms,
                                cause=kind, **{k: v for k, v in info.items()
                                               if k != "seconds"})

    def _quarantine_record(self, rec: int, reason: str) -> None:
        self.quarantined += 1
        rate = self.quarantined / max(1, self.pulled)
        if self.telemetry is not None:
            self.telemetry.emit("data_quarantine", record_id=int(rec),
                                reason=reason, total=self.quarantined,
                                rate=round(rate, 6))
        if (self.quarantined >= self.quarantine.min_count
                and rate > self.quarantine.max_rate):
            raise QuarantineOverflowError(
                f"{self.quarantined} of {self.pulled} pulled records "
                f"quarantined (rate {rate:.4f} > policy max_rate "
                f"{self.quarantine.max_rate}) — last: record {rec} "
                f"({reason}); the dataset/storage is damaged beyond "
                "skip-and-count")

    # -- pulling ---------------------------------------------------------

    def _pull(self, slot: int) -> tuple:
        """(record id, payload) for ``slot``'s next pull, quarantining
        damaged records (each advances only this slot's cursor)."""
        while True:
            pos = self._cursors[slot] * self.batch_size + slot
            self._cursors[slot] += 1
            rec = self.record_at(pos)
            data = self.files.read(rec)
            self.pulled += 1
            if self.checksummed and not check_record_crc(data):
                self._quarantine_record(rec, "crc_mismatch")
                continue
            payload = data[: self.payload_bytes]
            if (self.validate_record is not None
                    and not self.validate_record(payload)):
                self._quarantine_record(rec, "validate_failed")
                continue
            return rec, payload

    def __next__(self):
        if (self.num_batches is not None
                and self.batches_consumed >= self.num_batches):
            raise StopIteration
        ids, rows = [], []
        for j in self.slots:
            rec, payload = self._pull(j)
            ids.append(rec)
            rows.append(np.frombuffer(payload, np.uint8))
        batch = np.stack(rows)
        self.batches_consumed += 1
        self.last_ids = ids
        if self.on_ids is not None:
            self.on_ids(self.batches_consumed - 1, list(ids))
        return self.decode(batch) if self.decode is not None else batch

    def __iter__(self) -> Iterator:
        return self

    # -- checkpointable-iterator protocol --------------------------------

    def _fingerprint(self) -> str:
        h = hashlib.sha256()
        for p in self.files.paths:
            h.update(os.path.basename(p).encode())
            h.update(str(os.path.getsize(p)).encode())
        h.update(f"{self.record_bytes}:{self.batch_size}:{self.seed}:"
                 f"{self.shuffle_window}:{int(self.checksummed)}".encode())
        return h.hexdigest()[:16]

    def state_dict(self) -> dict:
        """Compact JSON-serializable position record (the checkpoint
        manifest's ``data_state`` key): per-slot cursors for the slots
        this rank owns, consumed-batch count, quarantine counters, and
        a config fingerprint restore validates against."""
        return {
            "version": DATA_STATE_VERSION,
            "fingerprint": self._fingerprint(),
            "batch_size": self.batch_size,
            "batches_consumed": self.batches_consumed,
            "slots": list(self.slots),
            "cursors": [int(self._cursors[j]) for j in self.slots],
            "quarantined": int(self.quarantined),
            "pulled": int(self.pulled),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore the iterator position.  The state may come from a
        different dp decomposition (an elastic dp→dp' restart): this
        rank adopts the cursors of exactly the slots it now owns —
        shard ownership re-partitions by re-slicing the global slot
        vector (C-order, the flat-contract rule)."""
        if not isinstance(state, dict):
            raise TypeError(f"data_state must be a dict, got "
                            f"{type(state).__name__}")
        if state.get("version") != DATA_STATE_VERSION:
            raise ValueError(
                f"data_state version {state.get('version')!r} != "
                f"{DATA_STATE_VERSION} — saved by an incompatible "
                "pipeline")
        if state.get("batch_size") != self.batch_size:
            raise ValueError(
                f"data_state batch_size {state.get('batch_size')} != "
                f"iterator batch_size {self.batch_size}: slot substreams "
                "are keyed by the GLOBAL batch size; exactly-once resume "
                "cannot re-partition across a batch-size change")
        if state.get("fingerprint") != self._fingerprint():
            raise ValueError(
                "data_state fingerprint mismatch: the checkpoint was "
                "saved against a different dataset/config (files, "
                "record_bytes, seed, shuffle_window, or checksumming "
                "changed) — exactly-once resume would replay a "
                "different stream")
        saved = dict(zip(state["slots"], state["cursors"]))
        missing = [j for j in self.slots if j not in saved]
        if missing:
            raise ValueError(
                f"data_state covers slots {sorted(saved)} but this rank "
                f"owns {self.slots} (missing {missing}) — merge every "
                "rank's state (merge_data_states) before a cross-"
                "topology restore")
        self._cursors = {j: int(saved[j]) for j in self.slots}
        self.batches_consumed = int(state["batches_consumed"])
        self.quarantined = int(state.get("quarantined", 0))
        self.pulled = int(state.get("pulled", 0))
        self.last_ids = []

    def close(self) -> None:
        self.files.close()

    def __enter__(self) -> "ShardedRecordIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def merge_data_states(states: Sequence[dict]) -> dict:
    """Union the per-rank ``data_state`` records of one dp group into
    the full-slot-vector state a cross-topology restore needs (slot
    ownership is disjoint; consumed-batch counts must agree)."""
    if not states:
        raise ValueError("merge_data_states needs at least one state")
    base = states[0]
    merged = {j: c for s in states
              for j, c in zip(s["slots"], s["cursors"])}
    for s in states[1:]:
        for k in ("version", "fingerprint", "batch_size",
                  "batches_consumed"):
            if s.get(k) != base.get(k):
                raise ValueError(
                    f"inconsistent data_state field {k!r} across ranks: "
                    f"{s.get(k)!r} != {base.get(k)!r}")
    slots = sorted(merged)
    return {
        "version": base["version"],
        "fingerprint": base["fingerprint"],
        "batch_size": base["batch_size"],
        "batches_consumed": base["batches_consumed"],
        "slots": slots,
        "cursors": [int(merged[j]) for j in slots],
        "quarantined": int(sum(s.get("quarantined", 0) for s in states)),
        "pulled": int(sum(s.get("pulled", 0) for s in states)),
    }
