"""Deterministic fault injection (port of the storage, data, preemption
and serving parts of the JAX package's ``apex_tpu/resilience/chaos.py``).

Storage faults, through the checkpoint layer's fault hook
(:func:`apex_tpu_torch.checkpoint.checkpoint.set_fault_hook`):

- :class:`FaultyStore` — raise transient errors
  (:class:`InjectedStorageError`) and/or sleep at named I/O events
  (``"write_arrays"``, ``"write_manifest"``, ``"commit"``,
  ``"read_arrays"``); :func:`slow_writer` slows the arrays write only;
- :func:`corrupt_arrays`, :func:`truncate_file`,
  :func:`flip_packed_leaf_byte` — on-disk damage that restore-side CRC32
  verification must catch;
- :class:`SimulatedPreemption` — a real SIGTERM to this process (or
  ``handler.request_stop()`` off the main thread) after a chosen number
  of step-boundary polls.

Data faults, through :func:`apex_tpu_torch.data.records.set_read_hook`:

- :func:`corrupt_record` — flip a byte of one record's payload; a
  checksummed pipeline must quarantine exactly that record;
- :class:`SlowShardRead` — per-read latency on one shard file, surfaced
  as ``data_stall`` telemetry;
- :class:`DropShard` — reads of one shard fail until the reader
  re-assigns it (reopens the file through a fresh handle).

Serving faults, through the engine's fault hook,
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
when the simulated crash propagates.

Mesh faults, for the ZeRO world of
:func:`apex_tpu_torch.resilience.run_elastic_training` (a "device" is a
rank there):

- :class:`DeviceLoss` — raise :class:`DeviceLossError` naming chosen
  ranks at a chosen step boundary, once (it is picklable: each spawned
  rank polls its copy, and the launcher marks it fired);
- :func:`corrupt_shard` — flip one byte inside the data of one shard
  file of a sharded checkpoint (format 3 rank or format 4 coordinate);
- :func:`slow_collective` — stall a chosen step (a straggling or hung
  collective seen from the host), so an armed watchdog must escalate.

Fleet faults, through the fleet's fault hook,
:func:`apex_tpu_torch.serving.fleet.set_fleet_fault_hook` (they model
the REPLICA failing — its process, its link — which the engine inside
it cannot see):

- :class:`KillReplica` — every step of one replica raises
  :class:`DeviceLossError` from a chosen step on; the engine's recovery
  budget burns, then the router's retries, then the fence and the
  migration;
- :class:`SlowReplica` — inflate one replica's health-probe latency
  (virtual: nothing sleeps); below the router's budget it is tolerated,
  past it the replica is fenced;
- :class:`BlackholeReplica` — one replica's probes report infinite
  latency and its steps raise; the router must fence it on the probe.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Iterable, Optional

import numpy as np

from apex_tpu_torch.checkpoint import checkpoint as _ckpt


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
    rebuild + restore must sail past the same point on the retry.

    Under tensor parallelism (``ServingEngine(tp=N)``, one process a
    rank) ``device_ids`` names tensor ranks, and the injector fires in
    the process it is installed in: installed on one rank only, its
    fault still reaches every rank (the engine's ranks agree on each
    step's fault verdict), so the group recovers once, together."""

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


# -- storage faults --------------------------------------------------------


class InjectedStorageError(OSError):
    """The error FaultyStore raises — a subclass of OSError so the default
    :class:`~apex_tpu_torch.checkpoint.checkpoint.RetryPolicy` treats it as
    transient/retryable."""


class FaultyStore:
    """Inject failures and latency into checkpoint storage I/O.

    ``fail_events`` — event names that should raise; the first
    ``fail_times`` matching calls raise :class:`InjectedStorageError`
    (``fail_times=None`` = always fail).  ``delay`` — seconds to sleep on
    every matching ``delay_events`` call (slow storage / slow writer).
    Counts are exposed for assertions: ``calls`` (per event) and
    ``failures_injected``.
    """

    def __init__(self, *, fail_events: Iterable[str] = (),
                 fail_times: Optional[int] = 0,
                 delay: float = 0.0,
                 delay_events: Iterable[str] = ("write_arrays",),
                 telemetry=None):
        self.fail_events = frozenset(fail_events)
        self.fail_times = fail_times
        self.delay = delay
        self.delay_events = frozenset(delay_events)
        # optional TelemetryBus: each injected failure emits a typed
        # `fault_injected` event, so a chaos run's stream shows WHICH
        # fault produced the retries/fallbacks it also records
        self.telemetry = telemetry
        self.calls: dict = {}
        self.failures_injected = 0
        self._lock = threading.Lock()
        self._prev_hook = None

    def _hook(self, event: str, path: str) -> None:
        with self._lock:
            self.calls[event] = self.calls.get(event, 0) + 1
            should_fail = event in self.fail_events and (
                self.fail_times is None
                or self.failures_injected < self.fail_times)
            if should_fail:
                self.failures_injected += 1
        if self.delay and event in self.delay_events:
            time.sleep(self.delay)
        if should_fail:
            if self.telemetry is not None:
                self.telemetry.emit("fault_injected", kind="storage",
                                    event=event, path=path)
            raise InjectedStorageError(
                f"injected fault at {event} ({path})")

    def __enter__(self) -> "FaultyStore":
        self._prev_hook = _ckpt.set_fault_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        _ckpt.set_fault_hook(self._prev_hook)
        self._prev_hook = None


class DeviceLoss:
    """Deterministically lose rank(s) at a chosen step boundary.

    Hook :meth:`poll` into the train loop's ``on_step``; on the
    ``at_step``-th poll it raises :class:`DeviceLossError` naming
    ``device_ids`` — once, so the rebuilt run sails past the same global
    step (the elastic launcher sets ``fired`` on its copy before it
    hands the hook to the survivors)."""

    def __init__(self, at_step: int, device_ids, *, telemetry=None):
        self.at_step = at_step
        self.device_ids = list(device_ids)
        self.telemetry = telemetry
        self.fired = False
        self.polls = 0

    def poll(self, *_args) -> None:
        self.polls += 1
        if not self.fired and self.polls >= self.at_step:
            self.fired = True
            if self.telemetry is not None:
                self.telemetry.emit(
                    "fault_injected", kind="device_loss",
                    device_ids=[getattr(d, "id", d)
                                for d in self.device_ids],
                    at_poll=self.polls)
            raise DeviceLossError(self.device_ids,
                                  detail=f"injected at poll {self.polls}")


def corrupt_shard(ckpt_dir: str, step: int, rank) -> str:
    """Flip one byte in one partition file of a sharded checkpoint —
    exactly that shard's CRC32 verification must fail while every other
    shard file stays intact.  ``rank`` is an int for a format-3 save, or
    a mesh-coordinate tuple like ``(d, p, t)`` for a format-4 one.  The
    flip lands inside the largest entry's DATA span, not in the zip
    framing between entries (which nothing validates).  Returns the
    damaged path."""
    import zipfile

    name = (_ckpt.shard_file_coords(rank) if isinstance(rank, (tuple, list))
            else _ckpt.shard_file(rank))
    path = os.path.join(_ckpt.step_dir(ckpt_dir, step), name)
    with zipfile.ZipFile(path) as z:
        info = max(z.infolist(), key=lambda i: i.compress_size)
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        hdr = f.read(30)
    n_name = int.from_bytes(hdr[26:28], "little")
    n_extra = int.from_bytes(hdr[28:30], "little")
    data_off = info.header_offset + 30 + n_name + n_extra
    _flip_byte(path, data_off + max(0, info.compress_size // 2))
    return path


def slow_collective(step_fn, *, at_step: int, delay: float,
                    axis: Optional[str] = None,
                    stale_devices=None, watchdog=None,
                    telemetry=None):
    """Wrap ``step_fn`` so its ``at_step``-th call stalls ``delay`` seconds
    before stepping — a straggling (or, for a large ``delay``, hung)
    collective as the host sees it; a watchdog armed around the step
    must overrun and escalate.  ``axis`` names the mesh axis whose
    collective stalls (in the ``fault_injected`` event).
    ``stale_devices`` + ``watchdog``: while the stall runs every device
    but the stale ones gets a fresh ``watchdog.beat``, so the hang report
    points at the stalled group."""
    calls = {"n": 0}

    def wrapped(state, batch):
        calls["n"] += 1
        if calls["n"] == at_step:
            if telemetry is not None:
                telemetry.emit("fault_injected", kind="slow_collective",
                               axis=axis, at_step=calls["n"],
                               delay_s=float(delay))
            if watchdog is not None and stale_devices is not None:
                stale = {getattr(d, "id", d) for d in stale_devices}
                deadline = time.monotonic() + delay
                while time.monotonic() < deadline:
                    for d in watchdog.device_ids:
                        if d not in stale:
                            watchdog.beat(d)
                    time.sleep(min(0.02, delay / 10))
            else:
                time.sleep(delay)
        return step_fn(state, batch)

    wrapped.calls = calls
    return wrapped


def slow_writer(delay: float) -> FaultyStore:
    """A FaultyStore that only slows the arrays write — the knob the
    async-overlap test turns."""
    return FaultyStore(delay=delay, delay_events=("write_arrays",))


def truncate_file(path: str, keep_bytes: Optional[int] = None) -> None:
    """Truncate ``path`` (default: to half its size) — the classic
    crashed-writer artifact."""
    size = os.path.getsize(path)
    keep = size // 2 if keep_bytes is None else keep_bytes
    with open(path, "r+b") as f:
        f.truncate(keep)


def _flip_byte(path: str, off: int) -> None:
    """Invert the byte at ``off`` in ``path``."""
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def corrupt_arrays(ckpt_dir: str, step: int, *, mode: str = "flip") -> str:
    """Damage the stored arrays of checkpoint ``step`` in place.

    ``mode="flip"`` inverts one byte in the middle of the file (caught by
    CRC32 verification, or by the npz zip CRC); ``mode="truncate"`` cuts
    the file in half (caught as an unreadable archive / short pack).
    Returns the damaged file's path."""
    d = _ckpt.step_dir(ckpt_dir, step)
    path = os.path.join(d, _ckpt._PACK)
    if not os.path.exists(path):
        path = os.path.join(d, _ckpt._ARRAYS)
    if mode == "truncate":
        truncate_file(path)
        return path
    if mode != "flip":
        raise ValueError(f"unknown corruption mode {mode!r}")
    _flip_byte(path, os.path.getsize(path) // 2)
    return path


def flip_packed_leaf_byte(ckpt_dir: str, step: int, key: str) -> None:
    """Precision strike for the packed format: flip one byte inside leaf
    ``key``'s stored span, so exactly that leaf's CRC32 check fails."""
    import json

    d = _ckpt.step_dir(ckpt_dir, step)
    with open(os.path.join(d, _ckpt._MANIFEST)) as f:
        entry = json.load(f)["leaves"][key]
    dt = np.dtype(_ckpt._stored_dtype(entry))
    nbytes = int(np.prod(entry["shape"] or [1])) * dt.itemsize
    _flip_byte(os.path.join(d, _ckpt._PACK),
               entry["offset"] + max(0, nbytes // 2))


# -- data-plane faults -----------------------------------------------------


def corrupt_record(path: str, index: int, record_bytes: int) -> int:
    """Flip one byte in the middle of record ``index``'s PAYLOAD in
    shard file ``path`` (fixed-size ``record_bytes`` records).  The
    flip deliberately avoids the CRC trailer: a checksummed pipeline
    must catch a damaged payload, not a damaged checksum.  Returns the
    flipped byte offset."""
    from apex_tpu_torch.data.records import RECORD_CRC_BYTES

    payload = record_bytes - RECORD_CRC_BYTES
    off = index * record_bytes + max(0, payload // 2)
    _flip_byte(path, off)
    return off


class _DataReadFault:
    """Base for data-plane read-hook injectors: installs itself on
    ``apex_tpu_torch.data.records.set_read_hook`` as a context manager,
    chaining to any previously-installed hook."""

    def __init__(self, path: str, *, telemetry=None):
        self.path = os.path.abspath(path)
        self.telemetry = telemetry
        self.reads = 0
        self._prev_hook = None

    def _match(self, path: str) -> bool:
        return os.path.abspath(path) == self.path

    def _hook(self, event: str, path: str) -> None:
        raise NotImplementedError

    def __enter__(self):
        from apex_tpu_torch.data import records as _records

        self._prev_hook = _records.set_read_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        from apex_tpu_torch.data import records as _records

        _records.set_read_hook(self._prev_hook)
        self._prev_hook = None


class SlowShardRead(_DataReadFault):
    """Sleep ``delay`` seconds on each read of ``path`` (the first
    ``times`` reads; None = every read) — a straggling shard-serving
    host.  The reader's ``slow_read_threshold`` must classify the reads
    as slow and the pipeline's telemetry must show ``data_stall``."""

    def __init__(self, path: str, *, delay: float, times: Optional[int] = 1,
                 telemetry=None):
        super().__init__(path, telemetry=telemetry)
        self.delay = float(delay)
        self.times = times
        self.slowed = 0

    def _hook(self, event: str, path: str) -> None:
        if self._prev_hook is not None:
            self._prev_hook(event, path)
        if event != "read_record" or not self._match(path):
            return
        self.reads += 1
        if self.times is not None and self.slowed >= self.times:
            return
        self.slowed += 1
        if self.telemetry is not None:
            self.telemetry.emit("fault_injected", kind="slow_read",
                                path=path, delay_s=self.delay)
        time.sleep(self.delay)


class DropShard(_DataReadFault):
    """Reads of ``path`` raise until the reader RE-ASSIGNS the shard
    (the ``reopen_shard`` hook event — a fresh handle standing in for a
    different serving replica), after which reads succeed.  Asserting
    on :attr:`reassigned` proves recovery took the re-assignment path
    rather than luck.  ``fail_after_reassign=True`` keeps failing even
    the re-assigned handle — the shard is truly gone and the pipeline
    must surface :class:`~apex_tpu_torch.data.DataShardError` instead of
    hanging."""

    def __init__(self, path: str, *, fail_after_reassign: bool = False,
                 telemetry=None):
        super().__init__(path, telemetry=telemetry)
        self.fail_after_reassign = fail_after_reassign
        self.failures_injected = 0
        self.reassigned = False

    def _hook(self, event: str, path: str) -> None:
        if self._prev_hook is not None:
            self._prev_hook(event, path)
        if not self._match(path):
            return
        if event == "reopen_shard":
            self.reassigned = True
            return
        if event != "read_record":
            return
        self.reads += 1
        if self.reassigned and not self.fail_after_reassign:
            return
        self.failures_injected += 1
        if self.telemetry is not None and self.failures_injected == 1:
            self.telemetry.emit("fault_injected", kind="drop_shard",
                                path=path)
        raise OSError(f"injected drop_shard fault: {path} unreachable "
                      "from this handle")


# -- preemption ------------------------------------------------------------


class SimulatedPreemption:
    """Deterministically preempt a training loop at a chosen step boundary.

    Call :meth:`poll` once per step (the resilient train loop does this for
    you via its ``on_step`` hook); on the ``at_poll``-th call it delivers a
    real ``SIGTERM`` to this process (exercising the actual signal path of
    :class:`~apex_tpu_torch.resilience.preemption.GracePeriodHandler`) or, when
    ``use_signal=False`` or off the main thread, calls
    ``handler.request_stop()`` directly."""

    def __init__(self, at_poll: int, *, handler=None, use_signal: bool = True,
                 telemetry=None):
        self.at_poll = at_poll
        self.handler = handler
        self.use_signal = use_signal
        self.telemetry = telemetry
        self.polls = 0
        self.fired = False

    def poll(self, *_args) -> None:
        self.polls += 1
        if self.fired or self.polls < self.at_poll:
            return
        self.fired = True
        if self.telemetry is not None:
            self.telemetry.emit("fault_injected", kind="preemption",
                                at_poll=self.polls,
                                use_signal=bool(self.use_signal))
        if (self.use_signal
                and threading.current_thread() is threading.main_thread()):
            os.kill(os.getpid(), signal.SIGTERM)
        elif self.handler is not None:
            self.handler.request_stop()
        else:
            raise RuntimeError(
                "SimulatedPreemption off the main thread needs a handler "
                "to call request_stop() on")


# ---------------------------------------------------------------------------
# Fleet faults
# ---------------------------------------------------------------------------


class _FleetFault:
    """Base for fleet-tier fault injectors: installs itself on
    :func:`apex_tpu_torch.serving.fleet.replica.set_fleet_fault_hook` as a
    context manager, chaining to any previously-installed hook.  These
    model the REPLICA failing (its process, its link) — the serving
    fault hook above keeps modeling the device inside one engine.
    Subclasses implement ``_on_event(event, replica, info)``; ``event``
    is ``"step"`` (info = the engine's step count) or ``"ping"`` (info
    = a mutable ``{"latency_s": float}`` probe the injector inflates —
    detection is virtual-latency, so a blackholed replica never hangs
    the suite).  ``replica`` selects the target by name."""

    def __init__(self, replica: str, *, telemetry=None):
        self.replica = replica
        self.telemetry = telemetry
        self.events = 0
        self._prev_hook = None

    def _hook(self, event: str, replica: str, info) -> None:
        if self._prev_hook is not None:
            self._prev_hook(event, replica, info)
        if replica != self.replica:
            return
        self.events += 1
        self._on_event(event, replica, info)

    def _on_event(self, event: str, replica: str, info) -> None:
        raise NotImplementedError

    def __enter__(self):
        from apex_tpu_torch.serving.fleet import replica as _rep

        self._prev_hook = _rep.set_fleet_fault_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        from apex_tpu_torch.serving.fleet import replica as _rep

        _rep.set_fleet_fault_hook(self._prev_hook)
        self._prev_hook = None


class KillReplica(_FleetFault):
    """From the ``at_step``-th step attempt on (1-based over this
    injector's lifetime), EVERY step of the target replica raises
    :class:`DeviceLossError` — a dead process, not a transient fault.
    The engine's own recovery budget burns first (each retry hits the
    same wall), then the router's retry-with-backoff, then the fence +
    migration path.  Persistence is the point: a transient would be
    absorbed and prove nothing about fencing."""

    def __init__(self, replica: str, *, at_step: int = 1, telemetry=None):
        super().__init__(replica, telemetry=telemetry)
        self.at_step = at_step
        self.steps = 0
        self.fired = False

    def _on_event(self, event: str, replica: str, info) -> None:
        if event != "step":
            return
        self.steps += 1
        if self.steps < self.at_step:
            return
        if not self.fired:
            self.fired = True
            if self.telemetry is not None:
                self.telemetry.emit("fault_injected", kind="kill_replica",
                                    replica=replica, at_step=self.steps)
        raise DeviceLossError(
            [0], detail=f"injected replica kill: {replica} is gone")


class SlowReplica(_FleetFault):
    """From the ``at_ping``-th health probe on, inflate the target's
    probe latency by ``latency_s`` — a straggling replica.  Below the
    router's health budget it degrades quietly; above it the router
    must fence and reroute (never wait it out: the latency is virtual,
    detection must be too)."""

    def __init__(self, replica: str, *, latency_s: float, at_ping: int = 1,
                 telemetry=None):
        super().__init__(replica, telemetry=telemetry)
        self.latency_s = float(latency_s)
        self.at_ping = at_ping
        self.pings = 0
        self.fired = False

    def _on_event(self, event: str, replica: str, info) -> None:
        if event != "ping":
            return
        self.pings += 1
        if self.pings < self.at_ping:
            return
        if not self.fired:
            self.fired = True
            if self.telemetry is not None:
                self.telemetry.emit("fault_injected", kind="slow_replica",
                                    replica=replica, delay_s=self.latency_s)
        info["latency_s"] += self.latency_s


class BlackholeReplica(_FleetFault):
    """From the ``at_ping``-th health probe on, the target's probes
    report infinite latency — an unreachable host (link down, process
    wedged pre-accept).  The router must detect via health-check
    timeout and migrate; as a backstop, a step routed to a blackholed
    replica raises (a real RPC would never return — silently stepping
    would mask a router that forgot to health-check)."""

    def __init__(self, replica: str, *, at_ping: int = 1, telemetry=None):
        super().__init__(replica, telemetry=telemetry)
        self.at_ping = at_ping
        self.pings = 0
        self.fired = False

    def _on_event(self, event: str, replica: str, info) -> None:
        if event == "ping":
            self.pings += 1
            if self.pings < self.at_ping:
                return
            if not self.fired:
                self.fired = True
                if self.telemetry is not None:
                    self.telemetry.emit("fault_injected",
                                        kind="blackhole_replica",
                                        replica=replica)
            info["latency_s"] = float("inf")
        elif event == "step" and self.fired:
            raise DeviceLossError(
                [0], detail=f"injected blackhole: {replica} unreachable")
