"""Elastic resilience: the step watchdog, sharded ZeRO checkpoints and
recovery from the loss of ranks (port of the JAX package's
``apex_tpu/resilience/elastic.py``).

:class:`Watchdog` arms a deadline around each step; on overrun its
monitor thread logs per-device last-heartbeat ages and step-duration
percentiles (the straggler diagnostic) and escalates: an ``on_hang``
callback, a grace handler's ``request_stop``, or — neither configured —
:class:`WatchdogTimeout` raised at the next step's entry.  The serving
engine arms it around every step (``ServingEngine(watchdog=...)``).

Escalation is cooperative: a watchdog firing flips a flag, and the loop
(presumed stuck *slow*, not stuck *dead*) acts at the next step
boundary.  A truly wedged device needs an external watchdog.

ZeRO checkpoints: :func:`save_zero_checkpoint` (format 3, or format 4
with ``shard_axes``) and :func:`restore_zero_checkpoint` (the newest
intact one, re-partitioned to the target's topology; across ranks each
rank gets its block).

Recovery: JAX's loop is one controller that rebuilds a mesh; here a
"device" is a rank, one process each, so :func:`run_elastic_training`
runs in the launching process.  It spawns the world
(:func:`apex_tpu_torch.parallel.multiproc.spawn`, gloo on a ``file://``
store), each rank builds the step (``build``), restores when there is a
checkpoint to resume, and runs
:func:`~apex_tpu_torch.transformer.testing.run_resilient_training` with
sharded saves.  A rank that raises
:class:`~apex_tpu_torch.resilience.chaos.DeviceLossError` ends the
attempt and reports the lost ranks; the launcher drops them, picks the
survivors' shape (``select_devices`` / ``select_mesh``, by default
:func:`largest_divisor_submesh` / :func:`best_surviving_submesh`), finds
the newest intact checkpoint, and spawns the survivors' world, which
restores it across topologies and goes on.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional, Sequence

import torch

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


# ---------------------------------------------------------------------------
# Sharded ZeRO checkpoint wrappers
# ---------------------------------------------------------------------------


def save_zero_checkpoint(ckpt_dir: str, state, *, step: int, shardings,
                         shard_axis: str = "data", **kw) -> str:
    """Sharded save of a ZeRO train state: leaves whose spec leads with
    ``shard_axis`` (the per-rank optimizer partitions) go to per-shard
    files with per-shard CRC32 digests; replicated leaves are stored
    once.  A veneer over :func:`apex_tpu_torch.checkpoint.
    save_checkpoint`: its knobs pass through (``shard_axes=`` for
    format 4 supersedes ``shard_axis``; ``group=`` when each rank holds
    its block)."""
    from apex_tpu_torch import checkpoint as ckpt

    if kw.get("shard_axes") is not None:
        shard_axis = None
    return ckpt.save_checkpoint(ckpt_dir, state, step=step,
                                shardings=shardings, shard_axis=shard_axis,
                                **kw)


def restore_zero_checkpoint(ckpt_dir: str, target, *, shardings=None,
                            shard_axes=None, group=None,
                            step: Optional[int] = None, device=None,
                            max_fallbacks: Optional[int] = None):
    """Cross-topology resilient restore: the newest *intact* checkpoint
    under ``ckpt_dir`` (or ``step``), verified and re-partitioned to
    ``target``'s topology.  In one process ``target`` holds whole stacks
    (:func:`~apex_tpu_torch.resilience.restore_resilient`).  Across the
    ranks of ``group``, ``target`` holds this rank's blocks, laid out by
    ``shardings`` over ``shard_axes``: rank 0 walks the candidates
    (corrupt ones skipped with a warning) and broadcasts the step, and
    each rank reads and verifies only the files its blocks overlap.
    Returns ``(state, step)``."""
    from apex_tpu_torch.checkpoint import restore_checkpoint
    from apex_tpu_torch.resilience.restore import (newest_intact_step,
                                                   restore_resilient)

    world = 1 if group is None else torch.distributed.get_world_size(group)
    if world == 1:
        if step is None:
            return restore_resilient(ckpt_dir, target, device=device,
                                     max_fallbacks=max_fallbacks)
        return restore_checkpoint(ckpt_dir, target, step=step,
                                  device=device, verify=True)
    if step is None:
        box = [None]
        if torch.distributed.get_rank(group) == 0:
            try:
                box = [newest_intact_step(ckpt_dir, max_fallbacks)]
            except Exception as e:   # every rank raises it below
                box = [f"{type(e).__name__}: {e}"]
        torch.distributed.broadcast_object_list(
            box, src=torch.distributed.get_global_rank(group, 0),
            group=group)
        if isinstance(box[0], str):
            from apex_tpu_torch.checkpoint import CheckpointCorruptionError
            raise CheckpointCorruptionError(box[0])
        step = box[0]
    return restore_checkpoint(ckpt_dir, target, step=step, device=device,
                              verify=True, shardings=shardings,
                              shard_axes=shard_axes, group=group)


# ---------------------------------------------------------------------------
# Elastic training: shrink the world on the loss of ranks and keep going
# ---------------------------------------------------------------------------


def largest_divisor_submesh(devices: Sequence, batch_size: int) -> list:
    """The largest prefix of ``devices`` whose length divides
    ``batch_size``: losing 2 of 8 ranks (6 survivors) rebuilds on 4."""
    devices = list(devices)
    for m in range(len(devices), 0, -1):
        if batch_size % m == 0:
            return devices[:m]
    return devices[:1]


def best_surviving_submesh(survivors: Sequence, mesh_shape,
                           *, batch_size: Optional[int] = None):
    """The best (dp, tp, pp) world on the survivors: per axis a divisor
    of the old size, shrinking dp before tp before pp (a pp change
    re-maps every stage's layers, a tp change re-slices every weight, a
    dp change is a flat re-partition); ``batch_size`` must divide the
    chosen dp.  Returns ``(survivors[:dp tp pp], (dp, tp, pp))``."""
    dp, tp, pp = (int(x) for x in mesh_shape)
    survivors = list(survivors)
    n = len(survivors)

    def _divisors_desc(k):
        return [d for d in range(k, 0, -1) if k % d == 0]

    for pp_c in _divisors_desc(pp):
        for tp_c in _divisors_desc(tp):
            for dp_c in _divisors_desc(dp):
                if dp_c * tp_c * pp_c > n:
                    continue
                if batch_size is not None and batch_size % dp_c:
                    continue
                return survivors[: dp_c * tp_c * pp_c], (dp_c, tp_c, pp_c)
    return survivors[:1], (1, 1, 1)


@dataclasses.dataclass
class ElasticResult:
    """Outcome of :func:`run_elastic_training`."""

    state: Any                    # final state, stacks whole (host)
    step: int
    restarts: int
    devices: list                 # surviving ranks (original ids) at exit
    lost_devices: list            # ids lost along the way
    preempted: bool
    stop_reason: Optional[str]
    loop_results: list            # per attempt: rank 0's summary
    mesh_shape: Optional[tuple] = None  # (dp, tp, pp) at exit (3-D runs)
    losses: list = dataclasses.field(default_factory=list)  # rank 0's


def _shard_axes(shape) -> dict:
    dp, tp, pp = shape
    # the parallel_state order, and the stacking order of the flagship's
    # opt leaves ([dp, pp, tp, shard])
    return {"data": dp, "pipeline": pp, "tensor": tp}


def stack_rank_states(states: Sequence, shardings, axes: dict):
    """One state with whole stacks from the ranks' states (each holding
    its block, rank r at ``unravel(r, axes)``): a leaf whose spec leads
    with axes of ``axes`` is assembled from the blocks of the ranks whose
    other coordinates are 0; any other leaf is rank 0's."""
    import numpy as np

    from apex_tpu_torch.multi_tensor.flat import (_tree_flatten,
                                                  _tree_unflatten,
                                                  expand_specs,
                                                  spec_lead_axes)

    leaves0, treedef = _tree_flatten(states[0])
    per_rank = [_tree_flatten(s)[0] for s in states]
    specs = expand_specs(shardings, states[0])
    names = list(axes)
    out = []
    for i, (leaf, spec) in enumerate(zip(leaves0, specs)):
        lead = spec_lead_axes(spec, axes)
        if not lead:
            out.append(leaf)
            continue
        sizes = [axes[a] for a in lead]
        whole = leaf.new_empty((*sizes, *leaf.shape[len(lead):]))
        for r, leaves in enumerate(per_rank):
            coords = np.unravel_index(r, tuple(axes.values()))
            if any(coords[names.index(a)] for a in names if a not in lead):
                continue
            c = tuple(int(coords[names.index(a)]) for a in lead)
            whole[c] = leaves[i].reshape(leaf.shape[len(lead):])
        out.append(whole)
    return _tree_unflatten(treedef, out)


def _host_tree(tree):
    from apex_tpu_torch.multi_tensor.flat import (_tree_flatten,
                                                  _tree_unflatten)

    leaves, treedef = _tree_flatten(tree)
    return _tree_unflatten(treedef, [
        x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
        else x for x in leaves])


def _elastic_rank(rank, world, init_file, out, job):
    """One rank of an elastic attempt (spawned by
    :func:`run_elastic_training`): build, restore, train, report."""
    import os

    from apex_tpu_torch.checkpoint import load_data_state
    from apex_tpu_torch.parallel.multiproc import init_file_group
    from apex_tpu_torch.resilience.chaos import DeviceLossError
    from apex_tpu_torch.transformer.testing import run_resilient_training

    init_file_group("gloo", rank, world, init_file)
    try:
        shape = job["mesh_shape"]
        build = job["build"]
        step_fn, state, shardings = (build() if shape is None
                                     else build(mesh_shape=shape))
        group = torch.distributed.group.WORLD if world > 1 else None
        axes = (_shard_axes(shape) if shape is not None
                else {job["shard_axis"]: world})
        step = job["step"]
        data_iter = job["data_iter"]
        if job["restore_step"] is not None:
            state, step = restore_zero_checkpoint(
                job["ckpt_dir"], state, shardings=shardings,
                shard_axes=axes, group=group, step=job["restore_step"])
            if data_iter is not None:
                data_iter.load_state_dict(
                    load_data_state(job["ckpt_dir"], step=step))
        batches = job["batches"]
        report = {"rank": rank, "start": step, "shardings": shardings}
        try:
            res = run_resilient_training(
                step_fn, state,
                batches[step - job["start_step"]:] if data_iter is None
                else None, data_iter=data_iter,
                ckpt_dir=job["ckpt_dir"], save_every=job["save_every"],
                keep=job["keep"], shardings=shardings,
                shard_axis=None if shape is not None else job["shard_axis"],
                shard_axes=axes if shape is not None else None,
                group=group, start_step=step, on_step=job["on_step"])
            report.update(step=res.step, preempted=res.preempted,
                          stop_reason=res.stop_reason, lost=None,
                          state=_host_tree(res.state),
                          data_state=(data_iter.state_dict()
                                      if data_iter is not None else None))
        except DeviceLossError as e:
            report.update(lost=list(e.device_ids), detail=str(e))
        report["losses"] = list(getattr(step_fn, "losses", []))
        on_step = job["on_step"]
        report["polls"] = getattr(getattr(on_step, "__self__", on_step),
                                  "polls", None)
        torch.save(report, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_elastic_training(
    build: Callable,
    devices: Sequence,
    batches: Optional[Sequence] = None,
    *,
    data_iter=None,
    ckpt_dir: str,
    save_every: int = 1,
    keep: Optional[int] = None,
    shard_axis: str = "data",
    max_restarts: int = 3,
    min_devices: int = 1,
    select_devices: Optional[Callable[[list], list]] = None,
    mesh_shape: Optional[Sequence[int]] = None,
    select_mesh: Optional[Callable] = None,
    batch_size: Optional[int] = None,
    start_step: int = 0,
    on_step: Optional[Callable] = None,
    log_fn: Optional[Callable[[str], None]] = None,
    work_dir: Optional[str] = None,
    timeout: float = 1800.0,
) -> ElasticResult:
    """Drive ZeRO training across the loss of ranks.

    ``devices`` — the ranks' ids (``list(range(world))``); one process is
    spawned per id.  ``build`` — a picklable callable run in every rank
    after it joined the world: ``build()`` (or ``build(mesh_shape=shape)``
    with ``mesh_shape``) returns ``(step_fn, state, shardings)`` for that
    world, the state holding this rank's blocks
    (:func:`~apex_tpu_torch.transformer.testing.flagship_elastic_build`).
    ``batches`` (a Sequence, handed to every rank) or ``data_iter`` (a
    picklable checkpointable iterator over the global batch: each rank
    runs a copy, its position rides every manifest as ``data_state`` and
    resumes from there across topologies; at the end the caller's
    iterator is set to rank 0's position).  ``on_step`` — a picklable
    hook each rank calls at every step boundary (a
    :class:`~apex_tpu_torch.resilience.chaos.DeviceLoss` ``poll``).

    Saves are sharded every ``save_every`` steps: format 3 over
    ``shard_axis``, or format 4 over (data, pipeline, tensor) with
    ``mesh_shape=(dp, tp, pp)``.  When a rank raises ``DeviceLossError``
    the attempt ends; the launcher drops the lost ids (``select_devices``
    filters the survivors; with ``mesh_shape``, ``select_mesh(survivors,
    shape) -> (devices, shape)``, default :func:`best_surviving_submesh`
    with ``batch_size``), finds the newest intact checkpoint, and spawns
    the survivors' world to restore it and go on.  Gives up (re-raises)
    after ``max_restarts`` rebuilds or below ``min_devices``.  Returns an
    :class:`ElasticResult` whose ``state`` holds whole stacks (rank 0's
    replicated leaves) on the host and whose ``losses`` are rank 0's
    step losses over every attempt (``step_fn.losses``)."""
    import os
    import tempfile

    from apex_tpu_torch.checkpoint.checkpoint import _complete_steps
    from apex_tpu_torch.parallel.multiproc import spawn
    from apex_tpu_torch.resilience.chaos import DeviceLossError
    from apex_tpu_torch.resilience.restore import newest_intact_step

    emit = log_fn or (lambda msg: log.info("%s", msg))
    if data_iter is not None:
        if batches is not None:
            raise ValueError("pass batches OR data_iter, not both")
        if not (hasattr(data_iter, "state_dict")
                and hasattr(data_iter, "load_state_dict")):
            raise TypeError(
                f"data_iter {type(data_iter).__name__} is not "
                "checkpointable (no state_dict/load_state_dict) — an "
                "elastic recovery would silently replay or skip "
                "training data")
        data_initial = data_iter.state_dict()
    elif batches is None:
        raise ValueError("run_elastic_training needs batches or data_iter")
    devices = list(devices)
    if mesh_shape is not None:
        mesh_shape = tuple(int(x) for x in mesh_shape)
    lost: list = []
    restarts = 0
    loop_results: list = []
    losses: list = []
    step, restore_step = start_step, None
    work = work_dir or tempfile.mkdtemp(prefix="elastic_")
    attempt = 0
    while True:
        out = os.path.join(work, f"attempt{attempt}")
        os.makedirs(out, exist_ok=True)
        if data_iter is not None and restore_step is None:
            data_iter.load_state_dict(data_initial)
        job = dict(build=build, mesh_shape=mesh_shape,
                   shard_axis=shard_axis, step=step,
                   restore_step=restore_step, ckpt_dir=ckpt_dir,
                   batches=batches, data_iter=data_iter,
                   start_step=start_step, save_every=save_every, keep=keep,
                   on_step=on_step)
        spawn(_elastic_rank, len(devices), os.path.join(out, "store"), out,
              job, timeout=timeout)
        reports = [torch.load(os.path.join(out, f"rank{r}.pt"),
                              weights_only=False)
                   for r in range(len(devices))]
        lead = reports[0]
        losses.extend(lead["losses"])
        loop_results.append({k: v for k, v in lead.items() if k != "state"})
        lost_now = sorted({d for r in reports if r["lost"]
                           for d in r["lost"]})
        attempt += 1
        if not lost_now:
            if any(r["lost"] is None and r.get("step") != lead["step"]
                   for r in reports):
                raise RuntimeError("ranks of one world ended at different "
                                   "steps")
            axes = (_shard_axes(mesh_shape) if mesh_shape is not None
                    else {shard_axis: len(devices)})
            state = stack_rank_states([r["state"] for r in reports],
                                      lead["shardings"], axes)
            if data_iter is not None and lead["data_state"] is not None:
                data_iter.load_state_dict(lead["data_state"])
            return ElasticResult(
                state=state, step=lead["step"], restarts=restarts,
                devices=devices, lost_devices=lost,
                preempted=lead["preempted"], stop_reason=lead["stop_reason"],
                loop_results=loop_results, mesh_shape=mesh_shape,
                losses=losses)
        # the hook fired in the ranks: the survivors must not see it again
        hook = getattr(on_step, "__self__", on_step)
        if hasattr(hook, "fired"):
            hook.fired = True
            if lead.get("polls") is not None:
                hook.polls = lead["polls"]
        lost_ids = set(lost_now)
        lost.extend(sorted(lost_ids))
        survivors = [d for d in devices if d not in lost_ids]
        if select_devices is not None:
            survivors = list(select_devices(survivors))
        new_shape = mesh_shape
        if mesh_shape is not None:
            picker = select_mesh or (
                lambda s, shape: best_surviving_submesh(
                    s, shape, batch_size=batch_size))
            survivors, new_shape = picker(survivors, mesh_shape)
            survivors = list(survivors)
        restarts += 1
        err = DeviceLossError(lost_now, detail=next(
            r["detail"] for r in reports if r["lost"]))
        if restarts > max_restarts:
            raise err
        if len(survivors) < max(1, min_devices):
            raise DeviceLossError(
                lost_now, detail=f"only {len(survivors)} devices survive, "
                                 f"min_devices={min_devices}") from err
        devices, mesh_shape = survivors, new_shape
        emit(f"[elastic] lost device(s) {sorted(lost_ids)} — rebuilding on "
             f"{len(devices)} survivors"
             + (f" as (dp, tp, pp)={mesh_shape}" if mesh_shape is not None
                else "") + f" (restart {restarts}/{max_restarts})")
        if _complete_steps(ckpt_dir):
            restore_step = step = newest_intact_step(ckpt_dir)
            if step < start_step:
                raise RuntimeError(
                    f"elastic restore fell back to step {step}, before "
                    f"this run's start_step={start_step} — the batches for "
                    "that range are not available here") from err
            emit(f"[elastic] resuming from sharded checkpoint step {step} "
                 f"on the {len(devices)}-rank world")
        else:
            restore_step, step = None, start_step
            emit(f"[elastic] no checkpoint yet — restarting from step "
                 f"{step}")
