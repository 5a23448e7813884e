"""Resilient training-loop harness (testing tier; port of the JAX
package's ``apex_tpu/transformer/testing/train_loop.py``).

A minimal but complete train loop wiring together every piece of
:mod:`apex_tpu_torch.resilience`: periodic async checkpointing,
preemption polling with a final blocking save, and divergence guarding.
The chaos tests drive this loop under simulated preemption and storage
faults to prove the survive-and-resume story on the CPU; it is also the
reference wiring for the port's ``examples/gpt/pretrain_gpt.py``.

With a :class:`~apex_tpu_torch.telemetry.TelemetryBus` attached the loop
is also the reference observability wiring: per-step ``step`` events
with the data-wait / step / checkpoint-fence wall split, ``ckpt_save``
events, ``skip`` events from the guard, ``watchdog`` events from the
deadline monitor, and a flight-recorder postmortem flushed on every
abnormal exit (grace-period stop, watchdog escalation, divergence).

Contract: ``step_fn(state, batch) -> (state, finite_or_None)`` where
``finite`` is the all-finite scalar of the step's grads (or None when the
loop should not do skip accounting).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.resilience.async_checkpoint import wait_for_save
from apex_tpu_torch.resilience.guards import StepGuard
from apex_tpu_torch.resilience.preemption import GracePeriodHandler


@dataclasses.dataclass
class LoopResult:
    state: Any
    steps_run: int  # steps executed by THIS loop invocation
    step: int  # global step reached (start_step + steps_run)
    preempted: bool
    stop_reason: Optional[str]
    last_saved_step: Optional[int]
    skipped_steps: int


def _default_scalars(state: Any, finite: Any) -> Dict[str, Any]:
    """Device-scalar refs the loop can surface without knowing the
    state's shape: the amp scaler's loss scale and monotonic skip
    counter (when the state carries them) plus the step's finite flag.
    These are REFERENCES — the accountant reads them back once per
    logging window."""
    out: Dict[str, Any] = {}
    scaler_state = getattr(state, "scaler_state", None)
    if scaler_state is not None:
        if getattr(scaler_state, "loss_scale", None) is not None:
            out["loss_scale"] = scaler_state.loss_scale
        if getattr(scaler_state, "skipped", None) is not None:
            out["scaler_skipped"] = scaler_state.skipped
    if finite is not None:
        out["finite"] = finite
    return out


def run_resilient_training(
    step_fn: Callable[[Any, Any], tuple],
    state: Any,
    batches: Optional[Iterable[Any]] = None,
    *,
    data_iter: Any = None,
    ckpt_dir: Optional[str] = None,
    save_every: int = 0,
    keep: Optional[int] = None,
    async_saves: bool = True,
    handler: Optional[GracePeriodHandler] = None,
    guard: Optional[StepGuard] = None,
    watchdog: Any = None,
    start_step: int = 0,
    on_step: Optional[Callable[[int], None]] = None,
    log_every: int = 0,
    log_fn: Optional[Callable[[str], None]] = None,
    telemetry: Any = None,
    telemetry_scalars: Optional[Callable[[Any], Dict[str, Any]]] = None,
) -> LoopResult:
    """Run ``step_fn`` over ``batches`` with the full resilience wiring.

    - every ``save_every`` steps: checkpoint (async by default — the loop
      keeps stepping while the write is in flight; the next save fences);
    - after every step: poll ``handler.should_stop``; on preemption write a
      final BLOCKING checkpoint (itself fencing any in-flight async write)
      and return with ``preempted=True`` — the caller restarts later via
      :func:`apex_tpu_torch.resilience.restore_resilient` and passes the
      remaining batches with ``start_step`` set;
    - ``guard`` counts skipped steps from the ``finite`` flag ``step_fn``
      returns and raises after too many consecutive skips;
    - ``watchdog`` (:class:`apex_tpu_torch.resilience.Watchdog`) arms its
      deadline around each ``step_fn`` call; a hang escalates to
      ``handler``'s save-and-exit path;
    - ``log_every``/``log_fn`` emit a status line every N steps carrying
      throughput (steps/s over the window), divergence-skip accounting
      (the guard's counters and, when the state carries a
      ``LossScaleState.skipped`` device counter, that too), and — with a
      watchdog attached — the max heartbeat age, so a stalling device is
      visible *before* the deadline escalates;
    - ``telemetry`` (:class:`apex_tpu_torch.telemetry.TelemetryBus`): the loop
      emits ``run_start``/``step``/``ckpt_save``/``run_end`` events,
      books the wall split (data-wait / step / ckpt-fence, for goodput),
      shares its bus with ``guard``/``watchdog`` (skip and watchdog
      events), and flushes a flight-recorder postmortem on the
      grace-period exit and on any exception leaving the loop.
      ``telemetry_scalars(state) -> {name: device_ref}`` adds run-
      specific scalars (e.g. the loss) to the windowed read;
    - ``on_step(step)`` runs at each step boundary *before* the preemption
      poll (the chaos harness's ``SimulatedPreemption.poll`` and
      hooks here);
    - ``data_iter`` (instead of ``batches``): an input-pipeline iterator
      conforming to the checkpointable-iterator protocol
      (``state_dict()``/``load_state_dict()``, e.g.
      :class:`apex_tpu_torch.data.ShardedRecordIterator` — optionally behind
      :class:`~apex_tpu_torch.data.AsyncPrefetcher`).  Every checkpoint then
      also records the iterator's position (the manifest ``data_state``
      key) so a resumed run replays *exactly* the samples an
      uninterrupted run would have seen — no duplicates, no drops
      (docs/data.md).  With checkpointing enabled, a plain
      generator/iterator without the protocol is REJECTED up front:
      restoring model state while silently rewinding (or fast-
      forwarding) the data stream is the bug this parameter exists to
      make impossible;
    - before returning (any path) the loop fences on outstanding async
      writes, so a completed run's checkpoints are durable.
    """
    if data_iter is not None:
        if batches is not None:
            raise ValueError("pass batches OR data_iter, not both")
        if ckpt_dir is not None and not (
                hasattr(data_iter, "state_dict")
                and hasattr(data_iter, "load_state_dict")):
            raise TypeError(
                f"data_iter {type(data_iter).__name__} is not "
                "checkpointable (no state_dict/load_state_dict) but "
                "checkpointing is enabled — a restored run would "
                "silently replay or skip training data.  Use "
                "apex_tpu_torch.data.ShardedRecordIterator (or wrap it in "
                "AsyncPrefetcher), or pass a Sequence via batches= and "
                "manage the position yourself.")
        if ckpt_dir is not None:
            # probe eagerly: a wrapper (AsyncPrefetcher) around a
            # non-checkpointable source defines state_dict but raises
            # inside it — fail NOW, not at the first checkpoint save
            # hundreds of steps in
            data_iter.state_dict()
        batches = data_iter
    elif batches is None:
        raise ValueError("run_resilient_training needs batches or "
                         "data_iter")
    step = start_step
    steps_run = 0
    last_saved: Optional[int] = None
    preempted = False

    acct = None
    if telemetry is not None:
        acct = telemetry.accountant(window=log_every or 10)
        if guard is not None and guard.telemetry is None:
            guard.telemetry = telemetry
        if watchdog is not None:
            telemetry.attach_watchdog(watchdog)
        telemetry.emit(
            "run_start", step=start_step,
            save_every=save_every, async_saves=bool(async_saves),
            sharded=False, watchdog=watchdog is not None,
            guarded=guard is not None)

    def _save(blocking: bool) -> None:
        nonlocal last_saved
        if ckpt_dir is None:
            return
        t0 = time.monotonic()
        # the iterator position rides the SAME manifest as the model
        # state (atomic commit), so a restore can never pair step N's
        # weights with step M's data cursor
        data_state = (data_iter.state_dict()
                      if data_iter is not None
                      and hasattr(data_iter, "state_dict") else None)
        ckpt.save_checkpoint(ckpt_dir, state, step=step, keep=keep,
                             data_state=data_state,
                             blocking=blocking or not async_saves)
        dt = time.monotonic() - t0
        last_saved = step
        if telemetry is not None:
            # the host-visible cost: a blocking save IS a fence+write;
            # an async save call only stalls when it fences a previous
            # in-flight write — either way `dt` is checkpoint stall
            acct.pause(dt, "ckpt_fence")
            telemetry.emit("ckpt_save", step=step,
                           blocking=bool(blocking or not async_saves),
                           wall_ms=round(dt * 1e3, 3))

    t_last_log = time.monotonic()
    step_last_log = start_step

    def _log() -> None:
        nonlocal t_last_log, step_last_log
        emit = log_fn or print
        parts = [f"[resilient] step {step}"]
        now = time.monotonic()
        if now > t_last_log and step > step_last_log:
            parts.append(
                f"{(step - step_last_log) / (now - t_last_log):.2f} steps/s")
        t_last_log, step_last_log = now, step
        if guard is not None:
            parts.append(f"skipped {guard.total_skipped}/"
                         f"{guard.total_steps} (consecutive "
                         f"{guard.consecutive})")
        scaler_state = getattr(state, "scaler_state", None)
        skipped = getattr(scaler_state, "skipped", None)
        if skipped is not None:
            parts.append(f"scaler_skipped {int(skipped)}")
        if watchdog is not None:
            age = watchdog.max_heartbeat_age()
            if age is not None:
                # the stall early-warning: this climbs for the whole
                # hang, the deadline only fires at its end
                parts.append(f"max_hb_age {age:.1f}s")
        if last_saved is not None:
            parts.append(f"last_saved {last_saved}")
        emit(" ".join(parts))

    def _flush_postmortem(reason: str) -> None:
        if telemetry is None:
            return
        try:
            telemetry.flush_postmortem(reason, step=step, watchdog=watchdog)
        except Exception:  # never mask the primary failure
            pass

    def _finish(reason: str) -> None:
        if acct is not None:
            try:
                acct.finish(step=step, reason=reason)
            except Exception:
                pass

    try:
        it = iter(batches)
        while True:
            t0 = time.monotonic()
            try:
                batch = next(it)
            except StopIteration:
                break
            t1 = time.monotonic()
            if watchdog is not None:
                with watchdog.step(step):
                    state, finite = step_fn(state, batch)
            else:
                state, finite = step_fn(state, batch)
            step += 1
            steps_run += 1
            skipped = False
            synced = guard is not None and finite is not None
            if synced:
                scaler_state = getattr(state, "scaler_state", None)
                # bool(finite) inside update is a device sync — the one
                # per-step sync a guarded loop already pays
                skipped = guard.update(
                    finite, step=step,
                    loss_scale=getattr(scaler_state, "loss_scale", None))
            # measure step wall AFTER the guard's finite sync, so on the
            # card step_ms covers the device step, not just the launch;
            # an unguarded loop has no sync point and its step events
            # are tagged timing="dispatch" — the stream must say which
            # clock it is on
            t2 = time.monotonic()
            if acct is not None:
                scalars = _default_scalars(state, finite)
                if telemetry_scalars is not None:
                    scalars.update(telemetry_scalars(state) or {})
                acct.step_done(step, step_s=t2 - t1, data_wait_s=t1 - t0,
                               skipped=skipped, scalars=scalars,
                               timing="synced" if synced else "dispatch")
            if log_every and step % log_every == 0:
                _log()
            if on_step is not None:
                on_step(step)
            if handler is not None and handler.should_stop:
                # grace period: current step finished; make the work durable
                # and hand control back for a clean exit
                preempted = True
                _save(blocking=True)
                break
            if save_every and step % save_every == 0:
                _save(blocking=False)
    except BaseException as e:
        # the crash path: dump the flight recorder FIRST (the postmortem
        # is the whole point of the recorder), then fence — and never
        # let a parked async-save error mask the primary exception
        # (e.g. a DivergenceError diagnostic)
        _flush_postmortem(type(e).__name__)
        _finish(type(e).__name__)
        try:
            wait_for_save()
        except Exception:
            pass
        raise
    t0 = time.monotonic()
    wait_for_save()
    if acct is not None:
        acct.pause(time.monotonic() - t0, "ckpt_fence")

    stop_reason = handler.reason if handler is not None else None
    if preempted:
        # grace-period exit (SIGTERM / watchdog escalation /
        # request_stop): leave the machine-readable record of the last
        # ring-buffer window next to the stream
        _flush_postmortem(stop_reason or "preempted")
    _finish(stop_reason or "completed")

    return LoopResult(
        state=state,
        steps_run=steps_run,
        step=step,
        preempted=preempted,
        stop_reason=stop_reason,
        last_saved_step=last_saved,
        skipped_steps=guard.total_skipped if guard is not None else 0,
    )
