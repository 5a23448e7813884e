"""The port's training resilience (``apex_tpu_torch.resilience``: the
grace handler, guards, the async writer's fences; the step accountant;
``transformer.testing.train_loop``) against the JAX package's.

The same numpy state and record shards go through both resilient loops:
their checkpoints are byte for byte the same files (manifests and
arrays), their loop results and event streams agree, and a run preempted
by a real SIGTERM and resumed from its checkpoint and data position ends
bitwise where the uninterrupted run ends.  The guards name the same
first non-finite leaf as JAX's; the accountant's events validate against
the port's schema.
"""

import filecmp
import os
import signal

import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as jckpt
from apex_tpu import data as jdata
from apex_tpu import resilience as jres
from apex_tpu import telemetry as jtele
from apex_tpu.resilience import async_checkpoint as jasync
from apex_tpu.transformer.testing import train_loop as jloop
from apex_tpu_torch import amp
from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch import data as tdata
from apex_tpu_torch import resilience as tres
from apex_tpu_torch import telemetry as ttele
from apex_tpu_torch.resilience import async_checkpoint as tasync
from apex_tpu_torch.resilience import chaos as tchaos
from apex_tpu_torch.transformer.testing import train_loop as tloop

PAYLOAD = 16


@pytest.fixture(autouse=True)
def _drain():
    yield
    jasync.drain(ignore_errors=True)
    tasync.drain(ignore_errors=True)


@pytest.fixture()
def shards(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for k in range(2):
        rows = rng.randint(0, 256, (9, PAYLOAD)).astype(np.uint8)
        p = str(tmp_path / f"s{k}.bin")
        tdata.write_checksummed_records(p, rows)
        paths.append(p)
    return paths


def _decode(m):
    return m.astype(np.float32) / 255.0


def _step_fn(state, batch):
    """A numpy step both loops can run: a decaying running mean of the
    batch (new arrays every step: nothing updated in place)."""
    w = state["w"] * 0.5 + batch.mean(axis=0).astype(np.float32)
    return {"w": w.astype(np.float32), "n": state["n"] + 1}, None


def _state():
    return {"w": np.zeros(PAYLOAD, np.float32), "n": np.asarray(0, np.int32)}


def _iter(mod, paths):
    return mod.ShardedRecordIterator(paths, PAYLOAD + 4, 3, checksummed=True,
                                     seed=11, decode=_decode, num_batches=6,
                                     shuffle_window=5)


def test_both_loops_write_the_same_checkpoints_and_events(shards, tmp_path):
    runs = {}
    for name, mod, loop, tele in (("jax", jdata, jloop, jtele),
                                  ("port", tdata, tloop, ttele)):
        sink = tele.MemorySink()
        bus = tele.TelemetryBus(run_id="r", sinks=[sink],
                                mesh={"n_devices": 1})
        d = str(tmp_path / name)
        res = loop.run_resilient_training(
            _step_fn, _state(), data_iter=_iter(mod, shards), ckpt_dir=d,
            save_every=2, telemetry=bus, log_every=2)
        runs[name] = (res, sink.events, d)
    (jr, jev, jd), (tr, tev, td) = runs["jax"], runs["port"]
    assert (tr.steps_run, tr.step, tr.preempted, tr.last_saved_step) == (
        jr.steps_run, jr.step, jr.preempted, jr.last_saved_step) == (
        6, 6, False, 6)
    assert np.array_equal(tr.state["w"], jr.state["w"])
    for s in (2, 4, 6):
        for f in ("manifest.json", "arrays.npz"):
            assert filecmp.cmp(os.path.join(jckpt.step_dir(jd, s), f),
                               os.path.join(tckpt.step_dir(td, s), f),
                               shallow=False), (s, f)
    # the same events, fields and scalar reads (times aside)
    strip = ("t", "ts", "wall_ms", "step_ms", "data_wait_ms", "wall_s",
             "goodput", "steps_per_sec", "buckets_s", "compile_ms")
    assert [{k: v for k, v in e.items() if k not in strip} for e in tev] == \
        [{k: v for k, v in e.items() if k not in strip} for e in jev
         if e["type"] != "recompile"]
    ttele.validate_events(tev)


def test_preempted_loop_resumes_exactly_once_and_bitwise(shards, tmp_path):
    straight = tloop.run_resilient_training(
        _step_fn, _state(), data_iter=_iter(tdata, shards))
    d = str(tmp_path / "c")
    sink = ttele.MemorySink()
    bus = ttele.TelemetryBus(run_id="p", sinks=[sink],
                             postmortem_dir=str(tmp_path))
    with tres.GracePeriodHandler() as h:
        preempt = tchaos.SimulatedPreemption(3, handler=h, telemetry=bus)
        first = tloop.run_resilient_training(
            _step_fn, _state(), data_iter=_iter(tdata, shards), ckpt_dir=d,
            save_every=2, handler=h, on_step=preempt.poll, telemetry=bus)
    assert first.preempted and first.stop_reason == "SIGTERM"
    assert (first.steps_run, first.last_saved_step) == (3, 3)
    assert signal.getsignal(signal.SIGTERM) is not h._on_signal
    # restart: the newest intact checkpoint and its data position
    restored, start = tres.restore_resilient(d, target=_state())
    it = _iter(tdata, shards)
    it.load_state_dict(tckpt.load_data_state(d, start))
    second = tloop.run_resilient_training(_step_fn, restored, data_iter=it,
                                          start_step=start)
    assert (start, second.step) == (3, 6)
    assert second.state["w"].tobytes() == straight.state["w"].tobytes()
    kinds = [e["type"] for e in sink.events]
    assert kinds.count("ckpt_save") == 2 and "postmortem" in kinds
    assert [e["kind"] for e in sink.events
            if e["type"] == "fault_injected"] == ["preemption"]
    ttele.validate_events(sink.events)


def test_loop_refuses_a_plain_iterator_with_checkpoints(tmp_path):
    with pytest.raises(TypeError, match="not checkpointable"):
        tloop.run_resilient_training(_step_fn, _state(),
                                     data_iter=iter([np.zeros(4)]),
                                     ckpt_dir=str(tmp_path))


def test_watchdog_escalates_to_the_grace_exit(tmp_path):
    import time

    def slow_step(state, batch):
        time.sleep(0.3)
        return _step_fn(state, batch)

    batches = [np.ones((3, PAYLOAD))] * 4
    with tres.GracePeriodHandler() as h:
        wd = tres.Watchdog(0.05, handler=h)
        res = tloop.run_resilient_training(
            slow_step, _state(), batches, ckpt_dir=str(tmp_path / "c"),
            handler=h, watchdog=wd)
        wd.close()
    assert res.preempted and res.stop_reason.startswith("watchdog_timeout")
    assert res.steps_run == 1 and res.last_saved_step == 1


# -- guards ------------------------------------------------------------------


def _bad_tree():
    g = {"b": np.ones(3, np.float32), "a": np.ones((2, 2), np.float32)}
    g["a"][0, 1] = np.nan
    g["a"][1, 0] = np.inf
    return g


def test_guard_diagnostic_names_jax_s_first_leaf():
    g = _bad_tree()
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    assert tres.first_nonfinite_leaf(tg) == jres.first_nonfinite_leaf(g) == \
        "['a']: 1 nan, 1 inf (of 4)"
    assert tres.first_nonfinite_leaf({"a": torch.ones(2)}) is None
    clean = {"a": np.arange(4, dtype=np.float32), "b": np.ones(2)}
    assert tres.global_grad_norm(
        {k: torch.from_numpy(v) for k, v in clean.items()}) == \
        pytest.approx(jres.global_grad_norm(clean), rel=1e-12)
    sink = ttele.MemorySink()
    guard = tres.StepGuard(max_consecutive_skips=2,
                           telemetry=ttele.TelemetryBus(sinks=[sink]))
    finite = guard.check(tg)
    assert finite.dtype == torch.bool and not bool(finite)
    assert guard.update(finite, tg, step=1, loss_scale=torch.tensor(8.0))
    assert not guard.update(torch.tensor(True))
    guard.update(False, tg)
    with pytest.raises(tres.DivergenceError,
                       match=r"first non-finite leaf: \['a'\]: 1 nan, 1 inf"):
        guard.update(False, tg)
    skips = [e for e in sink.events if e["type"] == "skip"]
    assert len(skips) == 3 and skips[0]["loss_scale"] == 8.0
    ttele.validate_events(sink.events)


def test_guard_adopts_the_port_scaler_s_skip_count():
    scaler = amp.LossScaler()
    state = scaler.init()
    state = scaler.update(state, torch.tensor(False))
    state = scaler.update(state, torch.tensor(False))
    guard = tres.StepGuard()
    guard.sync_from_scaler(state)
    assert guard.total_skipped == 2


# -- preemption and the writer -----------------------------------------------


def test_grace_handler_catches_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with tres.GracePeriodHandler() as h:
        assert not h.should_stop and h.reason is None
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop and h.reason == "SIGTERM"
        h.reset()
        h.request_stop("maintenance")
        assert h.reason == "maintenance"
    assert signal.getsignal(signal.SIGTERM) is before


def test_writer_fences_one_write_at_a_time(tmp_path):
    d = str(tmp_path / "c")
    with tchaos.slow_writer(0.2) as store:
        tckpt.save_checkpoint(d, {"w": torch.ones(3)}, step=1,
                              blocking=False)
        assert tres.in_flight()
        tckpt.save_checkpoint(d, {"w": torch.zeros(3)}, step=2)
        assert not tres.in_flight()
        assert store.calls["write_arrays"] == 2
    assert tckpt.latest_step(d) == 2
    assert sorted(os.listdir(d)) == ["latest", "step_0000000001",
                                     "step_0000000002"]


# -- the accountant ----------------------------------------------------------


def test_accountant_events_match_jax_s():
    streams = {}
    for name, tele in (("jax", jtele), ("port", ttele)):
        sink = tele.MemorySink()
        bus = tele.TelemetryBus(run_id="a", sinks=[sink],
                                mesh={"n_devices": 1})
        acct = bus.accountant(window=2)
        assert bus.accountant() is acct
        scal = (torch.tensor(2.5) if name == "port" else np.float32(2.5))
        acct.step_done(1, step_s=0.01, data_wait_s=0.002,
                       scalars={"loss": scal})
        acct.step_done(2, step_s=0.02, skipped=True,
                       scalars={"loss": scal, "n": 3}, timing="synced")
        acct.pause(0.05, "ckpt_fence")
        with pytest.raises(ValueError, match="unknown pause kind"):
            acct.pause(1.0, "lunch")
        acct.finish(step=2)
        streams[name] = sink.events
    strip = ("t", "ts", "wall_s", "goodput", "steps_per_sec")
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in streams["port"]] == [
        {k: v for k, v in e.items() if k not in strip}
        for e in streams["jax"]]
    ttele.validate_events(streams["port"])
    end = streams["port"][-1]
    assert end["buckets_s"]["ckpt_fence"] == 0.05 and end["skips"] == 1
    assert streams["port"][1]["scalars"] == {"loss": 2.5, "n": 3}
