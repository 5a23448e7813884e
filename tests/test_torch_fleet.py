"""The port's serving fleet (``apex_tpu_torch.serving.fleet``: routing,
SLO classes, fencing and live migration, rolling restart, the fleet
faults of ``apex_tpu_torch.resilience.chaos`` and the scale hint), held
against the live JAX fleet on the CPU.

The classes mirror the JAX package's fleet tests.  Each scenario that
JAX is compared on runs once on each package (``torch_fleet_twins``:
the JAX serving toy, fp32, ``SimClock`` time, JAX's weights carried
across), and the port must give, without a tolerance: the same token
streams, the same event stream (every field but the bus's run id, mesh
and wall-clock stamps), the same migration plan and the same scale
hints.  Streams are also held bitwise to an uninterrupted single-engine
control, as JAX's tests hold its fleet.  The JAX references are module
fixtures, shared by the tests that read them.
"""

import json

import pytest

import torch_fleet_twins as tw


@pytest.fixture(scope="module")
def sides():
    return tw.make_sides()


@pytest.fixture(scope="module")
def jside(sides):
    return sides[0]


@pytest.fixture(scope="module")
def side(sides):
    return sides[1]


def _on_both(sides, scenario, *args, **kw):
    return [scenario(s, *args, **kw) for s in sides]


# ---------------------------------------------------------------------------
# The scenarios run on both packages
# ---------------------------------------------------------------------------

KILL_PROMPTS = tw.prompts(6, seed=4)


def _kill(side, prompts=KILL_PROMPTS, *, at_step=3, factory_kw=None,
          max_new=5):
    """r0 killed past every recovery budget: fence, migrate, drain."""
    bus, mem = side.bus("kill")
    fleet, reps = side.colocated(
        2, telemetry=bus, fault_retries=2,
        factory_kw=dict(factory_kw or {}, telemetry=bus))
    fleet.warmup()
    for p in prompts:
        fleet.submit(p, max_new_tokens=max_new)
    with side.chaos.KillReplica("r0", at_step=at_step, telemetry=bus):
        fleet.run()
    hint = fleet.emit_scale_hint()
    return dict(fleet=fleet, reps=reps, mem=mem, hint=hint,
                streams=tw.streams(fleet), events=tw.events(mem))


@pytest.fixture(scope="module")
def kill_runs(sides):
    return _on_both(sides, _kill)


@pytest.fixture(scope="module")
def kill_control(jside):
    return jside.control(KILL_PROMPTS)


def _health(side, fault, prompts, **fault_kw):
    bus, mem = side.bus("health")
    fleet, reps = side.colocated(2, telemetry=bus, health_timeout_s=0.25)
    fleet.warmup()
    for p in prompts:
        fleet.submit(p, max_new_tokens=3)
    with getattr(side.chaos, fault)("r0", telemetry=bus, **fault_kw):
        fleet.run(max_steps=500)
    return dict(reps=reps, mem=mem, streams=tw.streams(fleet),
                events=tw.events(mem))


ROLL_PROMPTS = tw.prompts(6, seed=9)


def _rolling(side):
    bus, mem = side.bus("roll")
    fleet, reps = side.colocated(3, telemetry=bus)
    fleet.warmup()
    for p in ROLL_PROMPTS:
        fleet.submit(p, max_new_tokens=5)
    for _ in range(3):                          # some work in flight
        fleet.step()
    side.fleet.rolling_restart(fleet)
    fleet.run()
    return dict(reps=reps, mem=mem, streams=tw.streams(fleet),
                events=tw.events(mem))


# ---------------------------------------------------------------------------
# Routing and SLO classes
# ---------------------------------------------------------------------------


class TestRouting:
    def test_least_loaded_placement_spreads(self, sides, side):
        placements = []
        for s in sides:
            fleet, reps = s.colocated(3)
            for p in tw.prompts(6):
                fleet.submit(p, max_new_tokens=3)
            placements.append(dict(fleet.placement))
            if s is side:
                assert sorted(r.queue_depth() for r in reps) == [2, 2, 2]
                fleet.warmup()
                fleet.run()
                assert all(len(fleet.handles[r].generated) == 3
                           for r in range(6))
        assert placements[0] == placements[1]

    def test_slo_class_assigns_deadline(self, side):
        fleet, _ = side.colocated(
            slo_classes=[side.fleet.SLOClass("gold", deadline_s=30.0),
                         side.fleet.SLOClass("best_effort")])
        rid_g = fleet.submit([1, 2, 3], max_new_tokens=2, slo="gold")
        rid_b = fleet.submit([1, 2, 3], max_new_tokens=2,
                             slo="best_effort")
        assert fleet.handles[rid_g].deadline_s == 30.0
        assert fleet.handles[rid_b].deadline_s is None

    def test_unknown_slo_class_raises(self, side):
        fleet, _ = side.colocated()
        with pytest.raises(ValueError, match="unknown SLO class"):
            fleet.submit([1], max_new_tokens=1, slo="platinum")

    def test_all_queues_full_rejects_loudly_as_jax(self, sides, side):
        got = []
        for s in sides:
            bus, mem = s.bus("full")
            fleet, _ = s.colocated(2, telemetry=bus,
                                   factory_kw={"max_queue": 1,
                                               "telemetry": bus})
            # no warmup or stepping: fill both bounded queues, overflow
            for p in tw.prompts(3, seed=1):
                fleet.submit(p, max_new_tokens=2)
            got.append(tw.events(mem))
            if s is side:
                rejected = [r for r in fleet.handles.values()
                            if r.finish_reason == "rejected"]
                assert len(rejected) == 1
                evs = tw.of_type(mem, "request_reject")
                assert len(evs) == 1 and evs[0]["reason"] == "queue_full"
        assert got[0] == got[1]

    def test_fenced_replicas_never_take_placement(self, side):
        fleet, reps = side.colocated(2)
        reps[0].fence()
        for p in tw.prompts(4, seed=2):
            fleet.submit(p, max_new_tokens=2)
        assert reps[0].queue_depth() == 0
        assert reps[1].queue_depth() == 4
        reps[1].fence()
        with pytest.raises(RuntimeError, match="no healthy replicas"):
            fleet.submit([1], max_new_tokens=1)


# ---------------------------------------------------------------------------
# request_reject reasons
# ---------------------------------------------------------------------------


class TestRejectReasons:
    def test_unservable_rejects_as_data_when_opted_in(self, side):
        bus, mem = side.bus("unserv")
        eng = side.factory(side.sv.SimClock(), telemetry=bus,
                           reject_unservable=True)()
        req = eng.submit([1] * 10, max_new_tokens=tw.TOY["max_position"])
        assert req.finish_reason == "rejected"
        assert req in eng.rejected
        evs = tw.of_type(mem, "request_reject")
        assert len(evs) == 1 and evs[0]["reason"] == "unservable"

    def test_unservable_still_raises_by_default(self, side):
        eng = side.factory(side.sv.SimClock())()
        with pytest.raises(ValueError, match="exceeds"):
            eng.submit([1] * 10, max_new_tokens=tw.TOY["max_position"])

    def test_reason_enum_is_closed(self, side):
        ev = {"type": "request_reject", "run_id": "r", "step": 0, "t": 0.0,
              "ts": 0.0, "mesh": {}, "rid": 1, "reason": "felt_like_it",
              "queue_depth": 0}
        with pytest.raises(side.tel.SchemaError, match="must be one of"):
            side.tel.validate_event(ev)


# ---------------------------------------------------------------------------
# serving_stall
# ---------------------------------------------------------------------------


class TestServingStall:
    def test_budget_exhaustion_emits_and_raises(self, side):
        bus, mem = side.bus("stall")
        eng = side.factory(side.sv.SimClock(), telemetry=bus)()
        eng.warmup()
        eng.submit([1, 2, 3, 4], max_new_tokens=8)
        with pytest.raises(RuntimeError, match="did not drain"):
            eng.run(max_steps=1)
        evs = tw.of_type(mem, "serving_stall")
        assert len(evs) == 1 and evs[0]["budget"] == 1
        assert evs[0]["waiting"] + evs[0]["running"] >= 1

    def test_raise_on_stall_false_returns_partial(self, side):
        bus, mem = side.bus("stall2")
        eng = side.factory(side.sv.SimClock(), telemetry=bus)()
        eng.warmup()
        eng.submit([1, 2, 3, 4], max_new_tokens=8)
        assert eng.run(max_steps=1, raise_on_stall=False) == []
        assert len(tw.of_type(mem, "serving_stall")) == 1
        assert eng.run() and eng.sched.idle


# ---------------------------------------------------------------------------
# Heterogeneous snapshot/restore and adopt atomicity
# ---------------------------------------------------------------------------


class TestHeterogeneousRestore:
    def _snapshot(self, side, n=5):
        src = side.factory(side.sv.SimClock(), max_queue=None)()
        for p in tw.prompts(n, seed=3):
            src.submit(p, max_new_tokens=4)
        return src.snapshot()

    @pytest.mark.parametrize("kw,match", [
        ({"max_queue": 2}, "max_queue"),
        ({"num_pages": 4}, "pages"),
    ], ids=["smaller_max_queue", "smaller_page_pool"])
    def test_restore_into_a_smaller_engine_refused_atomically(
            self, side, kw, match):
        if "num_pages" in kw:
            src = side.factory(side.sv.SimClock())()
            src.submit([1] * 40, max_new_tokens=20)   # 8 pages worst
            snap = src.snapshot()
        else:
            snap = self._snapshot(side)
        tgt = side.factory(side.sv.SimClock(), **kw)()
        with pytest.raises(ValueError, match=match):
            tgt.restore(snap)
        assert not tgt.sched.waiting and not tgt.sched.running
        assert not tgt.sched.finished and tgt.steps == 0

    def test_adopt_merges_into_busy_engine(self, side):
        snap = self._snapshot(side, n=2)
        tgt = side.factory(side.sv.SimClock())()
        tgt.warmup()
        own = tgt.submit([9] * 6, max_new_tokens=3)
        recs = json.loads(json.dumps(snap["requests"]))
        for i, r in enumerate(recs):
            r["rid"] = 100 + i
        adopted = tgt.adopt(recs)
        tgt.run()
        assert own.finish_reason is not None
        assert all(len(a.generated) == 4 for a in adopted)

    def test_adopt_refuses_rid_collision_atomically(self, side):
        snap = self._snapshot(side, n=2)
        tgt = side.factory(side.sv.SimClock())()
        tgt.submit([9] * 6, max_new_tokens=3)      # takes rid 0
        assert snap["requests"][0]["rid"] == 0
        before = len(tgt.sched.waiting)
        with pytest.raises(ValueError, match="collides"):
            tgt.adopt(snap["requests"])
        assert len(tgt.sched.waiting) == before

    def test_adopt_refuses_past_queue_headroom_atomically(self, side):
        snap = self._snapshot(side, n=5)
        tgt = side.factory(side.sv.SimClock(), max_queue=3)()
        with pytest.raises(ValueError, match="headroom"):
            tgt.adopt(snap["requests"])
        assert not tgt.sched.waiting


# ---------------------------------------------------------------------------
# Fence and migration: the bitwise pin
# ---------------------------------------------------------------------------


class TestFenceAndMigrate:
    def test_killed_replica_fences_and_streams_stay_bitwise(
            self, kill_runs, kill_control):
        j, t = kill_runs
        reps, fleet, mem = t["reps"], t["fleet"], t["mem"]
        assert reps[0].state == tw.tfleet.FENCED
        assert reps[0].engine.recoveries == reps[0].engine.max_recoveries
        assert reps[0].fault_attempts == fleet.fault_retries + 1
        fences = tw.of_type(mem, "replica_fence")
        assert len(fences) == 1 and fences[0]["replica"] == "r0"
        assert fences[0]["cause"] == "DeviceLossError"
        moves = tw.of_type(mem, "request_migrate")
        assert moves and all(m["from_replica"] == "r0"
                             and m["to_replica"] == "r1" for m in moves)
        assert len(fleet.handles) == len(KILL_PROMPTS)
        assert t["streams"] == j["streams"] == kill_control

    def test_event_stream_equals_jax(self, kill_runs):
        j, t = kill_runs
        assert t["events"] == j["events"]
        types = {e["type"] for e in t["events"]}
        assert {"replica_fence", "request_migrate", "fault_injected",
                "device_loss", "serving_recovery", "span"} <= types

    def test_last_replica_fence_refuses_loudly(self, sides):
        errs = []
        for s in sides:
            fleet, _ = s.colocated(1, fault_retries=0)
            fleet.submit([1, 2, 3, 4], max_new_tokens=4)
            with s.chaos.KillReplica("r0"):
                with pytest.raises(s.fleet.FleetCapacityError,
                                   match="no healthy") as ei:
                    fleet.run()
            errs.append((str(ei.value), ei.value.unplaceable))
        assert errs[0] == errs[1]

    def test_kill_at_every_boundary_sweep(self, side, kill_control):
        """Kill r0 at every step index the healthy run reaches: every
        kill point migrates to the control's streams with zero drops."""
        probe, _ = side.colocated(2)
        probe.warmup()
        for p in KILL_PROMPTS:
            probe.submit(p, max_new_tokens=5)
        probe.run()
        total = max(r.engine.steps for r in probe.replicas)
        assert total >= 5
        for at in range(1, total + 1):
            fleet, _ = side.colocated(2)
            fleet.warmup()
            for p in KILL_PROMPTS:
                fleet.submit(p, max_new_tokens=5)
            with side.chaos.KillReplica("r0", at_step=at):
                fleet.run()
            assert tw.streams(fleet) == kill_control, f"kill at {at}"

    def test_plan_migration_equals_jax(self, sides):
        """The same snapshot records over the same targets (unequal load,
        one with a bounded queue) give the same plan; a refused plan
        reports the same shortfall."""
        plans, refusals = [], []
        for s in sides:
            clock = s.sv.SimClock()
            src = s.fleet.ReplicaProxy("src", s.factory(clock))
            targets = [s.fleet.ReplicaProxy(n, s.factory(clock, **kw))
                       for n, kw in (("a", {}), ("b", {"max_queue": 3}),
                                     ("c", {}))]
            for i, p in enumerate(tw.prompts(9, seed=6)):
                src.engine.submit(p, max_new_tokens=4)
                if i < 2:
                    targets[2].engine.submit(p, max_new_tokens=4)
            records = json.loads(json.dumps(src.snapshot()))["requests"]
            records[-1] = dict(records[-1], generated=[5, 6, 7, 8])
            plan = s.fleet.plan_migration(records, targets)
            plans.append({n: [r["rid"] for r in recs]
                          for n, recs in plan.items()})
            with pytest.raises(s.fleet.FleetCapacityError) as ei:
                s.fleet.plan_migration(records, targets[1:2])
            e = ei.value
            refusals.append((str(e), e.unplaceable, e.pages_required,
                             e.pages_available))
        assert plans[0] == plans[1]
        assert sorted(r for v in plans[1].values() for r in v) == \
            list(range(9))
        # rid 8 was done at capture: it takes no queue headroom
        assert len([r for r in plans[1]["b"] if r != 8]) <= 3
        assert refusals[0] == refusals[1]
        assert len(refusals[1][1]) == 5


# ---------------------------------------------------------------------------
# Health-check chaos: slow and blackholed replicas
# ---------------------------------------------------------------------------


class TestHealthChaos:
    def test_slow_replica_below_budget_is_tolerated(self, side):
        fleet, reps = side.colocated(2, health_timeout_s=0.25)
        fleet.warmup()
        for p in tw.prompts(4, seed=6):
            fleet.submit(p, max_new_tokens=3)
        with side.chaos.SlowReplica("r0", latency_s=0.1) as slow:
            fleet.run()
        assert slow.fired and reps[0].state != tw.tfleet.FENCED
        assert all(len(h.generated) == 3 for h in fleet.handles.values())

    def test_slow_replica_past_budget_is_fenced_as_jax(self, sides, jside):
        prompts = tw.prompts(4, seed=7)
        control = jside.control(prompts, max_new=3)
        j, t = _on_both(sides, _health, "SlowReplica", prompts,
                        latency_s=1.0)
        assert t["reps"][0].state == tw.tfleet.FENCED
        fences = tw.of_type(t["mem"], "replica_fence")
        assert fences[0]["cause"] == "health_check_timeout"
        assert t["streams"] == j["streams"] == control
        assert t["events"] == j["events"]

    def test_blackholed_replica_is_detected_as_jax(self, sides):
        j, t = _on_both(sides, _health, "BlackholeReplica",
                        tw.prompts(4, seed=8))
        assert t["reps"][0].state == tw.tfleet.FENCED
        assert all(len(v) == 3 for v in t["streams"].values())
        assert t["streams"] == j["streams"]
        assert t["events"] == j["events"]
        assert [e["kind"] for e in tw.of_type(t["mem"], "fault_injected")
                ] == ["blackhole_replica"]

    def test_ping_is_deterministic_and_sleepless(self, side):
        rep = side.fleet.ReplicaProxy(
            "solo", side.factory(side.sv.SimClock()))
        assert rep.ping(0.25) == 0.0
        with side.chaos.BlackholeReplica("solo"):
            with pytest.raises(side.fleet.HealthCheckTimeout, match="inf"):
                rep.ping(0.25)
        with side.chaos.SlowReplica("solo", latency_s=0.5, at_ping=2):
            assert rep.ping(0.25) == 0.0
            with pytest.raises(side.fleet.HealthCheckTimeout):
                rep.ping(0.25)

    def test_fault_hooks_chain_and_restore(self, side):
        rep = side.fleet.ReplicaProxy(
            "solo", side.factory(side.sv.SimClock()))
        with side.chaos.SlowReplica("solo", latency_s=0.1) as a:
            with side.chaos.SlowReplica("solo", latency_s=0.2) as b:
                assert rep.ping(1.0) == pytest.approx(0.3)
            assert rep.ping(1.0) == pytest.approx(0.1)
        assert rep.ping(1.0) == 0.0
        assert (a.events, b.events) == (2, 1)
        assert side.fleet.set_fleet_fault_hook(None) is None


# ---------------------------------------------------------------------------
# Rolling restart
# ---------------------------------------------------------------------------


class TestRollingRestart:
    def test_rolling_restart_mid_serve_is_bitwise_as_jax(self, sides,
                                                         jside):
        control = jside.control(ROLL_PROMPTS)
        j, t = _on_both(sides, _rolling)
        fences = tw.of_type(t["mem"], "replica_fence")
        assert [f["cause"] for f in fences] == ["rolling_restart"] * 3
        assert all(r.restarts == 1 and r.healthy for r in t["reps"])
        assert t["streams"] == j["streams"] == control
        assert t["events"] == j["events"]

    def test_fleet_of_one_readmits_its_own_snapshot(self, side):
        prompts = tw.prompts(4, seed=10)
        control = side.control(prompts)
        fleet, reps = side.colocated(1)
        fleet.warmup()
        for p in prompts:
            fleet.submit(p, max_new_tokens=5)
        for _ in range(2):
            fleet.step()
        side.fleet.rolling_restart(fleet)
        fleet.run()
        assert reps[0].restarts == 1
        assert tw.streams(fleet) == control

    def test_restart_repairs_a_fenced_replica(self, side):
        fleet, reps = side.colocated(2)
        fleet.warmup()
        for p in tw.prompts(4, seed=11):
            fleet.submit(p, max_new_tokens=3)
        with side.chaos.KillReplica("r0"):
            fleet.run()
        assert reps[0].state == tw.tfleet.FENCED
        side.fleet.rolling_restart(fleet)
        assert all(r.healthy for r in reps)
        fleet.submit([1, 2, 3], max_new_tokens=2)
        assert reps[0].queue_depth() + reps[0].running() == 1
        fleet.run()


# ---------------------------------------------------------------------------
# Speculative and chunked replicas through the same machinery
# ---------------------------------------------------------------------------


class TestSpecChunkedFleet:
    def test_migration_bitwise_with_spec_and_chunked(self, jside, side):
        """Spec + chunked replicas, one killed mid-decode; the control is
        JAX's PLAIN engine (draft-verify and chunked prefill are
        output-invariant)."""
        prompts = tw.prompts(4, seed=12, lo=12, hi=24)
        control = jside.control(prompts, max_new=6)
        run = _kill(side, prompts, at_step=2, max_new=6, factory_kw={
            "spec": side.sv.SpecConfig(k=2, chunk_size=8)})
        assert run["reps"][0].state == tw.tfleet.FENCED
        assert run["streams"] == control
        assert run["reps"][1].engine.verify_steps > 0


# ---------------------------------------------------------------------------
# Autoscaling signal
# ---------------------------------------------------------------------------


class TestScaleHint:
    def test_pure_thresholds_as_jax(self, sides, side):
        hint = side.fleet.scale_hint
        assert hint(shed_rate=0.2, occupancy=0.1) == "scale_up"
        assert hint(shed_rate=0.0, occupancy=0.9) == "scale_up"
        assert hint(shed_rate=0.0, occupancy=0.5,
                    deadline_hit_rate=0.5) == "scale_up"
        assert hint(shed_rate=0.0, occupancy=0.1) == "scale_down"
        assert hint(shed_rate=0.01, occupancy=0.5) == "hold"
        assert hint(shed_rate=0.0, occupancy=0.5,
                    deadline_hit_rate=0.95) == "hold"
        grid = [(s, o, d) for s in (0.0, 0.01, 0.05, 0.0501, 0.3)
                for o in (0.0, 0.2499, 0.25, 0.85, 0.8501)
                for d in (None, 0.5, 0.8999, 0.9, 0.989, 0.99, 1.0)]
        assert [side.fleet.scale_hint(shed_rate=s, occupancy=o,
                                      deadline_hit_rate=d)
                for s, o, d in grid] == [
            sides[0].fleet.scale_hint(shed_rate=s, occupancy=o,
                                      deadline_hit_rate=d)
            for s, o, d in grid]

    def test_from_recorded_trace_as_jax(self, kill_runs, sides):
        """The policy replays from a recorded stream alone: each
        package's function reads the other's stream the same way."""
        j, t = kill_runs
        jf, tf = (s.fleet.scale_hint_from_events for s in sides)
        jev, tev = j["mem"].events, t["mem"].events
        assert tf(tev) == tf(jev) == jf(tev) == jf(jev)
        synth = [{"type": "request_reject"}] * 5 + \
                [{"type": "request_retire"}] * 5
        assert tf(synth) == jf(synth) == "scale_up"
        assert tf([]) == jf([])

    def test_router_emits_schema_valid_hint(self, kill_runs, side):
        j, t = kill_runs
        evs = tw.of_type(t["mem"], "fleet_scale_hint")
        assert evs and evs[-1]["hint"] == t["hint"] == j["hint"]
        for e in evs:
            side.tel.validate_event(e)


# ---------------------------------------------------------------------------
# Event schema pins
# ---------------------------------------------------------------------------


class TestFleetEventSchema:
    def _stamp(self, type_, **payload):
        ev = {"type": type_, "run_id": "r", "step": 0, "t": 0.0,
              "ts": 0.0, "mesh": {}}
        ev.update(payload)
        return ev

    def test_new_events_validate(self, side):
        side.tel.validate_event(self._stamp(
            "serving_stall", waiting=2, running=1, budget=100))
        side.tel.validate_event(self._stamp(
            "replica_fence", replica="r0", cause="DeviceLossError",
            live_requests=3, recoveries=3, fault_retries=2))
        side.tel.validate_event(self._stamp(
            "request_migrate", rid=7, from_replica="r0", to_replica="r1",
            tokens_done=4, was_running=True))
        side.tel.validate_event(self._stamp(
            "fleet_scale_hint", hint="hold", shed_rate=0.0, occupancy=0.4,
            replicas=3, healthy=3))

    def test_hint_enum_is_closed(self, side):
        with pytest.raises(side.tel.SchemaError, match="must be one of"):
            side.tel.validate_event(self._stamp(
                "fleet_scale_hint", hint="buy_more_tpus", shed_rate=0.0,
                occupancy=0.4, replicas=3, healthy=3))

    def test_was_running_must_be_a_real_bool(self, side):
        with pytest.raises(side.tel.SchemaError, match="bool"):
            side.tel.validate_event(self._stamp(
                "request_migrate", rid=7, from_replica="r0",
                to_replica="r1", tokens_done=4, was_running=1))
