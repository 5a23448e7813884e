"""The port's transport seam and disaggregated prefill/decode
(``apex_tpu_torch.serving.fleet``: ``LocalTransport``,
``ChaosTransport``, ``PageImporter``, ``DisaggRouter``), held against the
live JAX fleet on the CPU.

The classes mirror the JAX package's disaggregation tests, plus the
fleet storm of its tracing tests.  Scenarios JAX is compared on run once
on each package (``torch_fleet_twins``: the JAX serving toy, fp32,
``SimClock`` time, JAX's weights carried across); the port must give,
without a tolerance, the same token streams, the same event stream
(every field but the bus's run id, mesh and wall-clock stamps), the same
chaos decisions for the same seed and the same span trees.  Wire
messages (``migrate``, ``kv_page``, ``kv_commit``) serialized by one
package are delivered to the other's handlers, both ways.  Streams are
also held bitwise to an uninterrupted colocated control.
"""

import dataclasses
import json

import pytest

import torch_fleet_twins as tw

FAULTS = tw.tfleet.transport.FAULTS


@pytest.fixture(scope="module")
def sides():
    return tw.make_sides()


@pytest.fixture(scope="module")
def jside(sides):
    return sides[0]


@pytest.fixture(scope="module")
def side(sides):
    return sides[1]


@pytest.fixture(scope="module")
def control(side):
    """The port's colocated control, by prompt set (memoized)."""
    memo = {}

    def get(prompts, max_new=5, **kw):
        key = (json.dumps(prompts), max_new, json.dumps(kw, sort_keys=True))
        if key not in memo:
            memo[key] = side.control(prompts, max_new=max_new, **kw)
        return memo[key]

    return get


def _shipment(side, clock, prompt, max_new=5, **kw):
    """One prompt through a prefill-only engine, exported:
    ``(record, pages_payload, kv_len)``."""
    eng = side.factory(clock, prefill_only=True, **kw)()
    eng.warmup()
    req = eng.submit(list(prompt), max_new_tokens=max_new)
    eng.step()
    assert req.prefill_pos is None and req.generated
    return eng.export_request(req.rid)


def _serve(side, prompts, *, max_new=5, n_prefill=1, n_decode=1,
           transport=None, engine_bus=True, chaos_bus=False, **kw):
    """A disaggregated fleet serving ``prompts`` to the end."""
    bus, mem = side.bus("disagg")
    if chaos_bus:
        transport.telemetry = bus
    fkw = dict(kw.pop("factory_kw", {}))
    if engine_bus:
        fkw["telemetry"] = bus
    fleet, reps = side.disagg(n_prefill=n_prefill, n_decode=n_decode,
                              telemetry=bus, transport=transport,
                              factory_kw=fkw, **kw)
    fleet.warmup()
    rids = [fleet.submit(p, max_new_tokens=max_new) for p in prompts]
    intake = {r: fleet.placement[r] for r in rids}
    fleet.run()
    return dict(fleet=fleet, reps=reps, mem=mem, intake=intake,
                streams=tw.streams(fleet), events=tw.events(mem))


def _chaos(side, **kw):
    return side.fleet.ChaosTransport(side.fleet.LocalTransport(), **kw)


# ---------------------------------------------------------------------------
# The transport seam, and the wire across the packages
# ---------------------------------------------------------------------------


class TestTransportSeam:
    def test_pipeline_roundtrip_mints_fresh_msg_ids(self, side):
        t = side.fleet.LocalTransport()
        seen = []
        t.register("d", "echo",
                   lambda p: (seen.append(p["x"]) or {"x": p["x"]}))
        assert t.call("d", "echo", {"x": 1}) == {"x": 1}
        assert t.call("d", "echo", {"x": 2}) == {"x": 2}
        assert seen == [1, 2]
        w1 = json.loads(t.serialize("d", "echo", {}))
        w2 = json.loads(t.serialize("d", "echo", {}))
        assert w1["msg_id"] != w2["msg_id"]

    def test_duplicate_wire_message_processes_once(self, side):
        t = side.fleet.LocalTransport()
        hits = []
        t.register("d", "bump",
                   lambda p: (hits.append(1) or {"hits": len(hits)}))
        wire = t.serialize("d", "bump", {})
        assert t.deliver(wire) == t.deliver(wire) and len(hits) == 1

    def test_envelope_crc_catches_in_flight_tamper(self, side):
        t = side.fleet.LocalTransport()
        t.register("d", "echo", lambda p: {"ok": True})
        env = json.loads(t.serialize("d", "echo", {"x": 1}))
        env["payload"]["x"] = 2        # mutate without re-stamping
        reply = t.deliver(json.dumps(env))
        with pytest.raises(side.fleet.TransportCorruption, match="CRC"):
            t.deserialize_reply(reply)

    def test_registered_errors_cross_typed(self, side):
        class ProbeFailed(RuntimeError):
            pass

        side.fleet.register_error(ProbeFailed)
        t = side.fleet.LocalTransport()

        def boom(p):
            raise ProbeFailed("pop")

        t.register("d", "boom", boom)
        with pytest.raises(ProbeFailed, match="pop"):
            t.call("d", "boom", {})

    def test_unregistered_handler_error_propagates_raw(self, side):
        t = side.fleet.LocalTransport()

        def bug(p):
            raise ValueError("handler bug")

        t.register("d", "bug", bug)
        with pytest.raises(ValueError, match="handler bug"):
            t.call("d", "bug", {})

    def test_missing_handler_is_loud(self, side):
        with pytest.raises(KeyError, match="no handler"):
            side.fleet.LocalTransport().call("d", "nope", {})

    def test_reorder_never_fires_on_control_classes(self, side):
        chaos = _chaos(side, schedule={("ping", "reorder"): {1, 2},
                                       ("migrate", "reorder"): {1}})
        chaos.register("d", "ping", lambda p: {"pong": True})
        chaos.register("d", "migrate", lambda p: {"ok": True})
        for _ in range(2):
            assert chaos.call("d", "ping", {})["pong"]
        assert chaos.call("d", "migrate", {})["ok"]
        assert chaos.injected == {}

    def test_envelopes_are_jax_text(self, sides):
        """The same payload and trace context serialize to the same wire
        text, CRC included; a reply crosses the same way."""
        payload = {"transfer_id": "t3", "page_index": 1, "n_pages": 2,
                   "data": {"k": "QUJD", "v": "REVG", "crc_k": 7,
                            "crc_v": 9}, "x": [1.5, None, True]}
        ctx = {"rid": 3, "span_id": "3:kv_ship:d0:1", "attempt": 1}
        wires = [s.fleet.LocalTransport().serialize("d0", "kv_page",
                                                    payload, ctx)
                 for s in sides]
        assert wires[0] == wires[1]
        assert tw.tfleet.transport._body_crc(payload) == \
            tw.jfleet.transport._body_crc(payload)
        j, t = (s.fleet.LocalTransport() for s in sides)
        for src, dst in ((j, t), (t, j)):
            dst.register("d0", "kv_page", lambda p: {"ok": p["x"][2]})
            assert src.deserialize_reply(dst.deliver(
                src.serialize("d0", "kv_page", payload))) == {"ok": True}

    def test_chaos_decisions_equal_jax_for_a_seed(self, sides):
        """The same seed and rates make the same fault decisions, message
        by message, with the same outcome at the sender."""
        rates = {(c, f): 0.2 for c in ("ping", "migrate", "kv_page",
                                       "kv_commit") for f in FAULTS}
        runs = []
        for s in sides:
            chaos = _chaos(s, seed=11, rates=rates,
                           schedule={("kv_commit", "drop"): {2}})
            got = []
            for cls in ("ping", "migrate", "kv_page", "kv_commit"):
                chaos.register("d", cls,
                               lambda p, cls=cls: got.append((cls, p))
                               or {"ok": True})
            outcomes = []
            for i in range(120):
                cls = ("ping", "kv_page", "kv_page", "migrate",
                       "kv_commit")[i % 5]
                try:
                    outcomes.append(chaos.call(
                        "d", cls, {"i": i, "data": {"k": "QUJDREVG"}}))
                except (s.fleet.TransportTimeout,
                        s.fleet.TransportCorruption) as e:
                    outcomes.append(type(e).__name__)
            runs.append((chaos.injected, outcomes, got))
        assert runs[0] == runs[1]
        assert set(runs[1][0]) >= {"kv_page:reorder", "kv_page:corrupt",
                                   "kv_commit:drop", "ping:duplicate"}

    def test_migrate_wire_crosses_both_ways(self, sides, control):
        """A ``migrate`` message serialized by one package is adopted by
        the other's router handler (rid-deduped: a second delivery adopts
        nothing), and the adopting replica finishes each request as the
        uninterrupted run does."""
        prompts = tw.prompts(4, seed=60)
        want = control(prompts)
        for src, dst in (sides, sides[::-1]):
            eng = src.factory(src.sv.SimClock())()
            for p in prompts:
                eng.submit(p, max_new_tokens=5)
            for _ in range(2):
                eng.step()
            records = eng.snapshot()["requests"]
            assert any(r["generated"] for r in records)
            fleet, reps = dst.colocated(2)
            wire = src.fleet.LocalTransport().serialize(
                "r1", "migrate", {"records": records})
            for _ in range(2):
                reply = src.fleet.LocalTransport().deserialize_reply(
                    fleet.transport.deliver(wire.replace(
                        '"msg_id": 0', f'"msg_id": {_}')))
                assert reply == {"ok": True,
                                 "adopted": list(range(len(prompts)))}
            assert reps[1].queue_depth() == len(prompts)
            reps[1].engine.run()
            assert {r.rid: list(r.generated)
                    for r in reps[1].engine.sched.finished} == want

    def test_page_wires_cross_both_ways(self, sides, control):
        """``kv_page`` and ``kv_commit`` messages serialized by one
        package land through the other's ``PageImporter`` (pages
        CRC-checked, the commit admitted once) and the decode engine
        continues the control's stream."""
        prompt = tw.prompts(1, seed=61, lo=12, hi=13)[0]
        want = control([prompt], max_new=6)
        for src, dst in (sides, sides[::-1]):
            record, pages, kv_len = _shipment(src, src.sv.SimClock(),
                                              prompt, max_new=6)
            assert len(pages) >= 2
            rep = dst.fleet.ReplicaProxy(
                "d0", dst.factory(dst.sv.SimClock(), kv_import=True),
                role="decode")
            rep.warmup()
            wire_t = dst.fleet.LocalTransport()
            imp = dst.fleet.PageImporter(rep, transport=wire_t)
            wire_t.register("d0", "kv_page", imp.on_page)
            wire_t.register("d0", "kv_commit", imp.on_commit)
            out = src.fleet.LocalTransport()
            tid = f"t{record['rid']}"
            commit = out.serialize("d0", "kv_commit", {
                "transfer_id": tid, "record": record, "kv_len": kv_len,
                "n_pages": len(pages)})
            replies = [out.deserialize_reply(wire_t.deliver(out.serialize(
                "d0", "kv_page", {"transfer_id": tid, "page_index": i,
                                  "n_pages": len(pages), "data": page})))
                for i, page in enumerate(pages)]
            assert replies == [{"ok": True}] * len(pages)
            assert out.deserialize_reply(wire_t.deliver(commit)) == {
                "ok": True, "rid": record["rid"]}
            assert out.deserialize_reply(wire_t.deliver(
                commit.replace('"msg_id": ', '"msg_id": 1'))) == {
                "ok": True, "rid": record["rid"]}
            assert len(rep.engine.sched.running) == 1
            rep.engine.run()
            assert [list(r.generated)
                    for r in rep.engine.sched.finished] == [want[0]]


# ---------------------------------------------------------------------------
# Chaos matrix: control plane (ping / migrate)
# ---------------------------------------------------------------------------


class TestControlPlaneChaosMatrix:
    @pytest.mark.parametrize("fault,cause", [
        ("drop", "transport_timeout"),
        ("delay", "transport_timeout"),
        ("corrupt", "transport_corruption"),
    ])
    def test_ping_fault_fences_and_work_reroutes(self, side, control,
                                                 fault, cause):
        prompts = tw.prompts(4, seed=1)
        chaos = _chaos(side, schedule={("ping", fault): {1}})
        bus, mem = side.bus(f"ping-{fault}")
        fleet, reps = side.colocated(2, telemetry=bus, transport=chaos)
        fleet.warmup()
        for p in prompts:
            fleet.submit(p, max_new_tokens=5)
        fleet.run()
        assert reps[0].state == tw.tfleet.FENCED
        assert [f["cause"] for f in tw.of_type(mem, "replica_fence")] == \
            [cause]
        assert chaos.injected == {f"ping:{fault}": 1}
        assert tw.streams(fleet) == control(prompts)

    def test_ping_duplicate_is_harmless(self, side, control):
        prompts = tw.prompts(3, seed=2)
        chaos = _chaos(side, schedule={("ping", "duplicate"): {1}})
        fleet, reps = side.colocated(2, transport=chaos)
        fleet.warmup()
        for p in prompts:
            fleet.submit(p, max_new_tokens=3)
        fleet.run()
        assert all(r.healthy for r in reps)
        assert chaos.injected == {"ping:duplicate": 1}
        assert tw.streams(fleet) == control(prompts, max_new=3)

    @pytest.mark.parametrize("fault", ["drop", "delay", "corrupt",
                                       "duplicate"])
    def test_migrate_fault_retries_dedupe_and_stay_bitwise(
            self, side, control, fault):
        prompts = tw.prompts(4, seed=3)
        chaos = _chaos(side, schedule={("migrate", fault): {1}})
        bus, mem = side.bus(f"mig-{fault}")
        fleet, reps = side.colocated(2, telemetry=bus, transport=chaos,
                                     fault_retries=1)
        fleet.warmup()
        for p in prompts:
            fleet.submit(p, max_new_tokens=5)
        with side.chaos.KillReplica("r0", at_step=2):
            fleet.run()
        assert reps[0].state == tw.tfleet.FENCED
        assert chaos.injected == {f"migrate:{fault}": 1}
        rids = [e["rid"] for e in tw.of_type(mem, "request_migrate")]
        assert rids and len(rids) == len(set(rids))
        assert tw.streams(fleet) == control(prompts)

    def test_migrate_budget_exhaustion_is_loud(self, side):
        chaos = _chaos(side, rates={("migrate", "drop"): 1.0})
        fleet, _ = side.colocated(2, transport=chaos, fault_retries=1)
        fleet.warmup()
        for p in tw.prompts(4, seed=4):
            fleet.submit(p, max_new_tokens=5)
        with side.chaos.KillReplica("r0", at_step=2):
            with pytest.raises(RuntimeError, match="failed after"):
                fleet.run()


# ---------------------------------------------------------------------------
# Disaggregated serving: the happy path
# ---------------------------------------------------------------------------

HAPPY_PROMPTS = tw.prompts(6, seed=20)


@pytest.fixture(scope="module")
def happy_runs(sides):
    return [_serve(s, HAPPY_PROMPTS, n_prefill=2, n_decode=2)
            for s in sides]


class TestDisaggServing:
    def test_streams_bitwise_and_events_as_jax(self, happy_runs, jside):
        j, t = happy_runs
        mem = t["mem"]
        assert all(v.startswith("p") for v in t["intake"].values())
        ships = tw.of_type(mem, "kv_ship")
        assert len(ships) == len(HAPPY_PROMPTS)
        assert all(e["attempts"] == 0 and e["payload_bytes"] > 0
                   and e["pages"] >= 1 for e in ships)
        assert {e["from_replica"] for e in ships} <= {"p0", "p1"}
        assert {e["to_replica"] for e in ships} == {"d0", "d1"}
        assert not tw.of_type(mem, "kv_ship_fallback")
        assert all(v.startswith("d") for v in t["fleet"].placement.values())
        assert all(r.queue_depth() + r.running() == 0
                   for r in t["reps"][:2])
        assert t["reps"][2].engine.prefills + \
            t["reps"][3].engine.prefills == 0
        assert t["streams"] == j["streams"] == \
            jside.control(HAPPY_PROMPTS)
        assert t["events"] == j["events"]

    def test_quantized_pool_ships_scale_planes(self, sides, jside):
        prompts = tw.prompts(4, seed=21)
        j, t = (_serve(s, prompts, factory_kw={"kv_quant": "int8"})
                for s in sides)
        assert t["streams"] == j["streams"] == \
            jside.control(prompts, kv_quant="int8")
        assert len(tw.of_type(t["mem"], "kv_ship")) == len(prompts)
        assert t["events"] == j["events"]

    def test_mixed_only_fleet_matches_base_router(self, side, control):
        prompts = tw.prompts(4, seed=22)
        bus, mem = side.bus("mixed")
        clock = side.sv.SimClock()
        reps = [side.fleet.ReplicaProxy(f"r{i}", side.factory(clock))
                for i in range(2)]
        fleet = side.fleet.DisaggRouter(reps, telemetry=bus)
        fleet.warmup()
        for p in prompts:
            fleet.submit(p, max_new_tokens=5)
        fleet.run()
        assert not tw.of_type(mem, "kv_ship")
        assert tw.streams(fleet) == control(prompts)

    def test_role_validation_is_loud(self, side):
        clock = side.sv.SimClock()
        with pytest.raises(ValueError, match="unknown replica role"):
            side.fleet.ReplicaProxy("x", side.factory(clock), role="oracle")
        pre = [side.fleet.ReplicaProxy(
            "p0", side.factory(clock, prefill_only=True), role="prefill")]
        with pytest.raises(ValueError, match="decode-capable"):
            side.fleet.DisaggRouter(pre)
        dec = [side.fleet.ReplicaProxy(
            "d0", side.factory(clock, kv_import=True), role="decode")]
        with pytest.raises(ValueError, match="prefill-capable"):
            side.fleet.DisaggRouter(dec)

    def test_decode_tier_loss_is_loud(self, side):
        fleet, reps = side.disagg()
        fleet.warmup()
        fleet.submit(tw.prompts(1, seed=23)[0], max_new_tokens=3)
        reps[1].fence()
        with pytest.raises(RuntimeError, match="decode tier"):
            fleet.run()

    def test_migration_never_targets_prefill_replicas(self, side, control):
        prompts = tw.prompts(4, seed=24, lo=8, hi=12)
        fleet, reps = side.disagg(n_decode=2, fault_retries=0)
        fleet.warmup()
        for p in prompts:
            fleet.submit(p, max_new_tokens=6)
        with side.chaos.KillReplica("d0", at_step=4):
            fleet.run()
        assert reps[1].state == tw.tfleet.FENCED
        assert all(not v.startswith("p") for v in fleet.placement.values())
        assert tw.streams(fleet) == control(prompts, max_new=6)


# ---------------------------------------------------------------------------
# The export / adopt seam on the engines
# ---------------------------------------------------------------------------


class TestExportAdoptSeam:
    def test_export_releases_the_prefill_footprint(self, side):
        eng = side.factory(side.sv.SimClock(), prefill_only=True)()
        eng.warmup()
        free0 = eng.cache.pages_free
        req = eng.submit(tw.prompts(1, seed=31)[0], max_new_tokens=4)
        eng.step()
        assert eng.cache.pages_free < free0
        eng.export_request(req.rid)
        assert req.finish_reason == "shipped"
        assert req not in eng.sched.finished
        assert eng.cache.pages_free == free0

    def test_adopt_validation_is_loud(self, side):
        clock = side.sv.SimClock()
        record, pages, kv_len = _shipment(
            side, clock, tw.prompts(1, seed=33, lo=12, hi=13)[0])
        assert len(pages) >= 2
        dec = side.factory(clock, kv_import=True)()
        dec.warmup()
        with pytest.raises(ValueError, match="page"):
            dec.adopt_prefilled(record, pages[:1], kv_len)
        dec.adopt_prefilled(record, pages, kv_len)
        with pytest.raises(ValueError, match="rid"):
            dec.adopt_prefilled(record, pages, kv_len)

    def test_quantized_export_carries_scale_planes(self, side):
        _, pages, _ = _shipment(side, side.sv.SimClock(),
                                tw.prompts(1, seed=36, lo=10, hi=11)[0],
                                kv_quant="int8")
        for p in pages:
            assert {"k", "v", "crc_k", "crc_v",
                    "k_scale", "v_scale"} <= set(p)
            assert side.sv.verify_page_payload(p)
            assert not side.sv.verify_page_payload(
                dict(p, k_scale="BBBB" + p["k_scale"][4:]))


# ---------------------------------------------------------------------------
# The receiver: idempotency and resume
# ---------------------------------------------------------------------------


class TestPageImporter:
    def _rig(self, side, seed):
        clock = side.sv.SimClock()
        record, pages, kv_len = _shipment(
            side, clock, tw.prompts(1, seed=seed, lo=12, hi=13)[0])
        assert len(pages) >= 2
        rep = side.fleet.ReplicaProxy(
            "d0", side.factory(clock, kv_import=True), role="decode")
        rep.warmup()
        imp = side.fleet.PageImporter(rep)
        tid = f"t{record['rid']}"

        def page(i, data=None):
            return imp.on_page({"transfer_id": tid, "page_index": i,
                                "n_pages": len(pages),
                                "data": data or pages[i]})

        def commit():
            return imp.on_commit({"transfer_id": tid, "record": record,
                                  "kv_len": kv_len, "n_pages": len(pages)})

        return rep, pages, page, commit

    def test_missing_pages_resume_not_restart(self, side):
        rep, pages, page, commit = self._rig(side, 40)
        assert page(0) == {"ok": True}
        r = commit()
        assert r["ok"] is False and r["reason"] == "missing_pages"
        assert r["missing"] == list(range(1, len(pages)))
        for i in r["missing"]:
            assert page(i) == {"ok": True}
        assert commit()["ok"] is True
        assert rep.find_request(0) is not None

    def test_commit_reply_is_memoized(self, side):
        rep, pages, page, commit = self._rig(side, 41)
        for i in range(len(pages)):
            page(i)
        r1 = commit()
        assert r1["ok"] is True and commit() == r1
        assert len(rep.engine.sched.running) == 1
        assert page(0) == {"ok": True}

    def test_duplicate_page_is_a_noop(self, side):
        rep, pages, page, commit = self._rig(side, 42)
        assert page(0) == page(0) == {"ok": True}
        for i in range(1, len(pages)):
            page(i)
        assert commit()["ok"] is True

    def test_corrupt_page_refused_and_not_buffered(self, side):
        rep, pages, page, commit = self._rig(side, 43)
        bad = dict(pages[0], k="BBBB" + pages[0]["k"][4:])
        assert page(0, data=bad) == {"ok": False, "reason": "crc_mismatch",
                                     "page_index": 0}
        for i in range(1, len(pages)):
            page(i)
        assert commit()["missing"] == [0]
        assert page(0) == {"ok": True}
        assert commit()["ok"] is True


# ---------------------------------------------------------------------------
# Chaos matrix: data plane (kv_page / kv_commit)
# ---------------------------------------------------------------------------

#: (message class, fault) -> the retry reasons the shipment layer may
#: book for it (empty = absorbed with no transfer retry)
DATA_PLANE_CELLS = [
    ("kv_page", "drop", {"timeout"}),
    ("kv_page", "delay", {"timeout"}),
    ("kv_page", "duplicate", set()),
    ("kv_page", "reorder", set()),
    ("kv_page", "corrupt", {"crc_mismatch"}),
    ("kv_commit", "drop", {"timeout"}),
    ("kv_commit", "delay", {"timeout"}),
    ("kv_commit", "duplicate", set()),
    ("kv_commit", "corrupt", {"corrupt"}),
]


class TestDataPlaneChaosMatrix:
    @pytest.mark.parametrize("cls,fault,reasons", DATA_PLANE_CELLS,
                             ids=[f"{c}-{f}" for c, f, _ in DATA_PLANE_CELLS])
    def test_shipment_survives(self, side, control, cls, fault, reasons):
        prompts = tw.prompts(3, seed=25)
        chaos = _chaos(side, schedule={(cls, fault): {1}})
        run = _serve(side, prompts, transport=chaos, engine_bus=False)
        mem = run["mem"]
        assert chaos.injected == {f"{cls}:{fault}": 1}
        assert {e["reason"] for e in tw.of_type(mem, "kv_ship_retry")} == \
            reasons
        assert not tw.of_type(mem, "kv_ship_fallback")
        assert len(tw.of_type(mem, "kv_ship")) == len(prompts)
        assert len(run["reps"][1].engine.sched.finished) == len(prompts)
        assert run["streams"] == control(prompts)


# ---------------------------------------------------------------------------
# Degradation: retry budget, capacity, destination loss
# ---------------------------------------------------------------------------


class TestShipmentDegradation:
    def test_budget_exhaustion_falls_back_as_jax(self, sides, control):
        """Every kv_page lost: past the budget each request migrates to
        the decode replica and re-prefills there — bitwise, zero drops,
        with JAX's events."""
        prompts = tw.prompts(3, seed=26)
        j, t = (_serve(s, prompts, fault_retries=1,
                       transport=_chaos(s, rates={("kv_page", "drop"): 1.0}),
                       chaos_bus=True) for s in sides)
        falls = tw.of_type(t["mem"], "kv_ship_fallback")
        assert len(falls) == len(prompts)
        assert all(e["reason"] == "timeout" for e in falls)
        assert not tw.of_type(t["mem"], "kv_ship")
        assert t["reps"][1].engine.prefills == len(prompts)
        assert t["streams"] == j["streams"] == control(prompts)
        assert t["events"] == j["events"]
        s = tw.ttel.summarize_events(t["mem"].events)
        assert s["serving_ship_fallback_rate"] == 1.0
        assert s["serving_ship_success_rate"] == 0.0

    def test_no_capacity_backs_off_until_a_slot_frees(self, side, control):
        prompts = tw.prompts(3, seed=27)
        run = _serve(side, prompts, max_new=3, decode_kw={"max_batch": 1},
                     fault_retries=5, engine_bus=False)
        retries = tw.of_type(run["mem"], "kv_ship_retry")
        assert retries and {e["reason"] for e in retries} == {"no_capacity"}
        assert not tw.of_type(run["mem"], "kv_ship_fallback")
        assert len(tw.of_type(run["mem"], "kv_ship")) == len(prompts)
        assert run["streams"] == control(prompts, max_new=3)

    def test_destination_fence_retargets_the_transfer(self, side, control):
        prompt = tw.prompts(1, seed=28)[0]
        chaos = _chaos(side, rates={("kv_page", "drop"): 1.0})
        bus, mem = side.bus("retarget")
        fleet, reps = side.disagg(n_decode=2, telemetry=bus,
                                  transport=chaos, fault_retries=20)
        fleet.warmup()
        rid = fleet.submit(prompt, max_new_tokens=4)
        for _ in range(3):
            fleet.step()
        assert fleet._transfers[rid].dst == "d0"
        reps[1].fence()                 # d0 dies mid-transfer
        chaos.rates.clear()             # the wire heals
        fleet.run()
        assert [e["to_replica"] for e in tw.of_type(mem, "kv_ship")] == \
            ["d1"]
        assert fleet.placement[rid] == "d1"
        assert fleet.handles[rid].generated == control([prompt],
                                                       max_new=4)[0]


# ---------------------------------------------------------------------------
# Everything at once
# ---------------------------------------------------------------------------


def _all_rates(p):
    return {(cls, fault): p for cls in ("migrate", "kv_page", "kv_commit")
            for fault in FAULTS}


class TestChaosEverything:
    def test_all_faults_armed_as_jax(self, sides, jside):
        """Every fault class on every data-plane message class, plus
        scheduled ping faults that fence prefill replica p0 mid-run:
        streams bitwise, zero drops, the same fault decisions and the
        same event stream as JAX."""
        prompts = tw.prompts(8, seed=18, lo=6, hi=14)
        runs = []
        for s in sides:
            chaos = _chaos(s, seed=7, rates=_all_rates(0.15),
                           schedule={("ping", "drop"): {9},
                                     ("ping", "duplicate"): {3},
                                     ("ping", "reorder"): {5}})
            run = _serve(s, prompts, max_new=6, n_prefill=2, n_decode=2,
                         transport=chaos, chaos_bus=True, fault_retries=3)
            runs.append(dict(run, injected=dict(chaos.injected)))
        j, t = runs
        mem = t["mem"]
        assert t["injected"] and t["injected"] == j["injected"]
        assert [f["replica"] for f in tw.of_type(mem, "replica_fence")] == \
            ["p0"]
        for e in mem.events:
            if e["type"] in ("kv_ship", "kv_ship_retry", "kv_ship_fallback",
                             "fault_injected", "request_migrate",
                             "replica_fence"):
                tw.ttel.validate_event(e)
        assert len(t["fleet"].handles) == len(prompts)
        assert all(r.done for r in t["fleet"].handles.values())
        assert t["streams"] == j["streams"] == \
            jside.control(prompts, max_new=6)
        assert t["events"] == j["events"]

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_full_grid_sweep(self, side, control, seed):
        prompts = tw.prompts(10, seed=100 + seed, lo=6, hi=14)
        rates = _all_rates(0.25)
        rates.update({("migrate", f): 0.05 for f in FAULTS})
        chaos = _chaos(side, seed=seed, rates=rates,
                       schedule={("ping", "drop"): {9}})
        run = _serve(side, prompts, max_new=6, n_prefill=2, n_decode=2,
                     transport=chaos, engine_bus=False, fault_retries=4)
        assert len(run["fleet"].handles) == len(prompts)
        assert run["streams"] == control(prompts, max_new=6)


# ---------------------------------------------------------------------------
# Prefix-affinity placement
# ---------------------------------------------------------------------------


class TestPrefixAffinity:
    def test_warm_replica_wins_over_load(self, side):
        fleet, reps = side.colocated(
            2, factory_kw={"prefix_sharing": True,
                           "spec": side.sv.SpecConfig(k=0, chunk_size=8)})
        fleet.warmup()
        stem = [(i % 60) + 1 for i in range(16)]
        rid_a = fleet.submit(list(stem), max_new_tokens=4)
        assert fleet.placement[rid_a] == "r0"
        fleet.run()
        rid_b1 = fleet.submit(tw.prompts(1, seed=45)[0], max_new_tokens=8)
        assert fleet.placement[rid_b1] == "r1"
        rid_b2 = fleet.submit(tw.prompts(1, seed=46)[0], max_new_tokens=8)
        assert fleet.placement[rid_b2] == "r0"
        assert reps[0].load_score() > reps[1].load_score()
        rid_c = fleet.submit(stem + [7, 8, 9], max_new_tokens=4)
        assert fleet.placement[rid_c] == "r0"    # affinity beats load
        rid_d = fleet.submit(tw.prompts(1, seed=47)[0], max_new_tokens=4)
        assert fleet.placement[rid_d] == "r1"
        fleet.run()
        assert fleet.handles[rid_c].prefix_hit

    def test_affinity_off_without_sharing(self, side):
        fleet, _ = side.colocated(2)
        fleet.warmup()
        stem = [(i % 60) + 1 for i in range(16)]
        fleet.submit(list(stem), max_new_tokens=3)
        fleet.run()
        fleet.submit(tw.prompts(1, seed=47)[0], max_new_tokens=8)
        rid = fleet.submit(list(stem) + [5], max_new_tokens=3)
        assert fleet.placement[rid] == "r1"


# ---------------------------------------------------------------------------
# Capacity refusal reporting
# ---------------------------------------------------------------------------


class TestCapacityRefusal:
    def test_refusal_reports_the_full_shortfall(self, side):
        bus, mem = side.bus("refused")
        clock = side.sv.SimClock()
        reps = [side.fleet.ReplicaProxy("r0", side.factory(clock)),
                side.fleet.ReplicaProxy("r1", side.factory(
                    clock, max_batch=1, max_queue=1))]
        fleet = side.fleet.FleetRouter(reps, telemetry=bus, fault_retries=0)
        fleet.warmup()
        for p in tw.prompts(6, seed=50, lo=8, hi=10):
            fleet.submit(p, max_new_tokens=5)
        assert sum(1 for n in fleet.placement.values() if n == "r0") == 5
        with side.chaos.KillReplica("r0", at_step=2):
            with pytest.raises(side.fleet.FleetCapacityError) as ei:
                fleet.run()
        err = ei.value
        assert len(err.unplaceable) == 4
        assert set(err.unplaceable) <= {rid for rid, n in
                                        fleet.placement.items() if n == "r0"}
        assert err.pages_required > 0 and err.pages_available >= 0
        evs = tw.of_type(mem, "migrate_refused")
        assert len(evs) == 1
        ev = evs[0]
        side.tel.validate_event(ev)
        assert (ev["replica"], ev["unplaceable"], ev["requests"],
                ev["pages_required"], ev["pages_available"]) == (
            "r0", list(err.unplaceable), len(err.unplaceable),
            err.pages_required, err.pages_available)


# ---------------------------------------------------------------------------
# Ship telemetry: schema and summary
# ---------------------------------------------------------------------------


class TestShipTelemetry:
    def _stamp(self, type_, **payload):
        ev = {"type": type_, "run_id": "r", "step": 0, "t": 0.0,
              "ts": 0.0, "mesh": {}}
        ev.update(payload)
        return ev

    def test_new_events_validate(self, side):
        for type_, payload in (
                ("kv_ship", dict(rid=3, from_replica="p0", to_replica="d1",
                                 pages=4, payload_bytes=8192, attempts=1)),
                ("kv_ship_retry", dict(rid=3, from_replica="p0",
                                       to_replica="d1", attempt=1,
                                       reason="timeout", backoff_rounds=2)),
                ("kv_ship_retry", dict(rid=3, from_replica="p0",
                                       to_replica="d1", attempt=0,
                                       reason="crc_mismatch")),
                ("kv_ship_fallback", dict(rid=3, from_replica="p0",
                                          to_replica="d1", attempts=3,
                                          reason="no_capacity")),
                ("migrate_refused", dict(replica="r0", unplaceable=[4, 5],
                                         requests=2, pages_required=8,
                                         pages_available=3))):
            side.tel.validate_event(self._stamp(type_, **payload))

    def test_retry_reason_enum_is_closed(self, side):
        with pytest.raises(side.tel.SchemaError, match="must be one of"):
            side.tel.validate_event(self._stamp(
                "kv_ship_retry", rid=3, from_replica="p0",
                to_replica="d1", attempt=1, reason="cosmic_rays"))

    def test_summary_reports_ship_rates_as_jax(self, sides):
        events = ([{"type": "kv_ship"}] * 3
                  + [{"type": "kv_ship_fallback"}]
                  + [{"type": "request_retire"}] * 4)
        quiet = [{"type": "request_retire"}]
        got = [(s.tel.summarize_events(events),
                s.tel.summarize_events(quiet)) for s in sides]
        keys = ("serving_ship_success_rate", "serving_ship_fallback_rate")
        assert [(a[k], b[k]) for a, b in got[1:] for k in keys] == [
            (0.75, None), (0.25, None)]
        assert [a[k] for a, _ in got for k in keys] == [0.75, 0.25] * 2


# ---------------------------------------------------------------------------
# The fleet storm: a kv_ship retry storm's span tree
# ---------------------------------------------------------------------------

STORM_PROMPT = [3, 7, 11, 13, 5, 2]


def _storm(side):
    """1 prefill + 1 decode replica; the first two kv_page messages drop,
    so the one shipment retries twice (backoff 2, then 4 rounds) before
    landing.  The router ticks the shared clock once a round."""
    bus, mem = side.bus("trace-storm")
    chaos = _chaos(side, schedule={("kv_page", "drop"): {1, 2}},
                   telemetry=bus)
    clock = side.sv.SimClock()
    fleet, _ = side.disagg(telemetry=bus, clock=clock,
                           factory_kw={"telemetry": bus}, transport=chaos,
                           on_round=clock.advance)
    fleet.warmup()
    rid = fleet.submit(list(STORM_PROMPT), max_new_tokens=4)
    fleet.run()
    return rid, mem.events, list(fleet.handles[rid].generated)


class TestShipStormTracing:
    def test_span_tree_equals_jax(self, sides):
        (jrid, jev, jgen), (rid, ev, gen) = (_storm(s) for s in sides)
        assert (rid, gen) == (jrid, jgen)
        jt, t = (s.tel.build_traces(e)[rid]
                 for s, e in zip(sides, (jev, ev)))
        spans = {k: dataclasses.asdict(s) for k, s in t.spans.items()}
        assert spans == {k: dataclasses.asdict(s)
                         for k, s in jt.spans.items()}
        assert tw.ttel.validate_trace(t) == []
        ships = t.by_kind("kv_ship")
        assert [s.outcome for s in ships] == ["retry", "retry", "ok"]
        assert [s.attempt for s in ships] == [1, 2, 3]
        assert t.by_kind("kv_import")[-1].parent_id == ships[-1].span_id
        d = tw.ttel.ttft_decomposition(t)
        assert d == tw.jtel.ttft_decomposition(jt)
        assert d["ttft_ship_ms"] > 0.0
        retire = [e for e in ev if e["type"] == "request_retire"][0]
        parts = (d["ttft_queue_ms"] + d["ttft_prefill_ms"]
                 + d["ttft_ship_ms"] + d["ttft_decode_wait_ms"])
        assert abs(parts - retire["ttft_ms"]) <= \
            tw.ttel.TTFT_SUM_TOLERANCE_MS
