"""Parity of the port's telemetry (``apex_tpu_torch.telemetry``) and the
engine's event stream with the JAX package's, on the CPU at the JAX
serving toy (vocab 64, hidden 32, 4 heads, 2 layers, max_position 96,
page 8, fp32, the JAX ``init_params`` weights carried across by
``params_from_jax``, ``SimClock`` time).

Tolerances: none are needed.  The schema tables are compared field spec
for field spec; the event streams event for event, every payload field
exactly, without the bus's own stamps ``t``, ``ts`` (wall and monotonic
time) and ``mesh`` (each package's devices); the traces, TTFT
decompositions and summaries exactly.  Token streams are exactly equal,
as ``test_torch_serving.py`` shows with margin.
"""

import json

import numpy as np
import pytest

import jax

from apex_tpu import serving as jsv
from apex_tpu import telemetry as jtel
from apex_tpu.telemetry import tracing as jtracing
from apex_tpu_torch import serving as tsv
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.telemetry import __main__ as tcli

TOY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
           max_position=96)
JCFG = jsv.ServingModelConfig(**TOY)
TCFG = tsv.ServingModelConfig(**TOY)
STAMPS = ("t", "ts", "mesh")


@pytest.fixture(scope="module")
def jparams():
    return jsv.init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tsv.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")


# -- the schema ----------------------------------------------------------------


def test_event_fields_equal_jax():
    from apex_tpu.telemetry import schema as js
    from apex_tpu_torch.telemetry import schema as ts
    assert list(ts.EVENT_FIELDS) == list(js.EVENT_FIELDS)
    for etype, fields in js.EVENT_FIELDS.items():
        assert list(ts.EVENT_FIELDS[etype]) == list(fields), etype
        for name, spec in fields.items():
            assert tuple(ts.EVENT_FIELDS[etype][name]) == tuple(spec), (
                etype, name)
    assert ts.EVENT_TYPES == js.EVENT_TYPES == ttel.EVENT_TYPES
    assert ts.STAMP_REQUIRED == js.STAMP_REQUIRED
    assert ttel.SPAN_KINDS == jtel.SPAN_KINDS
    assert ttel.TTFT_SUM_TOLERANCE_MS == jtel.TTFT_SUM_TOLERANCE_MS


@pytest.mark.parametrize("event", [
    {"type": "request_reject", "rid": 1, "reason": "queue_fill",
     "queue_depth": 2},
    {"type": "serving_recovery", "cause": "device_loss", "pool_rebuilt": 1,
     "running_restored": 1, "waiting_restored": 0},
    {"type": "request_retire", "rid": 1, "reason": "length"},
    {"type": "no_such_event"},
], ids=["closed_choice", "bool_not_int", "missing_field", "unknown_type"])
def test_validate_event_refuses_as_jax(event):
    ev = dict({"run_id": "r", "step": 0, "t": 0.0, "ts": 0.0, "mesh": {}},
              **event)
    with pytest.raises(ttel.SchemaError):
        ttel.validate_event(ev)
    with pytest.raises(jtel.SchemaError):
        jtel.validate_event(ev)


def test_bus_stamps_and_mesh():
    mem = ttel.MemorySink()
    bus = ttel.TelemetryBus(run_id="r0", sinks=[mem])
    ev = bus.emit("serving_stall", step=3, waiting=1, running=0, budget=9)
    ttel.validate_event(ev)
    jtel.validate_event(ev)
    # the CPU engine's mesh stamp; a card's names the card count
    assert ev["mesh"] == {"n_devices": 1, "platform": "cpu"}
    assert ttel.default_mesh_topology() == ev["mesh"]
    assert ev["run_id"] == "r0" and ev["step"] == 3 and mem.events == [ev]
    with pytest.raises(ttel.TelemetryError, match="unknown event type"):
        bus.emit("no_such_event")
    bus.set_mesh({"n_devices": 4, "platform": "gpu"})
    assert bus.emit("serving_stall", waiting=0, running=0,
                    budget=1)["mesh"]["n_devices"] == 4
    assert bus.counts == {"serving_stall": 2}


def test_failing_sink_is_dropped_and_the_ring_kept(tmp_path):
    class Broken:
        def write(self, event):
            raise OSError("disk full")

        def close(self):
            pass

    mem = ttel.MemorySink()
    path = tmp_path / "run.jsonl"
    bus = ttel.TelemetryBus(run_id="r1", sinks=[Broken(), mem,
                                                 ttel.JsonlSink(str(path))])
    for i in range(3):
        bus.emit("serving_stall", step=i, waiting=i, running=0, budget=3)
    assert len(bus.sinks) == 2 and len(mem.events) == 3
    assert len(bus.recorder) == 3
    # a file-backed bus dumps its ring as a schema-valid bundle; a
    # memory-only one does not
    assert ttel.maybe_dump_flight_record(
        ttel.TelemetryBus(sinks=[ttel.MemorySink()]), "x") is None
    pm = ttel.maybe_dump_flight_record(bus, "recovery_exhausted:X", step=3)
    assert pm is not None and ttel.validate_jsonl(pm) == 4
    assert jtel.validate_jsonl(pm) == 4
    bus.close()
    assert ttel.validate_jsonl(str(path)) == 4     # + the announcement


# -- the engine's event stream against the JAX engine's ----------------------


def _trace(mod):
    # deadlines (a timeout), a burst over the bounded queue (rejects) and a
    # pool too small for every request at once (preemptions)
    return mod.poisson_trace(5, 10, rate=2.0, prompt_len=(4, 30),
                             max_new=(3, 16), vocab_size=64,
                             deadline_s=(4.0, 16.0))


def _modes_prompts():
    rng = np.random.RandomState(13)
    prompts = [[int(t) for t in rng.randint(0, 64, n)]
               for n in (6, 24, 40, 11)]
    prompts.append(prompts[2][:17] + [int(t) for t in rng.randint(0, 64, 9)])
    prompts.append(list(prompts[1]))
    return prompts


def _serve(mod, tel, params, mode):
    mem = tel.MemorySink()
    bus = tel.TelemetryBus(run_id="parity", sinks=[mem])
    kw = dict(page_size=8, max_batch=4, prefill_budget=96,
              clock=mod.SimClock(), telemetry=bus)
    if mod is tsv:
        kw["device"] = "cpu"
    if mode == "plain":
        eng = mod.ServingEngine(mod.ServingModelConfig(**TOY), params,
                                num_pages=9, max_queue=3, **kw)
        reqs = _trace(mod)
        eng.serve(reqs)
    else:
        eng = mod.ServingEngine(
            mod.ServingModelConfig(**TOY), params, num_pages=64,
            spec=mod.SpecConfig(k=4, chunk_size=16), prefix_sharing=True,
            **kw)
        reqs = []
        for p in _modes_prompts():
            reqs.append(eng.submit(p, 12))
            eng.step()
        eng.run()
    streams = {r.rid: (list(r.generated), r.finish_reason) for r in reqs}
    return mem.events, streams


@pytest.fixture(scope="module", params=["plain", "modes"])
def streams_pair(request, jparams, tparams):
    j = _serve(jsv, jtel, jparams, request.param)
    t = _serve(tsv, ttel, tparams, request.param)
    return request.param, j, t


def _unstamped(events):
    return [{k: v for k, v in e.items() if k not in STAMPS} for e in events]


def test_event_stream_equals_jax(streams_pair):
    mode, (jevents, jstreams), (tevents, tstreams) = streams_pair
    assert tstreams == jstreams
    assert _unstamped(tevents) == _unstamped(jevents)
    types = {e["type"] for e in tevents}
    if mode == "plain":
        reasons = {r for _, r in tstreams.values()}
        assert {"rejected", "timeout", "length"} <= reasons
        assert {"request_reject", "request_timeout"} <= types
        assert any(e["type"] == "decode_step" and e["evicted"]
                   for e in tevents), "no preemption in the trace"
    else:
        steps = [e for e in tevents if e["type"] == "decode_step"]
        assert any(e.get("spec_verify") for e in steps)
        assert all("pool_shared_pages" in e for e in steps)
        admits = [e for e in tevents if e["type"] == "request_admit"]
        assert any(e.get("chunked") for e in admits)
        assert any(e["prefix_hit"] for e in admits)
    for e in tevents:
        ttel.validate_event(e)
        jtel.validate_event(e)


def test_traces_and_summaries_equal_jax(streams_pair):
    _, (jevents, _), (tevents, _) = streams_pair
    jtr, ttr = jtel.build_traces(jevents), ttel.build_traces(tevents)
    assert sorted(ttr) == sorted(jtr) and ttr
    retired = {e["rid"]: e for e in tevents
               if e["type"] == "request_retire" and "ttft_ms" in e}
    for rid, tr in ttr.items():
        assert ttel.validate_trace(tr) == jtel.validate_trace(jtr[rid]) == []
        assert [s.span_id for s in ttel.critical_path(tr)] == [
            s.span_id for s in jtel.critical_path(jtr[rid])]
        dec = ttel.ttft_decomposition(tr)
        assert dec == jtel.ttft_decomposition(jtr[rid])
        if rid in retired:
            parts = sum(v for k, v in dec.items()
                        if k.startswith("ttft_") and k != "ttft_ms")
            assert abs(parts - retired[rid]["ttft_ms"]) <= \
                ttel.TTFT_SUM_TOLERANCE_MS
        assert ttel.format_trace(tr) == jtracing.format_trace(jtr[rid])
    ts, js = ttel.summarize_events(tevents), jtel.summarize_events(jevents)
    drop = ("wall_s",)    # the stamps' span: host time, not the stream's
    assert {k: v for k, v in ts.items() if k not in drop} == {
        k: v for k, v in js.items() if k not in drop}
    assert ts["serving_requests"] and "serving     requests" in \
        ttel.format_summary(ts)
    assert ttel.format_summary(ts) == jtel.format_summary(ts)
    assert ttel.format_diff(ts, ts) == jtel.format_diff(ts, ts)


def test_cli_reads_an_engine_stream(tmp_path, tparams, capsys):
    path = tmp_path / "serve.jsonl"
    bus = ttel.TelemetryBus(run_id="cli", sinks=[ttel.JsonlSink(str(path))])
    eng = tsv.ServingEngine(TCFG, tparams, num_pages=16, page_size=8,
                            max_batch=2, clock=tsv.SimClock(),
                            telemetry=bus, device="cpu")
    eng.serve(tsv.poisson_trace(2, 3, rate=1.0, prompt_len=(4, 9),
                                max_new=(2, 5), vocab_size=64))
    bus.close()
    assert tcli.main(["validate", str(path)]) == 0
    assert tcli.main(["summarize", str(path)]) == 0
    out = capsys.readouterr().out
    assert "serving     requests 3" in out
    assert tcli.main(["summarize", str(path), "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["serving_requests"] == 3
    assert tcli.main(["trace", str(path)]) == 0
    assert tcli.main(["trace", str(path), "--rid", "77"]) == 2
