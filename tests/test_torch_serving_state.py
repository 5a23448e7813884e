"""The port's serving state, page integrity and recovery
(``ServingEngine.snapshot``/``restore``/``adopt``/``recover``,
``export_request``/``adopt_prefilled``, ``PagedKVCache``'s CRCs, page
payloads and ``defrag``, the chaos injectors and the step watchdog),
held against the live JAX package on the CPU at the JAX serving toy
(vocab 64, hidden 32, 4 heads, 2 layers, max_position 96, page 8, fp32;
the JAX ``init_params`` weights carried across by ``params_from_jax``;
``SimClock`` time).

Tolerances: none.  Snapshots, export records and page payloads are
compared as JSON text, token streams exactly (``test_torch_serving.py``
shows the toy's greedy choices have margins far above the packages'
sum-order noise), page mappings and accounting exactly, and a payload's
bytes exactly.  The int8 pool's scales are JAX's function of the port's
own K/V (``test_torch_serving_modes.py``), so a JAX payload is landed
verbatim in the port and continued there, not compared to a port
export.
"""

import base64
import json

import numpy as np
import pytest
import torch

import jax

from apex_tpu import serving as jsv
from apex_tpu import telemetry as jtel
from apex_tpu.resilience import chaos as jchaos
from apex_tpu.serving import kv_cache as jkv
from apex_tpu_torch import serving as tsv
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.resilience import chaos
from apex_tpu_torch.resilience.chaos import DeviceLossError
from apex_tpu_torch.resilience.elastic import Watchdog, WatchdogTimeout
from apex_tpu_torch.serving import engine as tengine
from apex_tpu_torch.serving import kv_cache as tkv

TOY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
           max_position=96)
JCFG = jsv.ServingModelConfig(**TOY)
TCFG = tsv.ServingModelConfig(**TOY)
MODES = {"plain": {},
         "modes": dict(spec=dict(k=4, chunk_size=16), prefix_sharing=True)}


@pytest.fixture(scope="module")
def jparams():
    return jsv.init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tsv.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")


def _engine(mod, params, mode="plain", **kw):
    opts = dict(MODES[mode])
    if "spec" in opts:
        opts["spec"] = mod.SpecConfig(**opts["spec"])
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_budget", TOY["max_position"])
    kw.setdefault("clock", mod.SimClock())
    if mod is tsv:
        kw["device"] = "cpu"
    cfg = TCFG if mod is tsv else JCFG
    return mod.ServingEngine(cfg, params, **opts, **kw)


def _trace(mod, mode="plain"):
    """The JAX resilience tier's trace; with the modes on, prompts past
    the 16-token chunk and a repeated 24-token head (prefix hits)."""
    if mode == "plain":
        return mod.poisson_trace(3, 6, rate=2.0, prompt_len=(4, 10),
                                 max_new=(3, 8), vocab_size=64)
    rng = np.random.RandomState(13)
    head = [int(t) for t in rng.randint(0, 64, 24)]
    prompts = [[int(t) for t in rng.randint(0, 64, 6)], head,
               [int(t) for t in rng.randint(0, 64, 40)],
               head[:17] + [int(t) for t in rng.randint(0, 64, 9)],
               list(head)]
    return [mod.Request(rid=i, prompt=p, max_new_tokens=10,
                        arrival_t=float(i)) for i, p in enumerate(prompts)]


def _streams(reqs):
    return {r.rid: list(r.generated) for r in reqs}


@pytest.fixture(scope="module")
def control(tparams):
    """Uninterrupted port streams, by mode, of :func:`_trace`."""
    out = {}
    for mode in MODES:
        tr = _trace(tsv, mode)
        _engine(tsv, tparams, mode).serve(tr)
        out[mode] = _streams(tr)
    return out


# -- the counters --------------------------------------------------------------


def test_decode_steps_count_every_boundary_as_jax(jparams, tparams, control):
    mem = jtel.MemorySink()
    jeng = _engine(jsv, jparams, "modes",
                   telemetry=jtel.TelemetryBus(sinks=[mem]))
    jtr = _trace(jsv, "modes")
    jeng.serve(jtr)
    teng = _engine(tsv, tparams, "modes")
    ttr = _trace(tsv, "modes")
    teng.serve(ttr)
    assert _streams(ttr) == _streams(jtr) == control["modes"]
    steps = [e for e in mem.events if e["type"] == "decode_step"]
    verify = [e for e in steps if e.get("spec_verify")]
    assert teng.decode_steps == jeng.decode_steps == len(steps)
    assert teng.verify_steps == len(verify)
    assert 0 < teng.verify_steps < teng.decode_steps
    assert teng.chunk_steps > 0 and teng.prefix_hits > 0


# -- snapshot and restore ------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_snapshots_are_jax_json(jparams, tparams, mode):
    # after each of the same steps, both engines' snapshots are one text
    jeng, teng = _engine(jsv, jparams, mode), _engine(tsv, tparams, mode)
    for a, b in zip(_trace(jsv, mode), _trace(tsv, mode)):
        jeng.submit_request(a)
        teng.submit_request(b)
    n = 0
    while not teng.sched.idle:
        jeng.step()
        teng.step()
        n += 1
        assert json.dumps(teng.snapshot()) == json.dumps(jeng.snapshot()), n
    assert jeng.sched.idle and n > 5


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_snapshot_crosses_packages(jparams, tparams, control, mode):
    # a JAX engine's snapshot continues in the port to the JAX streams, and
    # the port's in a JAX engine to the port's
    src = _engine(jsv, jparams, mode)
    for r in _trace(jsv, mode):
        src.submit_request(r)
    for _ in range(4):
        src.step()
    snap = json.loads(json.dumps(src.snapshot()))
    src.run()
    jax_streams = _streams(src.sched.finished)
    dst = _engine(tsv, tparams, mode)
    restored = dst.restore(snap)
    dst.run()
    assert restored and {r.rid: list(r.generated) for r in restored} == {
        r.rid: jax_streams[r.rid] for r in restored}
    assert dst.decode_steps > snap["decode_steps"] and dst.steps > 4

    src = _engine(tsv, tparams, mode)
    for r in _trace(tsv, mode):
        src.submit_request(r)
    for _ in range(3):
        src.step()
    back = _engine(jsv, jparams, mode)
    restored = back.restore(json.loads(json.dumps(src.snapshot())))
    back.run()
    assert restored and all(list(r.generated) == control[mode][r.rid]
                            for r in restored)


def test_restore_at_every_boundary(tparams, control):
    for cut in range(1, 12):
        src = _engine(tsv, tparams)
        for r in _trace(tsv):
            src.submit_request(r)
        for _ in range(cut):
            if src.sched.idle:
                break
            src.step()
        snap = json.loads(json.dumps(src.snapshot()))
        dst = _engine(tsv, tparams)
        # restore depends on nothing in the pool: poison it
        dst.cache.k.fill_(1e3)
        dst.cache.v.fill_(1e3)
        restored = dst.restore(snap)
        dst.run()
        for r in restored:
            assert list(r.generated) == control["plain"][r.rid], (cut, r.rid)


def _state(eng):
    return (eng.snapshot(), eng._next_rid, eng.steps, eng.decode_steps,
            len(eng.sched.finished), eng.cache.pages_free)


def test_restore_refusals_leave_the_engine_untouched(tparams):
    src = _engine(tsv, tparams, "modes")
    for r in _trace(tsv, "modes"):
        src.submit_request(r)
    src.step()
    snap = json.loads(json.dumps(src.snapshot()))
    assert len(snap["requests"]) == 5
    busy = _engine(tsv, tparams)
    busy.submit([3, 4], 2)
    before = _state(busy)
    with pytest.raises(RuntimeError, match="busy"):
        busy.restore(snap)
    assert _state(busy) == before
    for dst, err in (
            (_engine(tsv, tparams), "format"),
            # a 40-token prompt needs chunks past a 32-token row
            (_engine(tsv, tparams, prefill_budget=32),
             "max_pages_per_request"),
            (_engine(tsv, tparams, max_queue=2), "max_queue")):
        before = _state(dst)
        bad = dict(snap, format=2) if err == "format" else snap
        with pytest.raises(ValueError, match=err):
            dst.restore(bad)
        assert _state(dst) == before and dst.sched.idle


def test_adopt_merges_records_into_a_busy_engine(tparams, control):
    src = _engine(tsv, tparams)
    for r in _trace(tsv):
        src.submit_request(r)
    for _ in range(3):
        src.step()
    records = json.loads(json.dumps(src.snapshot()))["requests"]
    dst = _engine(tsv, tparams, max_queue=len(records))
    own = dst.submit([5, 6, 7], 4)
    own.rid = 100
    dst._next_rid = 101
    dst.step()
    before = _state(dst)
    with pytest.raises(ValueError, match="collides"):
        dst.adopt(records + [dict(records[0], rid=100)])
    assert _state(dst) == before
    adopted = dst.adopt(records)
    dst.run()
    assert {r.rid: list(r.generated) for r in adopted} == {
        r.rid: control["plain"][r.rid] for r in adopted}
    assert len(own.generated) == 4 and dst._next_rid == 101


# -- recovery ------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_device_loss_mid_decode_recovers_bitwise(tparams, control, mode):
    mem = ttel.MemorySink()
    bus = ttel.TelemetryBus(run_id="loss", sinks=[mem])
    tr = _trace(tsv, mode)
    with chaos.ServingDeviceLoss(at_step=3, device_ids=[0],
                                 telemetry=bus) as dl:
        eng = _engine(tsv, tparams, mode, telemetry=bus)
        eng.serve(tr)
    assert dl.fired and eng.recoveries == 1
    assert _streams(tr) == control[mode]
    rec = next(e for e in mem.events if e["type"] == "serving_recovery")
    assert rec["pool_rebuilt"] is True and rec["cause"] == "device_loss"
    assert rec["running_restored"] >= 1
    assert any(e["type"] == "device_loss" for e in mem.events)
    for e in mem.events:
        ttel.validate_event(e)
        jtel.validate_event(e)
    if eng.prefix_index is not None:
        eng.prefix_index.clear()
    assert eng.cache.pages_used == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_corrupt_page_is_caught_only_with_crcs(tparams, control, mode):
    mem = ttel.MemorySink()
    eng = _engine(tsv, tparams, mode, validate_pages=True,
                  telemetry=ttel.TelemetryBus(sinks=[mem]))
    tr = _trace(tsv, mode)
    with chaos.CorruptLivePage(eng.cache, at_step=2) as cp:
        eng.serve(tr)
    assert cp.corrupted_page is not None and eng.recoveries == 1
    assert _streams(tr) == control[mode]
    rec = next(e for e in mem.events if e["type"] == "serving_recovery")
    assert rec["cause"] == "page_corruption"
    # the control: the same byte flip without CRCs raises nothing
    quiet = _engine(tsv, tparams, mode)
    with chaos.CorruptLivePage(quiet.cache, at_step=2) as cp:
        quiet.serve(_trace(tsv, mode))
    assert cp.corrupted_page is not None and quiet.recoveries == 0


def test_crcs_track_every_write_and_match_jax_recipe(tparams, control):
    eng = _engine(tsv, tparams, "modes", validate_pages=True)
    tr = _trace(tsv, "modes")
    for r in tr:
        eng.submit_request(r)
    for _ in range(6):
        eng.step()
        live = {p for r in eng.sched.running for p in r.pages}
        crc = eng.cache._crc
        assert live and set(crc) <= set(eng.cache._ref)
        for p in crc:
            k = eng.cache.k[:, p].contiguous().numpy().tobytes()
            v = eng.cache.v[:, p].contiguous().numpy().tobytes()
            assert crc[p] == (jkv.zlib.crc32(k), jkv.zlib.crc32(v))
    eng.run()
    assert _streams(tr) == control["modes"]


@pytest.mark.parametrize("kw", [dict(max_recoveries=0),
                                dict(recover_on_fault=False)],
                         ids=["budget_spent", "recovery_off"])
def test_recovery_budget_and_switch_reraise(tparams, kw):
    with chaos.ServingDeviceLoss(at_step=2):
        eng = _engine(tsv, tparams, **kw)
        with pytest.raises(DeviceLossError):
            eng.serve(_trace(tsv))
    assert eng.recoveries == 0


def test_other_errors_are_never_absorbed(tparams):
    # a kernel's or the runtime's error is not a fault recover() may hide
    def hook(event, info):
        if event == "decode" and info == 1:
            raise RuntimeError("CUDA error: an illegal memory access")

    prev = tengine.set_fault_hook(hook)
    try:
        eng = _engine(tsv, tparams)
        with pytest.raises(RuntimeError, match="illegal memory"):
            eng.serve(_trace(tsv))
    finally:
        tengine.set_fault_hook(prev)
    assert eng.recoveries == 0


# -- export and adoption of prefilled pages ------------------------------------


def _shipment(mod, params, prompt, max_new, **kw):
    eng = _engine(mod, params, prefill_only=True, **kw)
    eng.warmup()
    req = eng.submit(list(prompt), max_new)
    eng.step()
    assert req.prefill_pos is None and req.generated
    if mod is tsv:
        assert not eng.decode_steps
    return eng, req, eng.export_request(req.rid)


PROMPT = [int(t) for t in np.random.RandomState(30).randint(1, 64, 20)]


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_export_then_adopt_continues_bitwise(tparams, quant):
    colocated = _engine(tsv, tparams, kv_quant=quant)
    want = colocated.submit(PROMPT, 9)
    colocated.run()
    src, req, (record, pages, kv_len) = _shipment(tsv, tparams, PROMPT, 9,
                                                  kv_quant=quant)
    assert req.finish_reason == "shipped" and req not in src.sched.finished
    assert src.cache.pages_used == 0 and len(pages) == 3 and kv_len == 20
    assert all(tkv.verify_page_payload(p) for p in pages)
    record, pages, kv_len = json.loads(json.dumps([record, pages, kv_len]))
    dec = _engine(tsv, tparams, kv_quant=quant, kv_import=True,
                  validate_pages=True)
    dec.warmup()
    got = dec.adopt_prefilled(record, pages, kv_len)
    assert [dec.cache._crc[p] for p in got.pages] == [
        (d["crc_k"], d["crc_v"]) for d in pages]
    dec.run()
    assert got.generated == want.generated and dec.prefills == 0
    assert dec.decode_steps == colocated.decode_steps


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_payloads_cross_packages(jparams, tparams, quant):
    # the port's payload verifies under JAX's check; JAX's lands in the
    # port and decodes on to JAX's colocated stream
    _, _, (_, tpages, _) = _shipment(tsv, tparams, PROMPT, 9,
                                     kv_quant=quant)
    assert all(jkv.verify_page_payload(p) for p in tpages)
    assert ("k_scale" in tpages[0]) == (quant is not None)
    jcol = _engine(jsv, jparams, kv_quant=quant)
    want = jcol.submit(PROMPT, 9)
    jcol.run()
    _, _, (record, pages, kv_len) = _shipment(jsv, jparams, PROMPT, 9,
                                              kv_quant=quant)
    assert sorted(pages[0]) == sorted(tpages[0])
    assert all(tkv.verify_page_payload(p) for p in pages)
    dec = _engine(tsv, tparams, kv_quant=quant, kv_import=True)
    got = dec.adopt_prefilled(record, pages, kv_len)
    for page, data in zip(got.pages, pages):
        assert dec.cache.export_page_bytes(page) == data
    dec.run()
    assert got.generated == want.generated


def _adopt_state(eng):
    return (len(eng.sched.running), eng.cache.pages_free, eng._next_rid,
            eng.cache.k.clone(), eng.cache.v.clone())


def _same(a, b):
    return a[:3] == b[:3] and all(bool((x == y).all())
                                  for x, y in zip(a[3:], b[3:]))


def test_a_corrupted_or_malformed_shipment_is_never_adopted(tparams):
    _, _, (record, pages, kv_len) = _shipment(tsv, tparams, PROMPT, 5)
    dec = _engine(tsv, tparams, kv_import=True)
    before = _adopt_state(dec)
    raw = bytearray(base64.b64decode(pages[1]["k"]))
    raw[7] ^= 0x01
    flipped = dict(pages[1], k=base64.b64encode(
        bytes(raw)).decode("ascii"))
    assert not tkv.verify_page_payload(flipped)
    with pytest.raises(ValueError, match="CRC"):
        dec.adopt_prefilled(record, [pages[0], flipped, pages[2]], kv_len)
    with pytest.raises(ValueError, match="pages for kv_len"):
        dec.adopt_prefilled(record, pages[:2], kv_len)
    assert _same(_adopt_state(dec), before)
    dec.adopt_prefilled(record, pages, kv_len)
    with pytest.raises(ValueError, match="collides"):
        dec.adopt_prefilled(record, pages, kv_len)


def test_a_full_batch_refuses_retryably(tparams):
    _, _, (record, pages, kv_len) = _shipment(tsv, tparams, PROMPT, 5)
    dec = _engine(tsv, tparams, kv_import=True, max_batch=1)
    dec.adopt_prefilled(record, pages, kv_len)
    before = _adopt_state(dec)
    with pytest.raises(tsv.AdmissionRefused, match="batch full"):
        dec.adopt_prefilled(dict(record, rid=7), pages, kv_len)
    assert _same(_adopt_state(dec), before)
    small = _engine(tsv, tparams, kv_import=True, num_pages=5,
                    max_pages_per_request=4)
    small.adopt_prefilled(record, pages, kv_len)
    before = _adopt_state(small)
    with pytest.raises(tsv.AdmissionRefused, match="need 3 pages"):
        small.adopt_prefilled(dict(record, rid=7), pages, kv_len)
    assert _same(_adopt_state(small), before)


# -- defrag --------------------------------------------------------------------


def _fragmented(mod, **kw):
    c = mod.PagedKVCache(num_layers=2, num_pages=12, page_size=4,
                         num_heads=2, head_dim=4, max_pages_per_request=4,
                         **kw)
    a = c.allocate(2, owner=1)
    b = c.allocate(3, owner=2)
    d = c.allocate(2, owner=3)
    e = c.allocate(1, owner=4)
    c.free(b)
    c.free(e)
    return c, [d, a]


def test_defrag_maps_pages_as_jax():
    jc, jlists = _fragmented(jsv)
    tc, tlists = _fragmented(tsv, device="cpu", crc_pages=True)
    # stamp each page with its id so content can be followed
    for p in range(tc.num_pages):
        tc.k[:, p] = p
        tc.v[:, p] = -p
    tc.refresh_page_crcs(range(1, tc.num_pages))
    jm, tm = jc.defrag(jlists), tc.defrag(tlists)
    assert tm == jm and tlists == jlists == [[1, 2], [3, 4]]
    assert tc._free == jc._free and tc._ref == jc._ref
    assert tc._owner == jc._owner
    for old, new in tm.items():
        assert bool((tc.k[:, new] == old).all())
        assert bool((tc.v[:, new] == -old).all())
    tc.verify_pages(tlists)           # digests moved with the ids
    jc2, jl2 = _fragmented(jsv)
    tc2, tl2 = _fragmented(tsv, device="cpu")
    for c, lists in ((jc2, jl2), (tc2, tl2)):
        c.share(lists[0][:1])
        with pytest.raises(ValueError, match="shared"):
            c.defrag(lists)
        c.free(lists[0][:1])
        with pytest.raises(ValueError, match="overlap"):
            c.defrag([lists[0], lists[0][:1]])


def test_defrag_mid_serve_is_output_invisible(tparams, control):
    eng = _engine(tsv, tparams, validate_pages=True)
    tr = _trace(tsv)
    pending = sorted(tr, key=lambda r: r.arrival_t)
    moved = 0
    for r in pending:
        eng.submit_request(r)
    while not eng.sched.idle:
        eng.step()
        live = [r.pages for r in eng.sched.running]
        moved += sum(o != n for o, n in eng.cache.defrag(live).items())
    assert moved and _streams(tr) == control["plain"]


# -- the step watchdog ---------------------------------------------------------


def test_wedged_decode_escalates_instead_of_hanging(tparams):
    # timeout 1.0 s against a 2.5 s wedge, kernels warmed before arming,
    # as the JAX package's case
    reports = []
    wd = Watchdog(timeout=1.0, on_hang=reports.append, poll_interval=0.02,
                  devices=[0])
    eng = _engine(tsv, tparams, watchdog=wd)
    eng.warmup()
    with chaos.SlowDecode(at_step=2, delay=2.5):
        with wd:
            reqs = [eng.submit([1, 2, 3], 4), eng.submit([4, 5], 4)]
            eng.run()
    assert wd.expired and reports, "watchdog never fired"
    assert reports[0]["timeout"] == 1.0
    assert all(len(r.generated) == 4 for r in reqs)


def test_unhandled_overrun_raises_at_next_step(tparams):
    wd = Watchdog(timeout=0.8, poll_interval=0.02, devices=[0])
    eng = _engine(tsv, tparams, watchdog=wd)
    eng.warmup()
    with chaos.SlowDecode(at_step=1, delay=2.0):
        with wd:
            eng.submit([1, 2, 3], 6)
            with pytest.raises(WatchdogTimeout):
                eng.run()


def test_chaos_faults_match_jax_bytes(jparams, tparams):
    # corrupt_page flips the byte JAX's flips (layer 0, the page's middle
    # row, head 0, the first element's lowest byte)
    for quant in (None, "int8"):
        jc = jsv.PagedKVCache(num_layers=2, num_pages=4, page_size=4,
                              num_heads=2, head_dim=4,
                              max_pages_per_request=2, quantize=quant)
        tc = tsv.PagedKVCache(num_layers=2, num_pages=4, page_size=4,
                              num_heads=2, head_dim=4,
                              max_pages_per_request=2, quantize=quant,
                              device="cpu")
        jchaos.corrupt_page(jc, 2)
        chaos.corrupt_page(tc, 2)
        np.testing.assert_array_equal(
            tc.k.view(torch.uint8).numpy(),
            np.asarray(jc.k).view(np.uint8))
    err = DeviceLossError([3, 1], detail="x")
    assert err.device_ids == [1, 3] and str(err) == str(
        jchaos.DeviceLossError([3, 1], detail="x"))
