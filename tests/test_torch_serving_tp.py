"""Tensor-parallel serving (``ServingEngine(tp=N)``): the port's ranks
against the JAX package's tp engines, on the CPU at the serving toy of
``tests/L0/test_serving_modes.py`` (vocab 64, hidden 32, 4 heads, 2
layers, max_position 96, fp32, its prompts and engine settings; the JAX
``init_params`` weights carried across).

The port runs one process a tensor rank: ONE launch of four gloo ranks
(rank bodies in ``tests/torch_ranks.py``) holds two tp 2 replicas that
split the checks, then tp 4 over all four, then a tp 2 group with a one
second timeout.  JAX runs its tp engines on the emulated mesh
(``tests/conftest.py``) in this process while the ranks run.

Tolerances: the model's logits and K/V at tp 2, 1e-5 x max(1, max|ref|)
of JAX's ``shard_map`` step (the partial sums meet in another order);
token streams, events (stamps aside), snapshots and page payloads
exactly.  The int8 streams are held to JAX's int8 tp 2 streams exactly
(the toy's greedy margins are far above the packages' sum-order noise,
as ``test_torch_serving.py`` shows at tp 1).
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import serving as jsv
from apex_tpu import telemetry as jtel
from apex_tpu.transformer import parallel_state as jps
from apex_tpu_torch import serving as tsv
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer import parallel_state

import torch_ranks

TOY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
           max_position=96)
JCFG = jsv.ServingModelConfig(**TOY)
TCFG = tsv.ServingModelConfig(**TOY)
TOL = 1e-5
PAGE = 8
PROMPTS = [[1, 2, 3, 4, 5], [6, 7] * 4, list(range(1, 13)),
           [9, 8, 7, 6, 5, 4, 3]]
PREFIX_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
SHIP_PROMPT = [int(t) for t in np.random.RandomState(30).randint(1, 64, 20)]
TIMEOUT_S = 1.0
STAMPS = ("t", "ts", "mesh")


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _jengine(params, **kw):
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_budget", TOY["max_position"])
    kw.setdefault("clock", jsv.SimClock())
    return jsv.ServingEngine(JCFG, params, **kw)


def _jstreams(eng, prompts=PROMPTS):
    reqs = [eng.submit(p, max_new_tokens=3 + i)
            for i, p in enumerate(prompts)]
    eng.run()
    return [list(r.generated) for r in reqs]


# -- one prefill, decode and extend at tp 2 ------------------------------------

def _model_operands(rng):
    """A prefill row (two requests' worth of tokens, one segment), a
    4-row decode step and a 4-row extend at q = 5 over a random pool of
    16 pages (rows of various lengths, one idle)."""
    S = 24
    tok = np.zeros((1, S), np.int32)
    tok[0, :17] = rng.randint(0, TOY["vocab_size"], 17)
    seg = (np.arange(S) < 17).astype(np.int32)[None]
    pos = np.where(seg, np.arange(S), 0).astype(np.int32)
    p_max, b = 4, 4
    table = np.zeros((b, p_max), np.int32)
    free = list(rng.permutation(np.arange(1, 16)))
    kv_len = np.array([9, 27, 3, 1], np.int32)
    for i, n in enumerate(kv_len[:3]):
        pages = [int(free.pop()) for _ in range(-(-n // PAGE))]
        table[i, :len(pages)] = pages
    positions = kv_len - 1
    tokens = rng.randint(0, TOY["vocab_size"], b).astype(np.int32)
    decode = (tokens, positions, table, kv_len)
    q = 5
    etok = np.zeros((b, q), np.int32)
    epos = np.zeros((b, q), np.int32)
    wp = np.zeros((b, q), np.int32)
    wo = np.zeros((b, q), np.int32)
    elen = np.array([9, 27, 3, q], np.int32)
    for i, real in enumerate((5, 2, 3)):
        p = np.arange(elen[i] - real, elen[i])
        etok[i, q - real:] = rng.randint(0, TOY["vocab_size"], real)
        epos[i, q - real:] = p
        wp[i, q - real:] = table[i][p // PAGE]
        wo[i, q - real:] = p % PAGE
    extend = (etok, epos, wp, wo, table, elen)
    shape = (TOY["num_layers"], 16, PAGE, TOY["num_heads"],
             TOY["hidden_size"] // TOY["num_heads"])
    return dict(prefill=(tok, seg, pos), decode=decode, extend=extend,
                k0=rng.randn(*shape).astype(np.float32),
                v0=rng.randn(*shape).astype(np.float32))


def _jax_model_steps(jparams, m):
    """The same three steps through the JAX engine's tp 2 layout: its
    mesh and parameter specs, the decoder inside ``shard_map``."""
    eng = _jengine(jparams, num_pages=16, tp=2)
    mesh, pspec, ax = eng._mesh, eng._param_specs(), eng._tp_axis
    dec = jsv.PagedDecoder(JCFG)
    sp = eng.params
    pool, r = P(None, None, None, ax, None), P()

    def sm(fn, n_in, pools):
        ins = (pspec,) + ((pool, pool) if pools else ()) + (r,) * n_in
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=ins,
                                 out_specs=(r, pool, pool), check_vma=False))

    pre = sm(lambda p, t, s, q: dec.prefill(p, t, s, q, tp_axis=ax), 3,
             False)(sp, *(jnp.asarray(a) for a in m["prefill"]))
    k0, v0 = jnp.asarray(m["k0"]), jnp.asarray(m["v0"])
    de = sm(lambda p, k, v, *a: dec.decode(p, k, v, *a, tp_axis=ax), 4,
            True)(sp, k0, v0, *(jnp.asarray(a) for a in m["decode"]))
    ex = sm(lambda p, k, v, *a: dec.extend(p, k, v, *a, tp_axis=ax), 6,
            True)(sp, k0, v0, *(jnp.asarray(a) for a in m["extend"]))
    return {"prefill": pre, "decode": de, "extend": ex}


# -- the launch ----------------------------------------------------------------

def _jax_shipments(jparams):
    """A JAX tp 2 prefill engine's export of SHIP_PROMPT, fp32 and
    int8."""
    out = {}
    for quant in (None, "int8"):
        eng = _jengine(jparams, tp=2, kv_quant=quant, prefill_only=True)
        req = eng.submit(list(SHIP_PROMPT), 9)
        eng.step()
        out[quant] = eng.export_request(req.rid)
    return out


def _jax_references(jparams, m):
    mem = jtel.MemorySink()
    bus = jtel.TelemetryBus(run_id="tp", sinks=[mem])
    fp = _jstreams(_jengine(jparams, tp=2, telemetry=bus))
    return {"fp": fp, "events": mem.events,
            "tp4": _jstreams(_jengine(jparams, tp=4)),
            "int8": _jstreams(_jengine(jparams, tp=2, kv_quant="int8")),
            "model": _jax_model_steps(jparams, m)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and JAX's references, computed side by side."""
    out = tmp_path_factory.mktemp("serving_tp")
    jparams = jsv.init_params(JCFG, seed=0)
    m = _model_operands(np.random.RandomState(5))
    ship = str(out / "jax_ship.pt")
    case = dict(cfg=TOY, jparams=jax.tree_util.tree_map(np.asarray, jparams),
                prompts=PROMPTS, prefix_prompt=PREFIX_PROMPT,
                ship_prompt=SHIP_PROMPT, model=m, timeout_s=TIMEOUT_S,
                jax_ship_file=ship)
    failed = []

    def launch():
        try:
            spawn(torch_ranks.serving_tp_checks, 4, str(out / "store"),
                  str(out), case, timeout=300)
        except BaseException as e:  # raised in the test thread below
            failed.append(e)

    t = threading.Thread(target=launch)
    t.start()
    try:
        # JAX's tp engines build their mesh from the first devices, whatever
        # model-parallel state an earlier test left registered in this
        # process
        with jps.uninitialized_scope():
            # JAX's payloads first: the ranks wait for the file (written
            # whole, then renamed into place)
            ref = {"ship": _jax_shipments(jparams)}
            torch.save(ref["ship"], ship + ".part")
            os.replace(ship + ".part", ship)
            ref.update(_jax_references(jparams, m))
    finally:
        t.join()
    if failed:
        raise failed[0]
    return torch_ranks.load_ranks(str(out), 4), ref


def test_shard_params_tp_is_jax_bitwise():
    # the shard-major wqkv reorder, and each rank's slice of it: the
    # columns of wqkv and w1, the rows of wo and w2 that JAX's param specs
    # hand shard j; everything else whole
    jparams = jsv.init_params(JCFG, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = tsv.params_from_jax(tree, device="cpu")
    for tp in (1, 2, 4):
        want = jsv.shard_params_tp(jparams, tp)
        got = tsv.shard_params_tp(tparams, tp)
        for jl, tl in zip(want["layers"], got["layers"]):
            assert np.array_equal(tl["wqkv"].numpy(), np.asarray(jl["wqkv"]))
        n = TOY["hidden_size"] // tp
        for rank in range(tp):
            mine = tsv.rank_params_from_jax(tree, tp, rank, "cpu")
            cols = {"wqkv": 3 * n, "w1": 4 * n}
            rows = {"wo": n, "w2": 4 * n}
            for jl, tl in zip(want["layers"], mine["layers"]):
                for key, w in cols.items():
                    assert np.array_equal(
                        tl[key].numpy(),
                        np.asarray(jl[key])[:, w * rank:w * (rank + 1)]), key
                for key, w in rows.items():
                    assert np.array_equal(
                        tl[key].numpy(),
                        np.asarray(jl[key])[w * rank:w * (rank + 1)]), key
                assert np.array_equal(tl["ln2"]["g"].numpy(),
                                      np.asarray(jl["ln2"]["g"]))
            assert np.array_equal(mine["embed"].numpy(), tree["embed"])


def test_tp_without_a_group_raises():
    # one process, no process group (whatever state an earlier test left
    # registered): tp > 1 never falls back to one rank
    params = tsv.init_params(TCFG, 0, "cpu")
    with parallel_state.uninitialized_scope():
        with pytest.raises(RuntimeError, match="tp=2"):
            tsv.ServingEngine(TCFG, params, num_pages=8, device="cpu", tp=2)
        with pytest.raises(ValueError, match="not divisible"):
            tsv.ServingEngine(TCFG, params, num_pages=8, device="cpu", tp=3)


def test_refusals_on_the_ranks(run):
    ranks, _ = run
    for res in ranks:
        (t3, m3), (t4, m4) = res["refused"]
        assert t3 == "ValueError" and "not divisible" in m3
        assert t4 == "ValueError" and "does not match" in m4


@pytest.mark.parametrize("step", ["prefill", "decode", "extend"])
def test_model_step_at_tp2_matches_jax_shard_map(run, step):
    ranks, ref = run
    got0, got1 = ranks[0]["model"][step], ranks[1]["model"][step]
    for a, b in zip(got0, got1):   # every rank ends with the same bits
        assert torch.equal(a, b)
    jl, jk, jv = ref["model"][step]
    logits, k, v = got0
    if step == "prefill":
        live = slice(0, 17)
        _close(logits[0, live], np.asarray(jl)[0, live])
        _close(k[:, 0, live], np.asarray(jk)[:, 0, live])
        _close(v[:, 0, live], np.asarray(jv)[:, 0, live])
        return
    if step == "decode":
        _close(logits[:3], np.asarray(jl)[:3])      # row 3 is idle
    else:
        # the real query rows of each extend row (front-padded windows)
        for i, real in enumerate((5, 2, 3)):
            _close(logits[i, 5 - real:], np.asarray(jl)[i, 5 - real:])
    # the pools outside the scratch page (idle rows write there)
    _close(k[:, 1:], np.asarray(jk)[:, 1:])
    _close(v[:, 1:], np.asarray(jv)[:, 1:])


def test_streams_at_tp2_and_tp4_equal_jax_and_tp1(run):
    ranks, ref = run
    assert ref["fp"] == ref["tp4"]
    for r in (0, 1):
        assert ranks[r]["fp"] == ref["fp"]
        assert ranks[r]["pool"] == ((2, 64, PAGE, 2, 8), 2)
    for res in ranks:
        assert res["tp4"] == ref["tp4"]
        assert res["tp4_pool"] == (2, 64, PAGE, 1, 8)
    for r in (0, 1):
        assert ranks[r]["tp1"] == ref["fp"]


def test_batched_equals_sequential_at_tp2(run):
    ranks, ref = run
    for r in (0, 1):
        assert ranks[r]["seq"] == ranks[r]["fp"] == ref["fp"]


def test_telemetry_is_the_first_ranks_and_equals_jax(run):
    ranks, ref = run

    def unstamped(events):
        return [{k: v for k, v in e.items() if k not in STAMPS}
                for e in events]

    assert ranks[0]["events"] and ranks[1]["events"] == []
    assert unstamped(ranks[0]["events"]) == unstamped(ref["events"])


def test_int8_at_tp2_equals_jax_int8_at_tp2(run):
    ranks, ref = run
    for r in (0, 1):
        assert ranks[r]["int8"] == ref["int8"]
        assert ranks[r]["int8_pool"] == ("torch.int8", (2, 64, PAGE, 2, 8),
                                         (2, 64, PAGE, 2))


def test_spec_and_chunking_at_tp2_equal_tp1(run):
    ranks, _ = run
    for r in (2, 3):
        tp2, tp1 = ranks[r]["spec"]
        assert tp2 == tp1
        assert [len(s) for s in tp2] == [3 + i for i in range(len(PROMPTS))]


def test_prefix_sharing_with_tp2_and_int8(run):
    ranks, _ = run
    for r in (2, 3):
        (shared, hits), (ctrl, ctrl_hits) = ranks[r]["prefix"]
        assert hits == [False, True] and ctrl_hits == [False, False]
        assert shared == ctrl


def test_kill_mid_decode_with_the_injector_on_rank0_only(run):
    ranks, _ = run
    k0, k1 = ranks[0]["kill"], ranks[1]["kill"]
    assert k0["fired"] is True and k1["fired"] is None
    for k in (k0, k1):
        assert k["recoveries"] == 1
        assert k["streams"] == k["ctrl"]


def test_snapshot_restore_round_trip_into_poisoned_pools(run):
    ranks, _ = run
    assert ranks[0]["snap"]["snapshot"] == ranks[1]["snap"]["snapshot"]
    for r in (0, 1):
        got = ranks[r]["snap"]["streams"]
        assert got
        for rid, stream in got.items():
            assert stream == ranks[r]["int8"][rid], rid


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_page_shipping_across_tp_sizes_and_packages(run, quant):
    ranks, ref = run
    jrec, jpages, jlen = ref["ship"][quant]
    for r in (2, 3):
        s = ranks[r][f"ship_{quant}"]
        # the tp 2 export is the whole page, the same on both ranks, in
        # JAX's format: a tp 1 engine lands it, exports the same bytes
        # and CRCs back and decodes the tp 2 engine's stream
        assert s["pages"] == ranks[2][f"ship_{quant}"]["pages"]
        assert all(tsv.verify_page_payload(p) for p in s["pages"])
        assert all(jsv.kv_cache.verify_page_payload(p) for p in s["pages"])
        assert [sorted(p) for p in s["pages"]] == [sorted(p) for p in jpages]
        assert s["back"] == s["pages"]
        assert s["tp1_stream"] == s["want"]
        # JAX's tp 2 payload lands in the port's tp 2 engine and exports
        # back byte for byte; each rank checks its slice's own CRC
        assert s["jax_again"] == jpages
        assert s["crc"] is None
        assert s["jax_landed_stream"][0] == jrec["generated"][0]
        assert s["jax_landed_stream"] == s["want"]


def test_a_rank_dependent_clock_gives_the_first_ranks_decisions(run):
    ranks, _ = run
    got2, ctrl2, _ = ranks[2]["clock"]
    got3, ctrl3, slow = ranks[3]["clock"]
    # rank 3's own clock (5 s a step) would have timed out other requests
    assert got2 == got3 == ctrl2 == ctrl3 != slow
    assert [why for _, why in got2] == ["timeout", "length", "shed",
                                        "length"]


def test_one_ranks_faults_reach_the_whole_group(run):
    ranks, _ = run
    for r in (2, 3):
        c = ranks[r]["corrupt"]
        assert c["recoveries"] == 1 and c["streams"] == c["ctrl"]
        name, msg = ranks[r]["other_error"]
        assert "injected" in msg
        assert name == ("ValueError" if r == 3 else "RuntimeError")
        assert ranks[r]["after_error"] == c["ctrl"]


def test_an_error_outside_the_agreement_point_stops_the_peer(run):
    ranks, _ = run
    (n1, m1), _ = ranks[1]["timeout"]
    assert n1 == "RuntimeError" and "injected device error" in m1
    (n0, m0), waited = ranks[0]["timeout"]
    assert n0 == "RuntimeError" and "injected" not in m0
    assert waited < TIMEOUT_S + 20
