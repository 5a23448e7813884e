"""Parity of the PyTorch port's serving stack (``apex_tpu_torch.serving``)
with the JAX package's (``apex_tpu.serving``), and the port's own
contracts, on the CPU at toy width.

The toy model is the JAX serving tier's (vocab 64, hidden 32, 4 heads,
2 layers, max_position 96, page 8), fp32, with the JAX ``init_params``
weights carried across by ``params_from_jax``.  Tolerances: logits and
K/V 1e-5 x max(1, max|ref|) (torch and XLA sum in different orders);
token streams exactly, with every greedy choice's top-2 logit margin
checked to be far above that tolerance so the equality is not luck.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import serving as jsv
from apex_tpu_torch import kernels
from apex_tpu_torch import serving as tsv

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
TOY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
           max_position=96)
JCFG = jsv.ServingModelConfig(**TOY)
TCFG = tsv.ServingModelConfig(**TOY)


@pytest.fixture(scope="module")
def jparams():
    return jsv.init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tsv.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))


def _prompts(n=4):
    return [[int(x) for x in np.random.RandomState(100 + i).randint(
        0, TOY["vocab_size"], 5 + 3 * i)] for i in range(n)]


def _port_engine(params, *, max_batch=4, num_pages=64, mppr=None):
    return tsv.ServingEngine(TCFG, params, num_pages=num_pages, page_size=8,
                             max_batch=max_batch,
                             max_pages_per_request=mppr,
                             prefill_budget=TOY["max_position"],
                             clock=tsv.SimClock(), device="cpu")


def _port_streams(params, prompts, max_new=12, **kw):
    eng = _port_engine(params, **kw)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    return [list(r.generated) for r in reqs], eng


# -- weights ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jcfg = jsv.ServingModelConfig(**TOY, dtype=getattr(jnp, dtype))
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(jcfg, seed=3))
    port = tsv.params_from_jax(tree, device="cpu")
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    got = jax.tree_util.tree_leaves(port)
    assert len(got) == len(leaves) == 4 + 8 * TOY["num_layers"]
    for a, t in zip(leaves, got):
        assert t.dtype == getattr(torch, dtype) and t.shape == a.shape
        # exact: bf16 -> fp32 -> bf16 loses nothing
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    back = jax.tree_util.tree_unflatten(
        treedef, [t.float().numpy() for t in got])
    assert set(back) == set(tree) and len(back["layers"]) == 2


# -- the decoder -----------------------------------------------------------


def _packed_row(lengths, S=96, seed=0):
    rng = np.random.RandomState(seed)
    tokens = np.zeros((1, S), np.int32)
    seg = np.zeros((1, S), np.int32)
    pos = np.zeros((1, S), np.int32)
    at = 0
    for i, n in enumerate(lengths):
        tokens[0, at:at + n] = rng.randint(0, TOY["vocab_size"], n)
        seg[0, at:at + n] = i + 1
        pos[0, at:at + n] = np.arange(n)
        at += n
    return tokens, seg, pos


@pytest.mark.parametrize("lengths", [[37], [20, 30, 9]],
                         ids=["one_request", "three_segments"])
def test_prefill_logits_and_kv_match_jax(jparams, tparams, lengths):
    tokens, seg, pos = _packed_row(lengths)
    jl, jk, jv = jsv.PagedDecoder(JCFG).prefill(
        jparams, jnp.asarray(tokens), jnp.asarray(seg), jnp.asarray(pos))
    dec = tsv.PagedDecoder(TCFG)
    tl, tk, tv = dec.prefill(tparams, *(torch.tensor(a)
                                        for a in (tokens, seg, pos)))
    assert tl.shape == jl.shape and tk.shape == jk.shape == tv.shape
    _close(tl.numpy(), jl)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
    # last_index: the one row admission needs
    last = sum(lengths) - 1
    one, _, _ = dec.prefill(tparams, *(torch.tensor(a)
                                       for a in (tokens, seg, pos)), last)
    assert one.shape == (1, 1, TOY["vocab_size"])
    _close(one[0, 0].numpy(), tl[0, last].numpy())


def test_decode_logits_and_pool_match_jax(jparams, tparams):
    rng = np.random.RandomState(1)
    L, n_pages, ps, H, D = 2, 10, 8, 4, 8
    k_pool = rng.randn(L, n_pages, ps, H, D).astype(np.float32)
    v_pool = rng.randn(L, n_pages, ps, H, D).astype(np.float32)
    table = np.array([[3, 7, 0], [5, 0, 0], [0, 0, 0]], np.int32)
    positions = np.array([12, 4, 0], np.int32)   # last row idle
    kv_len = positions + 1
    tokens = np.array([5, 17, 0], np.int32)
    jl, jk, jv = jsv.PagedDecoder(JCFG).decode(
        jparams, jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(table),
        jnp.asarray(kv_len))
    tk, tv = torch.tensor(k_pool), torch.tensor(v_pool)
    tl = tsv.PagedDecoder(TCFG).decode(
        tparams, tk, tv, torch.tensor(tokens), torch.tensor(positions),
        torch.tensor(table), torch.tensor(kv_len))
    _close(tl.numpy(), jl)
    _close(tk.numpy(), jk)   # the port appended in place
    _close(tv.numpy(), jv)


# -- the engine ------------------------------------------------------------


def test_engine_streams_match_jax_with_margin(jparams, tparams):
    prompts = _prompts(4)
    jeng = jsv.ServingEngine(JCFG, jparams, num_pages=64, page_size=8,
                             max_batch=4, prefill_budget=96,
                             clock=jsv.SimClock())
    jreqs = [jeng.submit(p, 12) for p in prompts]
    jeng.run()
    port, _ = _port_streams(tparams, prompts)
    assert port == [list(r.generated) for r in jreqs]
    # every greedy choice had a margin far above the sum-order noise:
    # score each stream teacher-forced in one prefill row
    dec = tsv.PagedDecoder(TCFG)
    for prompt, gen in zip(prompts, port):
        seq = prompt + gen[:-1]
        tokens, seg, pos = (np.zeros((1, 96), np.int32) for _ in range(3))
        tokens[0, :len(seq)], seg[0, :len(seq)] = seq, 1
        pos[0, :len(seq)] = np.arange(len(seq))
        logits, _, _ = dec.prefill(tparams, *(torch.tensor(a)
                                              for a in (tokens, seg, pos)))
        rows = logits[0, len(prompt) - 1:len(seq)]
        top2 = rows.topk(2, dim=-1).values
        assert rows.argmax(-1).tolist() == gen
        assert float((top2[:, 0] - top2[:, 1]).min()) > 100 * TOL


def test_batched_matches_sequential(tparams):
    prompts = _prompts(4)
    batched, eng = _port_streams(tparams, prompts, max_batch=4)
    one_at_a_time = []
    seq = _port_engine(tparams, max_batch=4)
    for p in prompts:
        r = seq.submit(p, 12)
        seq.run()
        one_at_a_time.append(list(r.generated))
    batch1, _ = _port_streams(tparams, prompts, max_batch=1)
    assert batched == one_at_a_time == batch1
    assert all(len(g) == 12 for g in batched)
    assert eng.cache.pages_used == 0 == seq.cache.pages_used


def test_preemption_is_output_invisible(tparams):
    prompts = _prompts(4)
    roomy, _ = _port_streams(tparams, prompts, num_pages=64)
    tight, eng = _port_streams(tparams, prompts, num_pages=9, mppr=4)
    assert sum(r.preemptions for r in eng.sched.finished) >= 1
    assert tight == roomy
    assert eng.cache.pages_used == 0


def test_serve_poisson_trace_drains(tparams):
    eng = _port_engine(tparams)
    eng.warmup()
    trace = tsv.poisson_trace(7, 6, rate=0.5, prompt_len=(4, 30),
                              max_new=(2, 10), vocab_size=64)
    done = eng.serve(trace)
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(len(r.generated) == r.max_new_tokens for r in done)
    assert all(r.first_token_t >= r.arrival_t for r in done)
    assert eng.cache.pages_used == 0


def test_poisson_trace_equals_jax():
    kw = dict(rate=2.0, prompt_len=(3, 9), max_new=(1, 5), vocab_size=50,
              deadline_s=(1.0, 4.0))
    for a, b in zip(jsv.poisson_trace(11, 5, **kw),
                    tsv.poisson_trace(11, 5, **kw)):
        assert (a.rid, a.prompt, a.max_new_tokens, a.arrival_t,
                a.deadline_s) == (b.rid, b.prompt, b.max_new_tokens,
                                  b.arrival_t, b.deadline_s)


def test_cpu_engine_never_reaches_a_kernel(tparams):
    before = [k.launches for k in kernels.KERNELS]
    _port_streams(tparams, _prompts(2), max_new=3)
    assert [k.launches for k in kernels.KERNELS] == before


def test_default_device_is_the_card_and_never_falls_back(tparams,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsv.ServingEngine(TCFG, tparams, num_pages=8, page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsv.init_params(TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsv.params_from_jax({"embed": np.zeros((2, 2), np.float32)})


def test_unported_options_are_refused(tparams):
    # only tensor parallelism is left unported: tp=2 is refused, tp=1 (the
    # JAX engine's default) accepted
    with pytest.raises(NotImplementedError, match="tp"):
        tsv.ServingEngine(TCFG, tparams, num_pages=8, device="cpu", tp=2)
    # the JAX engine's rule: prefix sharing prefills a hit's suffix in
    # chunks, so it needs a chunk size
    with pytest.raises(ValueError, match="chunked prefill"):
        tsv.ServingEngine(TCFG, tparams, num_pages=8, page_size=8,
                          device="cpu", prefix_sharing=True)
    with pytest.raises(ValueError, match="chunked prefill"):
        tsv.ServingEngine(TCFG, tparams, num_pages=8, page_size=8,
                          device="cpu", prefix_sharing=True,
                          spec=tsv.SpecConfig(k=2))
    with pytest.raises(TypeError):
        tsv.ServingEngine(TCFG, tparams, num_pages=8, device="cpu",
                          no_such_option=1)
    # the five options that were refused are taken, with the JAX engine's
    # recovery knobs, and the six methods exist and run
    from apex_tpu_torch.resilience import Watchdog
    from apex_tpu_torch.telemetry import MemorySink, TelemetryBus
    bus = TelemetryBus(sinks=[MemorySink()])
    with Watchdog(60.0) as wd:
        eng = tsv.ServingEngine(TCFG, tparams, num_pages=8, page_size=8,
                                device="cpu", tp=1, telemetry=bus,
                                watchdog=wd, validate_pages=True,
                                recover_on_fault=True, max_recoveries=3,
                                prefill_only=True, kv_import=True,
                                clock=tsv.SimClock())
        eng.warmup()
        req = eng.submit([1, 2, 3], 4)
        eng.step()
    assert eng.cache.crc_pages and req.generated and not eng.decode_steps
    snap = eng.snapshot()
    assert snap["format"] == 1 and snap["requests"][0]["rid"] == req.rid
    record, payload, kv_len = eng.export_request(req.rid)
    dec = tsv.ServingEngine(TCFG, tparams, num_pages=8, page_size=8,
                            device="cpu", kv_import=True)
    dec.adopt_prefilled(record, payload, kv_len)
    dec.recover("device_loss")
    assert dec.recoveries == 1 and len(dec.sched.waiting) == 1
    fresh = tsv.ServingEngine(TCFG, tparams, num_pages=8, page_size=8,
                              device="cpu")
    assert len(fresh.restore(snap)) == 1
    assert len(fresh.adopt([dict(snap["requests"][0], rid=9)])) == 1
    assert bus.counts["request_admit"] == 1


def test_submit_rejects_what_can_never_be_served(tparams):
    eng = _port_engine(tparams)
    with pytest.raises(ValueError):
        eng.submit([1] * 90, 10)   # 100 > max_position 96
    with pytest.raises(ValueError):
        eng.submit([], 3)
    full = tsv.ServingEngine(TCFG, tparams, num_pages=64, page_size=8,
                             max_queue=1, device="cpu")
    full.submit([1, 2], 2)
    assert full.submit([1, 2], 2).finish_reason == "rejected"


# -- host-side policy: the pool and the scheduler against JAX's ------------


def _pools(num_pages=9):
    kw = dict(num_layers=1, num_pages=num_pages, page_size=4, num_heads=1,
              head_dim=8, max_pages_per_request=4)
    return jsv.PagedKVCache(**kw), tsv.PagedKVCache(**kw, device="cpu")


def test_page_accounting_matches_jax():
    jc, tc = _pools()
    for c in (jc, tc):
        a = c.allocate(3, owner=0)
        b = c.allocate(2, owner=1)
        c.share(b)
        c.free(a[1:2])
        c.free(b)              # refcount 2 -> 1: still allocated
        tail = a + [c.allocate(1, owner=0)[0]]
        c.free_tail(tail, 2)
    assert tc.pages_free == jc.pages_free and tc.pages_used == jc.pages_used
    assert tc._free == jc._free and tc._ref == jc._ref
    assert tc._owner == jc._owner
    for c in (jc, tc):
        with pytest.raises(jsv.PagePoolExhausted if c is jc
                           else tsv.PagePoolExhausted):
            c.allocate(99, owner=2)
        with pytest.raises(ValueError):
            c.free([0])
    np.testing.assert_array_equal(
        tc.page_table([[3, 1], [2]], rows=3),
        np.asarray(jc.page_table([[3, 1], [2]], rows=3)))


def test_write_tokens_matches_jax():
    jc, tc = _pools()
    rng = np.random.RandomState(2)
    k = rng.randn(1, 5, 1, 8).astype(np.float32)
    v = rng.randn(1, 5, 1, 8).astype(np.float32)
    pages = np.array([3, 3, 5, 1, 2], np.int32)
    offs = np.array([0, 3, 1, 2, 0], np.int32)
    jc.write_tokens(jnp.asarray(k), jnp.asarray(v), pages, offs)
    tc.write_tokens(torch.tensor(k), torch.tensor(v), torch.tensor(pages),
                    torch.tensor(offs))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def test_scheduler_decisions_match_jax():
    # the same requests through both schedulers over a tight pool:
    # admissions, page lists, growth, preemption victims, deadline
    # sheds/timeouts and retirements must agree step by step
    jc, tc = _pools(num_pages=7)
    scheds = [
        jsv.ContinuousBatchingScheduler(jc, max_batch=3, prefill_budget=24,
                                        max_position=24, preempt_cap=2),
        tsv.ContinuousBatchingScheduler(tc, max_batch=3, prefill_budget=24,
                                        max_position=24, preempt_cap=2)]
    mods = (jsv, tsv)
    for sched, mod in zip(scheds, mods):
        for rid in range(6):
            sched.submit(mod.Request(
                rid=rid, prompt=[1] * (3 + rid), max_new_tokens=6,
                deadline_s=9.0 if rid == 5 else None))

    def state(s):
        return ([(r.rid, list(r.pages), r.preemptions) for r in s.running],
                [r.rid for r in s.waiting],
                [(r.rid, r.finish_reason) for r in s.finished])

    for step in range(40):
        now = float(step)
        for s in scheds:
            s.expire_deadlines(now)
            s.retire_finished(now)
            s.admit()
            s.ensure_decode_capacity()
            for r in s.running:
                r.generated.append(7)
        assert state(scheds[1]) == state(scheds[0]), step
        if scheds[0].idle:
            break
    assert scheds[1].idle and tc.pages_used == 0
    reasons = {r.rid: r.finish_reason for r in scheds[1].finished}
    assert sum(r.preemptions for r in scheds[1].finished) >= 1
    assert reasons == {0: "length", 1: "length", 2: "length", 3: "length",
                       4: "length", 5: "timeout"}


# -- the port stands alone -------------------------------------------------


def test_import_pulls_in_neither_jax_nor_apex_tpu():
    code = ("import sys, apex_tpu_torch, apex_tpu_torch.ops, "
            "apex_tpu_torch.serving, apex_tpu_torch.serving.spec, "
            "apex_tpu_torch.kernels, apex_tpu_torch.amp, "
            "apex_tpu_torch.utils, apex_tpu_torch.optimizers\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apex_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_source_never_imports_jax_or_apex_tpu():
    files = sorted((REPO / "apex_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 10
    spec = REPO / "apex_tpu_torch" / "serving" / "spec"
    assert {spec / f"{m}.py" for m in ("__init__", "proposer",
                                       "verify")} <= set(files)
    pkg = REPO / "apex_tpu_torch"
    assert {pkg / "amp" / f"{m}.py" for m in (
        "__init__", "scaler", "properties", "handle", "lists", "opt")} | {
        pkg / "utils" / "tree.py"} | {pkg / "optimizers" / f"{m}.py" for m in (
            "base", "fused_sgd", "fused_lamb", "fused_novograd",
            "fused_adagrad", "larc")} <= set(files)
    assert {pkg / "checkpoint" / f"{m}.py" for m in (
        "__init__", "checkpoint", "train_state")} | {
        pkg / "data" / f"{m}.py" for m in (
            "__init__", "records", "iterator", "native", "prefetch")} | {
        pkg / "resilience" / f"{m}.py" for m in (
            "async_checkpoint", "guards", "preemption", "restore")} | {
        pkg / "_native" / "__init__.py",
        pkg / "telemetry" / "accounting.py",
        pkg / "transformer" / "testing" / "train_loop.py"} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "apex_tpu"), (path, name)
