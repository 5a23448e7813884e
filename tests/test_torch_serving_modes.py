"""Parity of the port's serving modes (speculative verify, chunked
prefill, prefix sharing) with the JAX package's, and the port's own
contracts for them, on the CPU at the JAX serving toy (vocab 64, hidden
32, 4 heads, 2 layers, max_position 96, page 8).

Tolerances: fp32 logits and K/V 1e-5 x max(1, max|ref|), as in
``test_torch_serving.py`` (torch and XLA sum in different orders); a
bf16 model's logits and pool 2^-6 x max(1, max|ref|), four bf16 ulps at
the output's scale (both round at every op, the sums in another order).
A quantized pool: codes within one quantization step of JAX's and scales
2^-8 relative (the K/V fed to the quantizer differ in the last fp32
bits, and layer 1's follow layer 0's attention over codes that may sit a
step apart: 1.4e-5 relative here); layer 0's codes and scales bit for
bit JAX's ``quantize_tokens`` of the port's own K/V; the logits within
2^-8 x max(1, max|ref|), since a window token whose code lands one fp8
step from JAX's moves the later rows' logits (5.1e-4 at a scale of 1.7
here).  Host policy (``commit_tokens``, ``NgramProposer``,
``PrefixIndex``, the scheduler) and token streams exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import serving as jsv
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import spec as jspec
from apex_tpu_torch import kernels
from apex_tpu_torch import serving as tsv
from apex_tpu_torch.serving import model as tmodel
from apex_tpu_torch.serving import spec as tspec

TOL = 1e-5
BF16_TOL = 2.0 ** -6
QUANT_TOL = 2.0 ** -8
TOY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
           max_position=96)
JCFG = jsv.ServingModelConfig(**TOY)
TCFG = tsv.ServingModelConfig(**TOY)
PAGE = 8


@pytest.fixture(scope="module")
def jparams():
    return jsv.init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tsv.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


# -- PagedDecoder.extend against JAX's ---------------------------------------

# rows of one extend call at q = 5 over pages of 8: (kv_len, real tokens);
# row 0 starts a sequence (kv_len 3 < q: its first two rows see nothing),
# row 1 is a full draft, row 2 a 2-token window, front-padded, and row 3
# is idle (kv_len == q over the scratch page)
Q = 5
EXTEND_ROWS = ((3, 3), (21, 5), (12, 2), (Q, 0))


def _extend_operands(rng, q=Q, rows=EXTEND_ROWS, p_max=4, n_pages=16):
    b = len(rows)
    tokens = np.zeros((b, q), np.int32)
    positions = np.zeros((b, q), np.int32)
    wpages = np.zeros((b, q), np.int32)
    woffs = np.zeros((b, q), np.int32)
    table = np.zeros((b, p_max), np.int32)
    kv_len = np.array([n for n, _ in rows], np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, (n, real) in enumerate(rows):
        if not real:
            continue
        pages = [int(free.pop()) for _ in range(-(-n // PAGE))]
        table[i, :len(pages)] = pages
        pos = np.arange(n - real, n)
        tokens[i, q - real:] = rng.randint(0, TOY["vocab_size"], real)
        positions[i, q - real:] = pos
        wpages[i, q - real:] = np.asarray(pages)[pos // PAGE]
        woffs[i, q - real:] = pos % PAGE
    return tokens, positions, wpages, woffs, table, kv_len


def _real_rows(rows=EXTEND_ROWS, q=Q):
    """(row, query row) of every real token whose window is not empty."""
    return [(i, r) for i, (n, real) in enumerate(rows)
            for r in range(q - real, q) if n - q + r >= 0]


def _pool_outside_scratch(pool):
    return np.asarray(pool, np.float32)[:, 1:]


@pytest.mark.parametrize("last_only", [False, True], ids=["all", "last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extend_matches_jax(jparams, dtype, last_only):
    jcfg = jsv.ServingModelConfig(**TOY, dtype=getattr(jnp, dtype))
    tcfg = tsv.ServingModelConfig(**TOY, dtype=getattr(torch, dtype))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jcfg.dtype), jparams)
    tp = tsv.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    rng = np.random.RandomState(4)
    shape = (2, 16, PAGE, 4, 8)
    k0 = rng.randn(*shape).astype(np.float32)
    v0 = rng.randn(*shape).astype(np.float32)
    ops = _extend_operands(rng)
    jl, jk, jv = jsv.PagedDecoder(jcfg).extend(
        jp, jnp.asarray(k0, jcfg.dtype), jnp.asarray(v0, jcfg.dtype),
        *(jnp.asarray(a) for a in ops), last_only=last_only)
    tk = torch.tensor(k0).to(tcfg.dtype)
    tv = torch.tensor(v0).to(tcfg.dtype)
    tl = tsv.PagedDecoder(tcfg).extend(
        tp, tk, tv, *(torch.tensor(a) for a in ops), last_only=last_only)
    assert tl.shape == jl.shape == (len(EXTEND_ROWS), 1 if last_only else Q,
                                    TOY["vocab_size"])
    tol = TOL if dtype == "float32" else BF16_TOL
    jl = np.asarray(jl, np.float32)
    if last_only:
        live = [i for i, (n, real) in enumerate(EXTEND_ROWS) if real]
        _close(tl.float().numpy()[live, 0], jl[live, 0], tol)
    else:
        idx = tuple(np.array(a) for a in zip(*_real_rows()))
        _close(tl.float().numpy()[idx], jl[idx], tol)
    # the port wrote its pools in place; scratch page 0 took the pad
    # rows' duplicate writes in an unspecified order, so it is left out
    _close(_pool_outside_scratch(tk.float()), _pool_outside_scratch(jk), tol)
    _close(_pool_outside_scratch(tv.float()), _pool_outside_scratch(jv), tol)


def test_extend_last_only_is_the_last_row(tparams):
    rng = np.random.RandomState(5)
    shape = (2, 16, PAGE, 4, 8)
    k0 = torch.tensor(rng.randn(*shape).astype(np.float32))
    v0 = torch.tensor(rng.randn(*shape).astype(np.float32))
    ops = [torch.tensor(a) for a in _extend_operands(rng)]
    dec = tsv.PagedDecoder(TCFG)
    full = dec.extend(tparams, k0.clone(), v0.clone(), *ops)
    last = dec.extend(tparams, k0.clone(), v0.clone(), *ops, last_only=True)
    # the LM head's GEMM has another shape, so its sums may round apart
    assert last.shape == (len(EXTEND_ROWS), 1, TOY["vocab_size"])
    _close(last[:, 0].numpy(), full[:, -1].numpy())


def _jax_codes_as_torch(codes, mode):
    return torch.from_numpy(np.asarray(codes).view(np.uint8).copy()).view(
        tsv.quant_pool_dtype(mode))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_extend_matches_jax(jparams, tparams, mode):
    rng = np.random.RandomState(6)
    qdtype, qmax = jkv.quant_pool_dtype(mode), jkv._QUANT_QMAX[mode]
    shape = (2, 16, PAGE, 4, 8)
    kc, ks = jkv.quantize_tokens(
        jnp.asarray(rng.randn(*shape).astype(np.float32)), qdtype, qmax)
    vc, vs = jkv.quantize_tokens(
        jnp.asarray(rng.randn(*shape).astype(np.float32)), qdtype, qmax)
    ops = _extend_operands(rng)
    jl, jk, jv, jks, jvs = jsv.PagedDecoder(JCFG).extend(
        jparams, kc, vc, *(jnp.asarray(a) for a in ops), k_scale=ks,
        v_scale=vs)
    tk, tv = _jax_codes_as_torch(kc, mode), _jax_codes_as_torch(vc, mode)
    tks, tvs = torch.tensor(np.asarray(ks)), torch.tensor(np.asarray(vs))
    tops = [torch.tensor(a) for a in ops]
    tl = tsv.PagedDecoder(TCFG).extend(tparams, tk, tv, *tops, k_scale=tks,
                                       v_scale=tvs)
    idx = tuple(np.array(a) for a in zip(*_real_rows()))
    _close(tl.numpy()[idx], np.asarray(jl)[idx], QUANT_TOL)
    step = 1.0 if mode == "int8" else None
    for got, ref in ((tk, jk), (tv, jv)):
        g = _pool_outside_scratch(got.float())
        r = _pool_outside_scratch(np.asarray(ref, np.float32))
        if step:
            assert np.abs(g - r).max() <= step
        else:   # fp8: one e4m3 step at the code's magnitude (3 bits)
            assert (np.abs(g - r) <= np.abs(r) * 2.0 ** -3 + 2.0 ** -9).all()
    for got, ref in ((tks, jks), (tvs, jvs)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(ref)[:, 1:], rtol=QUANT_TOL,
                                   atol=0)
    # layer 0's K/V are the port's own: JAX's quantizer of them gives the
    # written codes and scales bit for bit
    tokens, positions, wpages, woffs = tops[:4]
    x = tparams["embed"][tokens] + tparams["pos"][positions]
    layer = tparams["layers"][0]
    qkv = tmodel._ln(x, layer["ln1"]) @ layer["wqkv"]
    kv = qkv[..., TOY["hidden_size"]:].reshape(len(EXTEND_ROWS), Q, 2, 4, 8)
    real = wpages > 0
    for which, (pool, scale) in enumerate(((tk, tks), (tv, tvs))):
        codes, sc = jkv.quantize_tokens(
            jnp.asarray(kv[:, :, which].numpy()), qdtype, qmax)
        at = (wpages[real], woffs[real])
        np.testing.assert_array_equal(
            pool[0][at].view(torch.uint8).numpy(),
            np.asarray(codes).view(np.uint8)[real.numpy()])
        np.testing.assert_array_equal(
            scale[0][at].numpy().view(np.int32),
            np.asarray(sc).view(np.int32)[real.numpy()])


# -- host policy: commit_tokens, NgramProposer, SpecConfig --------------------


def test_commit_tokens_matches_jax():
    rng = np.random.RandomState(7)
    for _ in range(400):
        j = int(rng.randint(0, 6))
        draft = [int(t) for t in rng.randint(0, 4, j)]
        argmax = [int(t) for t in rng.randint(0, 4, j + 1)]
        if rng.rand() < 0.5:       # a long accepted prefix, now and then
            a = int(rng.randint(0, j + 1))
            argmax[:a] = draft[:a]
        eos = None if rng.rand() < 0.5 else int(rng.randint(0, 4))
        remaining = int(rng.randint(1, 8))
        assert tspec.commit_tokens(draft, argmax, eos_id=eos,
                                   remaining=remaining) == \
            jspec.commit_tokens(draft, argmax, eos_id=eos,
                                remaining=remaining)
    for mod in (tspec, jspec):
        with pytest.raises(ValueError):
            mod.commit_tokens([1, 2], [1, 2], eos_id=None, remaining=3)
        with pytest.raises(ValueError):
            mod.commit_tokens([1], [1, 2], eos_id=None, remaining=0)


def test_ngram_proposer_matches_jax():
    rng = np.random.RandomState(8)
    port, ref = tspec.NgramProposer(ngram_n=3), jspec.NgramProposer(ngram_n=3)
    hist = {rid: [int(t) for t in rng.randint(0, 5, 4)] for rid in range(3)}
    for it in range(300):
        rid = int(rng.randint(0, 3))
        roll = rng.rand()
        if roll < 0.05:            # the rid is reused with a new history
            hist[rid] = [int(t) for t in rng.randint(0, 5, 3)]
        elif roll < 0.1:           # the history shrinks
            hist[rid] = hist[rid][:max(1, len(hist[rid]) - 2)]
        elif roll < 0.13:
            port.release(rid)
            ref.release(rid)
        else:
            hist[rid] += [int(t) for t in rng.randint(0, 5,
                                                     rng.randint(1, 3))]
        k = int(rng.randint(0, 6))
        got = port.propose(rid, hist[rid], k)
        assert got == ref.propose(rid, hist[rid], k), (it, rid)
        port.observe(len(got), len(got) // 2)
        ref.observe(len(got), len(got) // 2)
    assert port.drafted == ref.drafted > 0
    assert port.acceptance_rate == ref.acceptance_rate
    assert isinstance(port, tspec.Proposer)
    with pytest.raises(ValueError):
        tspec.NgramProposer(ngram_n=0)


@pytest.mark.parametrize("kw", [dict(k=-1), dict(k=0),
                                dict(k=2, chunk_size=0)])
def test_spec_config_validates_as_jax(kw):
    with pytest.raises(ValueError):
        jspec.SpecConfig(**kw)
    with pytest.raises(ValueError):
        tsv.SpecConfig(**kw)


# -- PrefixIndex and copy-on-write against JAX's ------------------------------


def _caches(num_pages=12, quantize=None):
    kw = dict(num_layers=1, num_pages=num_pages, page_size=4, num_heads=2,
              head_dim=4, max_pages_per_request=6, quantize=quantize)
    return jsv.PagedKVCache(**kw), tsv.PagedKVCache(**kw, device="cpu")


def _accounting(c):
    return (list(c._free), dict(c._ref), dict(c._owner), c.pages_shared,
            c.pages_used)


def test_prefix_index_matches_jax():
    jc, tc = _caches()
    ji = jsv.PrefixIndex(jc, max_entries=3)
    ti = tsv.PrefixIndex(tc, max_entries=3)
    rng = np.random.RandomState(9)
    head = [1, 2, 3, 4, 5, 6]
    owned = {}
    for it in range(120):
        roll = rng.rand()
        ctx = head[:int(rng.randint(0, 7))] + [int(t) for t in rng.randint(
            0, 3, rng.randint(1, 9))]
        if roll < 0.35 and jc.pages_free >= jc.pages_needed(len(ctx)):
            rid = it
            pj = jc.allocate(jc.pages_needed(len(ctx)), rid)
            pt = tc.allocate(tc.pages_needed(len(ctx)), rid)
            assert pj == pt
            aligned = len(ctx) // 4 * 4
            assert ji.register(ctx[:aligned], pj[:aligned // 4]) == \
                ti.register(ctx[:aligned], pt[:aligned // 4])
            owned[rid] = pt
        elif roll < 0.7:
            assert ti.lookup(ctx) == ji.lookup(ctx), it
        elif roll < 0.8:
            assert ti.evict_one() == ji.evict_one()
        elif owned:
            rid = sorted(owned)[int(rng.randint(0, len(owned)))]
            pages = owned.pop(rid)
            jc.free(pages)
            tc.free(pages)
        assert ti.entries == ji.entries
        assert _accounting(tc) == _accounting(jc), it
        for p in range(1, jc.num_pages):
            assert tc.refcount(p) == jc.refcount(p)
            assert tc.owner_of(p) == jc.owner_of(p)
    assert ti.clear() == ji.clear()
    for pages in owned.values():
        tc.free(pages)
    assert tc.pages_used == 0 and len(ti) == 0
    for idx in (ti, ji):
        with pytest.raises(ValueError):
            idx.register(list(range(8)), [1])       # two pages' tokens


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cow_gives_a_private_copy_as_jax(quantize):
    jc, tc = _caches(quantize=quantize)
    rng = np.random.RandomState(10)
    k = rng.randn(1, 4, 2, 4).astype(np.float32)
    v = rng.randn(1, 4, 2, 4).astype(np.float32)
    [p] = jc.allocate(1, owner=1)
    assert tc.allocate(1, owner=1) == [p]
    jc.write_tokens(jnp.asarray(k), jnp.asarray(v), np.full(4, p, np.int32),
                    np.arange(4, dtype=np.int32))
    planes = ("k", "v") + (("k_scale", "v_scale") if quantize else ())
    for name in planes:      # the same content in both pools
        getattr(tc, name).copy_(torch.from_numpy(np.array(getattr(jc,
                                                                  name))))
    for c in (jc, tc):
        c.share([p])
        new = c.cow(p, owner=2)
        assert new != p and c.refcount(p) == c.refcount(new) == 1
        assert c.owner_of(new) == 2 and not c.is_shared(p)
        with pytest.raises(ValueError):
            c.cow(p, owner=3)          # an unshared page needs no copy
    assert _accounting(tc) == _accounting(jc)
    for name in planes:
        t = getattr(tc, name)
        assert torch.equal(t[:, new], t[:, p]) and bool(t[:, p].any())
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jc,
                                                                    name)))
    # writing the copy leaves the original's content alone
    before = tc.k[:, p].clone()
    tc.write_tokens(torch.tensor(-k), torch.tensor(-v),
                    torch.full((4,), new, dtype=torch.int32),
                    torch.arange(4, dtype=torch.int32))
    assert torch.equal(tc.k[:, p], before)
    assert not torch.equal(tc.k[:, new], before)
    tc.warm_copy()
    assert torch.equal(tc.k[:, p], before)


# -- the scheduler against JAX's schedule_prefill ----------------------------


def _requests(mod, seed):
    rng = np.random.RandomState(seed)
    head = [9, 8, 7, 6, 5, 4, 3, 2]           # two pages of 4
    prompts = []
    for i in range(9):
        if i in (4, 7):                        # exact repeats: mid-page hits
            prompts.append(list(prompts[i - 3]))
            continue
        tail = [int(t) for t in rng.randint(0, 5, rng.randint(2, 14))]
        prompts.append((head[:int(rng.randint(0, 9))] if i % 3 else head)
                       + tail)
    return [mod.Request(rid=i, prompt=p,
                        max_new_tokens=int(rng.randint(2, 9)),
                        deadline_s=14.0 if i == 8 else None)
            for i, p in enumerate(prompts)]


def _policy_step(sched, now, rng):
    """One engine step of host policy, device work stood in for: the
    same decisions as the engine, with tokens and acceptances drawn from
    a seeded generator."""
    log = []
    sched.expire_deadlines(now)
    sched.retire_finished(now)
    chunks, admitted = sched.schedule_prefill()
    log.append([(r.rid, s, n) for r, s, n in chunks])
    log.append([(r.rid, r.prefix_hit, list(r.pages)) for r in admitted])

    def register(req):
        aligned = req.seq_len // 4 * 4
        if sched.prefix_index is not None and aligned >= 4:
            sched.prefix_index.register(req.context[:aligned],
                                        req.pages[:aligned // 4])

    for req in admitted:
        if req.prefill_pos is None:
            req.kv_len = req.seq_len
            register(req)
            req.generated.append(int(rng.randint(0, 3)))
    for req, start, n in chunks:
        req.kv_len = req.prefill_pos = start + n
        if req.prefill_pos >= req.seq_len:
            req.prefill_pos = None
            register(req)
            req.generated.append(int(rng.randint(0, 3)))
    sched.retire_finished(now)
    drafts = {r.rid: int(rng.randint(0, 3)) for r in sched.running
              if r.prefill_pos is None}
    drafts = {rid: min(j, r.max_new_tokens - len(r.generated) - 1)
              for r in sched.running for rid, j in drafts.items()
              if r.rid == rid}
    evicted = sched.ensure_decode_capacity(
        extra={rid: j for rid, j in drafts.items() if j > 0} or None)
    log.append([r.rid for r in evicted])
    for req in sched.running:
        if req.prefill_pos is not None:
            continue
        j = max(drafts.get(req.rid, 0), 0)
        a = int(rng.randint(0, j + 1))
        S = req.seq_len
        take = min(a + 1, req.max_new_tokens - len(req.generated))
        req.generated += [int(t) for t in rng.randint(0, 3, take)]
        req.kv_len = S + min(take, a)
        sched.cache.free_tail(req.pages, sched.cache.pages_needed(
            max(req.seq_len, req.kv_len)))
    return log


def _sched_state(s):
    return ([(r.rid, list(r.pages), r.preemptions, r.prefill_pos,
              r.prefix_hit, r.kv_len, list(r.generated)) for r in s.running],
            [r.rid for r in s.waiting],
            [(r.rid, r.finish_reason) for r in s.finished],
            _accounting(s.cache),
            s.prefix_index.entries if s.prefix_index is not None else None)


@pytest.mark.parametrize("share", [False, True], ids=["chunked", "shared"])
def test_schedule_prefill_matches_jax_step_by_step(share):
    jc, tc = _caches(num_pages=14)
    scheds = []
    for mod, c in ((jsv, jc), (tsv, tc)):
        index = mod.PrefixIndex(c, max_entries=3) if share else None
        s = mod.ContinuousBatchingScheduler(
            c, max_batch=3, prefill_budget=12, max_position=40,
            preempt_cap=2, chunk_size=6, prefix_index=index)
        for req in _requests(mod, seed=11):
            s.submit(req)
        scheds.append(s)
    rngs = [np.random.RandomState(12), np.random.RandomState(12)]
    seen = {"chunks": 0, "hits": 0, "preempted": 0}
    for step in range(200):
        logs = [_policy_step(s, float(step), g) for s, g in zip(scheds,
                                                                rngs)]
        assert logs[1] == logs[0], step
        assert _sched_state(scheds[1]) == _sched_state(scheds[0]), step
        seen["chunks"] += len(logs[1][0])
        seen["hits"] += sum(hit for _, hit, _ in logs[1][1])
        seen["preempted"] += len(logs[1][2])
        if scheds[0].idle:
            break
    assert scheds[1].idle
    assert seen["chunks"] > 0 and seen["preempted"] > 0
    if share:
        assert seen["hits"] > 0 and scheds[1].cows > 0
        scheds[1].prefix_index.clear()
        scheds[0].prefix_index.clear()
    assert tc.pages_used == 0 == jc.pages_used
    reasons = {r.rid: r.finish_reason for r in scheds[1].finished}
    assert reasons.pop(8) in ("shed", "timeout")     # its deadline
    assert set(reasons.values()) == {"length"}


def test_scheduler_checks_match_jax():
    jc, tc = _caches()
    for mod, c in ((jsv, jc), (tsv, tc)):
        with pytest.raises(ValueError, match="chunk_size"):
            mod.ContinuousBatchingScheduler(c, max_batch=2, prefill_budget=8,
                                            max_position=40, chunk_size=9)
        with pytest.raises(ValueError, match="prefix sharing"):
            mod.ContinuousBatchingScheduler(
                c, max_batch=2, prefill_budget=8, max_position=40,
                prefix_index=mod.PrefixIndex(c))
        chunked = mod.ContinuousBatchingScheduler(
            c, max_batch=2, prefill_budget=8, max_position=40, chunk_size=4)
        # past the prefill row: only a chunked scheduler takes it
        chunked.submit(mod.Request(rid=0, prompt=[1] * 10, max_new_tokens=4))
        with pytest.raises(RuntimeError, match="schedule_prefill"):
            chunked.admit()
        whole = mod.ContinuousBatchingScheduler(
            c, max_batch=2, prefill_budget=8, max_position=40)
        with pytest.raises(ValueError, match="prefill budget"):
            whole.submit(mod.Request(rid=1, prompt=[1] * 10,
                                     max_new_tokens=4))


# -- the engine: streams against JAX's and the plain engine's ---------------

MODES = {
    "spec": dict(spec=dict(k=4)),
    "chunked": dict(spec=dict(k=0, chunk_size=16)),
    "spec_chunked": dict(spec=dict(k=3, chunk_size=16)),
    "shared": dict(spec=dict(k=4, chunk_size=16), prefix_sharing=True),
}


def _mode_prompts():
    """Short prompts and ones past the chunk; the last two share a
    17-token head with an earlier prompt (a hit over two pages), and one
    repeats an earlier 24-token prompt exactly (a hit ending mid-page:
    copy-on-write)."""
    rng = np.random.RandomState(13)
    prompts = [[int(t) for t in rng.randint(0, TOY["vocab_size"], n)]
               for n in (6, 24, 40, 11)]
    prompts.append(prompts[2][:17] + [int(t) for t in rng.randint(0, 64, 9)])
    prompts.append(list(prompts[1]))
    return prompts


def _engine(mod, cfg, params, mode, **kw):
    opts = dict(MODES[mode]) if mode else {}
    if "spec" in opts:
        opts["spec"] = mod.SpecConfig(**opts["spec"])
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_batch", 4)
    if mod is tsv:
        kw["device"] = "cpu"
    return mod.ServingEngine(cfg, params, page_size=PAGE,
                             prefill_budget=TOY["max_position"],
                             clock=mod.SimClock(), **opts, **kw)


def _serve(eng, prompts, max_new=12):
    reqs = []
    for p in prompts:
        reqs.append(eng.submit(p, max_new))
        eng.step()                     # staggered arrivals
    eng.run()
    return [list(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def plain_streams(tparams):
    return _serve(_engine(tsv, TCFG, tparams, None), _mode_prompts())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_match_jax_and_plain(jparams, tparams, plain_streams,
                                            mode):
    prompts = _mode_prompts()
    jeng = _engine(jsv, JCFG, jparams, mode)
    ref = _serve(jeng, prompts)
    eng = _engine(tsv, TCFG, tparams, mode)
    eng.warmup()
    got = _serve(eng, prompts)
    assert got == ref == plain_streams
    spec = MODES[mode]["spec"]
    if spec["k"]:
        assert eng.verify_steps > 0 and 0 < eng.spec_accepted \
            <= eng.spec_drafted
        assert eng.proposer.acceptance_rate == jeng.proposer.acceptance_rate
        assert eng.spec_committed >= eng.spec_accepted + eng.verify_steps
    if spec.get("chunk_size"):
        assert eng.chunk_steps > 0
    if mode == "shared":
        hits = [r.prefix_hit for r in eng.sched.finished]
        assert eng.prefix_hits == sum(hits) >= 2 and eng.cows >= 1
        assert eng.prefix_index.entries == jeng.prefix_index.entries
        eng.prefix_index.clear()
    assert eng.cache.pages_used == 0
    assert not eng.proposer or not eng.proposer._index


def test_modes_on_a_quantized_pool_match_jax(jparams, tparams):
    # quantize-on-write in the verify and chunk steps, and the scale
    # planes copied with a shared page's codes
    prompts = _mode_prompts()
    ref = _serve(_engine(jsv, JCFG, jparams, "shared", kv_quant="int8"),
                 prompts)
    eng = _engine(tsv, TCFG, tparams, "shared", kv_quant="int8")
    got = _serve(eng, prompts)
    plain = _serve(_engine(tsv, TCFG, tparams, None, kv_quant="int8"),
                   prompts)
    assert got == ref == plain
    assert eng.cows >= 1 and eng.verify_steps > 0 and eng.chunk_steps > 0


@pytest.mark.parametrize("mode", ["spec_chunked", "shared"])
def test_modes_batched_matches_sequential_and_rerun(tparams, plain_streams,
                                                    mode):
    prompts = _mode_prompts()
    batched = _serve(_engine(tsv, TCFG, tparams, mode), prompts)
    again = _serve(_engine(tsv, TCFG, tparams, mode), prompts)
    seq = _engine(tsv, TCFG, tparams, mode)
    one_at_a_time = []
    for p in prompts:
        r = seq.submit(p, 12)
        seq.run()
        one_at_a_time.append(list(r.generated))
    assert batched == again == one_at_a_time == plain_streams


@pytest.mark.parametrize("mode", ["spec", "spec_chunked"])
def test_preemption_mid_draft_and_mid_chunk_is_output_invisible(
        tparams, plain_streams, mode):
    eng = _engine(tsv, TCFG, tparams, mode, num_pages=12,
                  max_pages_per_request=7)
    got = _serve(eng, _mode_prompts())
    assert sum(r.preemptions for r in eng.sched.finished) >= 1
    assert got == plain_streams
    assert eng.cache.pages_used == 0


class _FixedProposer:
    """Proposes the same draft for every request (empty: never drafts)."""

    def __init__(self, draft):
        self.draft = list(draft)
        self.observed = []
        self.released = []

    def propose(self, rid, context, k):
        return self.draft[:k]

    def observe(self, drafted, accepted):
        self.observed.append((drafted, accepted))

    def release(self, rid):
        self.released.append(rid)


def test_rejected_draft_rolls_back_kv_len_and_pages(tparams):
    # a draft the model never emits (tokens past the greedy stream's
    # reach are rejected at the first row): one token a step, kv_len
    # over the committed tokens only, no page kept for the draft
    prompt = _mode_prompts()[0]
    plain = _serve(_engine(tsv, TCFG, tparams, None), [prompt], max_new=10)
    bad = [(plain[0][0] + 1) % 64] * 4
    eng = tsv.ServingEngine(TCFG, tparams, num_pages=64, page_size=4,
                            max_batch=4, prefill_budget=96,
                            clock=tsv.SimClock(), device="cpu",
                            spec=tsv.SpecConfig(k=4,
                                                proposer=_FixedProposer(bad)))
    req = eng.submit(prompt, 10)
    eng.step()                                   # prefill + one verify
    assert eng.verify_steps == 1 and len(req.generated) == 2
    assert req.kv_len == len(prompt) + 1 == req.seq_len - 1
    assert len(req.pages) == eng.cache.pages_needed(req.seq_len)
    assert eng.proposer.observed == [(4, 0)]
    eng.run()
    assert req.generated == plain[0]
    # the last token has no room for a draft: a decode step
    assert eng.spec_accepted == 0 and eng.spec_committed == 8
    assert eng.verify_steps == 8 and eng.decode_steps == 1
    assert eng.proposer.released == [req.rid]


def test_empty_drafts_fall_back_to_the_decode_step(tparams, plain_streams):
    eng = _engine(tsv, TCFG, tparams, None,
                  spec=tsv.SpecConfig(k=4, proposer=_FixedProposer([])))
    calls = []
    extend = eng.decoder.extend
    eng.decoder.extend = lambda *a, **kw: calls.append(1) or extend(*a, **kw)
    assert _serve(eng, _mode_prompts()) == plain_streams
    assert eng.verify_steps == 0 and not calls
    assert eng.decode_steps > 0


def test_proposer_state_is_released_on_every_terminal_path(tparams):
    prop = _FixedProposer([1, 2])
    eng = _engine(tsv, TCFG, tparams, None,
                  spec=tsv.SpecConfig(k=2, proposer=prop), max_batch=1)
    done = eng.submit([3] * 10, 6)
    # queued behind ``done`` past its deadline; then admitted, too slow
    shed = eng.submit([4] * 10, 5, deadline_s=3.0)
    late = eng.submit([5] * 10, 40, deadline_s=10.0)
    eng.run()
    reasons = {r.rid: r.finish_reason for r in eng.sched.finished}
    assert reasons == {done.rid: "length", shed.rid: "shed",
                       late.rid: "timeout"}
    assert sorted(prop.released) == sorted(reasons)


def test_modes_on_the_cpu_never_reach_a_kernel(tparams):
    before = [k.launches for k in kernels.KERNELS]
    _serve(_engine(tsv, TCFG, tparams, "shared"), _mode_prompts()[:3],
           max_new=4)
    assert [k.launches for k in kernels.KERNELS] == before


def test_chunked_engine_serves_past_the_prefill_row(tparams):
    eng = tsv.ServingEngine(TCFG, tparams, num_pages=64, page_size=PAGE,
                            max_batch=2, prefill_budget=32,
                            clock=tsv.SimClock(), device="cpu",
                            spec=tsv.SpecConfig(k=0, chunk_size=16))
    # the chunked default table reaches max_position, not the row
    assert eng.cache.max_pages_per_request == 96 // PAGE
    req = eng.submit(list(range(1, 61)), 20)      # 80 > the row's 32
    eng.run()
    assert len(req.generated) == 20 and eng.chunk_steps == 4
    plain = tsv.ServingEngine(TCFG, tparams, num_pages=64, page_size=PAGE,
                              max_batch=2, clock=tsv.SimClock(),
                              device="cpu")
    ref = plain.submit(list(range(1, 61)), 20)
    plain.run()
    assert req.generated == ref.generated
