"""Parity of the port's serving stack over a quantized KV pool
(``ServingEngine(..., kv_quant="int8" | "fp8")``) with the JAX package's,
and the port's own contracts there, on the CPU at toy width.

The toy model is ``tests/test_torch_serving.py``'s (vocab 64, hidden 32,
4 heads of 8, 2 layers, max_position 96, page 8, fp32), with the JAX
``init_params`` weights carried across.  Tolerances: logits 1e-5 x
max(1, max|ref|), as there; the pools' codes within one step of their
grid and the scales within one fp32 ulp, since the K/V being quantized
come out of products that round differently across frameworks and JAX's
jitted writer computes a scale as absmax x (1 / qmax) where its function
divides; token streams exactly, with every greedy choice's top-2 logit
margin far above the logit tolerance so the equality is not luck.  As in
JAX, the quantized streams are not held equal to the default pool's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import serving as jsv
from apex_tpu_torch import serving as tsv
from test_torch_decode_sm90 import codes_within_one_step

TOL = 1e-5
TOY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
           max_position=96)
JCFG = jsv.ServingModelConfig(**TOY)
TCFG = tsv.ServingModelConfig(**TOY)
MODES = ("int8", "fp8")


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


def _port_engine(params, mode, *, max_batch=4):
    return tsv.ServingEngine(TCFG, params, num_pages=64, page_size=8,
                             max_batch=max_batch,
                             prefill_budget=TOY["max_position"],
                             clock=tsv.SimClock(), kv_quant=mode,
                             device="cpu")


def _port_streams(params, mode, prompts, max_new=12, **kw):
    eng = _port_engine(params, mode, **kw)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    return [list(r.generated) for r in reqs], eng


def test_quant_qmax():
    assert tsv.quant_qmax(torch.int8) == 127.0
    assert tsv.quant_qmax(torch.float8_e4m3fn) == 448.0


@pytest.mark.parametrize("mode", MODES)
def test_quantized_decode_matches_jax(jparams, tparams, mode):
    rng = np.random.RandomState(1)
    L, n_pages, ps, H, D = 2, 10, 8, 4, 8
    qdtype, qmax = jsv.kv_cache.quant_pool_dtype(mode), \
        jsv.kv_cache._QUANT_QMAX[mode]
    # a pool the JAX quantizer filled from random K/V
    kc, ks = jsv.kv_cache.quantize_tokens(
        jnp.asarray(rng.randn(L, n_pages, ps, H, D).astype(np.float32)),
        qdtype, qmax)
    vc, vs = jsv.kv_cache.quantize_tokens(
        jnp.asarray(rng.randn(L, n_pages, ps, H, D).astype(np.float32)),
        qdtype, qmax)
    table = np.array([[3, 7, 0], [5, 0, 0], [0, 0, 0]], np.int32)
    positions = np.array([12, 4, 0], np.int32)   # last row idle
    kv_len = positions + 1
    tokens = np.array([5, 17, 0], np.int32)
    jl, jk, jv, jks, jvs = jsv.PagedDecoder(JCFG).decode(
        jparams, kc, vc, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(table), jnp.asarray(kv_len), k_scale=ks, v_scale=vs)

    def port(codes):
        return torch.from_numpy(np.asarray(codes).view(np.uint8).copy()
                                ).view(tsv.quant_pool_dtype(mode))

    tk, tv = port(kc), port(vc)
    tks, tvs = torch.tensor(np.asarray(ks)), torch.tensor(np.asarray(vs))
    tl = tsv.PagedDecoder(TCFG).decode(
        tparams, tk, tv, torch.tensor(tokens), torch.tensor(positions),
        torch.tensor(table), torch.tensor(kv_len), k_scale=tks, v_scale=tvs)
    _close(tl.numpy(), jl)
    # the port appended in place, codes beside their scales
    for got, ref in ((tk, jk), (tv, jv)):
        codes_within_one_step(got.float().numpy(),
                              np.asarray(ref, np.float32), mode)
    for got, ref in ((tks, jks), (tvs, jvs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=0)
    # the appended slots moved; the untouched ones kept their bytes
    moved = np.zeros((n_pages, ps), bool)
    moved[[7, 5, 0], [4, 4, 0]] = True
    before = np.asarray(ks)
    assert (tks.numpy()[:, ~moved] == before[:, ~moved]).all()
    assert (tks.numpy()[:, 7, 4] != before[:, 7, 4]).all()


@pytest.mark.parametrize("mode", MODES)
def test_quantized_engine_streams_match_jax_with_margin(jparams, tparams,
                                                        mode):
    prompts = _prompts(4)
    jeng = jsv.ServingEngine(JCFG, jparams, num_pages=64, page_size=8,
                             max_batch=4, prefill_budget=96,
                             clock=jsv.SimClock(), kv_quant=mode)
    jreqs = [jeng.submit(p, 12) for p in prompts]
    jeng.run()
    eng = _port_engine(tparams, mode)
    assert eng.cache.k.dtype == tsv.quant_pool_dtype(mode)
    # every logit row the port chose a token from, prefill and decode
    chosen = []
    prefill, decode = eng.decoder.prefill, eng.decoder.decode

    def record_prefill(*args, **kwargs):
        out = prefill(*args, **kwargs)
        chosen.append(out[0][0])
        return out

    def record_decode(*args, **kwargs):
        out = decode(*args, **kwargs)
        live = args[6] > 1          # idle rows sit at kv_len 1
        chosen.append(out[live])
        return out

    eng.decoder.prefill, eng.decoder.decode = record_prefill, record_decode
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.run()
    port = [list(r.generated) for r in reqs]
    assert port == [list(r.generated) for r in jreqs]
    rows = torch.cat(chosen)
    assert rows.shape[0] == sum(len(g) for g in port)
    top2 = rows.topk(2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 100 * TOL


@pytest.mark.parametrize("mode", MODES)
def test_quantized_batched_matches_sequential_and_itself(tparams, mode):
    prompts = _prompts(4)
    batched, eng = _port_streams(tparams, mode, prompts)
    again, _ = _port_streams(tparams, mode, prompts)
    one_at_a_time = []
    seq = _port_engine(tparams, mode)
    for p in prompts:
        r = seq.submit(p, 12)
        seq.run()
        one_at_a_time.append(list(r.generated))
    assert batched == one_at_a_time == again
    assert all(len(g) == 12 for g in batched)
    assert eng.cache.pages_used == 0 == seq.cache.pages_used


@pytest.mark.parametrize("mode", MODES)
def test_quantized_engine_warms_serves_and_drains(tparams, mode):
    eng = _port_engine(tparams, mode)
    eng.warmup()
    trace = tsv.poisson_trace(7, 6, rate=0.5, prompt_len=(4, 30),
                              max_new=(2, 10), vocab_size=64)
    done = eng.serve(trace)
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(len(r.generated) == r.max_new_tokens for r in done)
    assert eng.cache.pages_used == 0
    assert eng.kv_quant == mode and eng.cache.k_scale.abs().sum() > 0


def test_unknown_kv_quant_raises(tparams):
    with pytest.raises(ValueError, match="unknown quantize"):
        tsv.ServingEngine(TCFG, tparams, num_pages=8, page_size=8,
                          kv_quant="int4", device="cpu")
