"""The fp16 instances of K3, K4, K6 and K7 (amp's half) and the fp16
refusal of every other kernel.

fp16 runs the packed attention (``flash_qkv_{fwd,bwd}_sm90[_d64]_f16``)
and the LayerNorms (``layer_norm_{fwd,bwd}[_sm90]_f16``) on entry points
of their own, so their launches count apart; K1, K2, K5 and K10 keep
refusing fp16 with a ``TypeError``.  The kernels run only on the card
(``chip_smoke.py`` holds them to their plain versions there); here the
wrappers' choice of kernel is read with the ``Kernel`` objects replaced
by recorders, and the fp16 plain versions are held to the JAX package's
functions: ``flash_attention_qkv`` and its vjp (the XLA route on the
CPU), the Pallas packed kernels and LayerNorm kernels in interpret mode,
and ``layer_norm``.

Tolerance of the fp16 cases: 2^-10 x max|ref|, one fp16 ulp at the
output's scale (the bf16 rule at fp16's spacing); fp32 outputs (lse,
dweight, dbias) 1e-5 x max(1, max|ref|).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import ops as jops
from apex_tpu.ops import attention as jatt
from apex_tpu_torch import kernels
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import flash_attention_qkv
from apex_tpu_torch.ops import fused_layer_norm as tln
from apex_tpu_torch.profiling import roofs

FP16_TOL = 2.0 ** -10
FP32_TOL = 1e-5


def _close(got, ref, half=True):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    tol = FP16_TOL * scale if half else FP32_TOL * max(1.0, scale)
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol, (err, tol)


class _Recorder:
    def __init__(self, symbol):
        self.symbol = symbol
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)


# -- the plain versions at fp16 against JAX ------------------------------------


@pytest.mark.parametrize("hn,causal,rate", [(64, False, 0.1), (128, True, 0.1),
                                            (64, True, 0.0)])
def test_packed_attention_plain_fp16_matches_jax(hn, causal, rate):
    b, s, nh = 2, 32, 2
    rng = np.random.RandomState(5)
    qkv = rng.randn(b, s, nh * 3 * hn).astype(np.float32)
    dctx = rng.randn(b, s, nh * hn).astype(np.float32)
    seed = 7 if rate else None
    jqkv = jnp.asarray(qkv, jnp.float16)

    def f(x):
        return jatt.flash_attention_qkv(x, nh, causal=causal,
                                        dropout_rate=rate, dropout_seed=seed)

    jctx, vjp = jax.vjp(f, jqkv)
    (jd,) = vjp(jnp.asarray(dctx, jnp.float16))
    assert jctx.dtype == jd.dtype == jnp.float16
    tqkv = torch.tensor(qkv).half().requires_grad_()
    ctx = flash_attention_qkv(tqkv, nh, causal=causal, dropout_rate=rate,
                              dropout_seed=seed)
    ctx.backward(torch.tensor(dctx).half())
    assert ctx.dtype == tqkv.grad.dtype == torch.float16
    _close(ctx.detach().float(), jctx.astype(jnp.float32))
    _close(tqkv.grad.float(), jd.astype(jnp.float32))


def test_packed_pallas_kernels_fp16_interpret_match_port_plain():
    """The TPU kernels themselves at fp16 (interpret mode, as
    tests/L0/test_attention.py drives them): they round P before P.V, and
    dS and P_drop before their products, to fp16 (``p.astype(v.dtype)``,
    ``ds.astype(q.dtype)``); the plain versions keep fp32, and the two
    agree within one fp16 ulp of the outputs."""
    b, s, nh, hn, block = 1, 64, 2, 64, 32
    scale = 1.0 / math.sqrt(hn)
    rng = np.random.RandomState(1)
    qkv = rng.randn(b, s, nh * 3 * hn).astype(np.float16)
    dctx = rng.randn(b, s, nh * hn).astype(np.float16)
    jctx, jlse = jatt._flash_qkv_fwd_pallas(jnp.asarray(qkv), 0, nh, hn,
                                            scale, True, block, 0.0)
    jd = jatt._flash_qkv_bwd_pallas(jnp.asarray(qkv), 0, jctx, jlse,
                                    jnp.asarray(dctx), nh, hn, scale, True,
                                    block, 0.0)
    assert jctx.dtype == jd.dtype == jnp.float16
    tctx, tlse = tatt._flash_qkv_fwd_plain(torch.tensor(qkv), None, None, nh,
                                           scale, True, 0.0, 0)
    jlse = np.asarray(jlse)[:, :, :, :, 0, :].reshape(b * nh, s)
    assert tctx.dtype == torch.float16
    _close(tctx.float(), np.asarray(jctx, np.float32))
    np.testing.assert_allclose(tlse.numpy(), jlse, rtol=0, atol=1e-5)
    td = tatt._flash_qkv_bwd_plain(torch.tensor(qkv), torch.tensor(dctx),
                                   tctx, tlse, None, None, nh, scale, True,
                                   0.0, 0)
    _close(td.float(), np.asarray(jd, np.float32))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("cols", [1024, 256])
def test_layer_norm_plain_fp16_matches_jax(use_pallas, cols):
    rows = 37
    rng = np.random.RandomState(11)
    x = (rng.randn(rows, cols) * 2 + 0.5).astype(np.float16)
    dy = rng.randn(rows, cols).astype(np.float16)
    w = (1 + 0.1 * rng.randn(cols)).astype(np.float32)
    b = (0.1 * rng.randn(cols)).astype(np.float32)
    jy, vjp = jax.vjp(lambda x, w, b: jops.layer_norm(
        x, w, b, eps=1e-5, use_pallas=use_pallas), jnp.asarray(x),
        jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(dy))
    tx, tdy = torch.tensor(x), torch.tensor(dy)
    y, mean, invvar = tln._ln_fwd_plain(tx, torch.tensor(w), torch.tensor(b),
                                        1e-5)
    dx, dw, db = tln._ln_bwd_plain(tx, tdy, mean, invvar, torch.tensor(w),
                                   True)
    assert y.dtype == dx.dtype == torch.float16
    _close(y.float(), np.asarray(jy, np.float32))
    _close(dx.float(), np.asarray(jdx, np.float32))
    _close(dw, jdw, half=False)
    _close(db, jdb, half=False)


def test_o3_half_layer_norm_weights_cast_as_jax():
    """O3 hands the LayerNorms fp16 weights: the port widens them to fp32
    for the kernels and returns dweight/dbias in fp16, as JAX's layer_norm
    computes in fp32 from its fp16 weights and returns fp16 cotangents."""
    rows, cols = 16, 1024
    rng = np.random.RandomState(3)
    x = rng.randn(rows, cols).astype(np.float16)
    dy = rng.randn(rows, cols).astype(np.float16)
    w = (1 + 0.1 * rng.randn(cols)).astype(np.float16)
    b = (0.1 * rng.randn(cols)).astype(np.float16)
    jy, vjp = jax.vjp(lambda x, w, b: jops.layer_norm(x, w, b, eps=1e-5),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(dy))
    tx = torch.tensor(x).requires_grad_()
    tw, tb = (torch.tensor(a).requires_grad_() for a in (w, b))
    y = tln.layer_norm(tx, tw, tb, eps=1e-5)
    y.backward(torch.tensor(dy))
    assert y.dtype == torch.float16
    assert tw.grad.dtype == tb.grad.dtype == torch.float16
    assert jdw.dtype == jdb.dtype == jnp.float16
    _close(y.detach().float(), np.asarray(jy, np.float32))
    _close(tx.grad.float(), np.asarray(jdx, np.float32))
    _close(tw.grad.float(), np.asarray(jdw, np.float32))
    _close(tb.grad.float(), np.asarray(jdb, np.float32))


# -- the wrappers send fp16 to its own instances ------------------------------


@pytest.fixture
def qkv_recorders(monkeypatch):
    rec = {}
    table = dict(tatt.QKV_KERNELS)
    for key, pair in tatt.QKV_KERNELS.items():
        table[key] = tuple(_Recorder(k.symbol) for k in pair)
        rec[key] = table[key]
    monkeypatch.setattr(tatt, "QKV_KERNELS", table)
    return rec


@pytest.mark.parametrize("hn", [64, 128])
def test_packed_wrappers_launch_the_fp16_instances(qkv_recorders, hn):
    b, s, nh = 1, 8, 2
    qkv = torch.zeros(b, s, nh * 3 * hn, dtype=torch.float16)
    args = (None, None, nh, hn ** -0.5, True, 0.1, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tatt.torch.cuda, "current_stream",
                   lambda device: type("S", (), {"cuda_stream": None})())
        ctx, lse = tatt._flash_qkv_fwd_cuda(qkv, *args)
        visits = torch.zeros(b * nh * 2, dtype=torch.int32)
        dqkv = tatt._flash_qkv_bwd_cuda(qkv, torch.zeros_like(ctx), ctx, lse,
                                        *args, visits=visits)
    fwd, bwd = qkv_recorders["sm90_f16", hn]
    suffix = "_d64" if hn == 64 else ""
    assert fwd.symbol == f"flash_qkv_fwd_sm90{suffix}_f16"
    assert bwd.symbol == f"flash_qkv_bwd_sm90{suffix}_f16"
    assert len(fwd.calls) == len(bwd.calls) == 1
    assert ctx.dtype == dqkv.dtype == torch.float16
    assert fwd.calls[0][:3] == (hn, None, qkv.data_ptr())
    assert bwd.calls[0][11] == visits.data_ptr()
    others = [r for k, pair in qkv_recorders.items() if k != ("sm90_f16", hn)
              for r in pair]
    assert not any(r.calls for r in others)


@pytest.mark.parametrize("cols", [1024, 2048, 4096, 1536])
def test_layer_norm_wrappers_launch_the_fp16_instances(monkeypatch, cols):
    names = ("LAYER_NORM_FWD", "LAYER_NORM_BWD", "LAYER_NORM_FWD_SM90",
             "LAYER_NORM_BWD_SM90", "LAYER_NORM_FWD_F16", "LAYER_NORM_BWD_F16",
             "LAYER_NORM_FWD_SM90_F16", "LAYER_NORM_BWD_SM90_F16")
    rec = {n: _Recorder(getattr(kernels, n).symbol) for n in names}
    for n, r in rec.items():
        monkeypatch.setattr(tln, n, r)
    monkeypatch.setattr(tln, "_stream", lambda device: None)
    x = torch.zeros(37, cols, dtype=torch.float16)
    w = torch.ones(cols)
    y, mean, invvar = tln._ln_fwd_cuda(x, w, None, 1e-5)
    tln._ln_bwd_cuda(x, torch.zeros_like(x), mean, invvar, w, False)
    sm90 = "_SM90" if cols in tln.SM90_WIDTHS else ""
    ran = {n for n, r in rec.items() if r.calls}
    assert ran == {f"LAYER_NORM_FWD{sm90}_F16", f"LAYER_NORM_BWD{sm90}_F16"}
    assert rec[f"LAYER_NORM_FWD{sm90}_F16"].calls[0][0] == kernels.FP16_CODE
    assert y.dtype == torch.float16


# -- every other kernel refuses fp16 ------------------------------------------


def test_generic_attention_kernels_refuse_fp16():
    """K1 and K2 (``flash_fwd*.cu``, ``flash_bwd*.cu``): the checks run
    before any launch, so CPU tensors show them."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        tatt._flash_fwd_cuda(q, q, q, None, None, None, 0.125, True, 0.0, 0)
    lse = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        tatt._flash_bwd_cuda(q, q, q, q, lse, q, None, None, None, 0.125,
                             True, 0.0, 0)
    assert not tatt._fwd_on_tensor_cores(q)
    assert not tatt._bwd_on_tensor_cores(q)


@pytest.mark.parametrize("pool", [torch.float16, torch.bfloat16])
def test_decode_kernels_refuse_fp16(pool):
    """K5: an fp16 q goes to no sm90 instance and ``flash_decode.cu``
    refuses it."""
    q = torch.zeros(1, 2, 1, 128, dtype=torch.float16)
    pages = torch.zeros(4, 8, 2, 128, dtype=pool)
    assert tatt._decode_route(q, pages) == "scalar"
    with pytest.raises(TypeError):
        tatt._flash_decode_cuda(q, pages, pages,
                                torch.zeros(1, 1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32), 0.1)


def test_attention_dot_floor_refuses_fp16():
    """K10 (``attention_dots_sm90.cu``) takes bf16 only."""
    q = torch.zeros(2, 64, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        roofs.attention_dots(q, q, q, 64, 64)


def test_fp16_is_not_a_shared_dtype_code():
    """fp16 stays out of ``DTYPE_CODES``, which every wrapper shares: only
    the K3/K4/K6/K7 routes name it."""
    assert torch.float16 not in kernels.DTYPE_CODES
    assert kernels.FP16_CODE not in kernels.DTYPE_CODES.values()
    f16 = [k.symbol for k in kernels.KERNELS if k.symbol.endswith("_f16")]
    assert sorted(f16) == sorted([
        "flash_qkv_fwd_sm90_f16", "flash_qkv_bwd_sm90_f16",
        "flash_qkv_fwd_sm90_d64_f16", "flash_qkv_bwd_sm90_d64_f16",
        "layer_norm_fwd_f16", "layer_norm_bwd_f16",
        "layer_norm_fwd_sm90_f16", "layer_norm_bwd_sm90_f16"])
