"""Parity of the PyTorch port's LayerNorm (``apex_tpu_torch.ops.
fused_layer_norm``) with the JAX package's (``apex_tpu.ops.layer_norm``).

The same inputs, drawn with numpy from a seed, go through both.  On the
CPU the port runs its plain PyTorch versions (``csrc/layer_norm_sm90.cu``
and ``csrc/layer_norm.cu`` are held against those on the card by
``chip_smoke.py``); JAX runs its XLA
route (``use_pallas=False``) and its Pallas kernels in interpret mode
(``use_pallas=True``, as ``tests/L0/test_ops.py`` runs them).

Tolerances: fp32 1e-5 x max(1, max|ref|) (sums in another order); bf16
outputs 2^-7 x max|ref|, one bf16 ulp at the output's scale (both sides
compute in fp32 from the same bf16 inputs and round once); the fp32
dweight/dbias of a bf16 x 1e-5 x max(1, max|ref|) (fp32 sums of the same
products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import ops as jops
from apex_tpu_torch import kernels
from apex_tpu_torch.ops import (FastLayerNorm, FusedLayerNorm,
                                MixedFusedLayerNorm, fast_layer_norm,
                                layer_norm, rms_norm)
from apex_tpu_torch.ops import fused_layer_norm as tln

FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _tol(ref, low_precision):
    scale = float(np.max(np.abs(ref)))
    return BF16_TOL * scale if low_precision else FP32_TOL * max(1.0, scale)


def _close(got, ref, low_precision=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= _tol(ref, low_precision), (err, _tol(ref, low_precision))


def _inputs(rows, cols, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, cols) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(cols)).astype(np.float32)
    b = (0.1 * rng.randn(cols)).astype(np.float32)
    dy = rng.randn(rows, cols).astype(np.float32)
    return x, w, b, dy


# (name, rows, cols, x dtype, affine)
CASES = [
    ("fp32", 16, 128, "float32", True),
    ("bf16_x_fp32_w", 16, 128, "bfloat16", True),
    ("fp32_no_affine", 8, 256, "float32", False),
    ("fp32_3d_input", 24, 128, "float32", True),
]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_norm_fwd_bwd_match_jax(case, use_pallas):
    name, rows, cols, dtype, affine = case
    x, w, b, dy = _inputs(rows, cols)
    low = dtype == "bfloat16"
    shape = (2, rows // 2, cols) if name.endswith("3d_input") else (rows, cols)
    jx = jnp.asarray(x.reshape(shape), getattr(jnp, dtype))
    jw, jb = (jnp.asarray(w), jnp.asarray(b)) if affine else (None, None)
    jdy = jnp.asarray(dy.reshape(shape), getattr(jnp, dtype))

    def f(x, w, b):
        return jops.layer_norm(x, w, b, eps=1e-5, use_pallas=use_pallas)

    if affine:
        jy, vjp = jax.vjp(f, jx, jw, jb)
        jdx, jdw, jdb = vjp(jdy)
    else:
        jy, vjp = jax.vjp(lambda x: f(x, None, None), jx)
        (jdx,) = vjp(jdy)

    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    tw = torch.tensor(w, requires_grad=True) if affine else None
    tb = torch.tensor(b, requires_grad=True) if affine else None
    ty = layer_norm(tx, tw, tb, eps=1e-5)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    ty.backward(torch.tensor(np.asarray(jdy.astype(jnp.float32))).to(
        ty.dtype))
    _close(ty.float().detach(), jy.astype(jnp.float32), low)
    _close(tx.grad.float(), jdx.astype(jnp.float32), low)
    if affine:
        assert tw.grad.dtype == torch.float32
        _close(tw.grad, jdw)
        _close(tb.grad, jdb)


def test_layer_norm_statistics_match_jax_xla_path():
    x, w, b, _ = _inputs(32, 256, seed=3)
    jy, jmean, jinv = jops.fused_layer_norm._xla_ln_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    ty, tmean, tinv = tln._ln_fwd_plain(torch.tensor(x), torch.tensor(w),
                                        torch.tensor(b), 1e-5)
    _close(ty, jy)
    _close(tmean, jmean)
    _close(tinv, jinv)


def test_layer_norm_backward_plain_matches_jax_pallas_interpret():
    # ragged last block in the Pallas backward (rows 40, block rows 8k)
    x, w, _, dy = _inputs(40, 128, seed=4)
    jx, jw, jdy = jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy)
    _, mean, invvar = jops.fused_layer_norm._xla_ln_fwd(jx, jw, None, 1e-5)
    jdx, jdw, _ = jops.fused_layer_norm._pallas_ln_bwd(
        jx, jdy, mean, invvar, jw, True, False)
    tdx, tdw, tdb = tln._ln_bwd_plain(
        torch.tensor(x), torch.tensor(dy), torch.tensor(np.asarray(mean)),
        torch.tensor(np.asarray(invvar)), torch.tensor(w), False)
    assert tdb is None
    _close(tdx, jdx)
    _close(tdw, jdw)


def test_rms_norm_matches_jax():
    x, w, _, _ = _inputs(8, 64, seed=5)
    ref = jops.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6)
    got = rms_norm(torch.tensor(x), torch.tensor(w), eps=1e-6)
    _close(got, ref)


def test_modules_hold_fp32_params_and_call_layer_norm():
    x, _, _, _ = _inputs(4, 64, seed=6)
    for cls in (FusedLayerNorm, MixedFusedLayerNorm, FastLayerNorm):
        m = cls(64, eps=1e-5)
        assert m.weight.dtype == torch.float32 and m.bias.shape == (64,)
        xt = torch.tensor(x).bfloat16()
        assert m(xt).dtype == torch.bfloat16
        torch.testing.assert_close(m(xt), layer_norm(xt, m.weight, m.bias))
    assert fast_layer_norm is layer_norm
    bare = FusedLayerNorm(64, elementwise_affine=False)
    assert bare.weight is None and len(list(bare.parameters())) == 0


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    both = (kernels.LAYER_NORM_FWD, kernels.LAYER_NORM_BWD,
            kernels.LAYER_NORM_FWD_SM90, kernels.LAYER_NORM_BWD_SM90)
    before = [k.launches for k in both]
    for cols in (32, 1024):   # a width of each route
        x = torch.randn(4, cols, requires_grad=True)
        layer_norm(x, torch.ones(cols), torch.zeros(cols)).sum().backward()
    assert [k.launches for k in both] == before


@pytest.mark.parametrize("dtype,cols,error", [
    (torch.float64, 64, TypeError),     # fp16 has its own _f16 instances
    (torch.bfloat16, 12, ValueError),   # rows of 24 bytes: no 16-byte vectors
    (torch.float32, 6, ValueError),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(dtype, cols,
                                                              error):
    with pytest.raises(error):
        tln._check_rows(torch.zeros(2, cols, dtype=dtype))
