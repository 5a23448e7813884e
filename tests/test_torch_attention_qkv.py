"""Parity of the PyTorch port's packed-QKV self-attention and attention
dropout (``apex_tpu_torch.ops.attention``) with the JAX package's
(``apex_tpu.ops.attention``).

The same inputs, drawn with numpy from a seed, go through both.  On the
CPU the port runs its plain versions (``csrc/flash_qkv_fwd.cu`` and
``csrc/flash_qkv_bwd.cu`` are held against those on the card by
``chip_smoke.py``); JAX runs ``flash_attention_qkv``'s CPU route (the
generic flash path through its XLA forward and backward) and, in one
tiny case, the packed Pallas kernels themselves in interpret mode.

Tolerances: dropout keep-masks bitwise; fp32 1e-5 x max(1, max|ref|)
(sums in another order); bf16 2^-7 x max|ref|, one bf16 ulp at the
output's scale (both sides compute in fp32 from the same bf16 inputs);
lse 1e-5 absolute.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import attention as jatt
from apex_tpu_torch import kernels
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import flash_attention_qkv

FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _close(got, ref, low_precision=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.max(np.abs(ref)))
    tol = BF16_TOL * scale if low_precision else FP32_TOL * max(1.0, scale)
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol, (err, tol)


# -- the dropout hash, bit for bit -----------------------------------------


@pytest.mark.parametrize("seed,rate", [
    (0, 0.1), (1234, 0.1), (-7, 0.5), (2 ** 31 - 1, 0.25), (-2 ** 31, 0.9),
    (99, 1e-12),
])
def test_dropout_keep_full_is_bitwise_jax(seed, rate):
    bh, sq, sk = 5, 33, 40
    ref = np.asarray(jatt._dropout_keep_full(jnp.int32(seed), bh, sq, sk,
                                             rate))
    got = tatt._dropout_keep_full(seed, bh, sq, sk, rate).numpy()
    assert got.dtype == np.bool_ and got.shape == (bh, sq, sk)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("b,qi,ki", [(0, 0, 0), (3, 64, 128),
                                     (2 ** 20 + 5, 4096, 65536)])
def test_dropout_keep_tile_is_bitwise_jax(b, qi, ki):
    ref = np.asarray(jatt._dropout_keep(jnp.int32(77), b, qi, ki, 16, 24,
                                        0.3))
    got = tatt._dropout_keep(77, b, qi, ki, 16, 24, 0.3).numpy()
    np.testing.assert_array_equal(got, ref)


def test_dropout_keep_rate_matches_its_probability():
    keep = tatt._dropout_keep_full(5, 4, 128, 128, 0.1)
    assert abs(keep.float().mean().item() - 0.9) < 0.01


# -- flash_attention_qkv, forward and backward -----------------------------


def _segments(b, s, kind):
    if kind is None:
        return None, None
    rng = np.random.RandomState(3)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cut = sorted(rng.choice(np.arange(4, s - 4), 2, replace=False))
        seg[i, cut[0]:] = 1
        seg[i, cut[1]:] = 2
    if kind == "ids":
        return seg, seg
    # (seg_q, seg_k): key padding, a BERT-style (ones, keep) pair
    keep = (np.arange(s)[None, :] < s - 5).astype(np.int32).repeat(b, 0)
    return np.ones_like(keep), keep


# (name, b, s, heads, hn, dtype, dropout rate, segments, causal).  The
# last three are the contract the tensor-core kernels meet on the card
# (chip_smoke.py holds them to these plain versions): not causal, a ragged
# s (no tile size divides 30), and bf16 at head dim 128.
QKV_CASES = [
    ("fp32", 2, 32, 2, 16, "float32", 0.0, None, True),
    ("fp32_dropout", 2, 32, 2, 16, "float32", 0.2, None, True),
    ("fp32_segment_ids_dropout", 2, 32, 2, 16, "float32", 0.1, "ids", True),
    ("fp32_seg_pair", 2, 24, 3, 8, "float32", 0.0, "pair", True),
    ("bf16_dropout", 1, 32, 2, 32, "bfloat16", 0.1, None, True),
    ("fp32_noncausal_dropout", 2, 32, 2, 16, "float32", 0.1, None, False),
    ("fp32_ragged_s30_segment_ids_dropout", 2, 30, 2, 16, "float32", 0.1,
     "ids", True),
    ("bf16_hn128_dropout", 1, 64, 1, 128, "bfloat16", 0.1, None, True),
]


@pytest.mark.parametrize("case", QKV_CASES, ids=[c[0] for c in QKV_CASES])
def test_flash_attention_qkv_fwd_bwd_match_jax(case):
    _, b, s, nh, hn, dtype, rate, segs, causal = case
    rng = np.random.RandomState(0)
    qkv = rng.randn(b, s, nh * 3 * hn).astype(np.float32)
    dctx = rng.randn(b, s, nh * hn).astype(np.float32)
    seg_q, seg_k = _segments(b, s, segs)
    low = dtype == "bfloat16"
    jqkv = jnp.asarray(qkv, getattr(jnp, dtype))
    jseg = None if seg_q is None else (jnp.asarray(seg_q), jnp.asarray(seg_k))
    seed = 11 if rate else None

    def f(x):
        return jatt.flash_attention_qkv(x, nh, causal=causal,
                                        dropout_rate=rate, dropout_seed=seed,
                                        segment_ids=jseg)

    jctx, vjp = jax.vjp(f, jqkv)
    (jd,) = vjp(jnp.asarray(dctx, getattr(jnp, dtype)))

    tqkv = torch.tensor(np.asarray(jqkv.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    tseg = None if seg_q is None else (torch.tensor(seg_q),
                                       torch.tensor(seg_k))
    ctx = flash_attention_qkv(tqkv, nh, causal=causal, dropout_rate=rate,
                              dropout_seed=seed, segment_ids=tseg)
    assert ctx.dtype == tqkv.dtype and ctx.shape == (b, s, nh * hn)
    ctx.backward(torch.tensor(dctx).to(ctx.dtype))
    _close(ctx.float().detach(), jctx.astype(jnp.float32), low)
    _close(tqkv.grad.float(), jd.astype(jnp.float32), low)


def test_packed_pallas_kernels_interpret_match_port_plain():
    # one tiny direct call of the TPU kernels themselves (interpret mode,
    # as tests/L0/test_attention.py drives them): b=1, s=64, hn=64 packs
    # two heads per kernel group
    b, s, nh, hn, block = 1, 64, 2, 64, 32
    scale = 1.0 / math.sqrt(hn)
    rng = np.random.RandomState(1)
    qkv = rng.randn(b, s, nh * 3 * hn).astype(np.float32)
    dctx = rng.randn(b, s, nh * hn).astype(np.float32)
    jctx, jlse = jatt._flash_qkv_fwd_pallas(jnp.asarray(qkv), 0, nh, hn,
                                            scale, True, block, 0.0)
    jd = jatt._flash_qkv_bwd_pallas(jnp.asarray(qkv), 0, jctx, jlse,
                                    jnp.asarray(dctx), nh, hn, scale, True,
                                    block, 0.0)
    tctx, tlse = tatt._flash_qkv_fwd_plain(torch.tensor(qkv), None, None, nh,
                                           scale, True, 0.0, 0)
    # the TPU slab [b, n_hg, group, n_b, 8, block] holds the values of the
    # port's plain [b*np, s] lse in its row 0
    jlse = np.asarray(jlse)[:, :, :, :, 0, :].reshape(b * nh, s)
    _close(tctx, jctx)
    np.testing.assert_allclose(tlse.numpy(), jlse, rtol=0, atol=1e-5)
    td = tatt._flash_qkv_bwd_plain(torch.tensor(qkv), torch.tensor(dctx),
                                   tctx, tlse, None, None, nh, scale, True,
                                   0.0, 0)
    _close(td, jd)


def test_flash_attention_fwd_cpu_dropout_matches_jax():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(4, 16, 8).astype(np.float32) for _ in range(3))
    jo, jlse = jatt._blockwise_fwd_xla(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0.3, True, None, None,
                                       None, jnp.int32(9), 0.25)
    o, lse = tatt.flash_attention_fwd(torch.tensor(q), torch.tensor(k),
                                      torch.tensor(v), causal=True,
                                      scale=0.3, dropout_rate=0.25,
                                      dropout_seed=9)
    _close(o, jo)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5)


def test_qkv_op_is_a_custom_op_with_a_fake():
    # the selective checkpoint of remat "attn_res" keys on this op
    assert tatt.FLASH_QKV_FWD_OP == torch.ops.apex_tpu_torch.flash_qkv_fwd.default
    qkv = torch.empty(2, 8, 2 * 3 * 4, device="meta")
    ctx, lse = torch.ops.apex_tpu_torch.flash_qkv_fwd(qkv, None, None, 2, 0.5,
                                                      True, 0.0, 0)
    assert ctx.shape == (2, 8, 8) and lse.shape == (4, 8)
    assert lse.dtype == torch.float32


QKV_KERNELS = tuple(k for pair in tatt.QKV_KERNELS.values() for k in pair)


def test_cpu_path_launches_no_kernel():
    before = [k.launches for k in QKV_KERNELS]
    qkv = torch.randn(1, 8, 3 * 2 * 4, requires_grad=True)
    flash_attention_qkv(qkv, 2).sum().backward()
    assert [k.launches for k in QKV_KERNELS] == before


def test_cpu_path_launches_no_kernel_bf16():
    # a bf16 CUDA tensor takes the tensor-core kernels; a bf16 CPU tensor
    # takes neither route
    before = [k.launches for k in QKV_KERNELS]
    qkv = torch.randn(1, 8, 3 * 2 * 4, dtype=torch.bfloat16,
                      requires_grad=True)
    flash_attention_qkv(qkv, 2).sum().backward()
    assert [k.launches for k in QKV_KERNELS] == before


@pytest.mark.parametrize("kwargs,error", [
    (dict(dropout_rate=0.1), ValueError),           # no seed
    (dict(dropout_rate=1.0, dropout_seed=1), ValueError),
    (dict(num_heads=5), ValueError),                # 24 lanes != 3 * 5 * hn
    (dict(segment_ids=torch.zeros(7, dtype=torch.int32)), ValueError),
])
def test_flash_attention_qkv_refuses_bad_arguments(kwargs, error):
    kwargs = dict(kwargs)
    nh = kwargs.pop("num_heads", 2)
    with pytest.raises(error):
        flash_attention_qkv(torch.zeros(1, 8, 24), nh, **kwargs)


@pytest.mark.parametrize("dtype,hn,error", [
    (torch.float16, 128, TypeError),
    (torch.float32, 96, ValueError),    # instances are built for hn 64, 128
])
def test_kernel_wrapper_refuses_what_the_kernels_do_not_take(dtype, hn,
                                                             error):
    qkv = torch.zeros(1, 4, 2 * 3 * hn, dtype=dtype)
    with pytest.raises(error):
        tatt._qkv_kernel_args(qkv, None, None, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hn", [64, 128])
def test_kernel_wrapper_takes_head_dims_64_and_128(dtype, hn):
    qkv = torch.zeros(1, 4, 2 * 3 * hn, dtype=dtype)
    assert tatt._qkv_kernel_args(qkv, None, None, 2) == (hn, (None, None), 1)
    route = "sm90" if dtype == torch.bfloat16 else "scalar"
    fwd, bwd = tatt.QKV_KERNELS[route, hn]
    suffix = "_d64" if hn == 64 else ""
    assert fwd.symbol == f"flash_qkv_fwd{'_sm90' * (route == 'sm90')}{suffix}"
    assert bwd.symbol == f"flash_qkv_bwd{'_sm90' * (route == 'sm90')}{suffix}"
