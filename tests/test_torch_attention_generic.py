"""Parity of the PyTorch port's generic flash attention with its backward
(``apex_tpu_torch.ops.attention.flash_attention`` and
``flash_attention_varlen``) with the JAX package's.

The same inputs, drawn with numpy from a seed, go through both.  On the
CPU the port runs its plain versions (``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` are held against those on the card by
``chip_smoke.py``); JAX runs ``flash_attention``'s CPU route (its XLA
forward and backward under the custom VJP, differentiated with
``jax.vjp``) and, once per route, the TPU backward kernel
``_flash_bwd_pallas`` itself in interpret mode.

Tolerances: fp32 1e-5 x max(1, max|ref|) on outputs and gradients (sums
in another order); lse 1e-5 absolute; dropout keep bits and tile ranges
exact.
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
from apex_tpu_torch.ops import flash_attention, flash_attention_varlen
from chip_smoke import flash_bwd_tiles

FP32_TOL = 1e-5


def _close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = FP32_TOL * max(1.0, float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol, (err, tol)


def _keep_ids(lengths, s):
    """[b, s] int32 key ids, 1 = real, 0 = padding."""
    return (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(
        np.int32)


def _packed(s, lengths):
    seg = np.zeros(s, np.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[at:at + n] = i + 1
        at += n
    return seg


# name -> (b, h, sq, sk, d, causal, mask, segments, dropout rate); mask
# and segments are functions of (rng, b, h, sq, sk) that return numpy arrays
def _pad_mask(rng, b, h, sq, sk):   # [b, 1, 1, sk] key padding, additive
    return np.where(_keep_ids(rng.randint(1, sk + 1, b), sk) == 0, -10000.0,
                    0.0)[:, None, None, :].astype(np.float32)


def _full_mask(rng, b, h, sq, sk):  # [b*h, sq, sk]
    return rng.randn(b * h, sq, sk).astype(np.float32)


def _shared_mask(rng, b, h, sq, sk):  # [1, sq, sk]
    return np.where(rng.rand(1, sq, sk) < 0.3, -10000.0, 0.0).astype(
        np.float32)


def _key_padding(rng, b, h, sq, sk):  # the modules' segment route
    return (np.ones((b, sq), np.int32), _keep_ids(rng.randint(1, sk + 1, b),
                                                  sk))


def _all_padded(rng, b, h, sq, sk):   # batch row 0 sees no key at all
    lengths = rng.randint(1, sk + 1, b)
    lengths[0] = 0
    return np.ones((b, sq), np.int32), _keep_ids(lengths, sk)


def _packed_pair(rng, b, h, sq, sk):  # cross-length packed segments
    return (np.stack([_packed(sq, [7, 9, 4])] * b),
            np.stack([_packed(sk, [10, 12, 2])] * b))


CASES = {
    "mask_key_padding_4d": (2, 2, 12, 20, 8, False, _pad_mask, None, 0.0),
    "mask_full_bh": (2, 2, 16, 16, 8, False, _full_mask, None, 0.0),
    "mask_shared_causal": (2, 2, 16, 24, 8, True, _shared_mask, None, 0.0),
    "key_padding_segments": (2, 3, 16, 16, 8, False, None, _key_padding, 0.0),
    "cross_length_segments": (2, 2, 20, 24, 8, False, None, _packed_pair, 0.0),
    "causal_sq_lt_sk": (1, 2, 12, 28, 8, True, None, None, 0.0),
    "causal_sq_gt_sk": (1, 2, 28, 12, 8, True, None, None, 0.0),
    "dropout": (2, 2, 16, 16, 8, True, None, None, 0.3),
    "all_padded_rows": (3, 2, 10, 14, 8, False, None, _all_padded, 0.0),
    "combined": (2, 2, 18, 22, 16, True, _pad_mask, _key_padding, 0.2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_fwd_and_grads_match_jax(name):
    b, h, sq, sk, d, causal, mask_fn, seg_fn, rate = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    mask = None if mask_fn is None else mask_fn(rng, b, h, sq, sk)
    seg = None if seg_fn is None else seg_fn(rng, b, h, sq, sk)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=11 if rate else None)

    def jfn(q, k, v):
        return jatt.flash_attention(
            q, k, v, mask_bias=None if mask is None else jnp.asarray(mask),
            segment_ids=None if seg is None else tuple(
                jnp.asarray(s) for s in seg), **kw)

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    o = flash_attention(
        tq, tk, tv, mask_bias=None if mask is None else torch.tensor(mask),
        segment_ids=None if seg is None else tuple(
            torch.tensor(s) for s in seg), **kw)
    o.backward(torch.tensor(do))
    _close(o.detach(), jo)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, ref)
    if name == "all_padded_rows":  # exact zeros, output and gradient
        assert (o[0] == 0).all() and (tq.grad[0] == 0).all()


def test_trainable_mask_gets_its_gradient():
    # mask_is_constant=False: the plain differentiable path, as JAX's XLA
    # path, so the bias gets a gradient (and the default gives it none)
    rng = np.random.RandomState(3)
    bh, s, d = 4, 12, 8
    q, k, v = (rng.randn(bh, s, d).astype(np.float32) for _ in range(3))
    bias = rng.randn(1, s, s).astype(np.float32)
    do = rng.randn(bh, s, d).astype(np.float32)

    def jfn(q, k, v, bias):
        return jatt.flash_attention(q, k, v, mask_bias=bias, causal=True,
                                    mask_is_constant=False)

    jo, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(do))
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v, bias)]
    o = flash_attention(*ts[:3], mask_bias=ts[3], causal=True,
                        mask_is_constant=False)
    o.backward(torch.tensor(do))
    _close(o.detach(), jo)
    for t, ref in zip(ts, jgrads):
        _close(t.grad, ref)
    constant = torch.tensor(bias, requires_grad=True)
    tq = torch.tensor(q, requires_grad=True)
    flash_attention(tq, torch.tensor(k), torch.tensor(v),
                    mask_bias=constant).sum().backward()
    assert constant.grad is None and tq.grad is not None


def test_3d_layout_with_per_row_segments_and_lse():
    rng = np.random.RandomState(4)
    bh, s, d = 4, 24, 8
    q, k, v = (rng.randn(bh, s, d).astype(np.float32) for _ in range(3))
    seg = np.stack([_packed(s, [10, 14]), _packed(s, [24]),
                    _packed(s, [5, 5, 5]), _packed(s, [20])])
    jo, jlse = jatt._blockwise_fwd_xla(
        *(jnp.asarray(t) for t in (q, k, v)), 1 / math.sqrt(d), True, None,
        jnp.asarray(seg), jnp.asarray(seg))
    o, lse = tatt.flash_attention_fwd(
        *(torch.tensor(t, requires_grad=True) for t in (q, k, v)),
        causal=True, segment_ids=torch.tensor(seg))
    _close(o.detach(), jo)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5)
    assert o.requires_grad and not lse.requires_grad   # lse: no gradient


@pytest.mark.parametrize("d", [8, 64, 128])
def test_lse_where_an_additive_mask_hides_every_key_of_a_row(d):
    # batch row 1 sees every key at -1e4: its rows' lse lies near -9997,
    # where fp32's spacing (2^-10) is a hundred times this file's lse
    # tolerance, so the bound asks for the reference's bits there
    rng = np.random.RandomState(40 + d)
    b, h, sq, sk = 3, 2, 12, 20
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32)
               for s in (sq, sk, sk))
    lengths = rng.randint(1, sk + 1, b)
    lengths[1] = 0
    mask = np.where(_keep_ids(lengths, sk) == 0, -10000.0,
                    0.0)[:, None, None, :].astype(np.float32)
    _, jlse = jatt._blockwise_fwd_xla(
        *(jnp.asarray(t.reshape(b * h, -1, d)) for t in (q, k, v)),
        1 / math.sqrt(d), False,
        jnp.asarray(np.broadcast_to(mask, (b, h, sq, sk)).reshape(
            b * h, sq, sk)), None, None)
    _, lse = tatt.flash_attention_fwd(
        *(torch.tensor(t) for t in (q, k, v)), mask_bias=torch.tensor(mask))
    jlse = np.asarray(jlse)
    hidden = slice(h, 2 * h)       # batch row 1's b*h rows
    assert (jlse[hidden] < -9000).all() and (jlse[:h] > -100).all()
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=1e-5)


def test_flash_attention_varlen_matches_jax():
    rng = np.random.RandomState(5)
    total, h, d = 40, 2, 8
    cu = np.array([0, 9, 21, 33], np.int32)    # 7 padding tokens past cu[-1]
    q, k, v, do = (rng.randn(total, h, d).astype(np.float32)
                   for _ in range(4))
    jo, vjp = jax.vjp(lambda q, k, v: jatt.flash_attention_varlen(
        q, k, v, jnp.asarray(cu)), *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    o = flash_attention_varlen(*ts, torch.tensor(cu))
    o.backward(torch.tensor(do))
    _close(o.detach(), jo)
    for t, ref in zip(ts, jgrads):
        _close(t.grad, ref)


# -- the TPU backward kernel itself, once per route (interpret mode) --------

ROUTES = {  # route -> (mask, segments, causal, dropout rate)
    "tiles": (True, False, True, 0.0),
    "grid": (True, False, False, 0.25),
    "grid_skip": (False, True, True, 0.0),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_flash_bwd_pallas_interpret_matches_port_plain(route):
    has_mask, has_seg, causal, rate = ROUTES[route]
    bh, s, d, block = 2, 32, 8, 16
    scale = 1.0 / math.sqrt(d)
    rng = np.random.RandomState(6)
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32) for _ in range(4))
    mask = (np.where(rng.rand(1, s, s) < 0.3, -10000.0, 0.0).astype(
        np.float32) if has_mask else None)
    seg = (np.stack([_packed(s, [12, 20]), _packed(s, [30])]) if has_seg
           else None)
    j = [jnp.asarray(t) for t in (q, k, v)]
    jmask = None if mask is None else jnp.asarray(mask)
    jseg = None if seg is None else jnp.asarray(seg)
    jo, jlse = jatt._blockwise_fwd_xla(*j, scale, causal, jmask, jseg, jseg,
                                       jnp.int32(5), rate)
    jd = jatt._flash_bwd_pallas(*j, jmask, jseg, jseg, jnp.int32(5), jo, jlse,
                                jnp.asarray(do), scale, causal, block, block,
                                rate, route=route)
    tseg = None if seg is None else torch.tensor(seg)
    td = tatt._blockwise_bwd(
        *(torch.tensor(t) for t in (q, k, v)), tseg, tseg,
        torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jlse)),
        torch.tensor(do), scale, causal, 5, rate,
        mask_bias=None if mask is None else torch.tensor(mask))
    for got, ref in zip(td, jd):
        _close(got, ref)


# -- K2's skip rule, as chip_smoke.py states it ------------------------------

SKIP_CASES = {  # name -> (seg_q rows, seg_k rows)
    "key_padding": ([[1] * 192], [[1] * 100 + [0] * 156]),
    "packed": ([[1] * 60 + [2] * 70 + [3] * 62],
               [[1] * 60 + [2] * 70 + [3] * 62]),
    "cross_packed": ([[1] * 64 + [2] * 128], [[1] * 30 + [2] * 200 + [0] * 26]),
    "descending_ids": ([[1] * 128 + [0] * 64], [[1] * 64 + [0] * 128]),
}


@pytest.mark.parametrize("name", sorted(SKIP_CASES))
def test_flash_bwd_tiles_are_jax_segment_block_bounds(name):
    # without the causal cut the rule is _segment_block_bounds at 64 x 64,
    # the second output (q-tiles per k-tile) for the dk/dv pass
    seg_q, seg_k = (np.asarray(t, np.int32) for t in SKIP_CASES[name])
    jq, jk = jatt._segment_block_bounds(jnp.asarray(seg_q),
                                        jnp.asarray(seg_k), 64, 64)
    q_ranges, k_ranges = flash_bwd_tiles(
        torch.tensor(seg_q), torch.tensor(seg_k), seg_q.shape[1],
        seg_k.shape[1], False)
    for got, ref in ((q_ranges, np.asarray(jk)), (k_ranges, np.asarray(jq))):
        live = ref[..., 1] > ref[..., 0]
        np.testing.assert_array_equal((got[..., 1] - got[..., 0]).numpy(),
                                      ref[..., 1] - ref[..., 0])
        np.testing.assert_array_equal(got.numpy()[live], ref[live])


@pytest.mark.parametrize("sq,sk", [(150, 150), (100, 230), (230, 100)])
def test_flash_bwd_tiles_never_skip_a_visible_pair(sq, sk):
    # conservative in both directions, under the causal cut and with
    # ragged last tiles: every tile pair holding a visible (row, col) is
    # inside both walks
    rng = np.random.RandomState(sq + sk)
    seg_q = np.sort(rng.randint(0, 4, (2, sq)), 1).astype(np.int32)
    seg_k = np.sort(rng.randint(0, 4, (2, sk)), 1)[:, ::-1].astype(np.int32)
    q_ranges, k_ranges = flash_bwd_tiles(
        torch.tensor(seg_q), torch.tensor(seg_k), sq, sk, True)
    rows = np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    for r in range(2):
        vis = (seg_q[r][:, None] == seg_k[r][None, :]) & (
            rows + (sk - sq) >= cols)
        for i, j in zip(*np.nonzero(vis)):
            qt, kt = i // 64, j // 64
            assert q_ranges[r, kt, 0] <= qt < q_ranges[r, kt, 1]
            assert k_ranges[r, qt, 0] <= kt < k_ranges[r, qt, 1]


@pytest.mark.parametrize("s", [150, 1000])
def test_sm90_tiles_never_skip_a_visible_pair(s):
    # the packed tensor-core backward's two walks (ops/attention.py::
    # QKV_SM90_BWD_TILES: 32 x 128 for dk/dv, 128 x 64 for dq) under the
    # causal cut, ragged s: every tile pair holding a visible (row, col) of
    # self-attention is inside its pass's walk
    (bq2, bk2), (bq3, bk3) = (tatt.QKV_SM90_BWD_TILES[k]
                              for k in ("dkdv", "dq"))
    rng = np.random.RandomState(s)
    seg = np.sort(rng.randint(0, 4, (2, s)), 1).astype(np.int32)
    q_ranges = flash_bwd_tiles(torch.tensor(seg), torch.tensor(seg), s, s,
                               True, bq2, bk2)[0]
    k_ranges = flash_bwd_tiles(torch.tensor(seg), torch.tensor(seg), s, s,
                               True, bq3, bk3)[1]
    rows = np.arange(s)[:, None]
    for r in range(2):
        vis = (seg[r][:, None] == seg[r][None, :]) & (rows >= rows.T)
        i, j = np.nonzero(vis)
        qt, kt = i // bq2, j // bk2
        assert np.all(q_ranges[r].numpy()[kt, 0] <= qt)
        assert np.all(qt < q_ranges[r].numpy()[kt, 1])
        qt, kt = i // bq3, j // bk3
        assert np.all(k_ranges[r].numpy()[qt, 0] <= kt)
        assert np.all(kt < k_ranges[r].numpy()[qt, 1])


# -- the op and the kernel wrappers ------------------------------------------


def test_generic_ops_are_custom_ops_with_fakes():
    q = torch.empty(2, 3, 8, 16, device="meta")
    k = torch.empty(2, 3, 12, 16, device="meta")
    o, lse = torch.ops.apex_tpu_torch.flash_fwd(q, k, k, None, None, None,
                                                0.25, True, 0.0, 0)
    assert o.shape == q.shape and lse.shape == (6, 8)
    dq, dk, dv = torch.ops.apex_tpu_torch.flash_bwd(
        q, k, k, o, lse, o, None, None, None, 0.25, True, 0.0, 0)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_cpu_path_launches_no_kernel():
    before = [k.launches for k in kernels.KERNELS]
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    flash_attention(q, q, q, causal=True, mask_bias=torch.zeros(1, 1, 16, 16),
                    dropout_rate=0.1, dropout_seed=1).sum().backward()
    assert [k.launches for k in kernels.KERNELS] == before


@pytest.mark.parametrize("change,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(d=32), ValueError),                    # no head-dim 32 instance
    (dict(kv_strides=True), ValueError),         # k and v strides differ
    (dict(mask_dtype=torch.bfloat16), TypeError),  # the kernels read fp32
    (dict(mask_shape=(2, 3, 9, 12)), RuntimeError),  # does not broadcast
])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(change, error):
    # the checks run before any launch, so CPU tensors show them
    dtype, d = change.get("dtype", torch.float32), change.get("d", 64)
    q = torch.zeros(2, 3, 8, d, dtype=dtype)
    k = torch.zeros(2, 3, 12, d, dtype=dtype)
    v = torch.zeros(2, 12, 3, d, dtype=dtype).transpose(1, 2) if change.get(
        "kv_strides") else k.clone()
    mask = torch.zeros(change.get("mask_shape", (2, 1, 8, 12)),
                       dtype=change.get("mask_dtype", torch.float32))
    args = (mask, None, None, 0.25, False, 0.0, 0)
    with pytest.raises(error):
        tatt._flash_fwd_cuda(q, k, v, *args)
    with pytest.raises(error):
        tatt._flash_bwd_cuda(q, k, v, q, torch.zeros(6, 8), q, *args)
