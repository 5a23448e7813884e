"""Parity of the PyTorch port's serving attention (``apex_tpu_torch.ops``)
with the JAX package's (``apex_tpu.ops.attention``).

The same inputs, drawn with numpy from a seed, go through the JAX
function and the port's.  On the CPU the port runs its plain PyTorch
versions — the CUDA kernels are held against those on the card by
``chip_smoke.py`` — and JAX runs its XLA path or, for the marked cases,
its Pallas kernel in interpret mode.

Tolerances: fp32 1e-5 x max(1, max|ref|) on outputs and 1e-5 on lse
(torch and XLA sum in different orders); bf16 2^-7 x max|ref| on
outputs, one bf16 ulp at the output's scale (both sides compute in fp32
from the same bf16 inputs and round once).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops import attention as jatt
from apex_tpu.ops import flash_attention as jax_flash_attention
from apex_tpu.ops import routing_override
from apex_tpu_torch import kernels
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import (flash_attention, flash_attention_fwd,
                                flash_decode)

FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _tol(ref, dtype):
    scale = float(np.max(np.abs(ref)))
    return BF16_TOL * scale if dtype == "bfloat16" else FP32_TOL * max(
        1.0, scale)


def _seg(s, lengths):
    seg = np.zeros(s, np.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[at:at + n] = i + 1
        at += n
    return seg


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


def _to_torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


# (name, b, h, sq, sk, d, causal, segment lengths or None, dtype)
FWD_CASES = [
    ("one_segment_plus_padding", 1, 2, 64, 64, 16, True, [40], "float32"),
    ("three_segments", 1, 2, 64, 64, 16, True, [20, 25, 10], "float32"),
    ("causal_offset_sq_lt_sk", 1, 2, 24, 64, 16, True, None, "float32"),
    ("not_causal", 2, 2, 32, 32, 8, False, [12, 20], "float32"),
    ("bf16_one_segment", 1, 2, 64, 64, 32, True, [40], "bfloat16"),
]


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_flash_attention_matches_jax_blockwise(case):
    _, b, h, sq, sk, d, causal, lengths, dtype = case
    rng = np.random.RandomState(0)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    seg = None if lengths is None else _seg(sq, lengths)[None]
    scale = 1.0 / math.sqrt(d)
    jseg = None if seg is None else jnp.asarray(np.repeat(seg, b * h, 0))
    jo, jlse = jatt._blockwise_fwd_xla(
        _to_jax(q.reshape(b * h, sq, d), dtype),
        _to_jax(k.reshape(b * h, sk, d), dtype),
        _to_jax(v.reshape(b * h, sk, d), dtype), scale, causal, None,
        jseg, jseg)
    o, lse = flash_attention_fwd(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
        causal=causal,
        segment_ids=None if seg is None else torch.tensor(seg))
    ref = np.asarray(jo.astype(jnp.float32)).reshape(b, h, sq, d)
    assert o.dtype == getattr(torch, dtype) and o.shape == (b, h, sq, d)
    np.testing.assert_allclose(o.float().numpy(), ref, rtol=0,
                               atol=_tol(ref, dtype))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5 * max(1.0, float(np.max(np.abs(jlse)))))


def test_flash_attention_layouts_and_per_batch_segments():
    # [b, h, s, d] with per-batch ids (JAX repeats them over heads) and
    # the [bh, s, d] layout with per-row ids both match JAX's public API
    rng = np.random.RandomState(1)
    b, h, s, d = 2, 3, 32, 8
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    seg = np.stack([_seg(s, [10, 22]), _seg(s, [5, 5, 5])])
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        segment_ids=jnp.asarray(seg)))
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=True, segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=FP32_TOL)
    seg_bh = np.repeat(seg, h, 0)
    got3 = flash_attention(*(torch.tensor(t.reshape(b * h, s, d))
                             for t in (q, k, v)),
                           causal=True, segment_ids=torch.tensor(seg_bh))
    np.testing.assert_allclose(got3.numpy(), ref.reshape(b * h, s, d),
                               rtol=0, atol=FP32_TOL)


def test_flash_attention_mask_bias_on_cpu_matches_jax():
    rng = np.random.RandomState(2)
    bh, s, d = 2, 16, 8
    q, k, v = (rng.randn(bh, s, d).astype(np.float32) for _ in range(3))
    bias = np.where(rng.rand(1, s, s) < 0.2, -10000.0, 0.0).astype(
        np.float32)
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask_bias=jnp.asarray(bias)))
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          mask_bias=torch.tensor(bias))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=FP32_TOL)


def test_flash_attention_dropout_is_not_ported():
    q = torch.zeros(1, 8, 8)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, dropout_rate=0.1)


@pytest.mark.slow  # interpret-mode Pallas kernel, as the JAX suite marks it
def test_flash_attention_matches_jax_varlen_kernel_interpret():
    bh, s, d = 2, 64, 16
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(bh, s, d).astype(np.float32) for _ in range(3))
    seg = np.stack([_seg(s, [24, 24]), _seg(s, [40, 8])])
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jatt._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        jnp.asarray(seg), jnp.asarray(seg), 0, scale, True, 16, 16, 0.0,
        route="varlen")
    o, lse = flash_attention_fwd(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), causal=True,
                                 segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                               atol=FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=FP32_TOL * 10)


SEG_CASES = {
    "packed_ascending": ([[1] * 10 + [2] * 30 + [3] * 24,
                          [1] * 50 + [0] * 14], 16, 8),
    "padding_tail": ([[1] * 40 + [0] * 24], 16, 8),
    "one_segment": ([[1] * 64], 32, 16),
    "interleaved": ([[1, 2] * 32], 8, 8),
}


@pytest.mark.parametrize("name", sorted(SEG_CASES))
def test_segment_block_bounds_equal_jax(name):
    seg, bq, bk = SEG_CASES[name]
    seg = np.asarray(seg, np.int32)
    seg_k = seg[:, ::-1].copy()  # a different k side, same shape
    for sk_ids in (seg, seg_k):
        jq, jk = jatt._segment_block_bounds(jnp.asarray(seg),
                                            jnp.asarray(sk_ids), bq, bk)
        tq, tk = tatt._segment_block_bounds(torch.tensor(seg),
                                            torch.tensor(sk_ids), bq, bk)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def _paged_state(rng, lengths, page_size, p_max, h, d, q_len):
    """Pool + page table for ragged ``lengths``: every slot starts at a
    large sentinel and only each request's valid slots get real values,
    so a read past ``kv_len`` or of a dead page blows the diff up."""
    b = len(lengths)
    n_pages = 1 + b * p_max
    k_pages = np.full((n_pages, page_size, h, d), 1e3, np.float32)
    v_pages = np.full((n_pages, page_size, h, d), 1e3, np.float32)
    table = np.zeros((b, p_max), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, n in enumerate(lengths):
        used = -(-n // page_size)
        pages = [free.pop() for _ in range(used)]
        table[i, :used] = pages
        for t in range(n):
            pg, off = pages[t // page_size], t % page_size
            k_pages[pg, off] = rng.randn(h, d)
            v_pages[pg, off] = rng.randn(h, d)
    q = rng.randn(b, h, q_len, d).astype(np.float32)
    return q, k_pages, v_pages, table, np.asarray(lengths, np.int32)


# (q_len, kv lengths); lengths below q_len leave empty windows
DECODE_CASES = [(1, [1, 7, 8, 9, 20]), (3, [3, 8, 13, 24, 2]),
                (3, [1, 2, 17, 24, 5])]


@pytest.mark.parametrize("q_len,lengths", DECODE_CASES)
def test_flash_decode_matches_jax_paged_xla(q_len, lengths):
    rng = np.random.RandomState(4)
    state = _paged_state(rng, lengths, 8, 3, 2, 16, q_len)
    jstate = [jnp.asarray(a) for a in state]
    ref = np.asarray(jatt._paged_attention_xla(*jstate, 0.25))
    got = flash_decode(*(torch.tensor(a) for a in state), scale=0.25)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=_tol(ref, "float32"))
    for i, n in enumerate(lengths):
        for r in range(q_len):
            if n - q_len + r < 0:  # empty causal window: exact zeros
                assert (got[i, :, r] == 0).all()


def test_flash_decode_matches_jax_decode_kernel_interpret():
    # the Pallas decode kernel itself, forced and run in interpret mode
    rng = np.random.RandomState(5)
    q_len, lengths = 3, [2, 11, 16]
    state = _paged_state(rng, lengths, 8, 2, 2, 16, q_len)
    with routing_override(decode="decode"):
        ref = np.asarray(jatt.flash_decode(*(jnp.asarray(a)
                                             for a in state)))
    got = flash_decode(*(torch.tensor(a) for a in state))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=_tol(ref, "float32"))
    assert (got[0, :, 0] == 0).all()  # kv_len 2 < q_len 3


def test_flash_decode_quantized_pool_is_not_ported():
    q = torch.zeros(1, 1, 1, 8)
    pool = torch.zeros(2, 8, 1, 8)
    scales = torch.ones(2, 8, 1)
    with pytest.raises(NotImplementedError):
        flash_decode(q, pool, pool, torch.zeros(1, 1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32), k_scale=scales,
                     v_scale=scales)


def test_cpu_tensors_never_reach_a_kernel():
    # CPU tensors take the plain versions: no kernel is built or launched
    before = [k.launches for k in kernels.KERNELS]
    rng = np.random.RandomState(6)
    q = torch.tensor(rng.randn(1, 2, 16, 8).astype(np.float32))
    flash_attention(q, q, q, causal=True)
    state = _paged_state(rng, [5], 8, 1, 2, 8, 1)
    flash_decode(*(torch.tensor(a) for a in state))
    assert [k.launches for k in kernels.KERNELS] == before
