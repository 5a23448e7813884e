"""The route of the port's generic flash forward to its tensor-core kernel
(``apex_tpu_torch/csrc/flash_fwd_sm90.cu``), the skip rule at that
kernel's tiles against the JAX package's, and the forward's parity with
JAX in the dtype and head dims that take the kernel on the card.

bf16 at head dims 64 and 128 runs ``flash_fwd_sm90.cu``; everything else
the scalar ``flash_fwd.cu``.  The kernels run only on the card
(``chip_smoke.py`` holds them against their plain versions there); here
the wrapper's checks, its choice of kernel and the arguments it passes are
read with the two ``Kernel`` objects replaced by recorders, so nothing is
launched.  The tiles the tensor-core kernel walks are stated by
``chip_smoke.flash_fwd_tiles``, against which the card holds the kernel's
own counts; this file holds that statement, at 128 x 128, against
``apex_tpu.ops.attention._segment_block_bounds`` and the causal cut of
``_flash_fwd_pallas``'s kernel.  Tile ranges are exact.

Tolerances of the parity case (bf16 q, k, v on the CPU: the port's plain
version against JAX's ``_blockwise_fwd_xla``, both fp32 inside): o within
2^-7 x max|ref|, one bf16 ulp at the output's scale (the two round fp32
values that differ in their last bits); lse 1e-5 absolute.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops import attention as jatt
from apex_tpu_torch.ops import attention as tatt
from chip_smoke import flash_fwd_tiles


class _Recorder:
    """Stands in for a ``Kernel``: keeps the arguments of each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)


@pytest.fixture
def recorders(monkeypatch):
    scalar, sm90 = _Recorder(), _Recorder()
    monkeypatch.setattr(tatt, "FLASH_FWD", scalar)
    monkeypatch.setattr(tatt, "FLASH_FWD_SM90", sm90)
    monkeypatch.setattr(tatt, "_stream", lambda device: None)
    return scalar, sm90


def _prefill_views(dtype, d, b=1, h=4, s=48):
    """q, k, v as the serving prefill hands them in: [b, h, s, d] views of
    one fused [b, s, 3*h*d] projection."""
    qkv = torch.zeros(b, s, 3 * h * d, dtype=dtype)
    return [t.view(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


def _module_views(dtype, d, b=2, h=3, sq=40, sk=56):
    """q, k, v as the attention modules hand them in: [b, h, s, d] views
    of [sq, b, h*d] (q) and [sk, b, 2*h*d] (k, v) projections."""
    def heads(t, s):
        return t.view(s, b, h, d).permute(1, 2, 0, 3)

    q = heads(torch.zeros(sq, b, h * d, dtype=dtype), sq)
    kv = torch.zeros(sk, b, 2 * h * d, dtype=dtype)
    k, v = (heads(t, sk) for t in kv.split(h * d, -1))
    return q, k, v


@pytest.mark.parametrize("dtype,d,tensor_cores", [
    (torch.float32, 8, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.bfloat16, 8, False),
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
])
def test_route_takes_tensor_cores_for_bf16_at_head_dims_64_and_128(
        recorders, dtype, d, tensor_cores):
    scalar, sm90 = recorders
    q, k, v = _module_views(dtype, d)
    o, lse = tatt._flash_fwd_cuda(q, k, v, None, None, None, 0.125, True,
                                  0.0, 0)
    assert tatt._fwd_on_tensor_cores(q) is tensor_cores
    assert tatt.flash_fwd_tiles_of(q) == (
        tatt.FLASH_FWD_SM90_TILES if tensor_cores else tatt.FLASH_FWD_TILES)
    assert (len(sm90.calls), len(scalar.calls)) == (
        (1, 0) if tensor_cores else (0, 1))
    assert o.shape == q.shape and o.stride() == q.stride()
    assert lse.shape == (6, 40) and lse.dtype == torch.float32
    args = (sm90 if tensor_cores else scalar).calls[0]
    if tensor_cores:
        assert args[:2] == (d, None)   # head dim, device index (CPU: None)
        assert args[12:16] == (2, 3, 40, 56)   # B, H, sq, sk
        assert args[17:23] == (0.125, 1, 0, 0, 1.0, None)
    else:
        assert args[:2] == (tatt._KERNEL_DTYPES[dtype], d)
        assert args[12:16] == (2, 3, 40, 56)


@pytest.mark.parametrize("layout", ["prefill", "modules"])
@pytest.mark.parametrize("d", [64, 128])
def test_strided_views_pass_uncopied_with_their_strides(recorders, layout,
                                                        d):
    _, sm90 = recorders
    q, k, v = (_prefill_views if layout == "prefill" else _module_views)(
        torch.bfloat16, d)
    assert not q.is_contiguous()
    o, lse = tatt._flash_fwd_cuda(q, k, v, None, None, None, 0.125, False,
                                  0.0, 0)
    args = sm90.calls[0]
    # q, k, v, o, lse pointers: the views themselves, no copy
    assert args[2:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr())
    want = [st for t in (q, k, v, o) for st in t.stride()[:3]] + [0] * 4
    assert list(args[16][:16]) == want


def test_broadcast_operand_copied_and_broadcast_mask_passed_by_strides(
        recorders):
    _, sm90 = recorders
    # k and v shared by the batch (b at stride 0): copied for the maps
    k, v = (torch.zeros(1, 3, 56, 64, dtype=torch.bfloat16).expand(
        2, 3, 56, 64) for _ in range(2))
    q = torch.zeros(2, 3, 40, 64, dtype=torch.bfloat16)
    mask = torch.zeros(2, 1, 1, 56)              # key padding, [b, 1, 1, sk]
    tatt._flash_fwd_cuda(q, k, v, mask, None, None, 0.125, False, 0.0, 0)
    args = sm90.calls[0]
    assert args[2] == q.data_ptr()
    assert args[3] != k.data_ptr() and args[4] != v.data_ptr()
    strides = list(args[16][:16])
    assert strides[3:9] == list(k.contiguous().stride()[:3]) * 2
    # the mask: its own storage, read through zero strides
    assert args[7] == mask.data_ptr()
    assert strides[12:16] == [56, 0, 0, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_visits_size_follows_the_route_tiles(recorders, dtype):
    q, k, v = _module_views(dtype, 64, sq=200, sk=200)
    n = 2 * 3 * math.ceil(200 / tatt.flash_fwd_tiles_of(q)[0])
    assert tatt.flash_fwd_visits_len(q) == n
    args = (None, None, None, 0.125, False, 0.0, 0)
    visits = torch.zeros(n, dtype=torch.int32)
    if dtype == torch.float32:   # the scalar kernel counts no tiles
        with pytest.raises(ValueError):
            tatt._flash_fwd_cuda(q, k, v, *args, visits=visits)
        return
    assert n == 2 * 3 * 2
    tatt._flash_fwd_cuda(q, k, v, *args, visits=visits)
    assert recorders[1].calls[0][11] == visits.data_ptr()
    wrong = 2 * 3 * math.ceil(200 / tatt.FLASH_FWD_TILES[0])
    with pytest.raises(ValueError):
        tatt._flash_fwd_cuda(q, k, v, *args,
                             visits=torch.zeros(wrong, dtype=torch.int32))


# -- the skip rule at the tensor-core kernel's tiles -------------------------


def _padded(ids, n, block):
    """Ids padded to whole tiles by repeating the last one (its min and
    max stay), as ``flash_bwd_tiles`` pads them."""
    return np.concatenate([ids, np.repeat(ids[:, -1:], n * block
                                          - ids.shape[1], 1)], 1)


def _jax_fwd_walk(seg_q, seg_k, sq, sk, causal, block_q, block_k):
    """The key tiles the JAX forward walks per q-tile, as sets: the range
    ``_segment_block_bounds`` gives, its end cut under the causal mask as
    ``_make_fwd_kernel`` cuts it, at ``(qi + block_q - 1 + (sk - sq)) //
    block_k + 1``."""
    n_qb, n_kb = -(-sq // block_q), -(-sk // block_k)
    lohi_q = np.asarray(jatt._segment_block_bounds(
        jnp.asarray(_padded(seg_q, n_qb, block_q)),
        jnp.asarray(_padded(seg_k, n_kb, block_k)), block_q, block_k)[0])
    walks = []
    for r in range(seg_q.shape[0]):
        row = []
        for i in range(n_qb):
            lo, hi = lohi_q[r, i]
            if causal:
                hi = min(hi, (i * block_q + block_q - 1 + sk - sq)
                         // block_k + 1)
            row.append(set(range(lo, hi)))
        walks.append(row)
    return walks


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (1000, 1000), (192, 256),
                                   (256, 192)])
def test_fwd_walk_is_the_jax_rule_and_skips_no_visible_pair(
        sq, sk, causal, segments):
    bq, bk = tatt.FLASH_FWD_SM90_TILES
    rng = np.random.RandomState(sq * 5 + sk + 2 * causal + segments)
    if segments:   # packed ids ascending, key-padding-like ids descending
        seg_q = np.sort(rng.randint(0, 4, (2, sq)), 1).astype(np.int32)
        seg_k = np.sort(rng.randint(0, 4, (2, sk)), 1)[:, ::-1].astype(
            np.int32)
        tq, tk = torch.tensor(seg_q), torch.tensor(seg_k.copy())
    else:          # one segment: every tile live but for the causal cut
        seg_q, seg_k = np.zeros((1, sq), np.int32), np.zeros((1, sk), np.int32)
        tq = tk = None
    walk = flash_fwd_tiles(tq, tk, sq, sk, causal, bq, bk).numpy()
    jax_walk = _jax_fwd_walk(seg_q, seg_k, sq, sk, causal, bq, bk)
    n_qb = -(-sq // bq)
    for r in range(seg_q.shape[0]):
        # inside the JAX walk, and equal to it but on a ragged last
        # q-tile, whose causal cut counts its valid rows
        for i, want in enumerate(jax_walk[r]):
            got = set(range(*walk[r, i]))
            assert got <= want
            if i < n_qb - 1 or sq % bq == 0:
                assert got == want
        # no visible pair is skipped
        vis = seg_q[r][:, None] == seg_k[r][None, :]
        if causal:
            vis &= np.arange(sq)[:, None] + (sk - sq) >= np.arange(sk)[None]
        i, j = np.nonzero(vis)
        lo, hi = walk[r][i // bq, 0], walk[r][i // bq, 1]
        assert np.all((lo <= j // bk) & (j // bk < hi))


# -- parity with JAX in the tensor-core route's dtype and head dims ----------


@pytest.mark.parametrize("d", [64, 128])
def test_prefill_shaped_fwd_matches_jax_in_bf16(d):
    rng = np.random.RandomState(d)
    b, h, s = 1, 2, 96
    qkv = rng.randn(b, s, 3 * h * d).astype(np.float32)
    seg = np.concatenate([np.full(40, 1), np.full(30, 2),
                          np.zeros(26)]).astype(np.int32)[None]
    t = torch.tensor(qkv).to(torch.bfloat16)
    q, k, v = (x.view(b, s, h, d).transpose(1, 2) for x in t.chunk(3, -1))
    o, lse = tatt.flash_attention_fwd(q, k, v, causal=True,
                                      segment_ids=torch.tensor(seg))
    jq, jk, jv = (jnp.asarray(x.float().reshape(b * h, s, d).numpy())
                  .astype(jnp.bfloat16) for x in (q, k, v))
    jo, jlse = jatt._blockwise_fwd_xla(jq, jk, jv, 1 / math.sqrt(d), True,
                                       None, jnp.asarray(seg),
                                       jnp.asarray(seg))
    ref = np.asarray(jo.astype(jnp.float32)).reshape(b, h, s, d)
    assert o.dtype == torch.bfloat16
    err = float(np.max(np.abs(o.float().numpy() - ref)))
    assert err <= 2.0 ** -7 * float(np.max(np.abs(ref))), err
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5)
    # the padding rows (segment 0) see one another only
    assert np.isfinite(lse.numpy()).all()
