"""The route of the port's generic flash backward to its tensor-core kernel
(``apex_tpu_torch/csrc/flash_bwd_sm90.cu``), and the skip rule at that
kernel's tiles against the JAX package's.

bf16 at head dims 64 and 128 runs ``flash_bwd_sm90.cu``; everything else
the scalar ``flash_bwd.cu``.  The kernels run only on the card
(``chip_smoke.py`` holds them against their plain versions there); here
the wrapper's checks, its choice of kernel and the arguments it passes are
read with the two ``Kernel`` objects replaced by recorders, so nothing is
launched.  The tiles each route walks are stated by
``chip_smoke.flash_bwd_tiles``, against which the card holds the kernels'
own counts; this file holds that statement, at the tensor-core kernel's
tiles, against ``apex_tpu.ops.attention._segment_block_bounds`` and the
causal tile rule of ``_flash_bwd_pallas``.  Tile ranges are exact.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops import attention as jatt
from apex_tpu_torch.ops import attention as tatt
from chip_smoke import flash_bwd_tiles


class _Recorder:
    """Stands in for a ``Kernel``: keeps the arguments of each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)


@pytest.fixture
def recorders(monkeypatch):
    scalar, sm90 = _Recorder(), _Recorder()
    monkeypatch.setattr(tatt, "FLASH_BWD", scalar)
    monkeypatch.setattr(tatt, "FLASH_BWD_SM90", sm90)
    monkeypatch.setattr(tatt, "_stream", lambda device: None)
    return scalar, sm90


def _operands(dtype, d, b=2, h=3, sq=40, sk=56):
    """q, k, v, o, do as the modules hand them in: [b, h, s, d] views of
    [s, b, h*d] (q, o, do) and [sk, b, 2*h*d] (k, v) tensors."""
    def heads(t, s):
        return t.view(s, b, h, d).permute(1, 2, 0, 3)

    q, o, do = (heads(torch.zeros(sq, b, h * d, dtype=dtype), sq)
                for _ in range(3))
    kv = torch.zeros(sk, b, 2 * h * d, dtype=dtype)
    k, v = (heads(t, sk) for t in kv.split(h * d, -1))
    lse = torch.zeros(b * h, sq)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype,d,tensor_cores", [
    (torch.float32, 8, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.bfloat16, 8, False),
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
])
def test_route_takes_tensor_cores_for_bf16_at_head_dims_64_and_128(
        recorders, dtype, d, tensor_cores):
    scalar, sm90 = recorders
    q, k, v, o, lse, do = _operands(dtype, d)
    mask = torch.zeros(2, 1, 40, 56)
    dq, dk, dv = tatt._flash_bwd_cuda(q, k, v, o, lse, do, mask, None, None,
                                      0.125, True, 0.0, 0)
    assert tatt._bwd_on_tensor_cores(q) is tensor_cores
    assert (len(sm90.calls), len(scalar.calls)) == (
        (1, 0) if tensor_cores else (0, 1))
    args = (sm90 if tensor_cores else scalar).calls[0]
    # dq keeps q's dimension order (k and v are views with gaps, so dk
    # and dv are laid out afresh, and written through their own strides)
    assert dq.stride() == q.stride()
    for g, t in ((dq, q), (dk, k), (dv, v)):
        assert g.shape == t.shape
    if tensor_cores:
        assert args[:2] == (d, None)   # head dim, device index (CPU: None)
        strides = list(args[21][:28])
        want = [st for t in (q, k, v, o, do, dq, dk, dv)
                for st in t.stride()[:3]] + list(
            mask.broadcast_to(2, 3, 40, 56).stride())
        assert strides == want
        assert args[17:21] == (2, 3, 40, 56)   # B, H, sq, sk
    else:
        assert args[:2] == (tatt._KERNEL_DTYPES[dtype], d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_visits_size_follows_the_route_tiles(recorders, dtype):
    q, k, v, o, lse, do = _operands(dtype, 64, sq=200, sk=200)
    tiles = tatt.flash_bwd_tiles_of(q)
    assert tiles == (tatt.FLASH_BWD_SM90_TILES if dtype == torch.bfloat16
                     else tatt.FLASH_BWD_TILES)
    n = 2 * 3 * (math.ceil(200 / tiles["dkdv"][1])
                 + math.ceil(200 / tiles["dq"][0]))
    assert tatt.flash_bwd_visits_len(q, 200) == n
    args = (None, None, None, 0.125, False, 0.0, 0)
    tatt._flash_bwd_cuda(q, k, v, o, lse, do, *args,
                         visits=torch.zeros(n, dtype=torch.int32))
    other = (tatt.FLASH_BWD_TILES if dtype == torch.bfloat16
             else tatt.FLASH_BWD_SM90_TILES)
    wrong = 2 * 3 * (math.ceil(200 / other["dkdv"][1])
                     + math.ceil(200 / other["dq"][0]))
    assert wrong != n
    with pytest.raises(ValueError):
        tatt._flash_bwd_cuda(q, k, v, o, lse, do, *args,
                             visits=torch.zeros(wrong, dtype=torch.int32))


def test_broadcast_operands_are_copied_for_the_tensor_map():
    x = torch.zeros(1, 3, 16, 64, dtype=torch.bfloat16)
    assert tatt._tma_loadable(x) is x                 # size-1 dim: as it is
    y = x.expand(2, 3, 16, 64)                        # b at stride 0
    z = tatt._tma_loadable(y)
    assert z is not y and z.is_contiguous() and torch.equal(z, y)
    w = torch.zeros(16, 2, 3 * 64, dtype=torch.bfloat16).view(
        16, 2, 3, 64).permute(1, 2, 0, 3)             # permuted, no zero
    assert tatt._tma_loadable(w) is w


# -- the skip rule at the tensor-core kernel's tiles -------------------------


def _padded(ids, n, block):
    """Ids padded to whole tiles by repeating the last one (its min and
    max stay), as ``flash_bwd_tiles`` pads them."""
    return np.concatenate([ids, np.repeat(ids[:, -1:], n * block
                                          - ids.shape[1], 1)], 1)


def _jax_walk(seg_q, seg_k, sq, sk, causal, block_q, block_k, by_k):
    """The tiles the JAX backward visits, as sets: per k-tile its q-tiles
    (``by_k``, the dk/dv pass) or per q-tile its k-tiles (the dq pass).
    ``_segment_block_bounds`` gives the segment ranges; a tile is then
    skipped under the causal mask by ``_flash_bwd_pallas``'s
    ``visible(qi, ki)``: not (causal and qi + block_q - 1 + (sk - sq) <
    ki)."""
    n_qb, n_kb = -(-sq // block_q), -(-sk // block_k)
    lohi_q, lohi_k = (np.asarray(t) for t in jatt._segment_block_bounds(
        jnp.asarray(_padded(seg_q, n_qb, block_q)),
        jnp.asarray(_padded(seg_k, n_kb, block_k)), block_q, block_k))

    def visible(i, j):
        return not (causal and i * block_q + block_q - 1 + (sk - sq)
                    < j * block_k)

    if by_k:
        return [[{i for i in range(*lohi_k[r, j]) if visible(i, j)}
                 for j in range(n_kb)] for r in range(seg_q.shape[0])]
    return [[{j for j in range(*lohi_q[r, i]) if visible(i, j)}
             for i in range(n_qb)] for r in range(seg_q.shape[0])]


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(150, 150), (1000, 1000), (192, 256),
                                   (256, 192)])
def test_sm90_walks_are_the_jax_rule_and_skip_no_visible_pair(
        sq, sk, causal, segments):
    (bq2, bk2), (bq3, bk3) = (tatt.FLASH_BWD_SM90_TILES[p]
                              for p in ("dkdv", "dq"))
    rng = np.random.RandomState(sq * 7 + sk + 2 * causal + segments)
    if segments:   # packed ids ascending, key-padding-like ids descending
        seg_q = np.sort(rng.randint(0, 4, (2, sq)), 1).astype(np.int32)
        seg_k = np.sort(rng.randint(0, 4, (2, sk)), 1)[:, ::-1].astype(
            np.int32)
        tq, tk = torch.tensor(seg_q), torch.tensor(seg_k.copy())
    else:          # one segment: every tile live but for the causal cut
        seg_q, seg_k = np.zeros((1, sq), np.int32), np.zeros((1, sk), np.int32)
        tq = tk = None
    kv_walk = flash_bwd_tiles(tq, tk, sq, sk, causal, bq2, bk2)[0].numpy()
    q_walk = flash_bwd_tiles(tq, tk, sq, sk, causal, bq3, bk3)[1].numpy()
    jax_kv = _jax_walk(seg_q, seg_k, sq, sk, causal, bq2, bk2, by_k=True)
    jax_q = _jax_walk(seg_q, seg_k, sq, sk, causal, bq3, bk3, by_k=False)
    n_q3 = -(-sq // bq3)
    for r in range(seg_q.shape[0]):
        # dk/dv: exactly the JAX walk; dq: inside it, and equal to it but
        # on a ragged last q-tile, whose causal cut counts its valid rows
        for j, want in enumerate(jax_kv[r]):
            assert set(range(*kv_walk[r, j])) == want
        for i, want in enumerate(jax_q[r]):
            got = set(range(*q_walk[r, i]))
            assert got <= want
            if i < n_q3 - 1 or sq % bq3 == 0:
                assert got == want
        # no visible pair is skipped by either pass
        vis = seg_q[r][:, None] == seg_k[r][None, :]
        if causal:
            vis &= np.arange(sq)[:, None] + (sk - sq) >= np.arange(sk)[None]
        i, j = np.nonzero(vis)
        lo, hi = kv_walk[r][j // bk2, 0], kv_walk[r][j // bk2, 1]
        assert np.all((lo <= i // bq2) & (i // bq2 < hi))
        lo, hi = q_walk[r][i // bq3, 0], q_walk[r][i // bq3, 1]
        assert np.all((lo <= j // bk3) & (j // bk3 < hi))
