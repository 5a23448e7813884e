"""The port's paged decode attention over a quantized pool, and its
Hopper kernel's route and partition.

``flash_decode`` with ``k_scale``/``v_scale`` (int8 or fp8 e4m3 codes,
fp32 scales per (page, slot, head)) against the JAX package's
``_paged_attention_xla`` and against its Pallas kernel
(``_flash_decode_pallas``, ``quantized=True``) forced with
``routing_override(decode="decode")`` and run in interpret mode; the
port's ``quantize_tokens`` against JAX's bit for bit.  On the CPU the port
runs its plain version; ``chip_smoke.py`` holds
``csrc/flash_decode_sm90.cu`` against that on the card.  Here the
wrapper's choice of entry point and the arguments it passes are read with
the ``Kernel`` objects replaced by recorders, so nothing is launched, and
the kernel's partition of a request's page walk
(:func:`decode_partition`) is held against the constants of the CUDA
source, read as text.

Tolerance of the parity cases: fp32 1e-5 x max(1, max|ref|) (the same
dequantized fp32 attention, summed in another order).
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops import attention as jatt
from apex_tpu.ops import routing_override
from apex_tpu.serving import kv_cache as jkv
from apex_tpu_torch import kernels
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import flash_decode
from apex_tpu_torch.serving import kv_cache as tkv

SOURCE = (Path(tatt.__file__).resolve().parent.parent / "csrc"
          / "flash_decode_sm90.cu").read_text()
FP32_TOL = 1e-5
MODES = ("int8", "fp8")


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=FP32_TOL * max(1.0,
                                                   float(np.abs(ref).max())))


def _codes(rng, mode, shape):
    """Random codes of a quantized pool as (numpy array in JAX's dtype,
    torch tensor of the same bytes)."""
    if mode == "int8":
        c = rng.randint(-127, 128, shape).astype(np.int8)
        return c, torch.from_numpy(c.copy())
    c = np.clip(rng.randn(*shape) * 100, -448, 448).astype(
        jnp.float8_e4m3fn)
    return c, torch.from_numpy(c.view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


def _quant_state(rng, mode, lengths, page_size, p_max, h, d, q_len):
    """A quantized pool and page table for ragged ``lengths``.  Slots no
    request holds keep large codes at scale 1e3, so a read past
    ``kv_len`` or of a dead page blows the diff up."""
    b = len(lengths)
    n_pages = 1 + b * p_max
    shape = (n_pages, page_size, h, d)
    (kc, tk), (vc, tv) = _codes(rng, mode, shape), _codes(rng, mode, shape)
    ks = np.full(shape[:-1], 1e3, np.float32)
    vs = np.full(shape[:-1], 1e3, np.float32)
    table = np.zeros((b, p_max), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, n in enumerate(lengths):
        used = -(-n // page_size)
        pages = [free.pop() for _ in range(used)]
        table[i, :used] = pages
        for t in range(n):
            pg, off = pages[t // page_size], t % page_size
            ks[pg, off] = rng.uniform(0.001, 0.02, h)
            vs[pg, off] = rng.uniform(0.001, 0.02, h)
    q = rng.randn(b, h, q_len, d).astype(np.float32)
    kv = np.asarray(lengths, np.int32)
    jax_args = [jnp.asarray(a) for a in (q, kc, vc, table, kv)]
    port = [torch.tensor(q), tk, tv, torch.tensor(table), torch.tensor(kv)]
    return (jax_args, (jnp.asarray(ks), jnp.asarray(vs)),
            port, (torch.tensor(ks), torch.tensor(vs)))


def _empty_rows_are_zeros(got, lengths, q_len):
    for i, n in enumerate(lengths):
        for r in range(q_len):
            if n - q_len + r < 0:  # empty causal window: exact zeros
                assert (got[i, :, r] == 0).all()


# (q_len, kv lengths); lengths below q_len leave empty windows
QUANT_CASES = [(1, [1, 7, 8, 9, 20]), (3, [3, 8, 13, 24, 2]),
               (3, [1, 2, 17, 24, 5])]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q_len,lengths", QUANT_CASES)
def test_quantized_flash_decode_matches_jax_paged_xla(mode, q_len, lengths):
    rng = np.random.RandomState(14)
    jargs, jsc, targs, tsc = _quant_state(rng, mode, lengths, 8, 3, 2, 16,
                                          q_len)
    ref = jatt._paged_attention_xla(*jargs, 0.25, k_scale=jsc[0],
                                    v_scale=jsc[1])
    got = flash_decode(*targs, scale=0.25, k_scale=tsc[0], v_scale=tsc[1])
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    _empty_rows_are_zeros(got, lengths, q_len)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q_len,lengths", [(1, [1, 33, 64]),
                                           (3, [2, 40, 64])])
def test_quantized_flash_decode_matches_jax_decode_kernel_interpret(
        mode, q_len, lengths):
    # the Pallas kernel's quantized body itself, forced and run in
    # interpret mode (a one-byte pool needs pages of 32 slots there)
    rng = np.random.RandomState(15)
    jargs, jsc, targs, tsc = _quant_state(rng, mode, lengths, 32, 2, 2, 16,
                                          q_len)
    assert jatt.flash_decode_route(jargs[0], jargs[1]) == "xla"
    with routing_override(decode="decode"):
        assert jatt.flash_decode_route(jargs[0], jargs[1]) == "decode"
        ref = jatt.flash_decode(*jargs, k_scale=jsc[0], v_scale=jsc[1])
    got = flash_decode(*targs, k_scale=tsc[0], v_scale=tsc[1])
    _close(got.numpy(), ref)
    _empty_rows_are_zeros(got, lengths, q_len)


def test_scales_come_in_pairs():
    q = torch.zeros(1, 1, 1, 8)
    pool = torch.zeros(2, 8, 1, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="together"):
        flash_decode(q, pool, pool, torch.zeros(1, 1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32),
                     k_scale=torch.ones(2, 8, 1))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_tokens_is_jax_bit_for_bit(mode):
    # six decades of magnitude, and an all-zero token-head (scale 1)
    rng = np.random.RandomState(16)
    x = (rng.randn(96, 4, 128) * 10.0 ** rng.uniform(-3, 3, (96, 4, 1))
         ).astype(np.float32)
    x[5, 1] = 0.0
    jc, js = jkv.quantize_tokens(jnp.asarray(x), jkv.quant_pool_dtype(mode),
                                 jkv._QUANT_QMAX[mode])
    tc, ts = tkv.quantize_tokens(torch.tensor(x), tkv.quant_pool_dtype(mode),
                                 tkv._QUANT_QMAX[mode])
    assert tc.dtype == tkv.quant_pool_dtype(mode)
    assert ts.dtype == torch.float32 and float(ts[5, 1]) == 1.0
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                  np.asarray(jc).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def codes_within_one_step(got, ref, mode):
    """Quantized codes (float views) that differ by at most one step of
    their grid: 1 for int8; for e4m3 one spacing at the larger magnitude
    (3 mantissa bits; 2^-9 below its normal range)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    step = 1.0 if mode == "int8" else np.maximum(
        2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(ref))
                                 + 1e-30)) - 3), 2.0 ** -9)
    assert (np.abs(got - ref) <= step).all()


@pytest.mark.parametrize("mode", MODES)
def test_quantized_write_tokens_matches_jax(mode):
    rng = np.random.RandomState(17)
    kw = dict(num_layers=2, num_pages=6, page_size=8, num_heads=2,
              head_dim=16, max_pages_per_request=3, quantize=mode)
    j = jkv.PagedKVCache(**kw)
    t = tkv.PagedKVCache(**kw, device="cpu")
    assert t.k.dtype == tkv.quant_pool_dtype(mode) and t.qmax == j.qmax
    assert tuple(t.k_scale.shape) == tuple(j.k_scale.shape) == (2, 6, 8, 2)
    k, v = ((rng.randn(2, 5, 2, 16) * 10.0 ** rng.uniform(-2, 2, (2, 5, 2, 1))
             ).astype(np.float32) for _ in range(2))
    pages = np.array([3, 3, 4, 0, 5], np.int32)
    offsets = np.array([0, 7, 2, 0, 1], np.int32)
    j.write_tokens(jnp.asarray(k), jnp.asarray(v), pages, offsets)
    t.write_tokens(torch.tensor(k), torch.tensor(v), torch.tensor(pages),
                   torch.tensor(offsets))
    qdtype, qmax = jkv.quant_pool_dtype(mode), jkv._QUANT_QMAX[mode]
    for x, codes, scales, jcodes, jscales in (
            (k, t.k, t.k_scale, j.k, j.k_scale),
            (v, t.v, t.v_scale, j.v, j.v_scale)):
        # bit for bit: JAX's quantize_tokens, scattered in place
        c, sc = jkv.quantize_tokens(jnp.asarray(x), qdtype, qmax)
        want_c = np.zeros(codes.shape, np.uint8)
        want_s = np.zeros(scales.shape, np.float32)
        want_c[:, pages, offsets] = np.asarray(c).view(np.uint8)
        want_s[:, pages, offsets] = np.asarray(sc)
        np.testing.assert_array_equal(codes.view(torch.uint8).numpy(),
                                      want_c)
        np.testing.assert_array_equal(scales.numpy(), want_s)
        # JAX's own jitted write computes absmax * (1 / qmax) where its
        # function divides: scales within one fp32 ulp, codes one step
        np.testing.assert_array_max_ulp(scales.numpy(), np.asarray(jscales),
                                        maxulp=1)
        codes_within_one_step(codes.float().numpy(),
                              np.asarray(jcodes, np.float32), mode)


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError, match="unknown quantize"):
        tkv.quant_pool_dtype("int4")
    with pytest.raises(ValueError, match="unknown quantize"):
        tkv.PagedKVCache(num_layers=1, num_pages=4, page_size=8,
                         num_heads=1, head_dim=8, max_pages_per_request=2,
                         quantize="int4", device="cpu")


def test_cpu_quantized_decode_never_reaches_a_kernel():
    before = [k.launches for k in kernels.KERNELS]
    rng = np.random.RandomState(18)
    _, _, targs, tsc = _quant_state(rng, "fp8", [5], 8, 1, 2, 128, 1)
    flash_decode(*targs, k_scale=tsc[0], v_scale=tsc[1])
    assert [k.launches for k in kernels.KERNELS] == before


# -- the Hopper kernel's route and partition --------------------------------


class _Recorder:
    """Stands in for a ``Kernel``: keeps the arguments of each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)


@pytest.fixture
def recorders(monkeypatch):
    rec = {}
    for name in ("FLASH_DECODE", "FLASH_DECODE_SM90",
                 "FLASH_DECODE_SM90_INT8", "FLASH_DECODE_SM90_FP8"):
        rec[name] = _Recorder()
        monkeypatch.setattr(tatt, name, rec[name])
    monkeypatch.setattr(tatt, "_DECODE_SM90_KERNELS", {
        torch.bfloat16: rec["FLASH_DECODE_SM90"],
        torch.int8: rec["FLASH_DECODE_SM90_INT8"],
        torch.float8_e4m3fn: rec["FLASH_DECODE_SM90_FP8"]})
    monkeypatch.setattr(tatt, "_stream", lambda device: None)
    return rec


POOLS = {"bfloat16": ("FLASH_DECODE_SM90", torch.bfloat16),
         "int8": ("FLASH_DECODE_SM90_INT8", torch.int8),
         "fp8": ("FLASH_DECODE_SM90_FP8", torch.float8_e4m3fn)}


def _engine_operands(pool_dtype, q_dtype, b=3, h=4, q_len=1, d=128,
                     page_size=64, p_max=5):
    """q as the decode step hands it in (a [b, h, q_len, d] view of the
    fused qkv projection), one layer's pool and scale planes."""
    qkv = torch.zeros(b, q_len, 3 * h * d, dtype=q_dtype)
    q = qkv[..., :h * d].view(b, q_len, h, d).transpose(1, 2)
    pool = torch.zeros(2, 1 + b * p_max, page_size, h, d, dtype=pool_dtype)
    scales = torch.ones(2, 1 + b * p_max, page_size, h)
    table = torch.zeros(b, p_max, dtype=torch.int32)
    kv_len = torch.ones(b, dtype=torch.int32)
    return q, pool[0], pool[1], table, kv_len, scales[0], scales[1]


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", list(POOLS))
def test_wrapper_launches_the_pools_entry_point(recorders, pool, q_dtype):
    name, pool_dtype = POOLS[pool]
    q, kp, vp, table, kv_len, ks, vs = _engine_operands(pool_dtype, q_dtype)
    assert tatt._decode_route(q, kp) == "sm90"
    quantized = pool != "bfloat16"
    o = tatt._flash_decode_sm90_cuda(
        q, kp, vp, table, kv_len, 0.5, ks if quantized else None,
        vs if quantized else None)
    assert [len(r.calls) for n, r in recorders.items() if n != name] == \
        [0, 0, 0]
    (args,) = recorders[name].calls
    b, h, q_len, d = q.shape
    max_splits = tatt.decode_max_splits(5, 64, 128)
    assert max_splits == 3      # 5 pages of 64 in splits of 2 pages
    assert args[:4] == (tatt._KERNEL_DTYPES[q_dtype], 128, None,
                        q.data_ptr())
    assert args[4:6] == (kp.data_ptr(), vp.data_ptr())
    assert args[6:8] == ((ks.data_ptr(), vs.data_ptr()) if quantized
                         else (None, None))
    assert args[8] == o.data_ptr() and args[9] is not None
    assert args[12:19] == (b, h, q_len, 5, 64, kp.shape[0], max_splits)
    assert list(args[19]) == [*q.stride()[:3], *kp.stride()[:3],
                              *o.stride()[:3],
                              *(ks.stride() if quantized else (0, 0, 0))]
    assert args[20:] == (0.5, None)
    assert o.dtype == q_dtype and o.shape == q.shape
    assert o.transpose(1, 2).is_contiguous()   # [b, q_len, h, d] in memory


def test_one_split_tables_take_no_workspace(recorders):
    q, kp, vp, table, kv_len, _, _ = _engine_operands(torch.bfloat16,
                                                      torch.bfloat16,
                                                      p_max=2)
    tatt._flash_decode_sm90_cuda(q, kp, vp, table, kv_len, 0.5)
    (args,) = recorders["FLASH_DECODE_SM90"].calls
    assert args[9] is None and args[18] == 1


def test_workspace_holds_every_split_partial(monkeypatch, recorders):
    sizes = []
    real_empty = torch.empty

    def spy(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    q, kp, vp, table, kv_len, ks, vs = _engine_operands(torch.int8,
                                                        torch.bfloat16,
                                                        q_len=3, p_max=16)
    monkeypatch.setattr(tatt.torch, "empty", spy)
    tatt._flash_decode_sm90_cuda(q, kp, vp, table, kv_len, 0.5, ks, vs)
    b, h, q_len, d = q.shape
    # o, then (m, l, acc[d]) for every (request, head, row, split)
    assert sizes == [b * q_len * h * d, b * h * q_len * 8 * (d + 2)]


@pytest.mark.parametrize("pool_dtype,d,route", [
    (torch.bfloat16, 128, "sm90"), (torch.int8, 128, "sm90"),
    (torch.float8_e4m3fn, 128, "sm90"), (torch.float32, 128, "scalar"),
    (torch.bfloat16, 8, "scalar"), (torch.bfloat16, 64, "scalar")])
def test_decode_route(pool_dtype, d, route):
    q = torch.zeros(1, 1, 1, d, dtype=torch.bfloat16)
    assert tatt._decode_route(q, torch.zeros(2, 8, 1, d).to(pool_dtype)) \
        == route


@pytest.mark.parametrize("bad", ["scales on a bf16 pool", "codes alone",
                                 "fp16 scales", "scale shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(recorders, bad):
    pool_dtype = torch.bfloat16 if bad == "scales on a bf16 pool" \
        else torch.int8
    q, kp, vp, table, kv_len, ks, vs = _engine_operands(pool_dtype,
                                                        torch.bfloat16)
    if bad == "codes alone":
        ks = vs = None
    elif bad == "fp16 scales":
        ks, vs = ks.half(), vs.half()
    elif bad == "scale shape":
        ks, vs = ks[:, :8], vs[:, :8]
    with pytest.raises(ValueError):
        tatt._flash_decode_sm90_cuda(q, kp, vp, table, kv_len, 0.5, ks, vs)
    assert not any(r.calls for r in recorders.values())


def _source_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_partition_constants_are_the_sources():
    assert _source_constant("kSplitElems") == tatt._DECODE_SPLIT_ELEMS
    assert _source_constant("kWarps") == tatt._DECODE_WARPS
    assert _source_constant("kTile") == tatt._DECODE_TILE
    assert _source_constant("kD") in tatt._DECODE_SM90_HEAD_DIMS
    # the three entry points the Kernel objects bind, one a pool dtype
    for symbol, code in (("flash_decode_sm90", "__nv_bfloat16"),
                         ("flash_decode_sm90_int8", "int8_t"),
                         ("flash_decode_sm90_fp8", "__nv_fp8_e4m3")):
        assert f"APEX_DECODE_ENTRY({symbol}, {code})" in SOURCE
    assert {k.symbol for k in tatt._DECODE_SM90_KERNELS.values()} == {
        "flash_decode_sm90", "flash_decode_sm90_int8",
        "flash_decode_sm90_fp8"}


@pytest.mark.parametrize("page_size", [1, 8, 16, 48, 64, 128, 256])
@pytest.mark.parametrize("kv_len", [0, 1, 15, 16, 17, 64, 127, 128, 129,
                                    300, 1024])
def test_partition_folds_every_visible_column_once(kv_len, page_size):
    cols = tatt.decode_split_columns(page_size, 128)
    assert cols % page_size == 0
    assert cols == max(page_size, (128 // page_size) * page_size)
    splits = tatt.decode_partition(kv_len, page_size, 128)
    assert len(splits) == max(1, -(-kv_len // cols))
    if kv_len % page_size == 0:
        assert tatt.decode_max_splits(kv_len // page_size, page_size,
                                      128) == len(splits)
    flat = [c for split in splits for warp in split for c in warp]
    assert sorted(flat) == list(range(kv_len))
    for s, split in enumerate(splits):
        assert len(split) == tatt._DECODE_WARPS
        for w, warp in enumerate(split):
            # the warp's tiles: tile t of the split goes to warp t % warps
            for c in warp:
                assert c // cols == s
                assert ((c % cols) // tatt._DECODE_TILE
                        % tatt._DECODE_WARPS == w)
            assert warp == sorted(warp)


def test_partition_reads_neither_the_batch_nor_the_card(monkeypatch):
    assert list(inspect.signature(tatt.decode_partition).parameters) == [
        "kv_len", "page_size", "d"]
    want = tatt.decode_partition(300, 64, 128)
    want_max = tatt.decode_max_splits(5, 64, 128)

    def no_card(*args, **kwargs):
        raise AssertionError("the partition asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert tatt.decode_partition(300, 64, 128) == want
    assert tatt.decode_max_splits(5, 64, 128) == want_max


def test_launch_arguments_do_not_follow_the_batch(recorders):
    # one request alone and the same request in a batch of eight: every
    # argument the kernel's partition reads (the table's width, the page
    # size, the head dim, max_splits) is the same
    args = []
    for b in (1, 8):
        q, kp, vp, table, kv_len, _, _ = _engine_operands(
            torch.bfloat16, torch.bfloat16, b=b)
        tatt._flash_decode_sm90_cuda(q, kp, vp, table, kv_len, 0.5)
        args.append(recorders["FLASH_DECODE_SM90"].calls[-1])
    one, eight = args
    assert one[12] == 1 and eight[12] == 8
    assert one[1] == eight[1] and one[13:17] == eight[13:17]
    assert one[18] == eight[18]
