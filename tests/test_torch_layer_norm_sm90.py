"""The route of the port's LayerNorm to ``csrc/layer_norm_sm90.cu``, the
backward's row partition and workspace, and the plain versions' parity
with JAX at that kernel's widths.

fp32 and bf16 rows of 1024, 2048 and 4096 columns run
``layer_norm_sm90.cu``; every other width ``layer_norm.cu``.  The kernels
run only on the card (``chip_smoke.py`` holds them against their plain
versions there, and their repeats bit for bit); here the wrapper's choice
of kernel and the arguments it passes are read with the four ``Kernel``
objects replaced by recorders, so nothing is launched.  The partition of
the backward's dgamma/dbeta sums (:func:`ln_bwd_partition`) is held
against the constants and instances of the CUDA source, read as text.

Tolerances of the parity cases, as in ``tests/test_torch_layer_norm.py``:
fp32 1e-5 x max(1, max|ref|) (sums in another order); bf16 outputs 2^-7 x
max|ref|, one bf16 ulp at the output's scale; the fp32 dweight/dbias of a
bf16 x 1e-5 x max(1, max|ref|).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import ops as jops
from apex_tpu_torch.ops import fused_layer_norm as tln

SOURCE = (Path(tln.__file__).resolve().parent.parent / "csrc"
          / "layer_norm_sm90.cu").read_text()
FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Recorder:
    """Stands in for a ``Kernel``: keeps the arguments of each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)


@pytest.fixture
def recorders(monkeypatch):
    rec = {name: _Recorder() for name in (
        "LAYER_NORM_FWD", "LAYER_NORM_BWD", "LAYER_NORM_FWD_SM90",
        "LAYER_NORM_BWD_SM90")}
    for name, r in rec.items():
        monkeypatch.setattr(tln, name, r)
    monkeypatch.setattr(tln, "_stream", lambda device: None)
    return rec


def _source_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _instances(direction):
    """{(dtype, cols): (V, W)} of ``layer_norm_{direction}_sm90``'s
    launcher, read from the source."""
    entry = SOURCE[SOURCE.index(f"int layer_norm_{direction}_sm90"):]
    entry = entry[:entry.index("return cudaErrorInvalidValue")]
    out = {}
    for dtype, code in (("bfloat16", 1), ("float32", 0)):
        block = re.search(rf"if \(dtype == {code}\) \{{(.*?)\}}", entry,
                          re.S).group(1)
        for cols, v, w in re.findall(
                rf"cols == (\d+)\)\s*return launch_{direction}<[\w:]+, "
                r"(\d+), (\d+)>", block):
            out[(dtype, int(cols))] = (int(v), int(w))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("cols", [256, 512, 1024, 1536, 2048, 3072, 4096,
                                  8192])
def test_route_is_sm90_for_fp32_and_bf16_at_its_widths(dtype, cols):
    want = ("sm90" if dtype != "float16" and cols in (1024, 2048, 4096)
            else "rows")
    assert tln._ln_route(getattr(torch, dtype), cols) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cols", [256, 1024, 1536, 2048, 4096])
def test_wrappers_launch_the_routes_kernel_with_its_workspace(recorders,
                                                              dtype, cols):
    rows = 37
    x = torch.zeros(rows, cols, dtype=DTYPES[dtype])
    w, b = torch.ones(cols), torch.zeros(cols)
    y, mean, invvar = tln._ln_fwd_cuda(x, w, b, 1e-5)
    dx, dw, db = tln._ln_bwd_cuda(x, torch.zeros_like(x), mean, invvar, w,
                                  True)
    sm90 = tln._ln_route(x.dtype, cols) == "sm90"
    fwd, other_fwd = (recorders["LAYER_NORM_FWD_SM90"],
                      recorders["LAYER_NORM_FWD"])
    bwd, other_bwd = (recorders["LAYER_NORM_BWD_SM90"],
                      recorders["LAYER_NORM_BWD"])
    if not sm90:
        fwd, other_fwd, bwd, other_bwd = other_fwd, fwd, other_bwd, bwd
    assert (len(fwd.calls), len(other_fwd.calls)) == (1, 0)
    assert (len(bwd.calls), len(other_bwd.calls)) == (1, 0)
    code = tln._KERNEL_DTYPES[x.dtype]
    f = fwd.calls[0]
    assert f[:3] == (code, None, x.data_ptr())      # CPU: device index None
    assert f[5:] == (y.data_ptr(), mean.data_ptr(), invvar.data_ptr(), rows,
                     cols, 1e-5, None)
    g = bwd.calls[0]
    assert g[0] == code and g[11:] == (rows, cols, None)
    assert g[7:9] == (dx.data_ptr(), dw.data_ptr())
    assert y.shape == dx.shape == x.shape and dw.dtype == torch.float32


@pytest.mark.parametrize("cols", [1024, 2048, 4096])
def test_backward_workspace_is_the_partitions(monkeypatch, cols):
    sizes = []
    real_empty = torch.empty

    def spy(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    for name in ("LAYER_NORM_BWD", "LAYER_NORM_BWD_SM90"):
        monkeypatch.setattr(tln, name, _Recorder())
    monkeypatch.setattr(tln, "_stream", lambda device: None)
    rows = 8191
    x = torch.zeros(rows, cols, dtype=torch.bfloat16)
    monkeypatch.setattr(tln.torch, "empty", spy)
    tln._ln_bwd_cuda(x, x, torch.zeros(rows), torch.ones(rows),
                     torch.ones(cols), True)
    blocks = tln.ln_bwd_partition(rows, torch.bfloat16, cols)
    # dw, db [cols] each, then the partials: dweight's and dbias's, one row
    # of cols a block
    assert sizes == [cols, cols, 2 * len(blocks) * cols]
    assert tln.ln_bwd_workspace(rows, cols) == 2 * len(blocks) * cols


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 37, 100, 8191, 8192])
@pytest.mark.parametrize("dtype,cols", [("bfloat16", 1024),
                                        ("bfloat16", 2048),
                                        ("bfloat16", 4096),
                                        ("float32", 1024),
                                        ("float32", 4096),
                                        ("bfloat16", 1536)])
def test_backward_partition_tiles_the_rows_once(rows, dtype, cols):
    blocks = tln.ln_bwd_partition(rows, DTYPES[dtype], cols)
    per = _source_constant("kBwdRowsPerBlock")
    assert per == tln._ROWS_PER_PARTIAL
    assert len(blocks) == math.ceil(rows / per)
    seen = []
    for i, groups in enumerate(blocks):
        for g in groups:
            assert g == sorted(g)
            assert all(i * per <= r < min(rows, (i + 1) * per) for r in g)
            seen += g
    assert sorted(seen) == list(range(rows))    # each row once, none past


def test_backward_partition_asks_nothing_of_the_device(monkeypatch):
    def refuse(*_):
        raise AssertionError("the partition read the device")

    want = tln.ln_bwd_partition(8191, torch.bfloat16, 2048)
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    assert tln.ln_bwd_partition(8191, torch.bfloat16, 2048) == want


@pytest.mark.parametrize("dtype,cols", [(d, c) for d in DTYPES
                                        for c in (1024, 2048, 4096)])
def test_partition_groups_are_the_sources_instances(dtype, cols):
    v, w = _instances("bwd")[(dtype, cols)]
    lane_cols = _source_constant("kBwdLaneCols")
    assert lane_cols == tln._SM90_LANE_COLS
    n = 16 // DTYPES[dtype].itemsize     # values in a 16-byte vector
    assert v * n == lane_cols and v * w * 32 * n == cols
    warps = _source_constant("kThreads") // 32
    assert warps == tln._SM90_WARPS
    blocks = tln.ln_bwd_partition(64, DTYPES[dtype], cols)
    assert all(len(groups) == warps // w for groups in blocks)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_every_route_width_has_its_instance(direction):
    got = _instances(direction)
    assert set(got) == {(d, c) for d in DTYPES for c in tln.SM90_WIDTHS}
    for (dtype, cols), (v, w) in got.items():   # a row is W warps of V
        n = 16 // DTYPES[dtype].itemsize        # 16-byte vectors a lane
        assert v * w * 32 * n == cols and _source_constant("kThreads") % (
            32 * w) == 0


def _inputs(rows, cols, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, cols) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(cols)).astype(np.float32)
    b = (0.1 * rng.randn(cols)).astype(np.float32)
    dy = rng.randn(rows, cols).astype(np.float32)
    return x, w, b, dy


def _close(got, ref, low_precision=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    tol = BF16_TOL * scale if low_precision else FP32_TOL * max(1.0, scale)
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_at_1024_with_ragged_rows(dtype,
                                                           use_pallas):
    rows, cols = 37, 1024
    x, w, b, dy = _inputs(rows, cols, seed=11)
    low = dtype == "bfloat16"
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jdy = jnp.asarray(dy, getattr(jnp, dtype))
    jy, vjp = jax.vjp(lambda x, w, b: jops.layer_norm(
        x, w, b, eps=1e-5, use_pallas=use_pallas), jx, jnp.asarray(w),
        jnp.asarray(b))
    jdx, jdw, jdb = vjp(jdy)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(DTYPES[dtype])
    tdy = torch.tensor(np.asarray(jdy.astype(jnp.float32))).to(DTYPES[dtype])
    y, mean, invvar = tln._ln_fwd_plain(tx, torch.tensor(w), torch.tensor(b),
                                        1e-5)
    dx, dw, db = tln._ln_bwd_plain(tx, tdy, mean, invvar, torch.tensor(w),
                                   True)
    assert y.dtype == dx.dtype == DTYPES[dtype]
    _close(y.float(), jy.astype(jnp.float32), low)
    _close(dx.float(), jdx.astype(jnp.float32), low)
    _close(dw, jdw)
    _close(db, jdb)
