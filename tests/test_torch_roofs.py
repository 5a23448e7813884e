"""Parity of the port's roofs and floor (``apex_tpu_torch.profiling``)
with the JAX bench's: the attention dot floor K10 (the plain version of
``csrc/attention_dots.cu``) against ``bench._attention_dot_floor``'s own
Pallas kernel, run in interpret mode on the CPU; its per-tile causal skip
against the rule stated pair by pair; K9's plain copy (the plain version
of ``csrc/hbm_copy.cu``); the flop and byte counts against the
expressions in ``bench.py``'s source; and the measuring entry points,
which must raise without a card rather than time anything on the CPU.

Tolerances: K10 2^-7 x max|ref| (one bf16 ulp at the output's scale).
The JAX kernel sums its per-tile fp32 products with a tree sum, the port
with one dense fp32 product, so the fp32 sums differ in their last bits
and now and then round to the other bf16 neighbour.  K9 and the counts
are exact.
"""

import ast
import functools
import inspect
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import bench
from apex_tpu_torch import kernels
from apex_tpu_torch.profiling import microbench, roofs, timing

REPO = Path(__file__).resolve().parent.parent
BF16_TOL = 2.0 ** -7


def bf16_inputs(seed, *shape, n=3):
    """n fp32 numpy arrays holding bf16 values (exactly representable in
    both packages) and the same values as torch bf16 tensors."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
          .to(torch.bfloat16) for _ in range(n)]
    return [t.float().numpy() for t in ts], ts


# -- K10 against the JAX bench's Pallas kernel -----------------------------


def jax_dot_floor(monkeypatch, arrays, block_q, block_k):
    """The output of ``bench._attention_dot_floor``'s kernel on ``arrays``
    (q, k, v as fp32 numpy holding bf16 values): ``pallas_call`` is run in
    interpret mode, and ``_device_ms`` is replaced by a stub that runs the
    jitted kernel on these arrays instead of the bench's own and keeps its
    output."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    out = {}

    def run_on_ours(fn, *_bench_args, steps=4):
        q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
        out["o"] = np.asarray(jax.jit(fn)(q, k, v).astype(jnp.float32))
        return 1.0

    monkeypatch.setattr(bench, "_device_ms", run_on_ours)
    bh, s, d = arrays[0].shape
    bench._attention_dot_floor(bh, s, d, block_q, block_k)
    return out["o"]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,block_q,block_k", [
    (256, 128, 128),
    (256, 64, 128),      # unequal blocks: qi + bq - 1 < kb * bk decides
    (256, 128, 64),
    (128, 128, 128),     # one tile, s = block
])
def test_attention_dots_plain_matches_jax_dot_floor(monkeypatch, d, s,
                                                    block_q, block_k):
    arrays, (q, k, v) = bf16_inputs(s + d + block_q + 3 * block_k, 2, s, d)
    ref = jax_dot_floor(monkeypatch, arrays, block_q, block_k)
    got = roofs.attention_dots(q, k, v, block_q, block_k)
    assert got.dtype == torch.bfloat16 and got.shape == (2, s, d)
    err = np.abs(got.float().numpy() - ref).max()
    tol = BF16_TOL * np.abs(ref).max()
    assert np.abs(ref).max() > 0
    assert err <= tol, (err, tol)


# -- K10's skip rule, pair by pair -------------------------------------------


def rule(i, j, bq, bk):
    """``bench.py``'s static causal tile skip for one pair."""
    return not (i // bq * bq + bq - 1 < j // bk * bk)


@pytest.mark.parametrize("block_q,block_k", [(32, 64), (64, 32), (128, 64),
                                             (16, 16), (512, 512)])
def test_dots_plain_sums_exactly_the_rule_pairs(block_q, block_k):
    """With v the identity (s = d = 128), the output IS the masked P: every
    pair the rule keeps shows bf16(q.k * 1e-3), every other pair 0, and
    their number is ``dots_pairs``."""
    s = d = 128
    bq, bk = min(block_q, s), min(block_k, s)
    want = np.array([[rule(i, j, bq, bk) for j in range(s)] for i in range(s)])
    assert np.array_equal(roofs.dots_keep(s, block_q, block_k).numpy(), want)
    # positive operands: every score is nonzero, so a kept P is nonzero
    g = torch.Generator().manual_seed(5)
    q, k = (torch.rand(1, s, d, generator=g).add(0.5).to(torch.bfloat16)
            for _ in range(2))
    eye = torch.eye(s, dtype=torch.bfloat16)[None]
    o = roofs.attention_dots(q, k, eye, block_q, block_k)[0].float()
    assert np.array_equal((o != 0).numpy(), want)
    assert int((o != 0).sum()) == roofs.dots_pairs(s, block_q, block_k)
    scores = q[0].double() @ k[0].double().T * 1e-3
    kept = torch.from_numpy(want)
    assert torch.allclose(o[kept], scores[kept].float(), rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("s,block_q,block_k,share", [
    (1024, 512, 512, 3 / 4),         # bench.py's shape: 3/4 of dense
    (2048, 64, 64, 528 / 1024),      # GPT-1.3B's, blocks 64: ~0.516
    (256, 64, 64, 10 / 16),          # Transformer-big's encoder
])
def test_dots_pairs_counts_the_executed_work(s, block_q, block_k, share):
    assert roofs.dots_pairs(s, block_q, block_k) == share * s * s
    assert roofs.dots_pairs(s, block_q, block_k) == int(
        roofs.dots_keep(s, block_q, block_k).sum())


def test_attention_dots_checks_its_arguments():
    _, (q, k, v) = bf16_inputs(0, 2, 128, 64)
    with pytest.raises(ValueError, match="divide"):
        roofs.attention_dots(q, k, v, 96, 64)      # 96 does not divide 128
    with pytest.raises(TypeError):
        roofs.attention_dots(q.float(), k.float(), v.float(), 64, 64)
    with pytest.raises(ValueError, match="shape"):
        roofs.attention_dots(q, k[:, :64], v, 64, 64)


@pytest.mark.parametrize("d,block_q,block_k,match", [
    (64, 32, 64, "multiples"),    # the kernel walks tiles of 64
    (64, 64, 32, "multiples"),
    (32, 64, 64, "head dims"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(d, block_q,
                                                              block_k, match):
    """The CUDA wrapper checks blocks and head dim before it touches the
    card (here it is handed CPU tensors and must raise first)."""
    _, (q, k, v) = bf16_inputs(1, 2, 128, d)
    before = kernels.ATTENTION_DOTS.launches
    with pytest.raises(ValueError, match=match):
        roofs._attention_dots_cuda(q, k, v, block_q, block_k)
    assert kernels.ATTENTION_DOTS.launches == before


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    _, (q, k, v) = bf16_inputs(2, 1, 128, 64)
    before = (kernels.ATTENTION_DOTS.launches, kernels.HBM_COPY.launches)
    roofs.attention_dots(q, k, v, 64, 64)
    roofs.hbm_copy(q)
    assert (kernels.ATTENTION_DOTS.launches,
            kernels.HBM_COPY.launches) == before


# -- K9: the copy ------------------------------------------------------------
#
# JAX's bench_hbm_roof runs only at its fixed 512 MiB shape: in interpret
# mode on a CPU that is ~9 s and over 1 GB per call, too heavy for the
# tier-1 suite.  Its kernel body is ``o_ref[...] = x_ref[...]``
# (bench.py:205), an identity, so the port's plain copy is held to its input
# bit for bit.


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (64, 128)),
    (torch.bfloat16, (256, 32)),
    (torch.bfloat16, (2 ** 12 + 3,)),     # ragged: not a multiple of 16 bytes
    (torch.uint8, (1001,)),
])
@pytest.mark.parametrize("given_out", [False, True])
def test_hbm_copy_plain_is_bitwise(dtype, shape, given_out):
    g = torch.Generator().manual_seed(3)
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    # any bits, NaNs too
    x = torch.randint(0, 256, (n,), dtype=torch.uint8,
                      generator=g).view(dtype).view(shape)
    out = torch.empty_like(x) if given_out else None
    y = roofs.hbm_copy(x, out)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.data_ptr() != x.data_ptr()
    if given_out:
        assert y is out
    assert torch.equal(y.view(torch.uint8), x.view(torch.uint8))


def test_hbm_copy_refuses_a_mismatched_out():
    x = torch.zeros(16)
    for out in (torch.zeros(16, dtype=torch.bfloat16), torch.zeros(8)):
        with pytest.raises(ValueError, match="does not match"):
            roofs.hbm_copy(x, out)


@pytest.mark.parametrize("x_off,out_off,refused", [
    (0, 0, None),                 # fresh allocations: taken
    (1, 0, "aligned x"),          # a sliced source, 2 bytes off
    (0, 4, "aligned out"),        # a sliced destination, 8 bytes off
])
def test_misaligned_pointers_are_refused(x_off, out_off, refused):
    """``hbm_copy.cu`` moves 16 bytes an access, so the CUDA wrapper
    refuses a tensor that is not 16-byte aligned (a slice) before it
    launches; the check reads only pointers, so it runs here on CPU
    tensors."""
    base_x = torch.zeros(64 + x_off, dtype=torch.bfloat16)
    base_out = torch.zeros(64 + out_off, dtype=torch.bfloat16)
    assert base_x.data_ptr() % 16 == base_out.data_ptr() % 16 == 0
    x, out = base_x[x_off:], base_out[out_off:]
    if refused is None:
        roofs._check_copy(x, out)
    else:
        with pytest.raises(ValueError, match=refused):
            roofs._check_copy(x, out)


# -- the counts against bench.py's own expressions --------------------------


def bench_function(name):
    tree = ast.parse((REPO / "bench.py").read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def bench_value(fn_name, target, env):
    """Evaluate the expression ``bench.py``'s function ``fn_name`` assigns
    to ``target`` (a name, or a key of its ``out`` dict), or returns when
    ``target`` is "return", with the names in ``env``."""
    for node in ast.walk(bench_function(fn_name)):
        expr = None
        if target == "return" and isinstance(node, ast.Return):
            expr = node.value
        elif isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == target:
                expr = node.value
            elif (isinstance(t, ast.Subscript)
                  and isinstance(t.slice, ast.Constant)
                  and t.slice.value == target):
                expr = node.value
            elif isinstance(node.value, ast.Dict):
                for key, val in zip(node.value.keys, node.value.values):
                    if isinstance(key, ast.Constant) and key.value == target:
                        expr = val
        if expr is not None:
            return eval(compile(ast.Expression(expr), "bench.py", "eval"),
                        {"round": round}, dict(env))
    raise LookupError(f"{fn_name} assigns no {target}")


@pytest.mark.parametrize("bh,s,d", [(128, 1024, 64), (16, 4096, 128)])
def test_attention_flops_are_bench_counts(bh, s, d):
    env = {"bh": bh, "s": s, "d": d}
    fwd = bench_value("bench_attention_kernel", "fwd_flops", env)
    bwd = bench_value("bench_attention_kernel", "bwd_flops",
                      {**env, "fwd_flops": fwd})
    assert microbench.attention_flops(bh, s, d) == (fwd, bwd)
    assert roofs.dots_flops(bh, s, d) == bench_value(
        "_attention_dot_floor", "flops", env)


def test_layer_norm_bytes_are_bench_counts():
    fn = bench_function("bench_layernorm_kernel")
    shape = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and isinstance(n.targets[0], ast.Tuple)
                 and [e.id for e in n.targets[0].elts] == ["rows", "cols"])
    rows, cols = ast.literal_eval(shape)
    assert (rows, cols) == (microbench.LN_ROWS, microbench.LN_COLS)
    nbytes = bench_value("bench_layernorm_kernel", "nbytes",
                         {"rows": rows, "cols": cols})
    # a time of 1e-9 s turns bench's GB/s expressions into their bytes
    env = {"nbytes": nbytes, "t_p": 1e-9, "t_fb": 1e-9}
    assert microbench.layer_norm_bytes() == (
        bench_value("bench_layernorm_kernel", "fwd_pallas_gb_s", env),
        bench_value("bench_layernorm_kernel", "bwd_fused_gb_s", env))


def test_copy_bytes_is_bench_count():
    x = torch.empty(16384 * 8192 // 64, dtype=torch.float32)
    gb_per_s = bench_value("bench_hbm_roof", "return",
                           {"x": SimpleNamespace(size=x.numel()), "t": 1.0})
    assert roofs.copy_bytes(x) / 1e9 == gb_per_s


def test_roof_defaults_are_bench_shapes():
    rows_cols = next(n.value for n in ast.walk(bench_function(
        "bench_hbm_roof")) if isinstance(n, ast.Assign)
        and isinstance(n.targets[0], ast.Tuple))
    m = bench_value("bench_matmul_roof", "m", {})
    hbm = inspect.signature(roofs.hbm_roof).parameters
    assert ast.literal_eval(rows_cols) == (hbm["rows"].default,
                                           hbm["cols"].default)
    assert m == inspect.signature(roofs.matmul_roof).parameters["m"].default
    for fn in ("bench_hbm_roof", "bench_matmul_roof"):   # _device_ms(steps=)
        steps = next(kw.value.value for n in ast.walk(bench_function(fn))
                     if isinstance(n, ast.Call)
                     and getattr(n.func, "id", None) == "_device_ms"
                     for kw in n.keywords if kw.arg == "steps")
        assert steps == timing.ROOF_STEPS


# -- no CPU fallback ---------------------------------------------------------


MEASURES = {
    "device_time_ms": lambda: timing.device_time_ms(lambda: None),
    "timed_pair": lambda: timing.timed_pair(lambda: None, lambda: None, (),
                                            ()),
    "cold_ms": lambda: timing.cold_ms(lambda: None),
    "hbm_roof": lambda: roofs.hbm_roof(),
    "matmul_roof": lambda: roofs.matmul_roof(),
    "attention_dot_floor": lambda: roofs.attention_dot_floor(2, 128, 64, 64,
                                                             64),
    "attention_kernel": lambda: microbench.attention_kernel(
        2, 128, 64, 64, 64, measure_floor=True),
    "layer_norm_kernel": lambda: microbench.layer_norm_kernel(),
}


@pytest.mark.parametrize("name", sorted(MEASURES))
def test_measures_raise_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA|card"):
        MEASURES[name]()


@pytest.mark.parametrize("fn", [roofs.hbm_roof, roofs.matmul_roof,
                                microbench.layer_norm_kernel])
def test_measures_refuse_the_cpu(fn):
    with pytest.raises(RuntimeError, match="card"):
        fn(device="cpu")


def test_timers_refuse_cpu_tensors_even_with_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    x = torch.zeros(4)
    calls = []
    with pytest.raises(RuntimeError, match="cpu tensor"):
        timing.device_time_ms(calls.append, x)
    with pytest.raises(RuntimeError, match="cpu tensor"):
        timing.timed_pair(calls.append, calls.append, (x,), (x,))
    assert calls == []   # refused before the first call


def test_profiling_imports_neither_jax_nor_apex_tpu():
    code = ("import sys, apex_tpu_torch.profiling\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apex_tpu', 'bench'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
