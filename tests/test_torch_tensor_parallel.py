"""The port's tensor parallelism against the JAX package's, case for case
with ``tests/L0/test_tensor_parallel.py``, at tp = 2 and tp = 4.

The port's ranks are processes (gloo on a ``file://`` store, one launch a
tp size, every rank-side check in ``tests/torch_ranks.py``); the JAX
side is the same function inside ``shard_map`` on the emulated 8-device
mesh of ``tests/conftest.py``, its model-parallel state destroyed after
each use.  Inputs are seeded numpy arrays given to both.

Tolerances: the regions, the embedding lookup, the broadcast and the 1-D
split are exact (copies, and sums of integers or of values with an exact
fp32 sum); fp32 products and their gradients 1e-5 x max(1, max|ref|)
(sums in another order); the cross entropy and its gradient 1e-5
absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as ttp

import torch_ranks

TPS = (2, 4)
TOL = 1e-5


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _case(tp):
    r = np.random.RandomState(tp)
    n = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "x86": n(8, 6), "x_roundtrip": n(2, 4, 8 * tp),
        "col": {"weight": n(32, 16) * 0.3, "bias": n(32)},
        "row": {"weight": n(16, 32) * 0.3, "bias": n(16)},
        "x_col": n(6, 16), "x_row": n(6, 32),
        "pair_c": n(16, 8) * 0.3, "pair_r": n(8, 16) * 0.3, "x_pair": n(4, 8),
        "emb": n(32, 12), "ids": r.randint(0, 32, (5, 7)),
        "emb_dy": n(5, 7, 12),
        "logits": n(6, 8 * tp) * 3, "target": r.randint(0, 8 * tp, (6,)),
        "tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
        "x_1d": np.arange(tp * 6.0, dtype=np.float32).reshape(2, tp * 3),
    }


@pytest.fixture(scope="module", params=TPS, ids=lambda t: f"tp{t}")
def run(request, tmp_path_factory):
    """(tp, case, the ranks' results, JAX's results)."""
    tp = request.param
    case = _case(tp)
    out = tmp_path_factory.mktemp(f"tp{tp}")
    spawn(torch_ranks.tensor_parallel_checks, tp, str(out / "store"),
          str(out), case)
    return tp, case, torch_ranks.load_ranks(str(out), tp), _jax(tp, case)


def _stack(shards):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *shards)


def _jax(tp, case):
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(tp, 1)
    try:
        def smap(f, ins, outs=P()):
            return shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs,
                             check_vma=False)

        local = lambda p: jax.tree_util.tree_map(lambda v: v[0], p)  # noqa
        res = {}

        def layer(cls, m, x, **kw):
            lay = cls(m["weight"].shape[1], m["weight"].shape[0], **kw)
            st = _stack([lay.shard_master(jax.tree_util.tree_map(
                jnp.asarray, m), r) for r in range(tp)])

            def loss(p, xs):
                return smap(lambda p, xv: jnp.sum(lay.apply(local(p), xv) ** 2),
                            (P("tensor"), P()))(p, xs)

            out = jax.jit(smap(lambda p, xv: lay.apply(local(p), xv),
                               (P("tensor"), P())))(st, jnp.asarray(x))
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                st, jnp.asarray(x))
            return out, gx, gp

        res["column"] = layer(jtp.ColumnParallelLinear, case["col"],
                              case["x_col"], gather_output=True)
        res["row"] = layer(jtp.RowParallelLinear, case["row"], case["x_row"],
                           input_is_parallel=False)
        emb = jtp.VocabParallelEmbedding(32, 12)
        st = _stack([emb.shard_master({"weight": jnp.asarray(case["emb"])},
                                      r) for r in range(tp)])
        res["embedding"] = smap(lambda p, i: emb.apply(local(p), i),
                                (P("tensor"), P()))(st, case["ids"])

        def ce(z, t):
            zl = jtp.scatter_to_tensor_model_parallel_region(z)
            return jtp.vocab_parallel_cross_entropy(zl, t)

        z, t = jnp.asarray(case["logits"]), jnp.asarray(case["target"])
        res["ce"] = jax.jit(smap(ce, (P(), P())))(z, t)
        res["ce_grad"] = jax.jit(jax.grad(
            lambda z: jnp.mean(smap(ce, (P(), P()))(z, t))))(z)
        return res
    finally:
        jps.destroy_model_parallel()


# -- sizes --------------------------------------------------------------------

def test_sizes(run):
    tp, _, ranks, _ = run
    for r, res in enumerate(ranks):
        assert res["sizes"] == (tp, 1, 1, r, 0, (r, 0, 0))


def test_invalid_sizes(run):
    for res in run[2]:
        assert res["invalid_raises"] and res["uninitialized_raises"]


@pytest.mark.parametrize("tp,pp,dp", [(2, 1, 2), (2, 2, 1), (4, 1, 2)])
def test_rank_layout_is_the_jax_mesh(tp, pp, dp):
    """rank_grid places global rank r where the JAX mesh puts device r,
    and every group is the ranks that differ in its axis only."""
    jps.destroy_model_parallel()
    try:
        mesh = jps.initialize_model_parallel(
            tp, pp, devices=jax.devices()[:tp * pp * dp])
        ids = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices))
    finally:
        jps.destroy_model_parallel()
    grid = ps.rank_grid(tp * pp * dp, tp, pp)
    np.testing.assert_array_equal(grid, ids - ids.min())
    groups = ps.group_ranks(tp * pp * dp, tp, pp)
    assert groups["tensor"] == [list(grid[d, p]) for d in range(dp)
                                for p in range(pp)]
    assert sorted(map(sorted, groups["data"])) == sorted(
        sorted(grid[:, p, t]) for p in range(pp) for t in range(tp))
    for r in range(tp * pp * dp):
        t, p, d = ps.coordinates(r, tp * pp * dp, tp, pp)
        assert grid[d, p, t] == r


# -- mappings -----------------------------------------------------------------

def test_copy_backward_sums_rank_contributions(run):
    tp, case, ranks, _ = run
    want_loss = sum(range(1, tp + 1)) * float(case["x86"].sum())
    for res in ranks:
        y, loss, g = res["copy"]
        np.testing.assert_array_equal(y, case["x86"])
        close(loss, want_loss)
        np.testing.assert_array_equal(
            g, np.full_like(case["x86"], sum(range(1, tp + 1))))


def test_scatter_gather_roundtrip(run):
    tp, case, ranks, _ = run
    for res in ranks:
        shape, back = res["roundtrip"]
        assert shape == (2, 4, 8)
        np.testing.assert_array_equal(back, case["x_roundtrip"])


def test_reduce(run):
    tp, _, ranks, _ = run
    for res in ranks:
        np.testing.assert_array_equal(res["reduce"], np.full((4, 4), tp))


# -- layers -------------------------------------------------------------------

def _serial(m, x):
    x = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(m["weight"]).requires_grad_()
    b = torch.from_numpy(m["bias"]).requires_grad_()
    y = x @ w.T + b
    (y ** 2).sum().backward()
    return y.detach(), x.grad, w.grad, b.grad


@pytest.mark.parametrize("kind,dim", [("column", 0), ("row", 1)])
def test_linear_matches_serial_and_jax(run, kind, dim):
    """Output and input gradient on every rank equal the serial layer's
    and JAX's; each rank's weight gradient is its shard of the serial
    one and of JAX's stacked one; the bias gradient its shard (column) or
    the whole (row)."""
    tp, case, ranks, jres = run
    m = case["col" if kind == "column" else "row"]
    y, gx, gw, gb = _serial(m, case[f"x_{'col' if kind == 'column' else 'row'}"])
    jy, jgx, jgp = jres[kind]
    for r, res in enumerate(ranks):
        oy, ogx, ogw, ogb = res[kind]
        close(oy, y)
        close(oy, jy)
        close(ogx, gx)
        close(ogx, jgx)
        close(ogw, ttp.split_tensor_along_last_dim(
            gw.T if dim == 0 else gw, tp)[r].T if dim == 0 else
            ttp.split_tensor_along_last_dim(gw, tp)[r])
        close(ogw, jgp["weight"][r])
        close(ogb, gb if kind == "row" else
              ttp.split_tensor_along_last_dim(gb, tp)[r])


def test_column_row_pair_grads_match_serial(run):
    tp, case, ranks, _ = run
    x = torch.from_numpy(case["x_pair"]).requires_grad_()
    wc = torch.from_numpy(case["pair_c"]).requires_grad_()
    wr = torch.from_numpy(case["pair_r"]).requires_grad_()
    y = torch.nn.functional.gelu(x @ wc.T, approximate="tanh") @ wr.T
    loss = (y ** 2).sum()
    loss.backward()
    chunk = 16 // tp
    for r, res in enumerate(ranks):
        ol, ogx, ogc, ogr = res["pair"]
        close(ol, loss.detach())
        close(ogx, x.grad)
        close(ogc, wc.grad[r * chunk:(r + 1) * chunk])
        close(ogr, wr.grad[:, r * chunk:(r + 1) * chunk])


def test_vocab_parallel_embedding(run):
    tp, case, ranks, jres = run
    want = case["emb"][case["ids"]]
    n = 32 // tp
    for r, res in enumerate(ranks):
        out, g = res["embedding"]
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, jres["embedding"])
        full = np.zeros((32, 12), np.float32)
        np.add.at(full, case["ids"], case["emb_dy"])
        close(g, full[r * n:(r + 1) * n])


# -- cross entropy ------------------------------------------------------------

def test_cross_entropy_matches_serial_and_jax(run):
    tp, case, ranks, jres = run
    z = torch.from_numpy(case["logits"])
    ref = torch.nn.functional.cross_entropy(
        z, torch.from_numpy(case["target"]).long(), reduction="none")
    for res in ranks:
        close(res["ce"][0], ref)
        close(res["ce"][0], jres["ce"])


def test_cross_entropy_grad_matches_serial_and_jax(run):
    tp, case, ranks, jres = run
    z = torch.from_numpy(case["logits"]).requires_grad_()
    torch.nn.functional.cross_entropy(
        z, torch.from_numpy(case["target"]).long()).backward()
    for res in ranks:
        close(res["ce"][1], z.grad)
        close(res["ce"][1], jres["ce_grad"])


# -- data and random ----------------------------------------------------------

def test_broadcast_data(run):
    _, case, ranks, _ = run
    for res in ranks:
        np.testing.assert_array_equal(res["broadcast"], case["tokens"])


def test_broadcast_data_dtype_check(run):
    for res in run[2]:
        assert res["broadcast_dtype_raises"]


def test_rng_tracker_distinct_streams():
    tracker = ttp.RngStatesTracker()
    tracker.add("a", 1)
    tracker.add("b", 2)
    with pytest.raises(Exception):
        tracker.add("a", 3)
    with pytest.raises(Exception):
        tracker.add("c", 1)  # duplicate seed
    assert tracker.fork("a") != tracker.fork("b")
    assert tracker.fork("a", 0) != tracker.fork("a", 1)
    with pytest.raises(Exception):
        tracker.fork("z")


def test_model_parallel_seed_per_rank(run):
    tp, _, ranks, _ = run
    defaults = {res["seeds"][0] for res in ranks}
    per_rank = [res["seeds"][1] for res in ranks]
    assert len(defaults) == 1 and len(set(per_rank)) == tp
    assert per_rank == [res["seeds_again"] for res in ranks]


def test_split_gather_1d(run):
    tp, case, ranks, _ = run
    flat = case["x_1d"].reshape(-1)
    chunk = flat.size // tp
    for r, res in enumerate(ranks):
        c, back = res["split_1d"]
        np.testing.assert_array_equal(c, flat[r * chunk:(r + 1) * chunk])
        np.testing.assert_array_equal(back, flat)


def test_checkpoint_matches_direct():
    def fn(x):
        return torch.sin(x) * torch.cos(x)

    x = torch.linspace(0, 1, 16, requires_grad=True)
    y = ttp.checkpoint(fn, x)
    close(y.detach(), fn(x).detach(), 1e-6)
    g1, = torch.autograd.grad(y.sum(), x)
    g2, = torch.autograd.grad(fn(x).sum(), x)
    close(g1, g2, 1e-6)


# -- utils --------------------------------------------------------------------

def test_divide():
    assert ttp.divide(12, 4) == 3
    with pytest.raises(ValueError):
        ttp.divide(10, 4)


def test_split_last_dim():
    x = torch.arange(24.0).reshape(2, 12)
    parts = ttp.split_tensor_along_last_dim(x, 3)
    assert [tuple(p.shape) for p in parts] == [(2, 4)] * 3
    np.testing.assert_array_equal(torch.cat(parts, -1), x)


def test_vocab_ranges():
    assert ttp.VocabUtility.vocab_range_from_global_vocab_size(
        32, 1, 4) == jtp.VocabUtility.vocab_range_from_global_vocab_size(
        32, 1, 4) == (8, 16)
