"""Batch norm across ranks and the spatial bottleneck: the port's
``sync_batch_norm`` / ``SyncBatchNorm``, GroupBN's ``bn_group``, the halo
exchange, ``spatial_conv2d`` and ``SpatialBottleneck`` over
``torch.distributed`` groups against the JAX package.

The same numpy inputs (drawn from a seed) go through both.  The ranks are
one launch of four gloo processes (rank body
``tests/torch_ranks.py::syncbn_checks``): SyncBN over the registered
``"data"`` group (all four ranks) and over the pairs [0, 1] / [2, 3] that
``create_syncbn_process_group(2, 4)`` makes (as a module, each pair on a
batch of its own), unequal per-rank batches (3 + 5 rows on a pair),
GroupBN at ``bn_group`` 2 on the pairs with and without ``z``, and the
spatial pieces with H split over four and over two ranks.  JAX runs in
the test process: ``shard_map`` over the emulated mesh for the batch
norms (each rank's weight and bias gradients are its own there too) and
the unsharded functions for the spatial pieces (JAX's own sharded tests
of them are in the slow tier).  Every rank's input gradient is that of
the sum of the ranks' losses, as under JAX's ``psum``.

Tolerances (x max(1, max|ref|)): forward values and running statistics
1e-5, gradients 1e-4 (fp32 sums over the batch and over the ranks in
another order, through rsqrt(var + eps)); the convolutions 1e-5 forward
and 1e-4 backward (oneDNN and XLA sum the taps in another order); a
weight gradient summed over the ranks' shards against the whole one
1e-4.  The halo rows are exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib.bottleneck import Bottleneck as JBottleneck
from apex_tpu.contrib.bottleneck import halo_exchange as jhalo
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JGroupBN
from apex_tpu.parallel import sync_batchnorm as jsbn
from apex_tpu_torch.contrib import bottleneck as tbneck
from apex_tpu_torch.parallel.multiproc import spawn

import torch_ranks

WORLD = 4
FWD, GRAD = 1e-5, 1e-4
CONVS = ((1, 3), (2, 3), (1, 5))
BLOCKS = {"s1": dict(in_channels=8, bottleneck_channels=4, out_channels=8),
          "s1_widen": dict(in_channels=8, bottleneck_channels=4,
                           out_channels=16),
          "s2": dict(in_channels=8, bottleneck_channels=4, out_channels=16,
                     stride=2),
          "s2_1x1": dict(in_channels=8, bottleneck_channels=4,
                         out_channels=16, stride=2, stride_1x1=True)}
DIMNUMS = ("NHWC", "HWIO", "NHWC")


def _close(got, ref, tol, what=""):
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bar = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= bar, f"{what}: max|err| {err} > {bar}"


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _bn_case(rng, shape):
    c = shape[-1]
    return dict(x=_f32(rng.standard_normal(shape) * 2 + 0.5),
                dy=_f32(rng.standard_normal(shape)),
                w=_f32(rng.uniform(0.5, 1.5, c)), b=_f32(rng.standard_normal(c)),
                rm=_f32(rng.standard_normal(c)), rv=_f32(rng.uniform(0.5, 2, c)))


def _block_params(rng, name):
    kw = BLOCKS[name]
    params = JBottleneck(**kw).init(jax.random.PRNGKey(len(name)))
    params = {k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
              if k.startswith(("scale", "bias")) else np.asarray(v)
              for k, v in params.items()}
    return params


def _case():
    rng = np.random.default_rng(27)
    halo_w = {w: [_f32(rng.standard_normal((1, 8 // w + 2, 1, 1)))
                  for _ in range(w)] for w in (4, 2)}
    conv_x = _f32(rng.standard_normal((2, 16, 8, 3)))
    conv_w = {k: _f32(rng.standard_normal((k, k, 3, 4)) * 0.3) for k in (3, 5)}
    conv_dy = {(s, k): _f32(rng.standard_normal((2, 16 // s, 8 // s, 4)))
               for s, k in CONVS}
    jparams = {n: _block_params(rng, n) for n in BLOCKS}
    block_x = {n: _f32(rng.standard_normal((2, 16, 8, 8))) for n in BLOCKS}
    block_dy = {n: _f32(rng.standard_normal(
        (2, 16 // kw.get("stride", 1), 8 // kw.get("stride", 1),
         kw["out_channels"]))) for n, kw in BLOCKS.items()}
    return dict(
        bn4=_bn_case(rng, (16, 3, 2, 6)),
        bn2=[_bn_case(rng, (8, 2, 3, 5)) for _ in range(2)],
        unequal=dict(_bn_case(rng, (8, 2, 2, 4)), cut=3),
        groupbn=[dict(x=_f32(rng.standard_normal((6, 3, 3, 4))),
                      z=_f32(rng.standard_normal((6, 3, 3, 4))),
                      dy=_f32(rng.standard_normal((6, 3, 3, 4))))
                 for _ in range(2)],
        spatial=dict(
            rows=_f32(np.arange(8).reshape(1, 8, 1, 1)), halo_w=halo_w,
            convs=CONVS, conv_x=conv_x,
            conv_w={k: np.ascontiguousarray(v.transpose(3, 2, 0, 1))
                    for k, v in conv_w.items()},
            conv_w_hwio=conv_w, conv_dy=conv_dy, blocks=BLOCKS,
            jblock_params=jparams,
            block_params={n: {k: v.numpy() for k, v in
                              tbneck.bottleneck_state_dict_from_jax(p).items()}
                          for n, p in jparams.items()},
            block_x=block_x, block_dy=block_dy))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("syncbn")
    case = _case()
    spawn(torch_ranks.syncbn_checks, WORLD, str(out / "store"), str(out),
          case)
    return case, torch_ranks.load_ranks(str(out), WORLD)


def _cat(runs, key, part):
    return np.concatenate([np.asarray(r[key][part]) for r in runs])


def _jax_bn(case, n_dev):
    """JAX's ``sync_batch_norm`` under ``shard_map`` over ``n_dev``
    devices: per device y, running statistics, dx, dw, db of sum(dy y)."""
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))
    w, b = jnp.asarray(case["w"]), jnp.asarray(case["b"])
    rm, rv = jnp.asarray(case["rm"]), jnp.asarray(case["rv"])

    def body(x, dy, w, b):
        def f(x, w, b):
            y, nrm, nrv = jsbn.sync_batch_norm(x, w, b, rm, rv,
                                               axis_name="data",
                                               training=True, momentum=0.1)
            return jnp.sum(y * dy), (y, nrm, nrv)

        (_, (y, nrm, nrv)), (dx, dw, db) = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(x, w, b)
        return y, nrm[None], nrv[None], dx, dw[None], db[None]

    out = jax.jit(shard_map(body, mesh=mesh,
                            in_specs=(P("data"), P("data"), P(), P()),
                            out_specs=(P("data"),) * 6, check_rep=False))(
        jnp.asarray(case["x"]), jnp.asarray(case["dy"]), w, b)
    return dict(zip(("y", "rm", "rv", "dx", "dw", "db"),
                    (np.asarray(a) for a in out)))


def _full_bn(case, x=None, dy=None):
    """JAX's batch norm over the whole batch on one device."""
    x = case["x"] if x is None else x
    dy = case["dy"] if dy is None else dy

    def f(x, w, b):
        y, nrm, nrv = jsbn.sync_batch_norm(
            x, w, b, jnp.asarray(case["rm"]), jnp.asarray(case["rv"]),
            axis_name=None, training=True, momentum=0.1)
        return jnp.sum(y * dy), (y, nrm, nrv)

    (_, (y, nrm, nrv)), (dx, dw, db) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(case["w"]), jnp.asarray(case["b"]))
    return dict(y=y, rm=nrm, rv=nrv, dx=dx, dw=dw, db=db)


def _hold(runs, key, jx, full, n_dev):
    """Each rank against its JAX device, the ranks together against the
    whole batch on one device."""
    for i, r in enumerate(runs):
        got = r[key]
        for part, tol in (("y", FWD), ("rm", FWD), ("rv", FWD), ("dx", GRAD),
                          ("dw", GRAD), ("db", GRAD)):
            n = jx[part].shape[0] // n_dev
            _close(got[part], jx[part][i * n:(i + 1) * n].reshape(
                np.shape(got[part])), tol, f"{key} rank {i} {part}")
        _close(got["rm"], full["rm"], FWD, f"{key} rank {i} rm, full")
        _close(got["rv"], full["rv"], FWD, f"{key} rank {i} rv, full")
    _close(_cat(runs, key, "y"), full["y"], FWD, f"{key} y, full batch")
    _close(_cat(runs, key, "dx"), full["dx"], GRAD, f"{key} dx, full batch")
    _close(sum(np.asarray(r[key]["dw"]) for r in runs), full["dw"], GRAD,
           f"{key} dw summed")


def test_syncbn_over_four_ranks_matches_jax_and_full_batch(ranks):
    case, runs = ranks
    _hold(runs, "bn4", _jax_bn(case["bn4"], WORLD), _full_bn(case["bn4"]),
          WORLD)


@pytest.mark.parametrize("pair", [0, 1])
def test_syncbn_module_over_a_pair_matches_jax(ranks, pair):
    """``SyncBatchNorm(process_group=<pair>)``: each pair pools its own
    batch, apart from the other pair's."""
    case, runs = ranks
    two = case["bn2"][pair]
    mine = runs[2 * pair:2 * pair + 2]
    _hold(mine, "bn2", _jax_bn(two, 2), _full_bn(two), 2)
    other = _full_bn(case["bn2"][1 - pair])
    assert not np.allclose(mine[0]["bn2"]["rm"], other["rm"], atol=1e-3)


@pytest.mark.parametrize("pair", [0, 1])
def test_syncbn_unequal_batches_are_count_weighted(ranks, pair):
    case, runs = ranks
    un = case["unequal"]
    full = _full_bn(un)
    mine = runs[2 * pair:2 * pair + 2]
    assert [r["unequal"]["y"].shape[0] for r in mine] == [un["cut"],
                                                          8 - un["cut"]]
    for r in mine:
        _close(r["unequal"]["rm"], full["rm"], FWD, "rm")
        _close(r["unequal"]["rv"], full["rv"], FWD, "rv")
    _close(_cat(mine, "unequal", "y"), full["y"], FWD, "y")
    _close(_cat(mine, "unequal", "dx"), full["dx"], GRAD, "dx")
    for part in ("dw", "db"):
        _close(sum(np.asarray(r["unequal"][part]) for r in mine), full[part],
               GRAD, part)


def test_group_helpers_and_refusals_across_ranks(ranks):
    _, runs = ranks
    assert [r["pair_ranks"] for r in runs] == [[0, 1], [0, 1], [2, 3],
                                               [2, 3]]
    for r in runs:
        kind, text = r["unregistered"]
        assert kind == "ValueError" and "world of 4" in text
        assert "names no registered process group" in text
        assert r["bad_world"][0] == "ValueError"
        assert "world_size=8" in r["bad_world"][1]
        assert r["bn_group_4_on_pair"][0] == "ValueError"
        assert "group of 2 rank" in r["bn_group_4_on_pair"][1]


@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("pair", [0, 1])
def test_groupbn_bn_group_2_matches_jax(ranks, pair, with_z):
    """``BatchNorm2d_NHWC(bn_group=2, axis_name=<pair>)`` against the JAX
    module with ``bn_group=2`` over a mesh axis of two devices
    (tests/L0/test_groupbn.py:34-73)."""
    case, runs = ranks
    g = case["groupbn"][pair]
    jbn = JGroupBN(4, bn_group=2, axis_name="bn")
    v = jbn.init()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bn",))

    def body(x, z, dy, p):
        def f(x, p, z):
            y, nv = jbn.apply({"params": p, "state": v["state"]}, x,
                              z if with_z else None)
            return jnp.sum(y * dy), (y, nv)

        (_, (y, nv)), (dx, dp, dz) = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(x, p, z)
        return (y, dx, dz, dp["weight"][None], dp["bias"][None],
                {k: a[None] for k, a in nv["state"].items()})

    jy, jdx, jdz, jdw, jdb, jst = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("bn"), P("bn"), P("bn"), P()),
        out_specs=(P("bn"),) * 6, check_rep=False))(
        jnp.asarray(g["x"]), jnp.asarray(g["z"]), jnp.asarray(g["dy"]),
        v["params"])
    n = g["x"].shape[0] // 2
    for r in range(2):
        got = runs[2 * pair + r][("groupbn", with_z)]
        rows = slice(r * n, (r + 1) * n)
        _close(got["y"], np.asarray(jy)[rows], FWD, "y")
        _close(got["dx"], np.asarray(jdx)[rows], GRAD, "dx")
        if with_z:
            _close(got["dz"], np.asarray(jdz)[rows], GRAD, "dz")
        _close(got["dw"], np.asarray(jdw)[r], GRAD, "dweight")
        _close(got["db"], np.asarray(jdb)[r], GRAD, "dbias")
        for k, a in got["state"].items():
            _close(a, np.asarray(jst[k])[r], FWD, k)


@pytest.mark.parametrize("world", [4, 2])
def test_halo_exchange_rows_and_gradients_match_jax(ranks, world):
    case, runs = ranks
    key = "spatial4" if world == 4 else "spatial2"
    h = 8 // world
    x = np.arange(8, dtype=np.float32)
    for r in range(world):
        halo, _ = runs[r][key]["halo"]
        want = np.concatenate([[x[r * h - 1] if r else 0.0],
                               x[r * h:(r + 1) * h],
                               [x[(r + 1) * h] if r + 1 < world else 0.0]])
        assert np.array_equal(halo.numpy().ravel(), want), (r, halo)
    if world == 4:
        assert [runs[r][key]["halo"][0].numpy().ravel().tolist()
                for r in (0, 3)] == [[0, 0, 1, 2], [5, 6, 7, 0]]
    # JAX's two ppermutes and their transposes on the same rows
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("spatial",))
    ct = np.concatenate(case["spatial"]["halo_w"][world], axis=1)
    fn = shard_map(lambda a: jhalo(a, "spatial", 1, 1), mesh=mesh,
                   in_specs=P(None, "spatial"), out_specs=P(None, "spatial"))
    jout, jdx = _jit_vjp(fn, (jnp.asarray(case["spatial"]["rows"]),),
                         jnp.asarray(ct))
    (jdx,) = jdx
    got = np.concatenate([runs[r][key]["halo"][0].numpy()
                          for r in range(world)], axis=1)
    assert np.array_equal(got, np.asarray(jout))
    gdx = np.concatenate([runs[r][key]["halo"][1].numpy()
                          for r in range(world)], axis=1)
    _close(gdx, jdx, 1e-6, "halo dx")


def _jit_vjp(fn, primals, ct):
    """(fn(*primals), the cotangents of ``primals``), compiled."""
    def both(primals, ct):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(ct)

    return jax.jit(both)(primals, ct)


@functools.lru_cache(maxsize=None)
def _jax_conv(s, k):
    sp = _case()["spatial"]

    def conv(x, w):
        return jax.lax.conv_general_dilated(x, w, (s, s), "SAME",
                                            dimension_numbers=DIMNUMS)

    jy, (jdx, jdw) = _jit_vjp(conv, (jnp.asarray(sp["conv_x"]),
                                     jnp.asarray(sp["conv_w_hwio"][k])),
                              jnp.asarray(sp["conv_dy"][(s, k)]))
    return np.asarray(jy), np.asarray(jdx), np.asarray(jdw)


@functools.lru_cache(maxsize=None)
def _jax_block(name):
    sp = _case()["spatial"]
    blk = JBottleneck(**BLOCKS[name])
    params = {k: jnp.asarray(v) for k, v in sp["jblock_params"][name].items()}
    out, (gp, gx) = _jit_vjp(blk.apply, (params,
                                         jnp.asarray(sp["block_x"][name])),
                             jnp.asarray(sp["block_dy"][name]))
    return np.asarray(out), np.asarray(gx), \
        tbneck.bottleneck_state_dict_from_jax(gp)


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("s,k", CONVS)
def test_spatial_conv2d_matches_jax_unsharded(ranks, world, s, k):
    _, runs = ranks
    key = "spatial4" if world == 4 else "spatial2"
    jy, jdx, jdw = _jax_conv(s, k)
    legs = [runs[r][key][("conv", s, k)] for r in range(world)]
    _close(np.concatenate([a[0].numpy() for a in legs], axis=1), jy, FWD, "y")
    _close(np.concatenate([a[1].numpy() for a in legs], axis=1), jdx, GRAD,
           "dx")
    _close(sum(a[2].numpy() for a in legs),
           np.asarray(jdw).transpose(3, 2, 0, 1), GRAD, "dw summed")


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_spatial_bottleneck_matches_jax_unsharded(ranks, world, name):
    """The H-sharded block's output, input gradient and (summed over the
    ranks) parameter gradients against JAX's unsharded ``Bottleneck``."""
    _, runs = ranks
    key = "spatial4" if world == 4 else "spatial2"
    out, gx, ref = _jax_block(name)
    legs = [runs[r][key][("block", name)] for r in range(world)]
    _close(np.concatenate([a[0].numpy() for a in legs], axis=1), out, FWD,
           "y")
    _close(np.concatenate([a[1].numpy() for a in legs], axis=1), gx, GRAD,
           "dx")
    for n in legs[0][2]:
        _close(sum(a[2][n].numpy() for a in legs), ref[n].numpy(), GRAD,
               f"d{n} summed")
