"""The ZeRO optimizers and their collectives: the port against the JAX
package's ``DistributedFusedAdam`` / ``DistributedFusedLAMB`` and, inside
the port, the bucketed step's contracts.

The port's ranks are processes (one launch of four gloo ranks for the
module, rank bodies in ``tests/torch_ranks.py``): the optimizers step the
synthetic parameters of ``tests/L0/test_distributed_optimizers.py`` at
world 2 (a subgroup of ranks 0-1) and world 4 over per-rank gradients,
from one seeded numpy draw that JAX takes too, inside ``shard_map`` over
the emulated 8-device mesh (gradients ``P("data")``, one per device).
The same launch runs the flagship toy at (dp, tp, pp) = (2, 2, 1) under
a sweep of bucket caps, the serialized control, and a cross-plan resume.

Bars: fp32 Adam (both modes) and LAMB 1e-6 x max(1, |p|) after three
steps (the same fp32 chain in another order of operations); ``bf16_fit``
2^-7 x max(1, |p|) after two (JAX's flagship bar); the e5m2 transport
one e5m2 spacing of the reference's delta; the bucket sweep, bucketed ==
serialized and the cross-plan resume bitwise (the reduce-scatter sums
each element in rank order whatever the bucket).  JAX's own test of the
cross-plan contract (``test_bucket_plan_does_not_leak_into_state_
layout``) is held nowhere here: the port is held to it within itself.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib.optimizers import (DistributedFusedAdam as JAdam,
                                         DistributedFusedLAMB as JLAMB)
from apex_tpu.multi_tensor import make_schema as jmake_schema
from apex_tpu.multi_tensor import plan_buckets as jplan_buckets
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu.transformer.testing import gpt1p3b_config as jgpt1p3b_config
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               DistributedFusedLAMB)
from apex_tpu_torch.multi_tensor import (BucketPlan, make_schema,
                                         plan_buckets)
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer.testing.convert import _flatten

import torch_ranks

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
STEPS = 3
TOL = 1e-6
BF16_TOL = 2.0 ** -7
TOY_KW = dict(num_layers=2, hidden_size=256, num_attention_heads=2,
              vocab_size=256, max_position_embeddings=64, bf16=False)
SHAPE = (2, 2, 1)
#: (name, kind, knobs, steps, param dtype): the JAX test's cases
OPT_CASES = (
    ("adamw", "adam", dict(lr=1e-2, weight_decay=0.01), STEPS, "float32"),
    ("adam_l2", "adam", dict(lr=1e-2, weight_decay=0.05, adam_w_mode=False),
     STEPS, "float32"),
    ("lamb", "lamb", dict(lr=1e-2, max_grad_norm=1.0), STEPS, "float32"),
    ("bf16_fit", "adam", dict(lr=1e-2, scatter_dtype="bfloat16",
                              gather_dtype="bfloat16",
                              exp_avg_dtype="bfloat16"), 2, "bfloat16"),
    ("e5m2", "adam", dict(lr=1e-2, e5m2_allgather=True), 1, "float32"),
)
#: flagship runs at SHAPE: (name, mesh, bucket bytes, plan, steps[, B])
RUNS = (
    ("one_bucket", SHAPE, 1 << 30, "fp32", 3),
    ("mid", SHAPE, 1 << 20, "fp32", 3),
    ("per_param", SHAPE, 1, "fp32", 3),
    ("serialized", SHAPE, None, "fp32", 3),
    ("control4", SHAPE, 1 << 30, "fp32", 4),
    ("resume", SHAPE, 1 << 30, "fp32", 4, 1 << 18),
    ("bf16_bucketed", SHAPE, 1 << 20, "bf16_fit", 2),
    ("bf16_serialized", SHAPE, None, "bf16_fit", 2),
)


def _params():
    r = np.random.RandomState(0)
    return {"w1": r.randn(33, 7).astype(np.float32),   # unaligned sizes
            "w2": r.randn(129).astype(np.float32),
            "b": r.randn(5, 3).astype(np.float32)}


def _grads(world, steps=STEPS):
    """[step][rank] -> tree, per-rank gradients drawn for this world."""
    r = np.random.RandomState(100 + world)
    shapes = {k: v.shape for k, v in _params().items()}
    return [[{k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(world)] for _ in range(steps)]


def _case():
    cfg = jgpt1p3b_config(**TOY_KW)
    master = jax.tree_util.tree_map(
        np.asarray, JGPTModel(cfg).init_master(jax.random.PRNGKey(0)))
    r = np.random.RandomState(1)
    tokens = r.randint(0, TOY_KW["vocab_size"], (8, 64)).astype(np.int32)
    return dict(params=_params(), grads={w: _grads(w) for w in (2, WORLD)},
                opt_cases=OPT_CASES, toy_kw=TOY_KW, master=master, lr=1e-3,
                tokens=tokens, labels=np.roll(tokens, -1, -1),
                rs_x=[np.random.RandomState(7 + k).randn(4 * 40).astype(
                    np.float32) for k in range(WORLD)],
                runs=RUNS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero")
    case = _case()
    spawn(torch_ranks.zero_checks, WORLD, str(out / "store"), str(out), case)
    return case, torch_ranks.load_ranks(str(out), WORLD)


def _jax_opt(kind, kw, steps, dtype, world):
    """JAX's final params and state (stacked per device) at ``world``."""
    kw = dict(kw)
    for k in ("scatter_dtype", "gather_dtype", "exp_avg_dtype"):
        if k in kw:
            kw[k] = getattr(jnp, kw[k])
    opt = (JAdam if kind == "adam" else JLAMB)(**kw)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    dt = getattr(jnp, dtype)
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), _params())
    schema = opt.make_schema(p, world)
    grads = _grads(world)
    gs = [jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs), dt),
                                 *grads[s]) for s in range(steps)]

    def run(p, *gs):
        state = opt.init(p, schema, world)
        for g in gs:
            g = jax.tree_util.tree_map(lambda a: a[0], g)
            p, state = opt.step(g, state, p, schema)
        return p, jax.tree_util.tree_map(lambda a: a[None], state)

    f = shard_map(run, mesh=mesh, in_specs=(P(),) + (P("data"),) * steps,
                  out_specs=(P(), P("data")), check_vma=False)
    p, state = jax.jit(f)(p, *gs)
    return (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p),
            tuple(np.asarray(a, np.float32) for a in state))


def _err(got, want):
    return max(float(np.max(np.abs(np.asarray(got[k], np.float64) - want[k])
                            / np.maximum(1.0, np.abs(want[k]))))
               for k in want)


@pytest.mark.parametrize("world", [2, WORLD])
@pytest.mark.parametrize("name,tol", [("adamw", TOL), ("adam_l2", TOL),
                                      ("lamb", TOL), ("bf16_fit", BF16_TOL)])
def test_optimizer_matches_jax(ranks, world, name, tol):
    """Each rank's parameters after the steps are JAX's within the bar,
    the same bits on every rank; each rank's moment shard is the JAX
    device's of the same index."""
    case, res = ranks
    _, kind, kw, steps, dtype = next(c for c in OPT_CASES if c[0] == name)
    want_p, want_s = _jax_opt(kind, kw, steps, dtype, world)
    got = [res[r]["opt"][world][name] for r in range(world)]
    err = _err(got[0][0], want_p)
    assert err <= tol, f"{name} at world {world}: max rel err {err:.3e}"
    for r in range(1, world):
        for k in want_p:
            np.testing.assert_array_equal(got[r][0][k], got[0][0][k])
    for r in range(world):
        assert int(got[r][1][0]) == steps
        for i in (1, 2):
            np.testing.assert_allclose(got[r][1][i], want_s[i][r],
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("world", [2, WORLD])
def test_e5m2_transport_within_one_spacing(ranks, world):
    """The e5m2 delta transport: parameters within one e5m2 spacing of the
    reference's delta (2 fraction bits) of JAX's e5m2 step, the fp32
    base kept: where the delta is 0 the parameter is exactly the old."""
    case, res = ranks
    _, kind, kw, steps, dtype = next(c for c in OPT_CASES if c[0] == "e5m2")
    want_p, _ = _jax_opt(kind, kw, steps, dtype, world)
    ref_p, _ = _jax_opt(kind, dict(lr=1e-2), steps, dtype, world)
    got = res[0]["opt"][world]["e5m2"][0]
    for k, p0 in case["params"].items():
        delta = np.abs(ref_p[k] - p0).astype(np.float64)
        spacing = np.where(delta > 0, 2.0 ** (np.floor(np.log2(
            np.maximum(delta, 1e-30))) - 2), 0.0)
        gap = np.abs(got[k].astype(np.float64) - want_p[k])
        assert np.all(gap <= spacing + 1e-7), (k, float(np.max(gap - spacing)))
        assert not np.array_equal(got[k], p0)


def test_refusals():
    """LAMB's bucketed step and e5m2 in a bucketed step raise, as in
    JAX; a plan of another world is refused."""
    p = {"w": torch.zeros(300)}
    plan = plan_buckets(make_schema(p, total_multiple_of=128), 1)
    lamb = DistributedFusedLAMB()
    with pytest.raises(NotImplementedError, match="grad-norm"):
        lamb.step_buckets(p, None, p, None, plan)
    e5 = DistributedFusedAdam(e5m2_allgather=True)
    schema = e5.make_schema(p, 1)
    with pytest.raises(NotImplementedError, match="e5m2"):
        e5.step_buckets(p, e5.init(p, schema, 1), p, schema, plan)
    adam = DistributedFusedAdam()
    bad = BucketPlan(spans=((0, 128),), shard=128, world=2,
                     bucket_bytes=None)
    with pytest.raises(ValueError, match="re-plan"):
        adam.step_buckets(p, adam.init(p, schema, 1), p, schema, bad)


def test_reduce_scatter_and_all_gather(ranks):
    """reduce_scatter sums each element in rank order (fp32 for the half
    dtypes, rounded once) and gives the same bits however the buffer is
    cut; all_gather_tiled is exact in every dtype, e5m2 included."""
    case, res = ranks
    xs = [torch.from_numpy(x) for x in case["rs_x"]]
    n = xs[0].numel() // WORLD
    for r in range(WORLD):
        for name in ("float32", "bfloat16", "float16"):
            dt = getattr(torch, name)
            acc = xs[0].to(dt)[r * n:(r + 1) * n].float()
            for j in range(1, WORLD):
                acc = acc + xs[j].to(dt)[r * n:(r + 1) * n].float()
            torch.testing.assert_close(res[r]["rs"][name], acc.to(dt),
                                       rtol=0, atol=0)
        assert torch.equal(res[r]["rs_cut"], res[r]["rs"]["float32"])
        for name in ("float32", "bfloat16", "float8_e5m2", "int32"):
            dt = getattr(torch, name)
            want = torch.cat([x[:4].to(dt) for x in xs])
            assert torch.equal(res[r]["ag"][name].view(torch.uint8),
                               want.view(torch.uint8))


# -- the planner ---------------------------------------------------------------

def _toy_tree(world=8):
    return {"a": np.zeros((700,), np.float32),
            "b": np.zeros((64, 64), np.float32),
            "c": np.zeros((5,), np.float32),
            "d": np.zeros((3000,), np.float32),
            "e": np.zeros((129,), np.float32)}


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("cap", [None, 1, 4096, 1 << 14, 1 << 30])
def test_plan_buckets_rules_match_jax(world, cap):
    """plan_buckets' spans (the DDP cap over the pack order, lane-rounded
    per-rank cuts, the one-bucket and one-param-per-bucket edges) are
    JAX's for the same schema."""
    tree = _toy_tree()
    js = jmake_schema(jax.tree_util.tree_map(jnp.asarray, tree), align=128,
                      total_multiple_of=128 * world)
    ts = make_schema({k: torch.from_numpy(v) for k, v in tree.items()},
                     align=128, total_multiple_of=128 * world)
    want = jplan_buckets(js, world, bucket_bytes=cap)
    got = plan_buckets(ts, world, bucket_bytes=cap)
    assert got.spans == want.spans and got.shard == want.shard
    got.validate()


# -- the flagship's bucketed step, held inside the port --------------------------

def _same(a, b, what):
    pa, pb = _flatten(a["params"]), _flatten(b["params"])
    assert sorted(pa) == sorted(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=f"{what}: {k}")
    for x, y in zip(a["opt"], b["opt"]):
        np.testing.assert_array_equal(x, y, err_msg=what)


def test_bucket_sweep_is_fp32_bitwise(ranks):
    """Losses, parameters and moments at (2, 2, 1) are the same bits for
    every bucket cap (the one-bucket edge is the serialized tail), and
    each step runs one reduce-scatter and one all-gather per bucket."""
    _, res = ranks
    for r in range(WORLD):
        runs = res[r]["flagship"]
        ref = runs["one_bucket"]
        assert ref["n_buckets"] == 1
        assert runs["per_param"]["n_buckets"] > runs["mid"]["n_buckets"] > 1
        for name in ("mid", "per_param"):
            assert runs[name]["losses"] == ref["losses"], name
            _same(runs[name], ref, f"rank {r} {name} vs one_bucket")
            for ops in runs[name]["ops"]:
                assert ops["reduce_scatter"] == runs[name]["n_buckets"]
                assert ops["all_gather"] == runs[name]["n_buckets"]


@pytest.mark.parametrize("plan", ["fp32", "bf16_fit"])
def test_bucketed_matches_serialized_bitwise(ranks, plan):
    """The bucketed step and the serialized control (one reduce-scatter,
    one all-gather) give the same bits at fp32 and at bf16_fit, and the
    parameters are the same bits on every rank."""
    _, res = ranks
    names = (("one_bucket", "serialized") if plan == "fp32"
             else ("bf16_bucketed", "bf16_serialized"))
    for r in range(WORLD):
        a, b = (res[r]["flagship"][n] for n in names)
        assert a["losses"] == b["losses"]
        _same(a, b, f"rank {r} {plan} bucketed vs serialized")
        for ops in b["ops"]:
            assert ops["reduce_scatter"] == 1 and ops["all_gather"] == 1
        p0 = _flatten(res[0]["flagship"][names[0]]["params"])
        for k, v in _flatten(a["params"]).items():
            np.testing.assert_array_equal(v, p0[k])


def test_bucket_plan_does_not_leak_into_state_layout_in_port(ranks):
    """Two steps under a one-bucket plan, then two under a many-bucket
    plan, from the state the first left: the same bits as four straight
    steps under the first."""
    _, res = ranks
    for r in range(WORLD):
        runs = res[r]["flagship"]
        mixed = runs[f"resume_{1 << 18}"]
        assert mixed["losses"] == runs["control4"]["losses"]
        _same(mixed, runs["control4"], f"rank {r} cross-plan resume")


def test_zero_modules_import_neither_jax_nor_apex_tpu():
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_ranks, "
            "apex_tpu_torch.contrib.optimizers, apex_tpu_torch.checkpoint, "
            "apex_tpu_torch.resilience, apex_tpu_torch.resilience.chaos, "
            "apex_tpu_torch.transformer.testing.flagship, "
            "apex_tpu_torch.transformer.testing.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apex_tpu', 'bench'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
