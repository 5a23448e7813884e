"""The GPT-1.3B flagship's ZeRO train step: the port against the JAX
package's ``build_flagship_train_step`` on the same mesh shape from the
same master.

TOY_KW of ``tests/L0/test_flagship.py`` (head dim 128) at fp32 compute,
plan ``fp32``, lr 1e-3, two steps on a seeded numpy batch: the port at
world 1 (this process, no process group), at dp 4 on the single-axis
path and at (dp, tp, pp) = (2, 2, 1) bucketed and serialized (one launch
of four gloo ranks), and at (4, 2, 1) bucketed and serialized (one launch
of eight), each against JAX's step on that mesh shape of the emulated
8-device mesh.  The port starts from JAX's master tree
(``convert.master_from_jax``).

Bars (JAX's own): losses 1e-5 relative; parameters 1e-3 absolute (the
JAX flagship's parity bar), the observed max in the message.  The
analytic tables (``flagship_state_bytes``, ``FIT_PLANS``) and the flat
schema (offsets, sizes, total; built from shapes alone for
``gpt1p3b_config()``) equal JAX's.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import apex_tpu.multi_tensor.flat as jflat
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.testing import FIT_PLANS as JFIT_PLANS
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu.transformer.testing import (
    build_flagship_train_step as jbuild)
from apex_tpu.transformer.testing import (
    flagship_state_bytes as jstate_bytes)
from apex_tpu.transformer.testing import gpt1p3b_config as jgpt1p3b_config
from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer.testing import (FIT_PLANS,
                                                build_flagship_train_step,
                                                flagship_state_bytes,
                                                gpt1p3b_config)
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, master_to_jax, zero_state_from_jax, zero_state_to_jax)
from apex_tpu_torch.transformer.testing.flagship import master_shapes

import torch_ranks

TOY_KW = dict(num_layers=2, hidden_size=256, num_attention_heads=2,
              vocab_size=256, max_position_embeddings=64, bf16=False)
LR, STEPS = 1e-3, 2
LOSS_TOL, PARAM_TOL = 1e-5, 1e-3
RUNS4 = (("dp4", None, "auto", "fp32", STEPS),
         ("221_bucketed", (2, 2, 1), "auto", "fp32", STEPS),
         ("221_serialized", (2, 2, 1), None, "fp32", STEPS))
RUNS8 = (("421_bucketed", (4, 2, 1), "auto", "fp32", STEPS),
         ("421_serialized", (4, 2, 1), None, "fp32", STEPS))
#: run name -> (JAX devices, mesh_shape, bucket_bytes)
JAX_RUNS = {"world1": (1, None, "auto"), "dp4": (4, None, "auto"),
            "221_bucketed": (4, (2, 2, 1), "auto"),
            "221_serialized": (4, (2, 2, 1), None),
            "421_bucketed": (8, (4, 2, 1), "auto"),
            "421_serialized": (8, (4, 2, 1), None)}


def _master():
    cfg = jgpt1p3b_config(**TOY_KW)
    return jax.tree_util.tree_map(
        np.asarray, JGPTModel(cfg).init_master(jax.random.PRNGKey(0)))


def _batch():
    r = np.random.RandomState(1)
    tokens = r.randint(0, TOY_KW["vocab_size"], (8, 64)).astype(np.int32)
    return tokens, np.roll(tokens, -1, -1)


def _case(runs):
    tokens, labels = _batch()
    return dict(toy_kw=TOY_KW, master=_master(), lr=LR, tokens=tokens,
                labels=labels, runs=runs)


def _jax_steps(n_dev, shape, steps):
    """JAX's (params, opt_state, loss) after each of ``steps`` steps."""
    cfg = jgpt1p3b_config(**TOY_KW)
    kw = {} if shape is None else dict(mesh_shape=shape)
    try:
        fs = jbuild(cfg, plan="fp32", lr=LR, devices=jax.devices()[:n_dev],
                    donate=False, **kw)
        tokens, labels = (jnp.asarray(a) for a in _batch())
        p, s, out = fs.params, fs.opt_state, []
        for _ in range(steps):
            p, s, loss = fs.step(p, s, tokens, labels)
            out.append((jax.tree_util.tree_map(np.asarray, p),
                        jax.tree_util.tree_map(np.asarray, s), float(loss)))
        return out
    finally:
        jps.destroy_model_parallel()


@pytest.fixture(scope="module")
def resume221():
    """JAX's (2, 2, 1) trajectory: the state after step 1 (carried into
    the port's ranks) and after step 2 (what they must reach)."""
    return _jax_steps(4, (2, 2, 1), 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, resume221):
    out = tmp_path_factory.mktemp("flagship4")
    case = _case(RUNS4)
    p1, s1, _ = resume221[0]
    case["resume"] = ((2, 2, 1), p1, s1)
    spawn(torch_ranks.flagship_runs, 4, str(out / "store"), str(out), case)
    return torch_ranks.load_ranks(str(out), 4)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    out = tmp_path_factory.mktemp("flagship8")
    spawn(torch_ranks.flagship_runs, 8, str(out / "store"), str(out),
          _case(RUNS8))
    return torch_ranks.load_ranks(str(out), 8)


def _jax_run(name):
    """JAX's losses and final master (flat names, fp32 numpy)."""
    n_dev, shape, bb = JAX_RUNS[name]
    cfg = jgpt1p3b_config(**TOY_KW)
    kw = {} if shape is None else dict(mesh_shape=shape, bucket_bytes=bb)
    try:
        fs = jbuild(cfg, plan="fp32", lr=LR, devices=jax.devices()[:n_dev],
                    donate=False, **kw)
        tokens, labels = (jnp.asarray(a) for a in _batch())
        p, s, losses = fs.params, fs.opt_state, []
        for _ in range(STEPS):
            p, s, loss = fs.step(p, s, tokens, labels)
            losses.append(float(loss))
        return losses, _flatten(jax.tree_util.tree_map(np.asarray, p))
    finally:
        jps.destroy_model_parallel()


def _hold(name, losses, params):
    want_l, want_p = _jax_run(name)
    np.testing.assert_allclose(losses, want_l, rtol=LOSS_TOL, atol=0)
    got = _flatten(params)
    assert sorted(got) == sorted(want_p)
    maxdw = max(float(np.max(np.abs(got[k] - want_p[k]))) for k in want_p)
    assert maxdw <= PARAM_TOL, f"{name}: max|dw| {maxdw:.3e} vs JAX"


def test_world1_without_process_group_matches_jax():
    """World 1 on one process, no process group: the collectives are the
    identity and the step is JAX's at one device."""
    assert not torch.distributed.is_initialized()
    fs = build_flagship_train_step(gpt1p3b_config(**TOY_KW), plan="fp32",
                                   lr=LR, device="cpu", master=_master())
    tokens, labels = (torch.from_numpy(a).long() for a in _batch())
    p, s, losses = fs.params, fs.opt_state, []
    for _ in range(STEPS):
        p, s, loss = fs.step(p, s, tokens, labels)
        losses.append(float(loss))
    assert fs.group is None and s.exp_avg.shape == (1, fs.schema.total)
    _hold("world1", losses, master_to_jax(p))


@pytest.mark.parametrize("name", [r[0] for r in RUNS4])
def test_four_ranks_match_jax(four, name):
    """dp 4 and (2, 2, 1), bucketed and serialized: every rank's loss and
    parameters are JAX's within the bars, the parameters the same bits
    on every rank."""
    res = four
    for r in range(4):
        assert res[r][name]["losses"] == res[0][name]["losses"]
        for k, v in _flatten(res[r][name]["params"]).items():
            np.testing.assert_array_equal(
                v, _flatten(res[0][name]["params"])[k])
    _hold(name, res[0][name]["losses"], res[0][name]["params"])


@pytest.mark.parametrize("name", [r[0] for r in RUNS8])
def test_eight_ranks_match_jax(eight, name):
    """(4, 2, 1), bucketed and serialized, on eight ranks."""
    res = eight
    for r in range(8):
        assert res[r][name]["losses"] == res[0][name]["losses"]
    _hold(name, res[0][name]["losses"], res[0][name]["params"])


def test_bucketed_equals_serialized_on_eight_ranks(eight):
    """Inside the port the two data paths are the same bits at (4, 2, 1)."""
    a, b = eight[0]["421_bucketed"], eight[0]["421_serialized"]
    assert a["losses"] == b["losses"]
    fa, fb = _flatten(a["params"]), _flatten(b["params"])
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("kw", [TOY_KW, {}])
@pytest.mark.parametrize("plan", sorted(JFIT_PLANS))
@pytest.mark.parametrize("n_shards", [1, 8])
def test_state_bytes_and_fit_plans_equal_jax(kw, plan, n_shards):
    cfg = gpt1p3b_config(**kw)
    jcfg = jgpt1p3b_config(**kw)
    assert flagship_state_bytes(cfg, FIT_PLANS[plan], n_shards) == \
        jstate_bytes(jcfg, JFIT_PLANS[plan], n_shards)
    jp, tp_ = JFIT_PLANS[plan], FIT_PLANS[plan]
    for f in ("param_dtype", "exp_avg_dtype", "scatter_dtype",
              "gather_dtype"):
        a, b = getattr(jp, f), getattr(tp_, f)
        assert (a is None and b is None) or \
            jnp.dtype(a).name == str(b).rsplit(".", 1)[1], (plan, f)


@pytest.mark.parametrize("kw", [TOY_KW, {}])
@pytest.mark.parametrize("world", [1, 8])
def test_flat_schema_equals_jax_from_shapes(kw, world, monkeypatch):
    """The port's schema over the master's shapes (meta tensors) is JAX's
    ``make_schema`` over ``eval_shape(init_master)``: offsets, sizes,
    total (JAX's walked without materializing the arrays)."""
    jcfg = jgpt1p3b_config(**kw)
    shapes = jax.eval_shape(JGPTModel(jcfg).init_master,
                            jax.random.PRNGKey(0))
    monkeypatch.setattr(jflat, "jnp", types.SimpleNamespace(
        asarray=lambda x: x))
    js = jflat.make_schema(shapes, align=128, total_multiple_of=128 * world)
    ts = DistributedFusedAdam().make_schema(
        master_shapes(gpt1p3b_config(**kw)), world)
    assert ts.offsets == js.offsets and ts.sizes == js.sizes
    assert ts.total == js.total and ts.shapes == js.shapes


def test_master_shapes_match_the_model():
    """master_shapes is the tree the flagship packs (the toy, built)."""
    fs = build_flagship_train_step(gpt1p3b_config(**TOY_KW), plan="fp32",
                                   lr=LR, device="cpu", master=_master())
    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = (tuple(v.shape), v.dtype)
        return out

    assert shapes(fs.params) == shapes(master_shapes(
        gpt1p3b_config(**TOY_KW)))


def test_state_carried_from_jax_steps_as_jax_does(four, resume221):
    """JAX's (2, 2, 1) state after one step, carried into the port's ranks
    (convert.master_from_jax, zero_state_from_jax: each rank its block of
    JAX's [dp, pp, tp, shard] stacks), steps as JAX's second step; the
    ranks' blocks stack back (zero_state_to_jax) into JAX's layout."""
    p2, s2, loss2 = resume221[1]
    got = [four[r]["resume"] for r in range(4)]
    np.testing.assert_allclose([g["loss"] for g in got], [loss2] * 4,
                               rtol=LOSS_TOL, atol=0)
    want = _flatten(p2)
    have = _flatten(got[0]["params"])
    maxdw = max(float(np.max(np.abs(have[k] - want[k]))) for k in want)
    assert maxdw <= PARAM_TOL, f"max|dw| {maxdw:.3e} vs JAX step 2"
    stacked = zero_state_to_jax([g["opt"] for g in got], (2, 1, 2))
    assert stacked.exp_avg.shape == s2.exp_avg.shape
    np.testing.assert_array_equal(stacked.step, s2.step)
    for a, b in ((stacked.exp_avg, s2.exp_avg),
                 (stacked.exp_avg_sq, s2.exp_avg_sq)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   rtol=1e-3, atol=1e-6)
    back = zero_state_from_jax(stacked, 3)
    assert tuple(back.exp_avg.shape) == (1, 1, 1, s2.exp_avg.shape[-1])
    assert torch.equal(back.exp_avg, got[3]["opt"].exp_avg)
