"""Parity of the PyTorch port's flat superblock path with the JAX
package's: ``make_schema`` / ``flatten`` / ``unflatten``, the bucket
planner, ``segment_l2norms``, ``FlatFusedAdam`` (the plain version of
``csrc/flat_adam.cu``), and GPT training on the superblock as
``chip_smoke.py``'s ``SuperblockTrainer`` does it; plus the port's own
contracts (views, in-place vs functional steps, bucketed == one launch).

The same numpy inputs go through both packages.  On the CPU the port runs
the kernel's plain version; JAX runs its Pallas kernel in interpret mode,
as its own tests do.  Tolerances: the schema, the packed buffers and the
plans are exact; ``segment_l2norms`` 1e-6 relative; the optimizer 1e-6 x
max(1, max|ref|) after five steps (read: at most 1.5e-7, on the moments
too with bias correction off, so not only c1 and c2 from two ``pow``
implementations but XLA's CPU code rounding some op otherwise); the toy
GPT's losses 1e-5 x max(1, |ref|) and its weights 1e-3 (see the test for
why).
"""

import collections
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
from jax.sharding import PartitionSpec as P

from apex_tpu import multi_tensor as jmt
from apex_tpu import optimizers as jopt
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu_torch import kernels
from apex_tpu_torch import multi_tensor as tmt
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.optimizers import FlatFusedAdam
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, jax_tree_from_state_dict, state_dict_from_jax)
from chip_smoke import TOY_TRAIN, SuperblockTrainer

REPO = Path(__file__).resolve().parent.parent
STEP_TOL = 1e-6


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    bar = tol * max(1.0, float(np.max(np.abs(ref)))) if ref.size else 0.0
    assert err <= bar, (err, bar)


def _leaves(seed):
    """Nested dicts and lists of mixed sizes, keys inserted out of order
    (JAX takes them sorted), one bf16 leaf."""
    rng = np.random.RandomState(seed)

    def a(*s):
        return rng.randn(*s).astype(np.float32)

    return {"zeta": a(3, 5), "alpha": [a(130), a(7, 1)],
            "mid": {"w": a(64, 9), "b": a(9), "x": [a(1)]},
            "half": jnp.asarray(a(20, 4), jnp.bfloat16)}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_tree(tree):
    """The same tree with torch leaves, dict insertion order kept."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if tree.dtype == jnp.bfloat16:
        return torch.tensor(np.asarray(tree, np.float32)).bfloat16()
    return torch.tensor(np.asarray(tree))


# -- the superblock ---------------------------------------------------------


@pytest.mark.parametrize("align,multiple", [(128, 1024), (128, 1), (256, 512)])
def test_schema_and_flatten_match_jax(align, multiple):
    tree = _leaves(0)
    jflat, jschema = jmt.flatten(_jax_tree(tree), align=align,
                                 total_multiple_of=multiple)
    tflat, tschema = tmt.flatten(_torch_tree(tree), align=align,
                                 total_multiple_of=multiple)
    assert tschema.offsets == jschema.offsets
    assert tschema.sizes == jschema.sizes
    assert tschema.shapes == jschema.shapes
    assert (tschema.total, tschema.align) == (jschema.total, jschema.align)
    assert tflat.dtype == torch.float32 and jflat.dtype == jnp.float32
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(tschema.segment_ids().numpy(),
                                  jschema.segment_ids())
    # bf16 leaves packed into an fp32 superblock by ``dtype=``
    half = {"b": tree["half"], "a": tree["half"][:3]}
    jh, _ = jmt.flatten(_jax_tree(half), dtype=jnp.float32)
    th, _ = tmt.flatten(_torch_tree(half), dtype=torch.float32)
    assert th.dtype == torch.float32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    # an OrderedDict keeps its insertion order, a defaultdict is sorted,
    # a namedtuple is a node; unflatten gives each container type back
    pair = collections.namedtuple("pair", "w b")

    def containers(make):
        dd = collections.defaultdict(list, {"y": make(5), "x": make(2, 3)})
        return collections.OrderedDict(
            [("z", make(200)), ("a", pair(make(3, 4), make(4))), ("m", dd)])

    def leaf(to):
        rng = np.random.RandomState(5)
        return lambda *s: to(rng.randn(*s).astype(np.float32))

    jflat, jschema = jmt.flatten(containers(leaf(jnp.asarray)), align=align,
                                 total_multiple_of=multiple)
    tflat, tschema = tmt.flatten(containers(leaf(torch.from_numpy)),
                                 align=align, total_multiple_of=multiple)
    assert tschema.offsets == jschema.offsets
    assert tschema.shapes == jschema.shapes
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tmt.unflatten(tflat, tschema)
    assert type(back) is collections.OrderedDict
    assert list(back) == ["z", "a", "m"]
    assert type(back["a"]) is pair and type(back["m"]) is \
        collections.defaultdict and back["m"].default_factory is list


def test_unflatten_round_trips_as_views():
    tree = _torch_tree(_leaves(1))
    flat, schema = tmt.flatten(tree, total_multiple_of=1024)
    back = tmt.unflatten(flat, schema)
    assert sorted(back) == sorted(tree)
    assert isinstance(back["alpha"], list) and len(back["alpha"]) == 2
    pairs = list(zip(jax.tree_util.tree_leaves(back, is_leaf=torch.is_tensor),
                     jax.tree_util.tree_leaves(tree, is_leaf=torch.is_tensor)))
    for got, want in pairs:
        assert got.dtype == want.dtype and torch.equal(got, want)
    # the fp32 leaves are views: a write through the superblock shows
    w = back["mid"]["w"]
    assert w.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    flat.zero_()
    assert not w.any()
    # the bf16 leaf is a cast copy of the fp32 buffer, not a view
    assert back["half"].untyped_storage().data_ptr() != \
        flat.untyped_storage().data_ptr()
    # an explicit dtype casts every leaf
    assert all(x.dtype == torch.float64 for x in jax.tree_util.tree_leaves(
        tmt.unflatten(flat, schema, dtype=torch.float64),
        is_leaf=torch.is_tensor))


def test_tree_structure_is_kept():
    tree = {"b": (torch.ones(2), None), "a": [torch.zeros(3), {"c": torch.ones(1)}]}
    flat, schema = tmt.flatten(tree)
    back = tmt.unflatten(flat, schema)
    assert isinstance(back["b"], tuple) and back["b"][1] is None
    assert isinstance(back["a"], list) and isinstance(back["a"][1], dict)
    assert schema.offsets == (0, 128, 256) and schema.total == 384
    assert hash(schema) == hash(tmt.make_schema(tree))


# -- the bucket planner -------------------------------------------------------


def _schemas(world):
    tree = {"emb": np.zeros((64, 96), np.float32),
            "layers": [{"w": np.zeros((96, 96), np.float32),
                        "b": np.zeros(96, np.float32)} for _ in range(3)],
            "tiny": np.zeros(5, np.float32)}
    kw = dict(total_multiple_of=1024 * world)
    return jmt.make_schema(_jax_tree(tree), **kw), tmt.make_schema(
        _torch_tree(tree), **kw)


@pytest.mark.parametrize("span_align", [128, 1024])
@pytest.mark.parametrize("bucket_bytes", [None, 1, 3000, 32 << 20])
@pytest.mark.parametrize("world", [1, 4])
def test_plan_buckets_matches_jax(world, bucket_bytes, span_align):
    jschema, tschema = _schemas(world)
    kw = dict(bucket_bytes=bucket_bytes, span_align=span_align)
    jplan = jmt.plan_buckets(jschema, world, **kw)
    tplan = tmt.plan_buckets(tschema, world, **kw)
    assert tplan.spans == jplan.spans
    assert (tplan.shard, tplan.world, tplan.bucket_bytes) == (
        jplan.shard, jplan.world, jplan.bucket_bytes)
    assert [tplan.collective_elements(b) for b in range(tplan.num_buckets)] \
        == [jplan.collective_elements(b) for b in range(jplan.num_buckets)]
    assert tmt.DEFAULT_BUCKET_BYTES == jmt.DEFAULT_BUCKET_BYTES


@pytest.mark.parametrize("case", ["world0", "span_align", "indivisible",
                                  "unaligned_shard", "bucket_bytes0",
                                  "gapped_plan"])
def test_plan_buckets_refusals_match_jax(case):
    def run(mt, schema):
        if case == "world0":
            return mt.plan_buckets(schema, 0)
        if case == "span_align":
            return mt.plan_buckets(schema, 1, span_align=100)
        if case == "indivisible":
            return mt.plan_buckets(schema, 3)
        if case == "unaligned_shard":
            return mt.plan_buckets(schema, 1, span_align=1 << 20)
        if case == "bucket_bytes0":
            return mt.plan_buckets(schema, 1, bucket_bytes=0)
        return mt.BucketPlan(spans=((0, 128), (256, schema.total)),
                             shard=schema.total, world=1,
                             bucket_bytes=None).validate()

    jschema, tschema = _schemas(1)
    with pytest.raises(ValueError) as jerr:
        run(jmt, jschema)
    with pytest.raises(ValueError) as terr:
        run(tmt, tschema)
    assert str(terr.value) == str(jerr.value)


def test_segment_l2norms_matches_jax():
    tree = _leaves(2)
    jflat, jschema = jmt.flatten(_jax_tree(tree), total_multiple_of=1024)
    tflat, tschema = tmt.flatten(_torch_tree(tree), total_multiple_of=1024)
    ref = np.asarray(jmt.segment_l2norms(jflat, jschema))
    got = tmt.segment_l2norms(tflat, tschema).numpy()
    assert got.shape == (tschema.num_tensors,)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# -- FlatFusedAdam ----------------------------------------------------------

VARIANTS = [dict(adam_w_mode=w, weight_decay=d, bias_correction=b)
            for w in (True, False) for d in (0.0, 0.05) for b in (True, False)]


def _problem(seed, n=3 * 1024, steps=5):
    rng = np.random.RandomState(seed)
    p = rng.randn(n).astype(np.float32)
    grads = [(rng.randn(n) * (0.2 if i % 2 else 3.0)).astype(np.float32)
             for i in range(steps)]
    return p, grads


@pytest.mark.parametrize("kw", VARIANTS, ids=[
    f"{'adamw' if v['adam_w_mode'] else 'l2'}-wd{v['weight_decay']}-"
    f"{'bc' if v['bias_correction'] else 'nobc'}" for v in VARIANTS])
def test_flat_fused_adam_matches_jax(kw):
    p, grads = _problem(3)
    kw = dict(kw, lr=1e-2, betas=(0.9, 0.95), eps=1e-8)
    jo = jopt.FlatFusedAdam(**kw)
    jp = jnp.asarray(p)
    js = jo.init(jp)
    jstep = jax.jit(jo.step)
    to = FlatFusedAdam(**kw)
    tp = torch.tensor(p)
    ts = to.init(tp)
    step = to.jit_step()
    for g in grads:
        jp, js = jstep(jnp.asarray(g), js, jp)
        tp, ts = step(torch.tensor(g), ts, tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 5
    _close(tp, jp, STEP_TOL)
    _close(ts.exp_avg, js.exp_avg, STEP_TOL)
    _close(ts.exp_avg_sq, js.exp_avg_sq, STEP_TOL)
    assert np.max(np.abs(tp.numpy() - p)) > 1e-2   # five steps at lr 1e-2


def test_bucketed_walk_is_bitwise_one_launch():
    tree = {f"w{i}": torch.randn(n, generator=torch.Generator().manual_seed(i))
            for i, n in enumerate([3000, 5, 1024, 4100, 700])}
    p0, schema = tmt.flatten(tree, total_multiple_of=1024)
    opt = FlatFusedAdam(lr=1e-2, weight_decay=0.01)
    n = schema.total
    plans = [None, tmt.plan_buckets(schema, 1, bucket_bytes=1,
                                    span_align=1024),
             tmt.BucketPlan(spans=((0, 1024), (1024, 5120), (5120, n)),
                            shard=n, world=1, bucket_bytes=None)]
    assert plans[1].num_buckets > 2
    out = []
    for plan in plans:
        p, state = p0.clone(), opt.init(p0)
        gen = torch.Generator().manual_seed(9)
        for _ in range(3):
            p, state = opt.step(torch.randn(n, generator=gen), state, p,
                                plan=plan)
        out.append((p, state.exp_avg, state.exp_avg_sq))
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))


@pytest.mark.parametrize("case", ["length", "world", "shard", "span_start"])
def test_flat_fused_adam_refusals_match_jax(case):
    n = 2048
    if case == "length":
        n = 2048 + 128
    jp, tp = jnp.zeros(n), torch.zeros(n)
    plan = None
    if case == "world":
        plan = dict(spans=((0, n // 2),), shard=n // 2, world=2)
    elif case == "shard":
        plan = dict(spans=((0, 1024),), shard=1024, world=1)
    elif case == "span_start":
        plan = dict(spans=((0, 128), (128, n)), shard=n, world=1)
    jplan = tplan = None
    if plan is not None:
        jplan = jmt.BucketPlan(bucket_bytes=None, **plan)
        tplan = tmt.BucketPlan(bucket_bytes=None, **plan)
    jo, to = jopt.FlatFusedAdam(), FlatFusedAdam()
    # JAX checks the length with an assert; the port raises ValueError
    with pytest.raises(AssertionError if case == "length" else ValueError
                       ) as jerr:
        jo.step(jp, jo.init(jp), jp, plan=jplan)
    with pytest.raises(ValueError) as terr:
        to.step(tp, to.init(tp), tp, plan=tplan)
    if case == "length":   # the same hint, naming each package's flatten
        assert "length a multiple of 1024" in str(jerr.value)
        assert "length a multiple of 1024" in str(terr.value)
    else:
        assert str(terr.value) == str(jerr.value)


def test_step_is_functional_and_jit_step_in_place():
    p, grads = _problem(4, n=1024, steps=1)
    g = torch.tensor(grads[0])
    opt = FlatFusedAdam(lr=1e-2, weight_decay=0.01)
    p0 = torch.tensor(p)
    s0 = opt.init(p0)
    kept = (p0.clone(), s0.exp_avg.clone(), s0.exp_avg_sq.clone())
    p1, s1 = opt.step(g, s0, p0)
    assert torch.equal(p0, kept[0]) and torch.equal(s0.exp_avg, kept[1])
    assert torch.equal(s0.exp_avg_sq, kept[2]) and int(s0.step) == 0
    p2, s2 = opt.jit_step(donate=False)(g, s0, p0)
    assert torch.equal(p0, kept[0]) and torch.equal(p2, p1)
    p3, s3 = opt.jit_step()(g, s0, p0)
    assert p3 is p0 and s3.exp_avg is s0.exp_avg
    assert s3.exp_avg_sq is s0.exp_avg_sq
    for a, b in zip((p3, s3.exp_avg, s3.exp_avg_sq),
                    (p1, s1.exp_avg, s1.exp_avg_sq)):
        assert torch.equal(a, b)
    assert int(s3.step) == 1 and not torch.equal(p0, kept[0])
    # bf16 params and grads are cast to fp32 first: the in-place step then
    # lands in a new fp32 buffer and leaves the bf16 input alone
    pb = torch.tensor(p).bfloat16()
    pb_kept = pb.clone()
    out, _ = opt.jit_step()(g.bfloat16(), opt.init(pb), pb)
    ref, _ = opt.step(g.bfloat16().float(), opt.init(pb), pb.float())
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    assert torch.equal(pb, pb_kept)


def test_step_refuses_mismatched_operands():
    opt = FlatFusedAdam()
    p = torch.zeros(1024)
    state = opt.init(p)
    with pytest.raises(ValueError):
        opt.step(torch.zeros(2048), state, p)
    with pytest.raises(ValueError):
        opt.step(torch.zeros(1024), state, torch.zeros(1024, 2))
    assert kernels.FLAT_ADAM.source == "flat_adam.cu"
    assert kernels.FLAT_ADAM in kernels.KERNELS


# -- the slice as a whole: GPT trained on the superblock --------------------


def test_superblock_training_matches_jax():
    argv = TOY_TRAIN + ["--lr", "3e-3", "--train-iters", "3"]
    args, model, _ = pretrain_gpt.setup(argv, "cpu")
    cfg = model.cfg
    jcfg = dict(num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
                num_attention_heads=cfg.num_attention_heads,
                vocab_size=cfg.vocab_size,
                max_position_embeddings=cfg.max_position_embeddings,
                use_flash_attention=True)
    parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        1, 1, devices=jax.devices()[:1])
    jmodel = JGPTModel(JGPTConfig(**jcfg))
    master = jax.tree_util.tree_map(np.asarray, jmodel.shard_master(
        jmodel.init_master(jax.random.PRNGKey(0)), 0))
    b, s = args.micro_batch_size, args.seq_length
    rng = np.random.RandomState(5)
    ids = rng.randint(0, cfg.vocab_size, (3, b, s + 1)).astype(np.int64)
    ids[2] = ids[0]   # step 3 sees step 1's batch again

    # the port: weights and grads are views of two flat buffers
    model.load_state_dict(state_dict_from_jax(master))
    trainer = SuperblockTrainer(args, model)
    losses = [float(trainer.step(torch.tensor(i[:, :-1]),
                                 torch.tensor(i[:, 1:]), it))
              for it, i in enumerate(ids)]
    lo = trainer.flat_g.data_ptr()
    assert all(lo <= p.grad.data_ptr() < lo + trainer.flat_g.numel() * 4
               for p in model.parameters())
    final = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # JAX: value_and_grad, clip, flatten, FlatFusedAdam.step, unflatten
    def per_token(p, t, l):
        return shard_map(lambda p, t, l: jmodel.apply(p, t, labels=l),
                         mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
                         check_vma=False)(p, t, l)

    flat_p, schema = jmt.flatten(_jax_tree(master), total_multiple_of=1024)
    opt = jopt.FlatFusedAdam(lr=args.lr, betas=(args.adam_beta1,
                                                 args.adam_beta2),
                             eps=args.adam_eps,
                             weight_decay=args.weight_decay)

    @jax.jit
    def step(flat_p, st, t, l):
        loss, g = jax.value_and_grad(lambda p: jnp.mean(per_token(p, t, l)))(
            jmt.unflatten(flat_p, schema))
        g, _ = jmt.clip_grad_norm(g, args.clip_grad)
        flat_p, st = opt.step(jmt.flatten(g, schema)[0], st, flat_p)
        return flat_p, st, loss

    st = opt.init(flat_p)
    ref = []
    for i in ids:
        flat_p, st, loss = step(flat_p, st, jnp.asarray(i[:, :-1], jnp.int32),
                                jnp.asarray(i[:, 1:], jnp.int32))
        ref.append(float(loss))
    parallel_state.destroy_model_parallel()
    _close(losses, ref, 1e-5)
    assert ref[2] < ref[0]
    # Adam divides each element's step by its own gradient scale, so an
    # element whose gradient is at rounding level (the key part of the qkv
    # bias has a zero exact gradient) takes a rounding-driven step of up to
    # lr.  The trajectory test's bars (1e-4, the qkv bias 1e-3) held at
    # hidden 64; here at hidden 256 three elements of 1.68M read above
    # 1e-4 (2.2e-4 on two qkv weights, 1.2e-4 on one dense_4h_to_h weight;
    # every other leaf <= 6.7e-5), so every leaf gets the qkv bias's 1e-3.
    # Three steps at lr 3e-3 (1e-2 overshoots at this width: the loss
    # rises) move every leaf by ~9e-3, so a missed update fails the bar
    init = _flatten(master)
    got = _flatten(jax_tree_from_state_dict(final))
    want = _flatten(jax.tree_util.tree_map(
        np.asarray, jmt.unflatten(flat_p, schema)))
    assert sorted(got) == sorted(want)
    bar = 1e-3
    for name in want:
        assert np.max(np.abs(got[name] - want[name])) <= bar, name
        assert np.max(np.abs(want[name] - init[name])) > 5 * bar, name


def test_flat_modules_import_neither_jax_nor_apex_tpu():
    code = ("import sys, apex_tpu_torch.multi_tensor, "
            "apex_tpu_torch.optimizers\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apex_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
