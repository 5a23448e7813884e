"""Parity of the PyTorch port's GPT training path with the JAX package's:
the fused LM-head cross-entropy, FusedAdam with global-norm clipping, the
multi-tensor ops, the standalone GPT's losses and gradients, and a short
``pretrain_gpt`` loss trajectory; the materialised-scores attention (the
JAX ``GPTModel`` default, through the fused softmax) with full masks and
packing ids, and the L1 harness's GPT cell at O0 and O2 against live JAX
losses; plus the port's own remat policies (each equal to no remat, and
the attention and LayerNorm calls each makes), ``--profile-every``, and
the device and refusal contracts.

The same weights (a JAX ``GPTModel.init_master`` tree carried over by
``transformer.testing.convert``) and the same inputs, drawn with numpy
from a seed, go through both.  On the CPU the port runs its kernels'
plain versions; JAX runs its CPU routes, the model inside a one-device
``shard_map`` as ``tests/L0/test_megatron_models.py`` runs it.

Tolerances: fp32 1e-5 x max(1, max|ref|) on losses and on each gradient
tensor (sums in another order); bf16 2^-7 x max|ref| (one bf16 ulp at
the output's scale); optimizer states and weights after several fp32
steps 1e-6 x max(1, max|ref|); the remat contract bitwise; the harness
cell's losses 1e-5 x |loss| at O0 and 5e-3 absolute at O2 (bf16, both
packages on the fused-softmax path).
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
from jax.sharding import PartitionSpec as P

from apex_tpu import multi_tensor as jmt
from apex_tpu import optimizers as jopt
from apex_tpu.ops import fused_linear_cross_entropy as jax_flce
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu_torch import multi_tensor as tmt
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.ops import fused_linear_cross_entropy
from apex_tpu_torch.ops import fused_linear_xent as tflce
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    normal_init)
from apex_tpu_torch.transformer.testing import (GPT1P3B_KW, GPTConfig,
                                                GPTModel, gpt1p3b_config,
                                                gpt_param_count)
from apex_tpu_torch.transformer.testing import arguments as targs
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, jax_tree_from_state_dict, state_dict_from_jax)

REPO = Path(__file__).resolve().parent.parent
FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
STEP_TOL = 1e-6


def _close(got, ref, tol=FP32_TOL, low_precision=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    bar = BF16_TOL * scale if low_precision else tol * max(1.0, scale)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= bar, (err, bar)


# -- fused LM-head cross-entropy -------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_linear_cross_entropy_matches_jax(smoothing, monkeypatch):
    # 96-wide vocab in chunks of 16 rows: the forward and backward walk
    # three row chunks
    monkeypatch.setattr(tflce, "_CHUNK_ELEMENTS", 96 * 16)
    rng = np.random.RandomState(0)
    n, hid, vocab = 48, 32, 96
    h = rng.randn(n, hid).astype(np.float32)
    w = (0.2 * rng.randn(vocab, hid)).astype(np.float32)
    labels = rng.randint(0, vocab, n)
    g = rng.rand(n).astype(np.float32)
    jh = jnp.asarray(h, jnp.bfloat16)
    jloss, vjp = jax.vjp(lambda h, w: jax_flce(h, w, jnp.asarray(labels),
                                               smoothing), jh, jnp.asarray(w))
    jdh, jdw = vjp(jnp.asarray(g))

    th = torch.tensor(np.asarray(jh.astype(jnp.float32))).bfloat16()
    th.requires_grad_()
    tw = torch.tensor(w, requires_grad=True)
    loss = fused_linear_cross_entropy(th, tw, torch.tensor(labels), smoothing)
    assert loss.dtype == torch.float32
    loss.backward(torch.tensor(g))
    _close(loss.detach(), jloss)
    assert th.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    _close(th.grad.float(), jdh.astype(jnp.float32), low_precision=True)
    _close(tw.grad, jdw, low_precision=True)


# -- optimizer, clipping, multi-tensor ops ---------------------------------


@pytest.mark.parametrize("adam_w_mode,bias_correction", [(True, True),
                                                          (False, True),
                                                          (True, False)])
def test_fused_adam_with_clipping_matches_jax(adam_w_mode, bias_correction):
    rng = np.random.RandomState(1)
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 4, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jo = jopt.FusedAdam(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    to = FusedAdam(list(tp.values()), **kw)
    for step in range(4):
        grads = {k: (rng.randn(*s) * (0.2 if step % 2 else 3.0)).astype(
            np.float32) for k, s in shapes.items()}
        jg, jnorm = jmt.clip_grad_norm({k: jnp.asarray(v)
                                        for k, v in grads.items()}, 1.0)
        jp, js = jo.step(jg, js, jp)
        for k, p in tp.items():
            p.grad = torch.tensor(grads[k])
        tnorm = tmt.clip_grad_norm([p.grad for p in tp.values()], 1.0)
        _close(tnorm, jnorm, STEP_TOL)
        to.step()
    for k, p in tp.items():
        _close(p.detach(), jp[k], STEP_TOL)
        _close(to.state[p]["exp_avg"], js.exp_avg[k], STEP_TOL)
        _close(to.state[p]["exp_avg_sq"], js.exp_avg_sq[k], STEP_TOL)
        assert to.state[p]["step"] == 4


def test_multi_tensor_ops_match_jax():
    rng = np.random.RandomState(2)
    xs = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    ys = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    jt = [jnp.asarray(x) for x in xs]
    tt = [torch.tensor(x) for x in xs]
    jn, jper = jmt.multi_tensor_l2norm(jt, per_tensor=True)
    tn, tper = tmt.multi_tensor_l2norm(tt, per_tensor=True)
    _close(tn, jn)
    _close(tper, jper)
    (js, jf), (ts, tf) = (jmt.multi_tensor_scale(jt, 0.5),
                          tmt.multi_tensor_scale(tt, 0.5))
    for a, b in zip(ts, js):
        _close(a, b)
    assert bool(tf) == bool(jf)
    ja, _ = jmt.multi_tensor_axpby(jt, [jnp.asarray(y) for y in ys], 2.0, -1.0)
    ta, _ = tmt.multi_tensor_axpby(tt, [torch.tensor(y) for y in ys], 2.0,
                                   -1.0)
    for a, b in zip(ta, ja):
        _close(a, b)
    _, finite = tmt.multi_tensor_scale([torch.tensor([1.0, float("inf")])],
                                       1.0)
    assert not bool(finite)


# -- the standalone GPT, fp32, against JAX ---------------------------------

TOY = dict(num_layers=2, hidden_size=64, num_attention_heads=2,
           vocab_size=128, max_position_embeddings=16,
           use_flash_attention=True, remat_policy="attn_res")
B, S = 2, 16


def _jax_loss_fn(cfg_kw):
    parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        1, 1, devices=jax.devices()[:1])
    model = JGPTModel(JGPTConfig(**cfg_kw))

    def losses(p, t, l):
        return shard_map(lambda p, t, l: model.apply(p, t, labels=l),
                         mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
                         check_vma=False)(p, t, l)

    return model, losses


@pytest.fixture(scope="module")
def toy_master():
    model = JGPTModel(JGPTConfig(**TOY))
    master = model.shard_master(model.init_master(jax.random.PRNGKey(0)), 0)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, TOY["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.randint(0, TOY["vocab_size"], (B, S)).astype(np.int32)
    yield jax.tree_util.tree_map(np.asarray, master), tokens, labels
    parallel_state.destroy_model_parallel()


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_gpt_losses_and_grads_match_jax(toy_master, remat):
    master, tokens, labels = toy_master
    cfg_kw = dict(TOY, remat=remat)
    _, losses = _jax_loss_fn(cfg_kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, master)

    @jax.jit
    def loss_and_grads(p, t, l):
        def mean(p):
            per_token = losses(p, t, l)
            return jnp.mean(per_token), per_token
        (_, per_token), g = jax.value_and_grad(mean, has_aux=True)(p)
        return per_token, g

    jloss, jgrads = loss_and_grads(jparams, jnp.asarray(tokens),
                                   jnp.asarray(labels))
    parallel_state.destroy_model_parallel()

    model = GPTModel(GPTConfig(**cfg_kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    tloss = model(torch.tensor(tokens), labels=torch.tensor(labels))
    assert tloss.shape == (B, S) and tloss.dtype == torch.float32
    _close(tloss.detach(), jloss)
    tloss.mean().backward()
    got = _flatten(jax_tree_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    ref = _flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name], ref[name])


def test_gpt_logits_without_labels_match_jax(toy_master):
    master, tokens, _ = toy_master
    parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        1, 1, devices=jax.devices()[:1])
    jmodel = JGPTModel(JGPTConfig(**TOY))
    jlogits = shard_map(lambda p, t: jmodel.apply(p, t), mesh=mesh,
                        in_specs=(P(), P()), out_specs=P(),
                        check_vma=False)(
        jax.tree_util.tree_map(jnp.asarray, master), jnp.asarray(tokens))
    parallel_state.destroy_model_parallel()
    model = GPTModel(GPTConfig(**TOY), device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    with torch.no_grad():
        logits = model(torch.tensor(tokens))
    assert logits.dtype == torch.float32
    _close(logits, jlogits)


def test_pretrain_gpt_three_step_trajectory_matches_jax(toy_master):
    master, _, _ = toy_master
    argv = ["--num-layers", "2", "--hidden-size", "64",
            "--num-attention-heads", "2", "--seq-length", str(S),
            "--max-position-embeddings", "16", "--micro-batch-size", str(B),
            "--vocab-size", "128", "--attention-dropout", "0",
            "--hidden-dropout", "0", "--lr", "1e-2", "--train-iters", "3",
            "--log-interval", "3"]
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 128, (3, B, S + 1)).astype(np.int64)
    ids[2] = ids[0]   # step 3 sees step 1's batch again
    batches = [(torch.tensor(i[:, :-1]), torch.tensor(i[:, 1:])) for i in ids]

    losses, final = [], {}

    def record(it, loss, model):
        losses.append(float(loss))
        final.update({k: v.detach().clone()
                      for k, v in model.state_dict().items()})

    last = pretrain_gpt.main(argv, device="cpu",
                             state_dict=state_dict_from_jax(master),
                             batches=batches, on_step=record)
    assert last == losses[-1]

    # the JAX example's step at tp = dp = 1 on the same weights and data
    model, per_token = _jax_loss_fn(dict(TOY, vocab_size=128))
    opt = jopt.FusedAdam(lr=1e-2, weight_decay=0.01, betas=(0.9, 0.999),
                         eps=1e-8)

    @jax.jit
    def step(p, o, t, l):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean(per_token(p, t, l)))(p)
        g, _ = jmt.clip_grad_norm(g, 1.0)
        p, o = opt.step(g, o, p)
        return p, o, loss

    p = jax.tree_util.tree_map(jnp.asarray, master)
    o = opt.init(p)
    ref = []
    for i in ids:
        p, o, loss = step(p, o, jnp.asarray(i[:, :-1], jnp.int32),
                          jnp.asarray(i[:, 1:], jnp.int32))
        ref.append(float(loss))
    parallel_state.destroy_model_parallel()
    _close(losses, ref)
    assert ref[2] < ref[0]   # the trajectory moves: lr 1e-2, same batch
    # the bars are ten times the largest gaps measured here. The key part of
    # the qkv bias has a zero gradient in exact arithmetic (softmax ignores
    # a shift shared by a row's scores), and Adam turns its rounding-level
    # gradients into steps of up to lr: read 1.1e-4, bar 1e-3; every other
    # weight read <= 9.6e-6, bar 1e-4. Three steps at lr 1e-2 move every
    # weight by about 3e-2, so a missed update fails either bar.
    init = _flatten(master)
    got = _flatten(jax_tree_from_state_dict(final))
    for name, want in _flatten(jax.tree_util.tree_map(np.asarray,
                                                      p)).items():
        bar = 1e-3 if name.endswith("qkv.bias") else 1e-4
        assert np.max(np.abs(got[name] - want)) <= bar, name
        assert np.max(np.abs(want - init[name])) > 10 * bar, name


# -- the port's own contracts ----------------------------------------------


@pytest.mark.parametrize("policy", ["attn_res", "full", "dots",
                                    "attn_res_mlp", "attn_out"])
def test_remat_with_hidden_dropout_gives_bitwise_equal_grads(policy):
    kw = dict(TOY, hidden_dropout=0.1, attention_dropout=0.1,
              remat_policy=policy)
    rng = np.random.RandomState(5)
    tokens = torch.tensor(rng.randint(0, 128, (B, S)))
    labels = torch.tensor(rng.randint(0, 128, (B, S)))
    grads = {}
    for remat in (False, True):
        model = GPTModel(GPTConfig(**kw, remat=remat), device="cpu", seed=3)
        loss = model(tokens, labels=labels, dropout_seed=42).mean()
        loss.backward()
        grads[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    assert torch.equal(grads[False][0], grads[True][0])
    for a, b in zip(grads[False][1], grads[True][1]):
        assert torch.equal(a, b)
    # and the masks are on: another seed gives another loss
    other = GPTModel(GPTConfig(**kw, remat=True), device="cpu", seed=3)
    assert not torch.equal(other(tokens, labels=labels,
                                 dropout_seed=43).mean(), grads[True][0])


def test_convert_round_trips_and_param_count(toy_master):
    master, _, _ = toy_master
    sd = state_dict_from_jax(master)
    back = state_dict_from_jax(jax_tree_from_state_dict(sd))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    model = GPTModel(GPTConfig(**TOY), device="cpu")
    assert sorted(model.state_dict()) == sorted(sd)
    assert sum(p.numel() for p in model.parameters()) == gpt_param_count(
        model.cfg)
    big = gpt1p3b_config()
    assert big.kv_channels == 128 and big.remat_policy == "attn_res"
    assert GPT1P3B_KW["num_layers"] == 24
    assert gpt_param_count(big) == 1317654528


def test_arguments_defaults_follow_the_jax_parser():
    args = targs.parse_args(args=["--num-layers", "2", "--hidden-size", "64",
                                  "--num-attention-heads", "2",
                                  "--micro-batch-size", "4", "--bf16"])
    assert (args.attention_dropout, args.hidden_dropout) == (0.1, 0.1)
    assert (args.weight_decay, args.clip_grad) == (0.01, 1.0)
    assert args.params_dtype == torch.bfloat16
    assert (args.world_size, args.global_batch_size) == (1, 4)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTModel(GPTConfig(**TOY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_gpt.main(["--num-layers", "2", "--hidden-size", "64",
                           "--num-attention-heads", "2", "--seq-length", "16",
                           "--micro-batch-size", "2", "--train-iters", "1"])


TOY_ARGV = ["--num-layers", "2", "--hidden-size", "64",
            "--num-attention-heads", "2", "--seq-length", "16",
            "--micro-batch-size", "2", "--vocab-size", "128"]
TP2_FLAGS = (("tensor-model-parallel-size",
              ["--tensor-model-parallel-size", "2"]),
             ("world-size", ["--world-size", "2"]))


@pytest.fixture(scope="module")
def tp2_runs(tmp_path_factory):
    """Two gloo ranks (tests/torch_ranks.py): the toy GPT at tp_size 2,
    pretrain_gpt's setup and one step under each of TP2_FLAGS, the three
    tensor-parallel layers at tp_size 2."""
    import torch_ranks
    from apex_tpu_torch.parallel.multiproc import spawn

    out = tmp_path_factory.mktemp("tp2")
    spawn(torch_ranks.gpt_runs_at_tp2, 2, str(out / "store"), str(out),
          {"toy": TOY, "argv": TOY_ARGV, "flags": TP2_FLAGS})
    return torch_ranks.load_ranks(str(out), 2)


@pytest.mark.parametrize("flags", [
    ["--tensor-model-parallel-size", "2"],
    ["--world-size", "2"],
    ["--profile-every", "2"],
    ["--num-layers", "12", "--remat-policy", "dots"],
    ["--pipeline-model-parallel-size", "2"],
], ids=lambda f: f[-2].lstrip("-") if len(f) == 4 else f[0].lstrip("-"))
def test_pretrain_gpt_refuses_unported_options(flags, request):
    """Pipeline parallelism is refused; tensor parallelism and more than
    one process run (two gloo ranks: tp 2 x dp 1, and tp 1 x dp 2 whose
    replicas stay equal after a step), as do the profile sampler and the
    remat policies."""
    if flags[0] in ("--tensor-model-parallel-size", "--world-size"):
        ranks = request.getfixturevalue("tp2_runs")
        name = flags[0].lstrip("-")
        want = (2, 1) if name.startswith("tensor") else (1, 2)
        for res in ranks:
            tp, dp, loss, params = res[name]
            assert (tp, dp) == want and np.isfinite(loss)
        if want == (1, 2):
            for a, b in zip(ranks[0][name][3], ranks[1][name][3]):
                assert torch.equal(a, b)
        return
    if flags[0] in ("--profile-every", "--num-layers"):
        args, model, _ = pretrain_gpt.setup(TOY_ARGV + flags, device="cpu")
        assert args.profile_every == (2 if flags[0] == "--profile-every"
                                      else 0)
        assert model.cfg.remat == (args.num_layers >= 12)
        assert model.cfg.remat_policy == args.remat_policy
        return
    with pytest.raises(NotImplementedError):
        pretrain_gpt.setup(TOY_ARGV + flags, device="cpu")


@pytest.mark.parametrize("overrides", [
    dict(num_experts=2), dict(use_flash_attention=False), dict(tp_size=2),
    dict(remat=True, remat_policy="attn_out"),
], ids=["moe", "no_flash", "tp2", "remat_attn_out"])
def test_gpt_model_refuses_unported_configs(overrides, request):
    """No config is refused any more: MoE (its parity with JAX in
    tests/test_torch_moe.py), tensor parallelism (in two gloo ranks), the
    fused-softmax path and every remat policy construct and run."""
    cfg = GPTConfig(**dict(TOY, **overrides))
    if "tp_size" in overrides:
        for res in request.getfixturevalue("tp2_runs"):
            loss, all_grads = res["model"]
            assert torch.isfinite(loss) and all_grads
        return
    model = GPTModel(cfg, device="cpu")
    tokens = torch.arange(2 * 8).reshape(2, 8) % TOY["vocab_size"]
    loss = model(tokens, labels=tokens).mean()
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in model.parameters())
    with pytest.raises(ValueError, match="unknown remat_policy"):
        GPTModel(GPTConfig(**dict(TOY, remat=True, remat_policy="dot")),
                 device="cpu")


def test_unported_masks_and_tensor_parallel_layers_raise(tp2_runs):
    """A full [b, 1, s, s] mask, which the packed kernels cannot take,
    runs the fused-softmax path on a flash config too, as in JAX (the
    same numbers as the non-flash config); the tensor-parallel layers run
    at tp_size 2 in two ranks and raise without a registered tensor group
    of that size."""
    flash = GPTModel(GPTConfig(**TOY), device="cpu")
    soft = GPTModel(GPTConfig(**dict(TOY, use_flash_attention=False)),
                    device="cpu")
    soft.load_state_dict(flash.state_dict())
    tokens = torch.tensor([[3, 1, 4, 1], [5, 9, 2, 6]])
    mask = torch.zeros(2, 1, 4, 4, dtype=torch.bool)
    mask[1, 0, :, 3] = True
    with torch.no_grad():
        a = flash(tokens, attention_mask=mask)
        b = soft(tokens, attention_mask=mask)
        c = flash(tokens)
    assert torch.equal(a, b) and not torch.equal(a, c)
    init = normal_init(0.02)
    for cls in (ColumnParallelLinear, RowParallelLinear,
                VocabParallelEmbedding):
        with pytest.raises(RuntimeError, match="initialize_model_parallel"):
            cls(8, 8, init_method=init, tp_size=2)
    for res in tp2_runs:
        assert res["layers"] == [(3, 8), (3, 8), (8, 8)]


def test_training_modules_import_neither_jax_nor_apex_tpu():
    code = ("import sys, apex_tpu_torch.examples.gpt.pretrain_gpt, "
            "apex_tpu_torch.ops.fused_softmax, apex_tpu_torch.ops.xentropy, "
            "apex_tpu_torch.ops.fused_dense, apex_tpu_torch.ops.mlp, "
            "apex_tpu_torch.transformer.enums, "
            "apex_tpu_torch.transformer.log_util, "
            "apex_tpu_torch.transformer.tensor_parallel.utils, "
            "apex_tpu_torch.transformer.pipeline_parallel, "
            "apex_tpu_torch.transformer.testing.global_vars, "
            "apex_tpu_torch.transformer._data, apex_tpu_torch.utils.logging, "
            "apex_tpu_torch.profiling.trace_report, apex_tpu_torch.profiling, "
            "apex_tpu_torch.telemetry.sampler, "
            "apex_tpu_torch.transformer.testing.convert, "
            "apex_tpu_torch.transformer.testing.arguments, "
            "apex_tpu_torch.transformer.testing.train_loop, "
            "apex_tpu_torch.optimizers, apex_tpu_torch.multi_tensor, "
            "apex_tpu_torch.ops.fused_layer_norm, "
            "apex_tpu_torch.ops.fused_linear_xent, "
            "apex_tpu_torch.checkpoint, apex_tpu_torch.data, "
            "apex_tpu_torch._native, apex_tpu_torch.resilience, "
            "apex_tpu_torch.resilience.chaos, "
            "apex_tpu_torch.telemetry.accounting\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apex_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- the fused-softmax attention path (the JAX GPTModel default) -----------

SOFT = dict(TOY, use_flash_attention=False)


def _jax_shard(cfg_kw, body):
    """``body(model, *args)`` for a JAX ``GPTModel`` of ``cfg_kw`` inside a
    one-device ``shard_map`` (every argument and the result replicated)."""
    parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        1, 1, devices=jax.devices()[:1])
    model = JGPTModel(JGPTConfig(**cfg_kw))

    def run(*args):
        return shard_map(lambda *a: body(model, *a), mesh=mesh,
                         in_specs=tuple(P() for _ in args), out_specs=P(),
                         check_vma=False)(*args)
    return run


def _masks(kind):
    """A boolean attention mask (True = masked) of ``kind`` for [B, S]."""
    lens = np.array([S, S - 5])
    q, k = np.arange(S)[:, None], np.arange(S)[None, :]
    pad = np.arange(S)[None, :] >= lens[:, None]          # [B, S]
    if kind == "none":
        return None
    if kind == "key_padding":
        return pad[:, None, None, :]
    if kind == "causal_padding":                         # [B, 1, S, S]
        return ((k > q)[None, None] | pad[:, None, None, :])
    raise ValueError(kind)


def _grads_of(model):
    return _flatten(jax_tree_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()
         if p.grad is not None}))


@pytest.mark.parametrize("kind,flash", [
    ("none", False), ("key_padding", False), ("causal_padding", False),
    ("causal_padding", True)],
    ids=["soft_cfg-none", "soft_cfg-key_padding", "soft_cfg-causal_padding",
         "flash_cfg-causal_padding"])
def test_softmax_path_losses_and_grads_match_jax(toy_master, kind, flash):
    """The fused-softmax path at toy depth against JAX's, loss and every
    gradient: with no mask and a key-padding mask on the non-flash config
    (a key-padding mask on the flash config stays on the packed kernels,
    held by ``test_torch_bert``); a full causal + padding [b, 1, s, s]
    mask on both, which the flash config also sends down the fused
    softmax."""
    master, tokens, labels = toy_master
    cfg_kw = dict(TOY, use_flash_attention=flash)
    mask = _masks(kind)

    def body(model, p, t, l, m=None):
        return model.apply(p, t, labels=l, attention_mask=m)

    run = _jax_shard(cfg_kw, body)
    args = [jnp.asarray(tokens), jnp.asarray(labels)]
    if mask is not None:
        args.append(jnp.asarray(mask))

    @jax.jit
    def loss_and_grads(p, *a):
        per_token, vjp = jax.vjp(lambda p: run(p, *a), p)
        (g,) = vjp(jnp.full_like(per_token, 1.0 / per_token.size))
        return per_token, g

    jloss, jgrads = loss_and_grads(
        jax.tree_util.tree_map(jnp.asarray, master), *args)
    parallel_state.destroy_model_parallel()
    model = GPTModel(GPTConfig(**cfg_kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    tloss = model(torch.tensor(tokens), labels=torch.tensor(labels),
                  attention_mask=None if mask is None else torch.tensor(mask))
    _close(tloss.detach(), jloss)
    tloss.mean().backward()
    got, ref = _grads_of(model), _flatten(jax.tree_util.tree_map(
        np.asarray, jgrads))
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name], ref[name])


@pytest.mark.parametrize("with_mask", [False, True], ids=["ids", "ids_pad"])
def test_softmax_path_packing_ids_match_jax(toy_master, with_mask):
    """Packing ids (and a key-padding mask on top) folded into the fused
    softmax's boolean mask, through the transformer body: its output and
    the gradients of a seeded projection of it, against JAX's
    ``ParallelTransformer.apply(..., segment_ids=)``."""
    master, _, _ = toy_master
    rng = np.random.RandomState(11)
    h = rng.randn(B, S, TOY["hidden_size"]).astype(np.float32)
    w = rng.randn(B, S, TOY["hidden_size"]).astype(np.float32)
    seg = np.array([[0] * 6 + [1] * 7 + [2] * 3, [0] * 9 + [1] * 7],
                   np.int32)
    mask = _masks("key_padding") if with_mask else None

    def body(model, p, x, sid, m=None):
        out, _ = model.transformer.apply(p["transformer"], x, m,
                                         segment_ids=sid)
        return out

    run = _jax_shard(SOFT, body)
    extra = [] if mask is None else [jnp.asarray(mask)]

    @jax.jit
    def fwd_bwd(p, x):
        out, vjp = jax.vjp(lambda p, x: run(p, x, jnp.asarray(seg), *extra),
                           p, x)
        return out, vjp(jnp.asarray(w))

    jout, (jgp, jgx) = fwd_bwd(jax.tree_util.tree_map(jnp.asarray, master),
                               jnp.asarray(h))
    parallel_state.destroy_model_parallel()
    model = GPTModel(GPTConfig(**SOFT), device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    x = torch.tensor(h, requires_grad=True)
    out, _ = model.transformer(x, None, None if mask is None
                               else torch.tensor(mask), torch.tensor(seg))
    _close(out.detach(), jout)
    out.backward(torch.tensor(w))
    _close(x.grad, jgx)
    got = {k: v for k, v in _grads_of(model).items()
           if k.startswith("transformer")}
    ref = {k: v for k, v in _flatten(jax.tree_util.tree_map(
        np.asarray, jgp)).items() if k.startswith("transformer")}
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name], ref[name])


# K3 (the packed attention forward) and K6 (LayerNorm forward) calls of one
# training step at 2 layers, by remat policy: the forward runs K3 once a
# layer and K6 twice a layer plus the final LayerNorm's; the recompute
# re-runs K3 unless the policy keeps its outputs (attn_res, attn_res_mlp),
# and both LayerNorms of every layer whatever the policy (their outputs
# feed saved products); K4 and K7 once per forward call
POLICY_CALLS = {"full": (4, 9), "dots": (4, 9), "attn_res": (2, 9),
                "attn_res_mlp": (2, 9), "attn_out": (4, 9)}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "softmax"])
@pytest.mark.parametrize("policy", sorted(POLICY_CALLS))
def test_remat_policies_equal_no_remat_and_rerun_what_they_drop(
        policy, flash, monkeypatch):
    """Each policy's loss and gradients bitwise equal to no remat (dropout
    on, both attention paths); the attention and LayerNorm calls of a
    step on the flash path are the policy's."""
    from apex_tpu_torch.ops import attention as att
    from apex_tpu_torch.ops import fused_layer_norm as fln

    calls = {"k3": 0, "k4": 0, "k6": 0, "k7": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    for key, mod, name in (("k3", att, "_flash_qkv_fwd_plain"),
                           ("k4", att, "_flash_qkv_bwd_plain"),
                           ("k6", fln, "_ln_fwd_plain"),
                           ("k7", fln, "_ln_bwd_plain")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    kw = dict(TOY, use_flash_attention=flash, hidden_dropout=0.1,
              attention_dropout=0.1, remat_policy=policy)
    rng = np.random.RandomState(12)
    tokens = torch.tensor(rng.randint(0, 128, (B, S)))
    labels = torch.tensor(rng.randint(0, 128, (B, S)))
    grads = {}
    for remat in (False, True):
        model = GPTModel(GPTConfig(**kw, remat=remat), device="cpu", seed=4)
        for k in calls:
            calls[k] = 0
        loss = model(tokens, labels=labels, dropout_seed=7).mean()
        loss.backward()
        grads[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    assert torch.equal(grads[False][0], grads[True][0])
    for a, b in zip(grads[False][1], grads[True][1]):
        assert torch.equal(a, b)
    k3, k6 = POLICY_CALLS[policy]
    want = ({"k3": k3, "k4": 2, "k6": k6, "k7": 5} if flash
            else {"k3": 0, "k4": 0, "k6": k6, "k7": 5})
    assert calls == want


# the L1 harness's GPT cell: tests/L1/common/harness.py's GPTConfig (2
# layers, hidden 32, 2 heads, vocab 64, the JAX defaults otherwise: the
# fused-softmax path), FusedAdam at lr 5e-3; O2 is bf16 with dynamic loss
# scaling.  Bars, test_torch_amp_gpt's for the same cells: O0 1e-5 x
# |loss| (read 1.2e-7); O2 5e-3 absolute on a loss near 4.2 (read 8.3e-4:
# both packages round the scores and probabilities to bf16, but each
# rounds its LayerNorms, GELU and products in its own order)
HARNESS_O0_TOL = 1e-5
HARNESS_O2_TOL = 5e-3


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_l1_harness_gpt_cell_matches_live_jax(level):
    from tests.L1.common.harness import RunConfig, run_trajectory
    from tests.test_torch_amp_gpt import port_trajectory

    cell = RunConfig(model="gpt", opt_level=level, steps=4, lr=5e-3,
                     **({"loss_scale": 1.0} if level == "O0" else {}))
    want = run_trajectory(cell)
    got = port_trajectory(level, torch.bfloat16, "adam", 4, 5e-3,
                          flash=False)
    gaps = [abs(g[0] - w) for g, w in zip(got, want)]
    tol = ([HARNESS_O0_TOL * abs(w) for w in want] if level == "O0"
           else [HARNESS_O2_TOL] * len(want))
    assert all(g <= t for g, t in zip(gaps, tol)), (got, want, gaps)
    assert all(f for _, f, _ in got)
    assert got[-1][0] < got[0][0]


def test_pretrain_gpt_profile_every_emits_profile_events(tmp_path):
    """``--profile-every 2 --telemetry-dir`` on the CPU toy: the sampler
    captures after step 2 and emits at step 3 (and 5), each profile event
    with its memory event; the stream validates, the overhead is in the
    profile bucket, no profiler session outlives the run, and
    ``summarize`` prints the phase row."""
    from apex_tpu_torch import telemetry as tele
    from apex_tpu_torch.telemetry.__main__ import main as tele_cli

    argv = TOY_ARGV + ["--train-iters", "6", "--log-interval", "3",
                       "--profile-every", "2", "--max-position-embeddings",
                       "16", "--telemetry-dir", str(tmp_path)]
    held = []
    real = tele.ProfileSampler

    class Held(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, max_overhead=1e9,
                             **{k: v for k, v in kw.items()
                                if k != "max_overhead"})
            held.append(self)

    old = tele.ProfileSampler
    tele.ProfileSampler = Held
    try:
        loss = pretrain_gpt.main(argv, device="cpu")
    finally:
        tele.ProfileSampler = old
    assert np.isfinite(loss)
    path = str(tmp_path / "pretrain_gpt.jsonl")
    events = tele.load_jsonl(path)
    assert tele.validate_jsonl(path) == len(events)
    profs = [e for e in events if e["type"] == "profile"]
    mems = [e for e in events if e["type"] == "memory"]
    assert [e["step"] for e in profs] == [3, 5]
    assert [e["step"] for e in mems] == [3, 5]
    assert all(e["total_device_ms"] > 0 and e["n_ops"] > 0 for e in profs)
    (s,) = held
    assert s.totals()["failures"] == 0 and not s.totals()["disabled"]
    assert s._active_dir is None            # the open window was closed
    end = [e for e in events if e["type"] == "run_end"][-1]
    assert end["buckets_s"]["profile"] > 0
    assert tele_cli(["summarize", path]) == 0
    with torch.profiler.profile():          # no session left running
        torch.zeros(1)
