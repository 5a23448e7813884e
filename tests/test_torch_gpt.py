"""Parity of the PyTorch port's GPT training path with the JAX package's:
the fused LM-head cross-entropy, FusedAdam with global-norm clipping, the
multi-tensor ops, the standalone GPT's losses and gradients, and a short
``pretrain_gpt`` loss trajectory; plus the port's own remat, device and
refusal contracts.

The same weights (a JAX ``GPTModel.init_master`` tree carried over by
``transformer.testing.convert``) and the same inputs, drawn with numpy
from a seed, go through both.  On the CPU the port runs its kernels'
plain versions; JAX runs its CPU routes, the model inside a one-device
``shard_map`` as ``tests/L0/test_megatron_models.py`` runs it.

Tolerances: fp32 1e-5 x max(1, max|ref|) on losses and on each gradient
tensor (sums in another order); bf16 2^-7 x max|ref| (one bf16 ulp at
the output's scale); optimizer states and weights after several fp32
steps 1e-6 x max(1, max|ref|); the remat contract bitwise.
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


@pytest.mark.parametrize("policy", ["attn_res", "full"])
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


@pytest.mark.parametrize("flags", [
    ["--tensor-model-parallel-size", "2"],
    ["--world-size", "2"],
    ["--profile-every", "2"],
    ["--num-layers", "12", "--remat-policy", "dots"],
], ids=lambda f: f[-2].lstrip("-") if len(f) == 4 else f[0].lstrip("-"))
def test_pretrain_gpt_refuses_unported_options(flags):
    with pytest.raises(NotImplementedError):
        pretrain_gpt.setup(TOY_ARGV + flags, device="cpu")


@pytest.mark.parametrize("overrides", [
    dict(num_experts=2), dict(use_flash_attention=False), dict(tp_size=2),
    dict(remat=True, remat_policy="attn_out"),
], ids=["moe", "no_flash", "tp2", "remat_attn_out"])
def test_gpt_model_refuses_unported_configs(overrides):
    with pytest.raises(NotImplementedError):
        GPTModel(GPTConfig(**dict(TOY, **overrides)), device="cpu")


def test_unported_masks_and_tensor_parallel_layers_raise():
    model = GPTModel(GPTConfig(**TOY), device="cpu")
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 4, dtype=torch.long),
              attention_mask=torch.zeros(1, 1, 4, 4, dtype=torch.bool))
    init = normal_init(0.02)
    for cls in (ColumnParallelLinear, RowParallelLinear,
                VocabParallelEmbedding):
        with pytest.raises(NotImplementedError):
            cls(8, 8, init_method=init, tp_size=2)


def test_training_modules_import_neither_jax_nor_apex_tpu():
    code = ("import sys, apex_tpu_torch.examples.gpt.pretrain_gpt, "
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
