"""Tensor- and data-parallel GPT (and BERT) training: the port against the
JAX package at tp = 2 and at tp 2 x dp 2.

The port's ranks are processes (gloo on a ``file://`` store, rank bodies
in ``tests/torch_ranks.py``), each loading its shard of a JAX
``init_master`` tree (``convert.rank_state_dict_from_jax``).  JAX runs
the models inside ``shard_map`` over the emulated 8-device mesh and its
``examples/gpt/pretrain_gpt.py`` over four of those devices
(``jax.devices`` patched in the test: the example uses every device it
sees); its model-parallel state is destroyed after each use.

What JAX computes at tp = 2 differs from the reference in one way the
tests pin: inside its ``shard_map`` the gradient of a replicated leaf
(the LayerNorms, the row-parallel biases, the position embedding) is a
per-rank partial, and the tp ranks' partials sum to the gradient (its
tp = 1 gradient).  The port follows the reference apex (the copy region
all-reduces the input gradient), so each of its ranks holds that sum,
the same bits on every rank, and its replicated leaves stay equal
across ranks after every step.  The port's trajectory at tp 2 x dp 2 is
therefore held to the JAX example at tp = 1 (dp 4, the same global
batch), and to the JAX example at tp 2 x dp 2 on its first step, before
JAX's replicas part.

Tolerances: fp32 losses 1e-5 x max(1, |ref|) and gradients 1e-5 x
max(1, max|ref|) (sums in another order); the three-step trajectory
against JAX at tp = 1 1e-5 x |loss| (read 4.8e-7 on the CPU, where JAX's
own tp 2 x dp 2 run is 8.3e-4 away at step 2); resumed runs against the
run they resume 1e-5 x |loss| across packages and bitwise within the
port.
"""

import json
import os
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
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.testing import BertConfig as JBertConfig
from apex_tpu.transformer.testing import BertModel as JBertModel
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch.data import write_records
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, jax_tree_from_state_dict, state_dict_from_jax,
    stacked_jax_tree)

import torch_ranks

REPO = Path(__file__).resolve().parent.parent
TP = 2
TOL = 1e-5
GPT_CFG = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
               vocab_size=64, max_position_embeddings=16)
BERT_CFG = dict(GPT_CFG, num_tokentypes=2, add_binary_head=True)
B, S = 2, 16
GPT_VARIANTS = (("plain", {}),
                ("flash_attn_res", dict(use_flash_attention=True, remat=True,
                                        remat_policy="attn_res")),
                ("dots", dict(remat=True, remat_policy="dots")))
#: leaves every tp rank holds whole
REPLICATED = ("layernorm", "position_embeddings", "proj.bias",
              "dense_4h_to_h.bias", "tokentype_embeddings", "pooler",
              "binary_head", "lm_head.dense")


def replicated(name):
    return any(k in name for k in REPLICATED)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _inputs():
    r = np.random.RandomState(3)
    mask = np.ones((B, S), np.int32)
    mask[1, 11:] = 0
    return {"tokens": r.randint(0, 64, (B, S)).astype(np.int32),
            "labels": r.randint(0, 64, (B, S)).astype(np.int32),
            "bert_mask": mask,
            "tokentypes": (np.arange(S)[None] >= S // 2).astype(
                np.int32).repeat(B, 0)}


def _masters():
    """The GPT and BERT masters, sharded and stacked as the JAX example
    stacks them (a leading tp axis)."""
    out = {}
    for name, cls, cfg_cls, kw in (("gpt", JGPTModel, JGPTConfig, GPT_CFG),
                                   ("bert", JBertModel, JBertConfig,
                                    BERT_CFG)):
        # the tp = 1 master (BERT's MLM bias is then vocab-long), sharded
        # by the tp = 2 model
        master = cls(cfg_cls(**kw)).init_master(jax.random.PRNGKey(0))
        model = cls(cfg_cls(**kw, tp_size=TP))
        if name == "bert":
            # JAX starts the binary head and the MLM bias at zero, which
            # would leave the pooler's gradient zero and the bias's shards
            # alike: give them values
            rs = np.random.RandomState(9)
            master["binary_head"]["weight"] = jnp.asarray(
                0.1 * rs.randn(2, kw["hidden_size"]), jnp.float32)
            master["lm_head"]["bias"] = jnp.asarray(
                0.1 * rs.randn(kw["vocab_size"]), jnp.float32)
        out[name] = (master, jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]),
            *[model.shard_master(master, r) for r in range(TP)]))
    return out


def _jax_grads(name, cfg_kw, stacked, inp, tp):
    """JAX's loss and stacked gradients at ``tp`` (``stacked``: leading
    axis tp)."""
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(tp, 1, devices=jax.devices()[:tp])
    try:
        if name == "bert":
            model = JBertModel(JBertConfig(**cfg_kw, tp_size=tp))

            def run(p, t, l, m, tt):
                p = jax.tree_util.tree_map(lambda a: a[0], p)
                lm, binary = model.apply(p, t, attention_mask=m,
                                         tokentype_ids=tt, lm_labels=l)
                return jnp.mean(lm) + jnp.mean(binary.astype(
                    jnp.float32) ** 2)
            args = (inp["tokens"], inp["labels"], inp["bert_mask"],
                    inp["tokentypes"])
        else:
            model = JGPTModel(JGPTConfig(**cfg_kw, tp_size=tp))

            def run(p, t, l):
                p = jax.tree_util.tree_map(lambda a: a[0], p)
                return jnp.mean(model.apply(p, t, labels=l))
            args = (inp["tokens"], inp["labels"])
        f = lambda p: shard_map(  # noqa: E731
            run, mesh=mesh, in_specs=(P("tensor"),) + (P(),) * len(args),
            out_specs=P(), check_vma=False)(p, *args)
        loss, g = jax.jit(jax.value_and_grad(f))(jax.tree_util.tree_map(
            jnp.asarray, stacked))
        return float(loss), {k: np.asarray(v) for k, v in _flatten(
            jax.tree_util.tree_map(np.asarray, g)).items()}
    finally:
        jps.destroy_model_parallel()


def _by_jax_name(grads):
    """The port's gradient dict under the JAX tree's flat names."""
    return _flatten(jax_tree_from_state_dict(grads))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = tmp_path_factory.mktemp("models")
    masters, inp = _masters(), _inputs()
    case = dict(inp, gpt_cfg=GPT_CFG, bert_cfg=BERT_CFG,
                gpt_variants=GPT_VARIANTS, gpt_master=masters["gpt"][1],
                bert_master=masters["bert"][1])
    spawn(torch_ranks.parallel_models, TP, str(out / "store"), str(out),
          case)
    return masters, inp, torch_ranks.load_ranks(str(out), TP)


@pytest.mark.parametrize("variant", [v for v, _ in GPT_VARIANTS])
def test_toy_gpt_tp2_losses_and_stacked_grads_against_jax(models, variant):
    """The loss on both ranks is JAX's; each rank's sharded gradients are
    JAX's stacked gradients at its index; the replicated ones are the sum
    of JAX's per-rank partials, and the same bits on both ranks."""
    masters, inp, ranks = models
    over = dict(GPT_VARIANTS)[variant]
    jloss, jg = _jax_grads("gpt", dict(GPT_CFG, **over), masters["gpt"][1],
                           inp, TP)
    got = [_by_jax_name(res[variant][1]) for res in ranks]
    assert set(got[0]) == set(jg)
    for r, res in enumerate(ranks):
        close(res[variant][0], jloss)
        for k, want in jg.items():
            if replicated(k):
                close(got[r][k], want.sum(0))
                np.testing.assert_array_equal(got[r][k], got[0][k])
            else:
                close(got[r][k], want[r])


def test_toy_gpt_tp2_against_tp1(models):
    """tp = 2 from tp = 1's master: the loss is tp = 1's, and the ranks'
    gradients stack (column shards, row shards, vocab shards) into tp =
    1's."""
    masters, inp, ranks = models
    m = GPTModel(GPTConfig(**GPT_CFG), device="cpu")
    one = JGPTModel(JGPTConfig(**GPT_CFG)).shard_master(masters["gpt"][0], 0)
    m.load_state_dict(state_dict_from_jax(one))
    loss = m(torch.from_numpy(inp["tokens"]),
             labels=torch.from_numpy(inp["labels"])).mean()
    loss.backward()
    want = _by_jax_name({n: p.grad for n, p in m.named_parameters()})
    stacked = _flatten(stacked_jax_tree([res["plain"][1] for res in ranks]))
    for r, res in enumerate(ranks):
        close(res["plain"][0], loss.detach())
    for k, w in want.items():
        g = stacked[k]
        if replicated(k):
            close(g[0], w)
            continue
        axis = 1 if ("proj.weight" in k or "4h_to_h.weight" in k) else 0
        lead = 1 if k.startswith("transformer.layers") else 0
        close(np.concatenate(list(g), axis=axis + lead), w)


def test_clip_norm_against_jax(models):
    """pretrain_gpt's clip norm at tp = 2 is the norm of the whole
    gradient: JAX's ``clip_grad_norm`` norm over its tp = 1 gradients."""
    masters, inp, ranks = models
    _, jg = _jax_grads("gpt", GPT_CFG, jax.tree_util.tree_map(
        lambda a: np.asarray(a)[None], JGPTModel(JGPTConfig(**GPT_CFG))
        .shard_master(masters["gpt"][0], 0)), inp, 1)
    _, norm = jmt.clip_grad_norm({k: jnp.asarray(v) for k, v in jg.items()},
                                 1e9)
    for res in ranks:
        close(res["clip_norm"], float(norm))


def test_tp2_stays_consistent_with_dropout(models):
    """Attention dropout on the per-rank stream and hidden dropout on the
    replicated one: both ranks hold the same hidden state, bit for bit,
    and dropout changed it."""
    _, _, ranks = models
    h = [res["dropout_hidden"] for res in ranks]
    np.testing.assert_array_equal(h[0][0], h[1][0])
    assert not torch.equal(h[0][0], h[0][1])


def test_bert_tp2_against_jax(models):
    """BERT at tp = 2 (the MLM head's vocab bias sharded): losses and
    binary logits JAX's, sharded gradients JAX's at the rank's index,
    replicated ones its tp = 1 gradients."""
    masters, inp, ranks = models
    jloss, jg = _jax_grads("bert", BERT_CFG, masters["bert"][1], inp, TP)
    one = JBertModel(JBertConfig(**BERT_CFG)).shard_master(
        masters["bert"][0], 0)
    _, jg1 = _jax_grads("bert", BERT_CFG, jax.tree_util.tree_map(
        lambda a: np.asarray(a)[None], one), inp, 1)
    for r, res in enumerate(ranks):
        lm, binary, grads = res["bert"]
        close(float(lm.mean() + binary.float().pow(2).mean()), jloss)
        got = _by_jax_name(grads)
        assert set(got) == set(jg)
        for k, want in jg.items():
            if replicated(k):
                close(got[k], jg1[k][0])
            else:
                close(got[k], want[r])


# -- pretrain_gpt at tp 2 x dp 2 against the JAX example ----------------------

WORLD = 4
TOY = ["--num-layers", "2", "--hidden-size", "64", "--num-attention-heads",
       "4", "--seq-length", str(S), "--max-position-embeddings", str(S),
       "--vocab-size", "128", "--make-vocab-size-divisible-by", "64",
       "--attention-dropout", "0", "--hidden-dropout", "0", "--lr", "1e-3",
       "--log-interval", "1", "--seed", "7", "--global-batch-size", "4"]
JAX_TP1 = ["--micro-batch-size", "1", "--world-size", str(WORLD)]
TP2 = ["--tensor-model-parallel-size", "2", "--micro-batch-size", "2"]
JAX_TP2 = TP2 + ["--world-size", str(WORLD)]


def _jax_losses(stream):
    out = {}
    for line in open(stream):
        e = json.loads(line)
        if e["type"] == "step":
            out[e["step"]] = e["scalars"]["loss"]
    return out


@pytest.fixture(scope="module")
def pretrain(tmp_path_factory):
    """The JAX example at tp = 1 (3 steps), at tp 2 x dp 2 (2 steps,
    saved, and its own resume to 3), then the port's ranks (an
    uninterrupted run, a saved run, its resume, the resume of JAX's
    checkpoint), then JAX's resume of the port's checkpoint."""
    d = tmp_path_factory.mktemp("pretrain")
    shard = str(d / "tokens.bin")
    ids = np.random.RandomState(5).randint(0, 2 ** 31, (24, S + 1))
    write_records(shard, ids.astype(np.uint32).view(np.uint8).reshape(24, -1))
    data = ["--data-path", shard]
    sys.path.insert(0, str(REPO / "examples" / "gpt"))
    mp = pytest.MonkeyPatch()
    try:
        import pretrain_gpt as jex
        real = jax.devices
        mp.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:WORLD])

        def jax_run(flags, name):
            tele = str(d / f"tele_{name}")
            jex.main(TOY + data + flags + ["--telemetry-dir", tele])
            return _jax_losses(os.path.join(tele, "pretrain_gpt.jsonl"))

        jax1 = jax_run(JAX_TP1 + ["--train-iters", "3"], "tp1")
        jck, pck = str(d / "jax_ckpt"), str(d / "port_ckpt")
        jax2 = jax_run(JAX_TP2 + ["--train-iters", "2", "--save", jck],
                       "tp2")
        jax2_resumed = jax_run(JAX_TP2 + ["--train-iters", "3", "--load",
                                          jck], "tp2_resumed")
        jcfg = JGPTConfig(num_layers=2, hidden_size=64,
                          num_attention_heads=4, vocab_size=128,
                          max_position_embeddings=S, tp_size=2)
        jmodel = JGPTModel(jcfg)
        master = jmodel.init_master(jax.random.PRNGKey(7))
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]),
            *[jmodel.shard_master(master, r) for r in range(2)])
        case = {"tp": 2, "master": stacked, "base": TOY + data + TP2,
                "runs": [("uninterrupted", ["--train-iters", "3"], True),
                         ("saved", ["--train-iters", "2", "--save", pck],
                          True),
                         ("resumed", ["--train-iters", "3", "--load", pck],
                          False),
                         ("from_jax", ["--train-iters", "3", "--load", jck],
                          False)]}
        spawn(torch_ranks.pretrain_runs, WORLD, str(d / "store"), str(d),
              case)
        ranks = torch_ranks.load_ranks(str(d), WORLD)
        jax_from_port = jax_run(JAX_TP2 + ["--train-iters", "3", "--load",
                                           pck], "from_port")
    finally:
        mp.undo()
        sys.path.remove(str(REPO / "examples" / "gpt"))
        sys.modules.pop("pretrain_gpt", None)
    return dict(jax1=jax1, jax2=jax2, jax2_resumed=jax2_resumed,
                jax_from_port=jax_from_port, ranks=ranks, jck=jck, pck=pck)


def _port_losses(run, name):
    losses = [res[name][0] for res in run["ranks"]]
    assert all(lo == losses[0] for lo in losses), losses
    return losses[0]


def test_pretrain_tp2_dp2_trajectory_against_the_jax_example(pretrain):
    """Three steps at tp 2 x dp 2 from the JAX example's weights and
    records: JAX's tp = 1 trajectory at every step, and JAX's own tp 2 x
    dp 2 step 1 (its loss before any update)."""
    got = _port_losses(pretrain, "uninterrupted")
    want = pretrain["jax1"]
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for s in want:
        assert abs(got[s] - want[s]) <= TOL * abs(want[s]), (s, got, want)
    assert abs(got[1] - pretrain["jax2"][1]) <= TOL * abs(got[1])


def test_pretrain_tp2_dp2_replicas_stay_bitwise_equal(pretrain):
    """After every step the replicated leaves are the same bits on both tp
    ranks, and the dp replicas (ranks 0 and 2, 1 and 3) hold the same
    bits in every parameter."""
    params = [res["uninterrupted"][1] for res in pretrain["ranks"]]
    for step in (1, 2, 3):
        for name, p in params[0][step].items():
            for r in (2,):
                assert torch.equal(p, params[r][step][name]), (step, name)
            assert torch.equal(params[1][step][name],
                               params[3][step][name]), (step, name)
            if replicated(name):
                assert torch.equal(p, params[1][step][name]), (step, name)


def test_pretrain_tp2_checkpoint_interchange(pretrain):
    """A tp = 2 checkpoint (a leading tp axis of 2) written by either
    example resumes in the other: the resumed step's loss is the writer's
    own resumed run's within 1e-5, and the port's resume of its own
    checkpoint is its uninterrupted run, bitwise."""
    mine = json.load(open(os.path.join(tckpt.step_dir(pretrain["pck"], 2),
                                       "manifest.json")))
    theirs = json.load(open(os.path.join(tckpt.step_dir(pretrain["jck"], 2),
                                         "manifest.json")))
    assert {k: (e["shape"], e["dtype"]) for k, e in mine["leaves"].items()} \
        == {k: (e["shape"], e["dtype"]) for k, e in theirs["leaves"].items()}
    assert all(e["shape"][0] == 2 for k, e in mine["leaves"].items()
               if "params" in k)
    assert mine["data_state"] == theirs["data_state"]
    full = _port_losses(pretrain, "uninterrupted")
    resumed = _port_losses(pretrain, "resumed")
    assert sorted(resumed) == [3] and resumed[3] == full[3]
    from_jax = _port_losses(pretrain, "from_jax")
    assert sorted(from_jax) == [3]
    want = pretrain["jax2_resumed"][3]
    assert abs(from_jax[3] - want) <= TOL * abs(want), (from_jax, want)
    got = pretrain["jax_from_port"]
    assert sorted(got) == [3]
    assert abs(got[3] - full[3]) <= TOL * abs(full[3]), (got, full)
