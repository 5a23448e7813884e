"""Parity of the PyTorch port's BERT training path with the JAX package's,
and the port's BERT-large workload against ``bench.py``'s.

The same weights (a JAX ``BertModel.init_master`` tree carried over by
``transformer.testing.convert``) and the same inputs, drawn with numpy
from a seed (the port's ``profiling.bert_large.bert_batches``, held
below to ``bench.py::_bert_batches``), go through both at fp32 on the
CPU: a toy of 2 layers, hidden 128, 2 heads of 64 (BERT-large's head
dim), vocab 128, sequence 32.  The port runs its kernels' plain versions;
JAX runs its CPU routes, the model inside a one-device ``shard_map``.
Three layouts: padded (a key-padding mask), packed (segment and position
ids) and both folded (the packed rows with their padding mask too).

Tolerances: losses, logits and every gradient tensor 1e-5 x max(1,
max|ref|) (fp32, sums in another order); packed == padded on the real
tokens 2e-5 (``tests/L0/test_megatron_models.py``'s bar); weights after
three FusedAdam steps as the test states them.
"""

import ast
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

from apex_tpu import optimizers as jopt
from apex_tpu.ops import attention as jatt
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import BertConfig as JBertConfig
from apex_tpu.transformer.testing import BertModel as JBertModel
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.profiling import bert_large
from apex_tpu_torch.transformer.testing import (BertConfig, BertModel,
                                                GPTConfig, GPTModel,
                                                bert_model_provider)
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, jax_tree_from_state_dict, state_dict_from_jax)
import chip_smoke
from chip_smoke import sm90_visits_want

REPO = Path(__file__).resolve().parent.parent

TOY = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
           vocab_size=128, max_position_embeddings=32,
           use_flash_attention=True, remat=True, remat_policy="attn_res",
           num_tokentypes=0, add_binary_head=False)
N_SEQ, SEQ = 5, 32
LAYOUTS = ("padded", "packed", "folded")


def _close(got, want, tol=1e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    bar = tol * max(1.0, float(np.max(np.abs(want))))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= bar, np.max(np.abs(got - want))


@pytest.fixture(scope="module")
def workload():
    """The toy's batches, padded and packed, as numpy arrays."""
    padded, packed, _, _ = bert_large.bert_batches(N_SEQ, SEQ,
                                                   TOY["vocab_size"],
                                                   device="cpu")
    return ({k: v.numpy() for k, v in padded.items()},
            {k: v.numpy() for k, v in packed.items()})


def _batch(workload, layout):
    padded, packed = workload
    if layout == "padded":
        return dict(padded)
    if layout == "packed":
        return dict(packed)
    return dict(packed, attention_mask=packed["loss_mask"])


def _master(cfg_kw, perturb_binary=False):
    model = JBertModel(JBertConfig(**cfg_kw))
    master = model.shard_master(model.init_master(jax.random.PRNGKey(0)), 0)
    master = jax.tree_util.tree_map(np.asarray, master)
    if perturb_binary:
        # JAX starts the binary head at zero, which would leave the
        # pooler's gradient zero: give it weights
        rng = np.random.RandomState(9)
        master["binary_head"]["weight"] = (
            0.1 * rng.randn(2, cfg_kw["hidden_size"])).astype(np.float32)
    return master


def _jax_apply(cfg_kw):
    """A function (params, batch of numpy arrays) -> (per-token losses,
    binary logits) through JAX's ``BertModel.apply``."""
    parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        1, 1, devices=jax.devices()[:1])
    model = JBertModel(JBertConfig(**cfg_kw))

    def run(p, batch):
        def f(p, b):
            return model.apply(
                p, b["tokens"], attention_mask=b.get("attention_mask"),
                tokentype_ids=b.get("tokentype_ids"), lm_labels=b["labels"],
                segment_ids=b.get("segment_ids"),
                position_ids=b.get("position_ids"))
        return shard_map(f, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                         check_vma=False)(p, batch)

    return run


def _port_apply(model, batch):
    t = {k: torch.tensor(v) for k, v in batch.items()}
    return model(t["tokens"], attention_mask=t.get("attention_mask"),
                 tokentype_ids=t.get("tokentype_ids"), lm_labels=t["labels"],
                 segment_ids=t.get("segment_ids"),
                 position_ids=t.get("position_ids"))


def _port_model(cfg_kw, master):
    model = BertModel(BertConfig(**cfg_kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    return model


def _objective(losses, binary, batch, r):
    """The MLM step's loss (mean over real tokens), plus a binary-head
    term when there is one (``r`` [b, 2])."""
    m = batch["loss_mask"].astype(np.float32)
    if torch.is_tensor(losses):
        m = torch.tensor(m)
        out = (losses * m).sum() / m.sum()
        return out if binary is None else out + (binary * torch.tensor(
            r)).sum()
    out = jnp.sum(losses * m) / jnp.sum(m)
    return out if binary is None else out + jnp.sum(binary * r)


def _check_losses_and_grads(cfg_kw, master, batch):
    rng = np.random.RandomState(6)
    r = rng.randn(batch["tokens"].shape[0], 2).astype(np.float32)
    run = _jax_apply(cfg_kw)

    @jax.jit
    def jax_side(p, b):
        def obj(p):
            losses, binary = run(p, b)
            return _objective(losses, binary, b, r), (losses, binary)
        (_, aux), g = jax.value_and_grad(obj, has_aux=True)(p)
        return aux, g

    (jloss, jbin), jgrads = jax_side(
        jax.tree_util.tree_map(jnp.asarray, master),
        {k: jnp.asarray(v) for k, v in batch.items()})
    parallel_state.destroy_model_parallel()

    model = _port_model(cfg_kw, master)
    tloss, tbin = _port_apply(model, batch)
    assert tloss.shape == batch["tokens"].shape
    assert tloss.dtype == torch.float32
    _close(tloss, jloss)
    assert (tbin is None) == (jbin is None)
    if tbin is not None:
        _close(tbin, jbin)
    _objective(tloss, tbin, batch, r).backward()
    got = _flatten(jax_tree_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    ref = _flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name], ref[name])
    return tloss


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bert_losses_and_grads_match_jax(workload, layout):
    _check_losses_and_grads(TOY, _master(TOY), _batch(workload, layout))


def test_bert_with_token_types_and_the_binary_head_matches_jax(workload):
    kw = dict(TOY, num_tokentypes=2, add_binary_head=True, remat=False)
    batch = _batch(workload, "padded")
    batch["tokentype_ids"] = np.random.RandomState(8).randint(
        0, 2, batch["tokens"].shape).astype(np.int32)
    _check_losses_and_grads(kw, _master(kw, perturb_binary=True), batch)


def test_bert_logits_without_labels_match_jax(workload):
    batch = _batch(workload, "folded")
    master = _master(TOY)
    run = _jax_apply(TOY)
    jlogits, _ = run(jax.tree_util.tree_map(jnp.asarray, master),
                     {k: jnp.asarray(v) for k, v in batch.items()
                      if k != "labels"} | {"labels": None})
    parallel_state.destroy_model_parallel()
    model = _port_model(TOY, master)
    t = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, binary = model(t["tokens"], attention_mask=t["attention_mask"],
                               segment_ids=t["segment_ids"],
                               position_ids=t["position_ids"])
    assert binary is None and logits.dtype == torch.float32
    _close(logits, jlogits)


def test_bert_three_step_fused_adam_trajectory_matches_jax(workload):
    lr = 1e-3
    batch = _batch(workload, "packed")
    master = _master(TOY)
    run = _jax_apply(TOY)
    opt = jopt.FusedAdam(lr=lr)

    @jax.jit
    def step(p, o, b):
        def obj(p):
            losses, binary = run(p, b)
            return _objective(losses, binary, b, None)
        loss, g = jax.value_and_grad(obj)(p)
        p, o = opt.step(g, o, p)
        return p, o, loss

    p = jax.tree_util.tree_map(jnp.asarray, master)
    o = opt.init(p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = []
    for _ in range(3):
        p, o, loss = step(p, o, jb)
        ref.append(float(loss))
    parallel_state.destroy_model_parallel()

    model = _port_model(TOY, master)
    topt = FusedAdam(model.parameters(), lr=lr)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    got = [float(bert_large.train_step(model, topt, tb, True))
           for _ in range(3)]
    _close(got, ref)
    assert ref[2] < ref[0]   # the trajectory moves: lr 1e-3, one batch
    # the bar is ten times the largest gap read here (5.8e-5, on
    # dense_4h_to_h.weight): Adam turns rounding-level differences of
    # near-zero gradients into steps of a sizeable fraction of lr.  Three
    # steps at lr 1e-3 move every weight by about 3e-3, so a missed update
    # fails it.
    bar = 6e-4
    init = _flatten(master)
    final = _flatten(jax_tree_from_state_dict(model.state_dict()))
    for name, want in _flatten(jax.tree_util.tree_map(np.asarray,
                                                      p)).items():
        assert np.max(np.abs(final[name] - want)) <= bar, name
        assert np.max(np.abs(want - init[name])) > 4 * bar, name


def test_packed_losses_equal_padded_on_real_tokens(workload):
    model = _port_model(TOY, _master(TOY))
    padded, packed = workload
    with torch.no_grad():
        l_pad, _ = _port_apply(model, padded)
        l_pack, _ = _port_apply(model, packed)
    lens = bert_large.bert_lengths(N_SEQ, SEQ)
    got, want = [], []
    for r, idxs in enumerate(bert_large.bert_pack_rows(lens, SEQ)):
        at = 0
        for i in idxs:
            n = int(lens[i])
            got.append(l_pack[r, at:at + n])
            want.append(l_pad[i, :n])
            at += n
    np.testing.assert_allclose(torch.cat(got).numpy(),
                               torch.cat(want).numpy(), rtol=2e-5, atol=2e-5)


def test_gpt_with_a_causal_key_padding_mask_matches_jax():
    kw = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
              vocab_size=128, max_position_embeddings=16,
              use_flash_attention=True)
    rng = np.random.RandomState(12)
    tokens = rng.randint(0, 128, (3, 16)).astype(np.int32)
    labels = rng.randint(0, 128, (3, 16)).astype(np.int32)
    pad = np.zeros((3, 1, 1, 16), bool)
    pad[0, ..., 11:] = pad[2, ..., 5:] = True     # True = masked key
    jmodel = JGPTModel(JGPTConfig(**kw))
    master = jax.tree_util.tree_map(np.asarray, jmodel.shard_master(
        jmodel.init_master(jax.random.PRNGKey(1)), 0))
    parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        1, 1, devices=jax.devices()[:1])

    def losses(p):
        return shard_map(
            lambda p, t, l, m: jmodel.apply(p, t, labels=l, attention_mask=m),
            mesh=mesh, in_specs=(P(),) * 4, out_specs=P(), check_vma=False)(
            p, jnp.asarray(tokens), jnp.asarray(labels), jnp.asarray(pad))

    @jax.jit
    def losses_and_grads(p):
        loss, vjp = jax.vjp(losses, p)
        return loss, vjp(jnp.ones_like(loss))[0]

    jloss, jgrads = losses_and_grads(jax.tree_util.tree_map(jnp.asarray,
                                                            master))
    parallel_state.destroy_model_parallel()
    model = GPTModel(GPTConfig(**kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    tloss = model(torch.tensor(tokens), labels=torch.tensor(labels),
                  attention_mask=torch.tensor(pad))
    _close(tloss, jloss)
    tloss.sum().backward()
    got = _flatten(jax_tree_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    for name, want in _flatten(jax.tree_util.tree_map(np.asarray,
                                                      jgrads)).items():
        _close(got[name], want)
    # the mask is on: without it the padded rows' losses change
    with torch.no_grad():
        free = model(torch.tensor(tokens), labels=torch.tensor(labels))
    assert not torch.allclose(free[0], tloss[0].detach())


def test_convert_round_trips_the_bert_tree():
    kw = dict(TOY, num_tokentypes=2, add_binary_head=True)
    master = _master(kw)
    sd = state_dict_from_jax(master)
    for name in ("lm_head.dense.weight", "lm_head.layernorm.bias",
                 "lm_head.bias", "pooler.weight", "binary_head.bias",
                 "tokentype_embeddings.weight", "position_embeddings.weight"):
        assert name in sd, name
    model = bert_model_provider(BertConfig(**kw), device="cpu")
    assert sorted(model.state_dict()) == sorted(sd)
    back = _flatten(jax_tree_from_state_dict(sd))
    want = _flatten(master)
    assert sorted(back) == sorted(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)


def _bench_functions(*names, **namespace):
    """``bench.py``'s functions of these names, compiled from its source
    into ``namespace`` (bench.py itself is not imported)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in names]
    consts = [n for n in tree.body if isinstance(n, ast.Assign)
              and any(isinstance(t, ast.Tuple) and any(
                  getattr(e, "id", "") == "BERT_SEQ" for e in t.elts)
                  for t in n.targets)]
    ns = dict(namespace, np=np)
    exec(compile(ast.Module(body=consts + fns, type_ignores=[]), "bench.py",
                 "exec"), ns)
    return ns


def test_workload_is_bench_pys():
    ns = _bench_functions("bert_lengths", "_bert_pack_rows", "_bert_batches",
                          "bert_analytic_flops", jnp=jnp, os=os)
    assert (ns["BERT_L"], ns["BERT_H"], ns["BERT_HEADS"], ns["BERT_V"],
            ns["BERT_SEQ"]) == (bert_large.BERT_L, bert_large.BERT_H,
                                bert_large.BERT_HEADS, bert_large.BERT_V,
                                bert_large.BERT_SEQ)
    np.testing.assert_array_equal(ns["bert_lengths"](40),
                                  bert_large.bert_lengths(40))
    lens = bert_large.bert_lengths(40)
    assert ns["_bert_pack_rows"](lens) == bert_large.bert_pack_rows(lens)
    padded, packed, n_real, seq_sq = ns["_bert_batches"]()
    tp, tk, tn, tsq = bert_large.bert_batches(device="cpu")
    assert (n_real, seq_sq) == (tn, tsq) == (5568, 2123264)
    for want, got in ((padded, tp), (packed, tk)):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    assert tk["tokens"].shape == (13, 512) and tp["tokens"].shape == (16, 512)
    assert ns["bert_analytic_flops"](n_real, seq_sq) == \
        bert_large.bert_analytic_flops(n_real, seq_sq)
    cfg = bert_large.bert_large_config()
    assert (cfg.kv_channels, cfg.remat_policy, cfg.bf16) == (64, "attn_res",
                                                             True)


def _jax_visits(seg_q, seg_k, b, h, s):
    """The non-causal tile walk of the packed tensor-core backward, from
    JAX's ``_segment_block_bounds`` on ids padded to whole tiles (edge
    values: a ragged tile's min and max stay its valid ids')."""
    out = []
    for pass_, (bq, bk) in (("dkdv", (32, 128)), ("dq", (128, 64))):
        def pad(ids, block):
            n = -(-s // block) * block
            return jnp.asarray(np.pad(ids, ((0, 0), (0, n - s)), "edge"))
        lohi_q, lohi_k = jatt._segment_block_bounds(pad(seg_q, bq),
                                                    pad(seg_k, bk), bq, bk)
        r = np.asarray(lohi_k if pass_ == "dkdv" else lohi_q)
        walk = r[..., 1] - r[..., 0]
        out.append(np.repeat(walk, h, axis=0).ravel())
    return np.concatenate(out)


def _fold_ids(fold, b, s, seed):
    """(seg_q, seg_k, pad) of one folding of key padding and packing ids:
    ragged lengths, sorted ids in 0-3 a row."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(40, s, b)
    pad = np.arange(s)[None] >= lens[:, None]
    ids = np.sort(rng.randint(0, 4, (b, s)), 1).astype(np.int32)
    if fold == "key_padding":
        return np.ones((b, s), np.int32), (~pad).astype(np.int32), pad
    if fold == "packed":
        return ids, ids, pad
    return ids, np.where(pad, -1, ids).astype(np.int32), pad


@pytest.mark.parametrize("s", [512, 500])
@pytest.mark.parametrize("fold", ["key_padding", "packed", "packed_padded"])
def test_sm90_visits_want_takes_a_pair(fold, s):
    b, h = 3, 2
    seg_q, seg_k, _ = _fold_ids(fold, b, s, s)
    got = sm90_visits_want((torch.tensor(seg_q), torch.tensor(seg_k)), b, s,
                           False, h)
    np.testing.assert_array_equal(got.numpy(), _jax_visits(seg_q, seg_k, b,
                                                           h, s))


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("fold", ["key_padding", "packed", "packed_padded"])
def test_attention_bound_reads_only_the_kv_rows_some_query_sees(
        monkeypatch, fold, fwd):
    b, h, s, d = 3, 2, 256, 64
    seg_q, seg_k, pad = _fold_ids(fold, b, s, 7)
    seen = seg_q[:, :, None] == seg_k[:, None, :]
    live_q, live_k = seen.any(2).sum() * h, seen.any(1).sum() * h
    if fold != "packed":   # a padded key is never seen
        assert live_k <= (~pad).sum() * h
    got = chip_smoke.live_counts(torch.tensor(seg_q), torch.tensor(seg_k), h)
    assert got == (seen.sum() * h, live_q, live_k)
    monkeypatch.setattr(chip_smoke, "bound",
                        lambda nbytes, flops, dtype: (nbytes, flops))
    rows = b * h * s
    nbytes, flops = chip_smoke.attention_bound(
        torch.bfloat16, d, rows, rows, fwd, *got[1:], got[0], 100)
    if fwd:   # q, k, v live rows in; ctx, lse out
        want = (live_q + 2 * live_k + rows) * d * 2 + rows * 4 + 100
    else:     # q, k, v, ctx, dctx, lse live rows in; dq, dk, dv out
        want = ((3 * live_q + 2 * live_k + 3 * rows) * d * 2 + live_q * 4
                + 100)
    assert (nbytes, flops) == (want, (4 if fwd else 10) * d * got[0])


def test_bert_modules_import_neither_jax_nor_apex_tpu():
    code = ("import sys, apex_tpu_torch.transformer.testing.standalone_bert, "
            "apex_tpu_torch.profiling.bert_large\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apex_tpu', 'bench'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_bert_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertModel(BertConfig(**TOY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_large.bert_batches(2, 32, 128)
