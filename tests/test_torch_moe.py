"""Mixture-of-Experts: the port's ``SwitchMLP`` (``apex_tpu_torch.
transformer.moe``), its expert axis over ``torch.distributed`` and the MoE
GPT against the JAX package's ``apex_tpu.transformer.moe`` and GPT.

The same numpy inputs (a JAX ``init_master`` tree carried by
``transformer.testing.convert``, tokens from a seed) go through both, at
``tests/L0/test_moe.py``'s sizes (H 16, F 32, E 4).  The expert axis runs
in four gloo ranks (rank bodies in ``tests/torch_ranks.py``, one launch
for the module): ep 4 over all four and ep 2 over the pairs [0, 1] and
[2, 3], each rank on its own 8 tokens, held to JAX's ``shard_map`` over
``"expert"`` on the emulated mesh and to one device; bench.py's tp 2 x
ep 2 leg held to JAX's; and every public collective of ``parallel.comm``
naming itself in ``comm.STATS.by_op``.

Routing is discontinuous, so every comparison first asserts that the
expert ids agree (a tie shows as a tie, not as a tolerance miss).
Tolerances: fp32 1e-5 x max(1, max|ref|) on outputs, aux and every
gradient (sums in another order); the expert ranks' aux bitwise equal to
each other; capacity overflow exactly zero.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.moe import MoEConfig as JMoEConfig
from apex_tpu.transformer.moe import SwitchMLP as JSwitchMLP
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer import moe as tmoe
from apex_tpu_torch.transformer.testing import (GPTConfig, GPTModel,
                                                make_gpt_stage_fns)
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, expert_state_dict_from_jax, jax_tree_from_expert_ranks,
    jax_tree_from_state_dict, nest, state_dict_from_jax)

import torch_ranks

TOL = 1e-5
H, F, E = 16, 32, 4
WORLD, N_TOK = 4, 8
CFS = (8.0, 1.25)       # ample capacity; 1.25 drops tokens at ep 4
TOY = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
           vocab_size=64, max_position_embeddings=16, num_experts=4,
           moe_capacity_factor=1.25)
B, S = 2, 16


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bar = tol * max(1.0, float(np.max(np.abs(ref))) if ref.size else 0.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= bar, (err, bar)


def _jmoe(cf=8.0):
    return JSwitchMLP(JMoEConfig(hidden_size=H, ffn_hidden_size=F,
                                 num_experts=E, capacity_factor=cf))


@pytest.fixture(scope="module")
def master():
    tree = _jmoe().init_master(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(master, cf=8.0, group=None, rank=0, world=1):
    m = tmoe.SwitchMLP(tmoe.MoEConfig(hidden_size=H, ffn_hidden_size=F,
                                      num_experts=E, capacity_factor=cf),
                       group=group, device="cpu")
    m.load_state_dict(expert_state_dict_from_jax(master, rank, world))
    return m


def _jax_ids(master, h):
    logits = jnp.asarray(h) @ master["gate"]["weight"]
    return np.asarray(jnp.argmax(jax.nn.softmax(logits, -1), -1))


def _tokens(n, seed=1):
    return np.random.RandomState(seed).randn(n, H).astype(np.float32)


# -- one device --------------------------------------------------------------

@pytest.mark.parametrize("cf", CFS)
def test_switch_mlp_matches_jax(master, cf):
    h = _tokens(24)
    jout, jaux = _jmoe(cf).apply(master, jnp.asarray(h))
    m = _port(master, cf)
    out, aux = m(torch.tensor(h))
    assert np.array_equal(m.route(torch.tensor(h))[0].numpy(),
                          _jax_ids(master, h))
    assert m.capacity(24) == _jmoe(cf).capacity(24)
    _close(out.detach(), jout)
    _close(aux.detach(), jaux)


def test_capacity_one_overflow_gives_exact_zeros(master):
    cf = E / 24.0                       # C = 1 for 24 tokens
    h = _tokens(24)
    m = _port(master, cf)
    assert m.capacity(24) == 1
    out = m(torch.tensor(h))[0].detach().numpy()
    jout = np.asarray(_jmoe(cf).apply(master, jnp.asarray(h))[0])
    dropped = np.all(jout == 0, axis=-1)
    assert dropped.sum() >= 24 - E
    assert np.array_equal(np.all(out == 0, axis=-1), dropped)
    assert np.all(out[dropped] == 0.0)
    _close(out, jout)


@pytest.mark.parametrize("cf", CFS)
def test_switch_mlp_gradients_match_jax(master, cf):
    h = _tokens(16, seed=2)

    def loss(p, h):
        out, aux = _jmoe(cf).apply(p, h)
        return jnp.sum(out ** 2) + 0.01 * aux

    jg, jdh = jax.grad(loss, argnums=(0, 1))(master, jnp.asarray(h))
    m = _port(master, cf)
    th = torch.tensor(h, requires_grad=True)
    out, aux = m(th)
    (out.pow(2).sum() + 0.01 * aux).backward()
    _close(th.grad, jdh)
    got = {k: p.grad for k, p in m.named_parameters()}
    ref = _flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name], ref[name])
    assert float(got["gate.weight"].abs().max()) > 0


# -- the MoE GPT --------------------------------------------------------------

@pytest.fixture(scope="module")
def gpt_master():
    model = JGPTModel(JGPTConfig(**TOY))
    tree = model.shard_master(model.init_master(jax.random.PRNGKey(0)), 0)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, TOY["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.randint(0, TOY["vocab_size"], (B, S)).astype(np.int32)
    yield jax.tree_util.tree_map(np.asarray, tree), tokens, labels
    jps.destroy_model_parallel()


def _jax_gpt(cfg_kw, master, tokens, labels):
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(1, 1, devices=jax.devices()[:1])
    model = JGPTModel(JGPTConfig(**cfg_kw))

    def mean(p):
        per_token = shard_map(
            lambda p, t, l: model.apply(p, t, labels=l), mesh=mesh,
            in_specs=(P(), P(), P()), out_specs=P(), check_vma=False)(
            p, jnp.asarray(tokens), jnp.asarray(labels))
        return jnp.mean(per_token), per_token

    try:
        (_, per_token), g = jax.jit(jax.value_and_grad(mean, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, master))
    finally:
        jps.destroy_model_parallel()
    return np.asarray(per_token), _flatten(
        jax.tree_util.tree_map(np.asarray, g))


@pytest.mark.parametrize("over", [
    dict(use_flash_attention=False),
    dict(use_flash_attention=True, remat=True, remat_policy="attn_res"),
], ids=["softmax", "flash_remat"])
def test_moe_gpt_losses_and_grads_match_jax(gpt_master, over):
    master, tokens, labels = gpt_master
    cfg_kw = dict(TOY, **over)
    jloss, jgrads = _jax_gpt(cfg_kw, master, tokens, labels)
    model = GPTModel(GPTConfig(**cfg_kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    # the first layer's routing, as both models see its input
    tt = torch.tensor(tokens)
    with torch.no_grad():
        layer = model.transformer.layers[0]
        h = model.embed(tt)
        h = h + layer.attention(layer.input_layernorm(h))
        ln2 = layer.post_attention_layernorm(h).reshape(B * S, -1)
    g0 = master["transformer"]["layers"]["mlp"]["gate"]["weight"][0]
    jids = np.asarray(jnp.argmax(jnp.asarray(ln2.numpy()) @ g0, -1))
    assert np.array_equal(layer.mlp.route(ln2)[0].numpy(), jids)
    tloss = model(tt, labels=torch.tensor(labels))
    assert tloss.shape == (B, S) and tloss.dtype == torch.float32
    _close(tloss.detach(), jloss)
    tloss.mean().backward()
    got = _flatten(jax_tree_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    assert sorted(got) == sorted(jgrads)
    for name in jgrads:
        _close(got[name], jgrads[name])


@pytest.mark.parametrize("policy", ["full", "dots", "attn_res",
                                    "attn_res_mlp", "attn_out"])
def test_moe_gpt_remat_policies_equal_no_remat(gpt_master, policy):
    """The layers' aux summed through the checkpoint under every remat
    policy: losses and every gradient bitwise those without remat."""
    master, tokens, labels = gpt_master
    runs = []
    for over in (dict(remat=False), dict(remat=True, remat_policy=policy)):
        model = GPTModel(GPTConfig(**dict(TOY, use_flash_attention=True,
                                          **over)), device="cpu")
        model.load_state_dict(state_dict_from_jax(master))
        loss = model(torch.tensor(tokens), labels=torch.tensor(labels))
        loss.mean().backward()
        runs.append((loss.detach(), {k: p.grad for k, p in
                                     model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_moe_gpt_bf16_fused_head_adds_the_aux_term(gpt_master):
    """At bf16 and tp 1 the loss is the fused LM-head cross entropy; every
    token's loss carries moe_aux_loss_coeff x the layers' summed aux."""
    from apex_tpu_torch.ops import fused_linear_cross_entropy

    master, tokens, labels = gpt_master
    cfg = GPTConfig(**dict(TOY, bf16=True, moe_aux_loss_coeff=0.5))
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(master))
    tt, tl = torch.tensor(tokens), torch.tensor(labels)
    with torch.no_grad():
        losses = model(tt, labels=tl)
        h, aux = model.transformer(model.embed(tt))
        hn = model.final_layernorm(h)
        ce = fused_linear_cross_entropy(hn.reshape(B * S, -1),
                                        model.embedding.weight,
                                        tl.reshape(B * S)).reshape(B, S)
    assert losses.dtype == torch.float32 and aux.dtype == torch.float32
    assert float(aux) > 0
    assert torch.equal(losses, ce + 0.5 * aux)


def test_moe_gpt_convert_and_pipeline_warning(gpt_master):
    """The MoE leaves carried both ways in JAX's stacked layout, whole and
    cut for each expert rank; a pipeline split warns as JAX's does and
    drops the aux at the stage boundary."""
    master, tokens, _ = gpt_master
    back = _flatten(jax_tree_from_state_dict(state_dict_from_jax(master)))
    ref = _flatten(master)
    assert sorted(back) == sorted(ref)
    assert "transformer.layers.mlp.experts.w1" in ref
    for k in ref:
        assert np.array_equal(back[k], ref[k])
    for world in (2, 4):
        sds = [expert_state_dict_from_jax(master, r, world)
               for r in range(world)]
        w1 = "transformer.layers.1.mlp.experts.w1"
        assert sds[1][w1].shape == (E // world, 32, 128)
        assert torch.equal(sds[1][w1], torch.tensor(
            ref["transformer.layers.mlp.experts.w1"][1][
                E // world:2 * E // world]))
        whole = _flatten(jax_tree_from_expert_ranks(sds))
        for k in ref:
            assert np.array_equal(whole[k], ref[k])
    with pytest.warns(UserWarning, match="drops the load-balancing aux"):
        stage_fn, _ = make_gpt_stage_fns(GPTConfig(**TOY), 2)
    stage = GPTModel(GPTConfig(**TOY), 1, device="cpu", post_process=False)
    h = stage_fn(stage, None, {"tokens": torch.tensor(tokens)})
    assert isinstance(h, torch.Tensor) and h.shape == (B, S, TOY[
        "hidden_size"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_gpt_stage_fns(GPTConfig(**dict(TOY, num_experts=0)), 2)


# -- the expert axis over gloo ranks -----------------------------------------

def _tp_ep_case():
    """bench.py:1444-1502's leg at its sizes (H 16, T 32, E 4, cf 8)."""
    kk = jax.random.split(jax.random.PRNGKey(0), 4)
    moe = JSwitchMLP(JMoEConfig(hidden_size=H, ffn_hidden_size=2 * H,
                                num_experts=4, capacity_factor=8.0))
    return dict(
        cfg=dict(hidden_size=H, ffn_hidden_size=2 * H, num_experts=4),
        cf=8.0, col_w=np.asarray(jax.random.normal(kk[0], (H, 2 * H)) * 0.1),
        row_w=np.asarray(jax.random.normal(kk[1], (2 * H, H)) * 0.1),
        master=_flatten(jax.tree_util.tree_map(
            np.asarray, moe.init_master(kk[2]))),
        h=np.asarray(jax.random.normal(kk[3], (32, H))))


@pytest.fixture(scope="module")
def ranks(master, tmp_path_factory):
    out = tmp_path_factory.mktemp("moe")
    case = dict(cfg=dict(hidden_size=H, ffn_hidden_size=F, num_experts=E),
                master=_flatten(master), h=_tokens(WORLD * N_TOK, seed=5),
                tokens_per_rank=N_TOK, cfs=CFS, tp_ep=_tp_ep_case())
    spawn(torch_ranks.moe_checks, WORLD, str(out / "store"), str(out), case)
    return case, torch_ranks.load_ranks(str(out), WORLD)


def _jax_ep(master, h, world, cf):
    """JAX's SwitchMLP under shard_map over ``world`` expert ranks, each on
    its dim-0 block of ``h``: per rank (out, aux, dh, grads)."""
    moe = _jmoe(cf)
    mesh = Mesh(np.array(jax.devices()[:world]), ("expert",))
    shards = [moe.shard_master(master, r, world) for r in range(world)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *shards)

    def run(p, ht):
        p = jax.tree_util.tree_map(lambda a: a[0], p)

        def loss(p, ht):
            out, aux = moe.apply(p, ht, axis_name="expert")
            return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

        (_, (out, aux)), (g, dh) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, ht)
        return out, aux[None], dh, jax.tree_util.tree_map(
            lambda a: a[None], g)

    out, aux, dh, g = jax.jit(shard_map(
        run, mesh=mesh, in_specs=(P("expert"), P("expert")),
        out_specs=(P("expert"), P("expert"), P("expert"), P("expert")),
        check_vma=False))(stacked, jnp.asarray(h))
    n = h.shape[0] // world
    g = _flatten(jax.tree_util.tree_map(np.asarray, g))
    return [dict(out=np.asarray(out)[r * n:(r + 1) * n],
                 aux=np.asarray(aux)[r], dh=np.asarray(dh)[r * n:(r + 1) * n],
                 grads={k: v[r] for k, v in g.items()})
            for r in range(world)]


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("ep", [4, 2])
def test_expert_parallel_matches_jax_and_one_device(ranks, master, ep, cf):
    case, runs = ranks
    h = case["h"]
    for g0 in range(0, WORLD, ep):         # each expert group's ranks
        hg = h[g0 * N_TOK:(g0 + ep) * N_TOK]
        ref = _jax_ep(master, hg, ep, cf)
        got = [runs[g0 + r][(f"ep{ep}", cf)] for r in range(ep)]
        for r, (a, b) in enumerate(zip(got, ref)):
            assert np.array_equal(a["expert"].numpy(),
                                  _jax_ids(master, hg[r * N_TOK:(r + 1)
                                                      * N_TOK]))
            _close(a["out"], b["out"])
            _close(a["aux"], b["aux"])
            _close(a["dh"], b["dh"])
            assert sorted(a["grads"]) == sorted(b["grads"])
            for k in b["grads"]:
                _close(a["grads"][k], b["grads"][k])
        # every rank adds the same aux, bit for bit
        assert all(torch.equal(a["aux"], got[0]["aux"]) for a in got)
        # one device: the same tokens through the one-rank module; with
        # ample capacity every token is kept there too
        one, aux1 = _port(master, cf)(torch.tensor(hg))
        _close(aux1.detach(), got[0]["aux"])
        if cf == 8.0:
            _close(torch.cat([a["out"] for a in got]), one.detach())


def test_tp_ep_leg_matches_jax(ranks):
    """bench.py's composition at tp 2 x ep 2 against JAX's ``shard_map``
    over ("tensor", "expert"): the loss, and each rank's gradients.  The
    port's are the true gradients of its rank's sum(out^2) and 0.01 aux
    (the tensor regions; the all-to-all and the group mean their own
    transposes).  JAX's transposes its psums into sums: ``psum(sum(out^2),
    ("tensor", "expert")) / tp`` gives each rank's sum(out^2) the
    cotangent ep, and ``psum(a @ row_w, "tensor")`` sums the tp ranks'
    cotangents into the dense block.  So JAX's gradient is ep x the
    port's sum(out^2) term + its aux term on the MoE's leaves, and tp x
    that on ``col_w`` and ``row_w``."""
    case, runs = ranks
    c = case["tp_ep"]
    tp = ep = 2
    moe = JSwitchMLP(JMoEConfig(**c["cfg"], capacity_factor=c["cf"]))
    H_ = c["cfg"]["hidden_size"]
    col_w, row_w = jnp.asarray(c["col_w"]), jnp.asarray(c["row_w"])
    mm = jax.tree_util.tree_map(jnp.asarray, nest(c["master"]))

    def rank_params(t, e):
        return {"col_w": col_w.reshape(H_, tp, 2 * H_ // tp)[:, t],
                "row_w": row_w.reshape(tp, 2 * H_ // tp, H_)[t],
                "moe": moe.shard_master(mm, e, ep)}

    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jax.tree_util.tree_map(lambda *ys: jnp.stack(ys),
                                 *[rank_params(t, e) for e in range(ep)])
          for t in range(tp)])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(tp, ep),
                ("tensor", "expert"))

    def inner(p, h):
        p = jax.tree_util.tree_map(lambda a: a[0, 0], p)

        def loss(p):
            a = jax.nn.gelu(h @ p["col_w"])
            y = jax.lax.psum(a @ p["row_w"], "tensor")
            out_, aux = moe.apply(p["moe"], y, axis_name="expert")
            return (jax.lax.psum(jnp.sum(out_ ** 2), ("tensor", "expert"))
                    / tp + 0.01 * aux)

        l, g = jax.value_and_grad(loss)(p)
        return l, jax.tree_util.tree_map(lambda a: a[None, None], g)

    jl, jg = jax.jit(shard_map(
        inner, mesh=mesh, in_specs=(P("tensor", "expert"), P()),
        out_specs=(P(), P("tensor", "expert")), check_vma=False))(
        stacked, jnp.asarray(c["h"]))
    jg = _flatten(jax.tree_util.tree_map(np.asarray, jg))
    for rank, run in enumerate(runs):
        t, e = rank // ep, rank % ep
        res = run["tp_ep"]
        _close(res["loss"], jl)
        assert sorted(res["grads_sq"]) == sorted(jg)
        for name, sq in res["grads_sq"].items():
            got = ep * sq + res["grads_aux"][name]
            if not name.startswith("moe."):
                got = tp * got
            _close(got, jg[name][t, e])
        assert float(res["grads_sq"]["moe.experts.w1"].abs().max()) > 0


@pytest.mark.parametrize("name", [
    "all_reduce", "all_gather", "all_gather_tiled", "reduce_scatter",
    "all_to_all", "broadcast", "gather", "exchange", "send_recv"])
def test_every_collective_names_itself(ranks, name):
    want = {"all_gather_tiled": {"all_gather": 1},
            "exchange": {"send": 1, "recv": 1},
            "send_recv": {"send": 1, "recv": 1}}.get(name, {name: 1})
    for rank, run in enumerate(ranks[1]):
        by_op, calls = run["collectives"][name]
        assert by_op == want, (rank, by_op)
        assert sum(by_op.values()) == calls
