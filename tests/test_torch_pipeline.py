"""Pipeline-parallel training: the port's schedules, transfers,
build_model and utilities against the JAX package's.

The port's stages are processes: four gloo ranks on a ``file://`` store
(rank bodies in ``tests/torch_ranks.py``, one launch for the module) run
the p2p wrappers at pipeline sizes 4 and 2, the toy stages of
``tests/L0/test_pipeline_parallel.py`` through 1F1B at pp 4 and through
the interleaved schedule at pp 4 x vpp 2, ``build_model``, and a toy GPT
at pp 2 and at tp 2 x pp 2 from a JAX master cut with
``convert.stage_state_dict_from_jax``.  JAX runs the same schedules under
``shard_map`` on the emulated 8-device mesh; its model-parallel state is
destroyed after each use.

The port's tp 2 x pp 2 is held to JAX's pp 2 at tp 1 (its gradients
assembled from the tp shards, its trajectory), as the tensor-parallel
tests hold tp 2 to JAX at tp 1 (``tests/test_torch_parallel_gpt.py``):
JAX's own tp 2 pipeline gives its loss but not its tp 1 gradients.

Tolerances: fp32 losses 1e-5 x max(1, |ref|), gradients and parameters
1e-5 x max(1, max|ref|) (sums in another order: the port seeds each
microbatch's backward with 1/m and accumulates in fp32 as JAX does, but
runs eager products); the transfers bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import optimizers as jopt
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer import pipeline_parallel as jpp
from apex_tpu.transformer.pipeline_parallel import build_model as jbm
from apex_tpu.transformer.pipeline_parallel import p2p_communication as jp2p
from apex_tpu.transformer.pipeline_parallel import utils as jutils
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu.transformer.testing import make_gpt_stage_fns as jstage_fns
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer import pipeline_parallel as tpp
from apex_tpu_torch.transformer.pipeline_parallel import schedules
from apex_tpu_torch.transformer.testing import global_vars
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, jax_tree_from_state_dict, stage_state_dict)

import torch_ranks

TOL = 1e-5
WORLD = 4
PP, N_MICRO, MB, HIDDEN = 4, 8, 2, 8
VPP = 2
PEAK_MS = (4, 16, 32)
GPT_CFG = dict(num_layers=4, hidden_size=32, num_attention_heads=4,
               vocab_size=64, max_position_embeddings=16,
               use_flash_attention=True)
GPT_MICRO, GPT_MBS, SEQ, LR, STEPS = 4, 2, 16, 1e-3, 3
#: leaves every tp rank holds whole
REPLICATED = ("layernorm", "position_embeddings", "proj.bias",
              "dense_4h_to_h.bias")


def close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _toy():
    """The JAX tests' toy: stage weights, interleaved chunk weights, data."""
    keys = jax.random.split(jax.random.PRNGKey(0), PP)
    w = np.stack([np.asarray(jax.random.normal(k, (HIDDEN, HIDDEN))) * 0.3
                  for k in keys])
    # a bias away from zero, so its gradient says something
    b = np.random.RandomState(4).randn(PP, HIDDEN).astype(np.float32) * 0.1
    vkeys = jax.random.split(jax.random.PRNGKey(0), PP * VPP)
    full_w = np.stack([np.asarray(jax.random.normal(k, (HIDDEN, HIDDEN)))
                       * 0.2 for k in vkeys])
    data = {"x": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                              (N_MICRO, MB, HIDDEN))),
            "y": np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                              (N_MICRO, MB, HIDDEN)))}
    return w.astype(np.float32), b, full_w.astype(np.float32), data


def _gpt_master():
    master = JGPTModel(JGPTConfig(**GPT_CFG)).init_master(
        jax.random.PRNGKey(0))
    stacked = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[JGPTModel(JGPTConfig(**GPT_CFG, tp_size=2)).shard_master(master, r)
          for r in range(2)])
    return jax.tree_util.tree_map(np.asarray, master), stacked


def _gpt_batch():
    r = np.random.RandomState(6)
    tokens = r.randint(0, 64, (GPT_MICRO, GPT_MBS, SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=-1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    w, b, full_w, data = _toy()
    master, stacked = _gpt_master()
    tokens, labels = _gpt_batch()
    rs = np.random.RandomState(8)
    case = dict(toy_w=w, toy_b=b, toy_full_w=full_w, toy_data=data,
                toy_shape=(MB, HIDDEN), n_toy=N_MICRO, peak_ms=PEAK_MS,
                p2p_x=rs.randn(WORLD, 3, 5).astype(np.float32),
                p2p_g=rs.randn(WORLD, 3, 5).astype(np.float32),
                gpt_cfg=GPT_CFG, gpt_master=master, gpt_stacked=stacked,
                tokens=tokens, labels=labels, mbs=GPT_MBS, seq=SEQ,
                n_micro=GPT_MICRO, lr=LR, steps=STEPS)
    spawn(torch_ranks.pipeline_checks, WORLD, str(out / "store"), str(out),
          case)
    return case, torch_ranks.load_ranks(str(out), WORLD)


# -- the transfers -------------------------------------------------------------

def _jax_ring(x, shift):
    """JAX's p2p over a pipeline of len(x) stages: stage s's value after
    ``send_recv_next`` (shift 1) or ``send_recv_prev`` (shift -1)."""
    n = len(x)
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(1, n, devices=jax.devices()[:n])
    try:
        fn = jp2p.send_recv_next if shift == 1 else jp2p.send_recv_prev
        got = shard_map(lambda a: fn(a[0])[None], mesh=mesh,
                        in_specs=P("pipeline"), out_specs=P("pipeline"),
                        check_vma=False)(jnp.asarray(x))
        return np.asarray(got)
    finally:
        jps.destroy_model_parallel()


@pytest.mark.parametrize("pp", [4, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_p2p_wrappers_against_jax_ring(ranks, pp, dtype):
    """Every wrapper receives, bit for bit, what JAX's ring permutation
    delivers between real neighbours, and None across the wrap (the first
    stage takes no activation, the last no gradient); each message counts
    one call and its bytes."""
    case, res = ranks
    members = range(pp)           # pipeline group of global rank 0
    x = np.stack([case["p2p_x"][r] for r in members])
    g = np.stack([case["p2p_g"][r] for r in members])
    nxt, prv = _jax_ring(x, 1), _jax_ring(g, -1)
    key = f"p2p{pp}_{dtype}"
    for s in members:
        got, stats = res[s][key]
        fwd = [got["recv_forward"], got["send_backward_recv_forward"],
               got["send_forward_recv_forward"]]
        bwd = [got["recv_backward"], got["send_forward_recv_backward"],
               got["send_backward_recv_backward"]]
        for t in fwd:
            if s == 0:
                assert t is None
            else:
                assert t.dtype == dtype
                want = torch.from_numpy(nxt[s]).to(dtype)
                assert torch.equal(t, want)
        for t in bwd:
            if s == pp - 1:
                assert t is None
            else:
                assert torch.equal(t, torch.from_numpy(prv[s]).to(dtype))
        # sends: forward 3 unless last, backward 3 unless first; the
        # receives the same counts, mirrored
        n = 3 * (s != pp - 1) + 3 * (s != 0)
        assert stats["calls"] == 2 * n
        assert stats["bytes"] == 2 * n * 15 * dtype.itemsize


# -- the schedules against JAX's -------------------------------------------------

@pytest.fixture()
def pp_mesh():
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(1, PP)
    yield mesh
    jps.destroy_model_parallel()


def _jax_1f1b(mesh, w, b, data, forward_only):
    def stage_fn(p, h, mb):
        s = jps.get_pipeline_model_parallel_rank()
        inp = jnp.where(s == 0, mb["x"], h)
        return jnp.tanh(inp @ p["w"][0] + p["b"][0])

    def loss_fn(p, y, mb):
        return jnp.mean((y - mb["y"]) ** 2)

    def run(p, d):
        return jpp.forward_backward_pipelining_without_interleaving(
            stage_fn, loss_fn, p, d, n_microbatches=N_MICRO,
            tensor_shape=(MB, HIDDEN), forward_only=forward_only)

    return shard_map(run, mesh=mesh, in_specs=(P("pipeline"), P()),
                     out_specs=P() if forward_only else (P(), P("pipeline")),
                     check_vma=False)({"w": w, "b": b}, data)


def test_1f1b_against_jax(ranks, pp_mesh):
    """1F1B at pp 4: the loss on every stage and each stage's gradients are
    JAX's; forward-only gives the same loss."""
    case, res = ranks
    w, b, data = case["toy_w"], case["toy_b"], case["toy_data"]
    loss, grads = _jax_1f1b(pp_mesh, w, b, data, False)
    (floss,) = _jax_1f1b(pp_mesh, w, b, data, True)
    close(floss, loss)
    for s in range(PP):
        got_loss, (gw, gb) = res[s]["1f1b"]
        close(got_loss, loss)
        close(gw, grads["w"][s])
        close(gb, grads["b"][s])
        assert gw.dtype == torch.float32
        close(res[s]["1f1b_fwd"][0], floss)


def test_interleaved_against_jax(ranks, pp_mesh):
    """The interleaved schedule at pp 4 x vpp 2: device d's chunk k is
    virtual stage d + 4k; its loss and gradients are JAX's."""
    case, res = ranks
    full_w, data = case["toy_full_w"], case["toy_data"]
    chunked = {"w": np.stack([np.stack([full_w[d + PP * k]
                                        for k in range(VPP)])
                              for d in range(PP)])}

    def chunk_fn(p, h, mb, k):
        s = jps.get_pipeline_model_parallel_rank()
        return jnp.tanh(jnp.where((s == 0) & (k == 0), mb["x"], h) @ p["w"])

    def loss_fn(p, y, mb):
        return jnp.mean((y - mb["y"]) ** 2)

    def run(p, d, forward_only):
        p = jax.tree_util.tree_map(lambda a: a[0], p)
        return jpp.forward_backward_pipelining_with_interleaving(
            chunk_fn, loss_fn, p, d, n_microbatches=N_MICRO,
            num_model_chunks=VPP, tensor_shape=(MB, HIDDEN),
            forward_only=forward_only)

    loss, grads = shard_map(
        lambda p, d: run(p, d, False), mesh=pp_mesh,
        in_specs=(P("pipeline"), P()), out_specs=(P(), P("pipeline")),
        check_vma=False)(chunked, data)
    (floss,) = shard_map(lambda p, d: run(p, d, True), mesh=pp_mesh,
                         in_specs=(P("pipeline"), P()), out_specs=P(),
                         check_vma=False)(chunked, data)
    close(floss, loss)
    for d in range(PP):
        got_loss, got = res[d]["vpp"]
        close(got_loss, loss)
        close(res[d]["vpp_fwd"][0], floss)
        for k in range(VPP):
            close(got[k][0], grads["w"][d * VPP + k])


@pytest.mark.parametrize("which", ["1f1b", "vpp"])
def test_saved_inputs_flat_in_microbatches(ranks, which):
    """A stage holds at most 2(V-1-v)+1 saved inputs (fewer when there
    are fewer microbatches): the same count at 16 and 32 microbatches,
    for each virtual stage v (JAX pins the same bound with its
    compiled memory, ``TestOneFOneBMemory``)."""
    _, res = ranks
    chunks = 1 if which == "1f1b" else VPP
    V = PP * chunks
    for d in range(PP):
        peaks = res[d][f"{which}_peaks"]
        for k in range(chunks):
            bound = 2 * (V - 1 - (d + PP * k)) + 1
            for m in PEAK_MS:
                assert peaks[m][k] == min(m, bound), (d, k, m, peaks)
            assert peaks[16][k] == peaks[32][k]


def test_no_pipelining_both_conventions_against_jax(pp_mesh):
    """``forward_backward_no_pipelining`` in its simple and its
    schedule-compatible convention, and forward-only: JAX's loss and
    gradients (averaged over the microbatches)."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                     (HIDDEN, HIDDEN))) * 0.3
    _, _, _, data = _toy()
    td = {k: torch.from_numpy(v) for k, v in data.items()}

    def fwd(p, mb):
        return jnp.mean((jnp.tanh(mb["x"] @ p["w"]) - mb["y"]) ** 2)

    def stage_fn(p, h, mb):
        return jnp.tanh(mb["x"] @ p["w"])

    def loss_fn(p, y, mb):
        return jnp.mean((y - mb["y"]) ** 2)

    jloss, jg = jpp.forward_backward_no_pipelining(
        fwd, params={"w": w}, microbatches=data, n_microbatches=N_MICRO)
    jloss2, jg2 = jpp.forward_backward_no_pipelining(
        stage_fn, loss_fn, {"w": w}, data, n_microbatches=N_MICRO,
        tensor_shape=(MB, HIDDEN))
    (jf,) = jpp.forward_backward_no_pipelining(
        fwd, params={"w": w}, microbatches=data, n_microbatches=N_MICRO,
        forward_only=True)

    stage = torch_ranks._Toy(w.astype(np.float32))

    def tfwd(st, mb):
        return ((st(mb["x"]) - mb["y"]) ** 2).mean()

    def tstage(st, h, mb):
        assert h.shape == (MB, HIDDEN) and not h.any()
        return st(mb["x"])

    loss, (g,) = tpp.forward_backward_no_pipelining(
        tfwd, params=stage, microbatches=td, n_microbatches=N_MICRO)
    loss2, (g2,) = tpp.forward_backward_no_pipelining(
        tstage, torch_ranks._toy_loss_fn, stage, td,
        n_microbatches=N_MICRO, tensor_shape=(MB, HIDDEN))
    (f,) = tpp.forward_backward_no_pipelining(
        tfwd, params=stage, microbatches=td, n_microbatches=N_MICRO,
        forward_only=True)
    loss3, (g3,) = tpp.forward_backward_no_pipelining(
        tfwd, params=stage, microbatches=td, n_microbatches=N_MICRO,
        remat=True)
    for got, want in ((loss, jloss), (loss2, jloss2), (f, jf),
                      (g, jg["w"]), (g2, jg2["w"]), (loss3, jloss)):
        close(got, want)
    assert torch.equal(g3, g)
    # the single-rank schedules run without a process group: 1F1B on one
    # stage is the no-pipelining step
    l1, (gw1,) = tpp.forward_backward_pipelining_without_interleaving(
        tstage, torch_ranks._toy_loss_fn, stage, td, n_microbatches=N_MICRO,
        tensor_shape=(MB, HIDDEN))
    close(l1, jloss2)
    close(gw1, jg2["w"])


def test_selector():
    assert tpp.get_forward_backward_func(None, 1) \
        is tpp.forward_backward_no_pipelining
    assert tpp.get_forward_backward_func(None, 4) \
        is tpp.forward_backward_pipelining_without_interleaving
    assert tpp.get_forward_backward_func(2, 4) \
        is tpp.forward_backward_pipelining_with_interleaving


def test_exports_match_jax():
    """The package exports every name the JAX package's does, and the p2p
    wrappers and build_model beside them."""
    missing = [n for n in dir(jpp) if not n.startswith("_")
               and not hasattr(tpp, n)
               and n not in ("microbatches", "schedules", "utils",
                             "p2p_communication", "build_model")]
    assert not missing, missing
    for name in ("send_forward", "recv_backward", "build_model",
                 "send_backward_recv_backward", "get_autoresume"):
        assert callable(getattr(tpp, name))


# -- build_model ---------------------------------------------------------------

def test_build_model_flags_by_rank(ranks):
    """One chunk a rank without interleaving, two with: ``pre_process``
    only on rank 0's first chunk and ``post_process`` only on the last
    rank's last chunk (the rank's real place; JAX, one program for every
    stage, sets them on every chunk that could sit at an end), the
    virtual cursor set around each call and back at 0, each chunk in a
    DistributedDataParallel when asked."""
    _, res = ranks
    for r in range(PP):
        assert res[r]["build_pp4"] == [(r == 0, r == PP - 1, "m", 0)]
        flags, kinds, cursor = res[r]["build_vpp"]
        assert flags == [(r == 0 and v == 0, r == PP - 1 and v == 1, "v", v)
                         for v in range(VPP)]
        assert kinds == ["DistributedDataParallel"] * VPP and cursor == 0


class _Chunk:
    def __init__(self, pre_process, post_process, tag):
        self.pre_process, self.post_process, self.tag = (
            pre_process, post_process, tag)


def _provider(pre_process=False, post_process=False, tag="x"):
    return _Chunk(pre_process, post_process, tag)


def test_build_model_single_rank_mirrors_jax():
    """tests/L0/test_build_model.py at pp 1: one chunk, both flags, the
    provider's keywords passed, the DDP wrap optional; JAX's flags
    equal."""
    parallel_state.initialize_model_parallel(1, 1)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1, 1)
    try:
        m = tpp.build_model(_provider, tag="m")
        j = jbm.build_model(_provider, tag="m")
        assert len(m) == len(j) == 1
        assert (m[0].pre_process, m[0].post_process, m[0].tag) == (
            j[0].pre_process, j[0].post_process, j[0].tag) == (
            True, True, "m")
        assert m[0].module.tag == "m"
        bare = tpp.build_model(_provider, wrap_with_ddp=False)
        assert isinstance(bare[0], _Chunk)
    finally:
        parallel_state.destroy_model_parallel()
        jps.destroy_model_parallel()


# -- the GPT stages ------------------------------------------------------------

def _jax_gpt_pp(tp, master, tokens, labels, steps):
    """JAX's toy GPT at tp x pp 2 through make_gpt_stage_fns and its 1F1B:
    per step the loss, the step-1 gradients and the parameters after each
    step (leaves flat, leading axes [pp, tp])."""
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(tp, 2, devices=jax.devices()[:2 * tp])
    try:
        cfg = JGPTConfig(**GPT_CFG, tp_size=tp)
        stage_fn, loss_fn = jstage_fns(cfg, 2)
        per = cfg.num_layers // 2

        def stage_params(s, r):
            m = {**master, "transformer": {"layers": jax.tree_util.tree_map(
                lambda a: a[s * per:(s + 1) * per],
                master["transformer"]["layers"])}}
            return JGPTModel(cfg, num_layers=per).shard_master(m, r)

        p = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs),
            *[jax.tree_util.tree_map(lambda *ys: jnp.stack(ys),
                                     *[stage_params(s, r) for r in range(tp)])
              for s in range(2)])
        mb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}

        @jax.jit
        def grads_fn(p, mb):
            def run(p, mb):
                pl = jax.tree_util.tree_map(lambda a: a[0, 0], p)
                loss, g = jpp.forward_backward_pipelining_without_interleaving(
                    stage_fn, loss_fn, pl, mb, n_microbatches=GPT_MICRO,
                    tensor_shape=(GPT_MBS, SEQ, cfg.hidden_size))
                return loss, jax.tree_util.tree_map(lambda x: x[None, None],
                                                    g)
            return shard_map(run, mesh=mesh,
                             in_specs=(P("pipeline", "tensor"), P()),
                             out_specs=(P(), P("pipeline", "tensor")),
                             check_vma=False)(p, mb)

        opt = jopt.FusedAdam(lr=LR)
        st = opt.init(p)
        out = {"losses": [], "params": []}
        for i in range(steps):
            loss, g = grads_fn(p, mb)
            if i == 0:
                out["grads"] = _flatten(jax.tree_util.tree_map(np.asarray, g))
            p, st = opt.step(g, st, p)
            out["losses"].append(float(loss))
            out["params"].append(_flatten(jax.tree_util.tree_map(np.asarray,
                                                                 p)))
        return out
    finally:
        jps.destroy_model_parallel()


@pytest.fixture(scope="module")
def jax_gpt(ranks):
    case, _ = ranks
    return {tp: _jax_gpt_pp(tp, case["gpt_master"], case["tokens"],
                            case["labels"], STEPS if tp == 1 else 1)
            for tp in (1, 2)}


def _named(run, tensors):
    """A rank's tensors under the JAX tree's flat names."""
    return _flatten(jax_tree_from_state_dict(dict(zip(run["names"],
                                                      tensors))))


def _replicated(name):
    return any(k in name for k in REPLICATED)


def _pp_tp(case, r):
    """(pipeline stage, tp rank) of global rank r at tp 2 x pp 2."""
    t, p, _ = parallel_state.coordinates(r, WORLD, 2, 2)
    return p, t


def test_gpt_pp2_step1_against_jax(ranks, jax_gpt):
    """pp 2 (two dp replicas): the loss on both stages and each stage's
    gradients are JAX's for the leaves the stage holds (stage 0 the
    embeddings and its layers, stage 1 its layers, the final LayerNorm
    and its own word-embedding copy, whose gradient is the head's
    alone); JAX's other leaves have zero gradients."""
    _, res = ranks
    want = jax_gpt[1]
    for r in range(WORLD):
        s = r % 2
        run = res[r]["gpt_pp2"]
        close(run["losses"][0], want["losses"][0])
        got = _named(run, run["grads"])
        assert set(got) == ({"embedding.weight", "position_embeddings.weight"}
                            if s == 0 else {"embedding.weight",
                                            "final_layernorm.weight",
                                            "final_layernorm.bias"}) | {
            k for k in want["grads"] if k.startswith("transformer")}
        for k, g in want["grads"].items():
            if k in got:
                close(got[k], g[s, 0])
            else:
                assert not np.any(g[s, 0]), k


def test_gpt_pp2_trajectory_against_jax(ranks, jax_gpt):
    """Three FusedAdam steps at pp 2: each loss JAX's, and every parameter
    JAX's after each step wherever JAX's step-1 gradient stands above
    1e-4 of its leaf's largest (Adam's first steps divide by |g|, so an
    element whose gradient is rounding noise, such as the key bias that
    the softmax cancels, moves by up to lr either way in both packages);
    the two copies of the word embedding start equal and part after step
    1 (nothing ties them, in either package)."""
    case, res = ranks
    want = jax_gpt[1]
    emb = case["gpt_master"]["embedding"]["weight"]
    for r in range(WORLD):
        s = r % 2
        run = res[r]["gpt_pp2"]
        for a, b in zip(run["losses"], want["losses"]):
            close(a, b)
        for step in range(STEPS):
            got = _named(run, run["params"][step])
            for k, v in got.items():
                g = np.abs(want["grads"][k][s, 0])
                live = g > 1e-4 * g.max()
                assert live.mean() > 0.5 or k == "embedding.weight", k
                close(v[live], want["params"][step][k][s, 0][live])
    first = _named(res[0]["gpt_pp2"], res[0]["gpt_pp2"]["params"][0])
    last = _named(res[1]["gpt_pp2"], res[1]["gpt_pp2"]["params"][0])
    assert not np.array_equal(first["embedding.weight"],
                              last["embedding.weight"])
    assert not np.array_equal(first["embedding.weight"], emb)
    jp = want["params"][0]["embedding.weight"]
    assert not np.array_equal(jp[0, 0], jp[1, 0])


def _tp_cat(shards, name):
    """The tp = 1 tensor of the tp ranks' shards of ``name``: column
    shards (qkv, h->4h, their biases) and the vocab rows stacked on their
    first axis, row shards (proj, 4h->h weights) on their second; a
    replicated leaf is rank 0's."""
    if _replicated(name):
        return shards[0]
    axis = 1 if ("proj.weight" in name or "4h_to_h.weight" in name) else 0
    lead = 1 if name.startswith("transformer") else 0
    return np.concatenate(shards, axis=axis + lead)


def test_gpt_tp2_pp2_against_jax(ranks, jax_gpt):
    """tp 2 x pp 2: step 1's loss is JAX's at tp 2 and at tp 1; the tp
    ranks' gradients assemble into JAX's pp 2 gradients at tp 1 (column,
    row and vocab shards concatenated; the replicated leaves whole on each
    rank, the same bits on both); the three losses follow JAX's pp 2
    trajectory; after every step the replicated parameters are the same
    bits on the two tp ranks.  JAX's own tp 2 pipeline is held to its
    loss only: inside its stages' ``jax.vjp`` under ``shard_map`` the
    sharded leaves' gradients come out twice its tp 1 ones (read on this
    toy), so its tp 1 gradients are the reference."""
    case, res = ranks
    want2, want1 = jax_gpt[2], jax_gpt[1]
    for s in range(2):
        stage = [r for r in range(WORLD) if _pp_tp(case, r)[0] == s]
        named = [_named(res[r]["gpt_tp2pp2"], res[r]["gpt_tp2pp2"]["grads"])
                 for r in stage]
        for k in named[0]:
            close(_tp_cat([g[k] for g in named], k), want1["grads"][k][s, 0])
            if _replicated(k):
                np.testing.assert_array_equal(named[0][k], named[1][k])
        runs = [res[r]["gpt_tp2pp2"] for r in stage]
        for run in runs:
            close(run["losses"][0], want2["losses"][0])
            for a, b in zip(run["losses"], want1["losses"]):
                close(a, b)
        for step in range(STEPS):
            mine, theirs = (_named(run, run["params"][step]) for run in runs)
            for k in mine:
                if _replicated(k):
                    np.testing.assert_array_equal(mine[k], theirs[k])


def test_amp_planted_overflow_skipped_on_every_rank(ranks):
    """bench.py's amp pp recipe at tp 2 x pp 2 (scaled loss, unscale, the
    overflow verdict agreed over the pipeline and tensor groups, a
    branchless skip): an inf planted in one stage's gradients at step 2
    makes every rank skip that step bitwise and halve its scale; steps 1
    and 3 are the unscaled run's steps 1 and 2, bit for bit."""
    _, res = ranks
    for r in range(WORLD):
        amp, plain = res[r]["amp_tp2pp2"], res[r]["gpt_tp2pp2"]
        assert amp["scales"] == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15]
        for a, b in zip(amp["params"][1], amp["params"][0]):
            assert torch.equal(a, b)
        for a, b in zip(amp["params"][0], plain["params"][0]):
            assert torch.equal(a, b)
        for a, b in zip(amp["params"][2], plain["params"][1]):
            assert torch.equal(a, b)
        assert amp["losses"][0] == plain["losses"][0]
        assert amp["losses"][2] == plain["losses"][1]


def test_stage_state_dict_cuts_the_whole_model():
    """``stage_state_dict`` at pp 2 x vpp 2 of a 4-layer model: a layer a
    virtual stage, renumbered from 0; the embeddings on virtual stage 0
    only, the final LayerNorm and the word embedding on the last only;
    the four cuts hold every layer once."""
    from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel

    cfg = GPTConfig(**GPT_CFG)
    sd = GPTModel(cfg, device="cpu").state_dict()
    seen = []
    for v in range(4):
        part = stage_state_dict(sd, v % 2, 2, chunk=v // 2, vpp=2)
        heads = {k.split(".")[0] for k in part if not k.startswith(
            "transformer")}
        assert heads == ({"embedding", "position_embeddings"} if v == 0 else
                         {"embedding", "final_layernorm"} if v == 3 else
                         set())
        layers = {k for k in part if k.startswith("transformer")}
        assert all(k.startswith("transformer.layers.0.") for k in layers)
        seen.append(part["transformer.layers.0.mlp.dense_4h_to_h.weight"])
        stage = GPTModel(cfg, 1, device="cpu", pre_process=v == 0,
                         post_process=v == 3)
        stage.load_state_dict(part)
    for i, t in enumerate(seen):
        assert torch.equal(t, sd[f"transformer.layers.{i}.mlp.dense_4h_to_h."
                                 "weight"])
    with pytest.raises(ValueError):
        stage_state_dict(sd, 0, 3)


# -- the utilities -------------------------------------------------------------

def test_ltor_masks_against_jax():
    """``get_ltor_masks_and_position_ids`` under every option on ids with
    several end tokens: JAX's masks, loss mask and position ids (and
    ``TestLtorMasks``'s two cases)."""
    data = np.random.RandomState(2).randint(0, 6, (3, 12)).astype(np.int64)
    data[0, :4] = [5, 3, 9, 3]
    for opts in [dict(), dict(reset_position_ids=True),
                 dict(reset_attention_mask=True), dict(eod_mask_loss=True),
                 dict(reset_position_ids=True, reset_attention_mask=True,
                      eod_mask_loss=True)]:
        got = tpp.get_ltor_masks_and_position_ids(torch.from_numpy(data), 3,
                                                  **opts)
        want = jpp.get_ltor_masks_and_position_ids(jnp.asarray(data), 3,
                                                   **opts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    am, lm, pid = tpp.get_ltor_masks_and_position_ids(
        torch.tensor([[5, 9, 7, 8]]), eod_token=9, reset_position_ids=True,
        reset_attention_mask=True, eod_mask_loss=True)
    assert lm[0].tolist() == [1, 0, 1, 1] and pid[0].tolist() == [0, 1, 0, 1]
    assert bool(am[0, 0, 2, 0]) and not bool(am[0, 0, 3, 2])


def test_microbatch_slicing_against_jax():
    batch = {"x": np.arange(24.0).reshape(12, 2), "y": np.arange(12)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    got, want = tpp.split_into_microbatches(tb, 4), \
        jpp.split_into_microbatches(jb, 4)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got = tpp.get_kth_microbatch(tb, 2, 3)
    want = jutils.get_kth_microbatch(jb, 2, 3)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_norms_and_prints_against_jax(capsys):
    """``calc_params_l2_norm`` is JAX's; ``print_params_min_max_norm`` prints
    JAX's lines for a tree and names a module's parameters."""
    tree = {"a": np.array([1.0, -2.0], np.float32),
            "b": np.ones((2, 2), np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    close(tpp.calc_params_l2_norm(tt), jpp.calc_params_l2_norm(jt))
    assert tpp.print_params_min_max_norm(tt, iteration=7) == \
        jutils.print_params_min_max_norm(jt, iteration=7)
    msg = tpp.print_params_min_max_norm(torch_ranks._Toy(tree["b"]))
    assert "iteration 0, w: min" in msg and "norm" in capsys.readouterr().out
    assert tpp.get_autoresume() is None is jutils.get_autoresume()
    assert tpp.check_adlr_autoresume_termination(0, None) is False
    assert tpp.listify_model(1) == [1] and tpp.unwrap_model([1]) == [1]


def test_calculator_shares_the_global_registry():
    """``setup_microbatch_calculator`` fills the registry
    ``global_vars`` reads (one calculator, refused twice), with JAX's
    counts through a ramp-up."""
    global_vars.destroy_global_vars()
    jutils.destroy_microbatch_calculator()
    try:
        tpp.setup_microbatch_calculator(0, [8, 8, 80], 32, 2, 2)
        jutils.setup_microbatch_calculator(0, [8, 8, 80], 32, 2, 2)
        with pytest.raises(RuntimeError):
            tpp.setup_microbatch_calculator(0, None, 32, 2, 2)
        for consumed in (0, 40, 100):
            tpp.update_num_microbatches(consumed)
            jutils.update_num_microbatches(consumed)
            assert tpp.get_num_microbatches() == \
                jutils.get_num_microbatches() == \
                global_vars.get_num_microbatches()
            assert tpp.get_current_global_batch_size() == \
                jutils.get_current_global_batch_size()
        assert tpp.get_micro_batch_size() == 2
        tpp.destroy_microbatch_calculator()
        assert global_vars._GLOBAL_NUM_MICROBATCHES_CALCULATOR is None
    finally:
        global_vars.destroy_global_vars()
        jutils.destroy_microbatch_calculator()


def test_average_losses_and_report_memory(capsys):
    """Without a process group the data-parallel average is the identity
    (JAX's pmean over a data axis of one); ``report_memory`` names each
    card it sees (none here)."""
    losses = [torch.tensor(1.5), torch.tensor(2.25)]
    got = tpp.average_losses_across_data_parallel_group(losses, group=None)
    assert got.tolist() == [1.5, 2.25]
    msg = tpp.report_memory("here")
    assert msg.splitlines()[0] == "memory (here)"
    assert len(msg.splitlines()) == 1 + (torch.cuda.device_count()
                                         if torch.cuda.is_available() else 0)


def test_schedule_stats_reset_each_run():
    stage = torch_ranks._Toy(np.eye(HIDDEN, dtype=np.float32))
    d = {"x": torch.zeros(3, MB, HIDDEN), "y": torch.zeros(3, MB, HIDDEN)}
    tpp.forward_backward_pipelining_without_interleaving(
        torch_ranks._toy_stage_fn, torch_ranks._toy_loss_fn, stage, d,
        n_microbatches=3, tensor_shape=(MB, HIDDEN))
    assert schedules.STATS.peak_saved_inputs == [1]
    assert schedules.STATS.backward_slots == [3]
    assert schedules.STATS.forward_slots == [0]
