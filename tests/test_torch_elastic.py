"""Sharded ZeRO checkpoints and elastic recovery: the port against the
JAX package's ``checkpoint`` formats 3 and 4 and ``resilience.elastic``.

Synthetic ZeRO-shaped states (``tests/L0/test_elastic.py``'s: replicated
params, per-rank opt partitions stacked on leading axes, a broadcast step
counter) are saved by one process holding the whole stacks and by four
gloo ranks each holding its block (one launch, rank bodies in
``tests/torch_ranks.py``); the files are JAX's (arrays and manifests
equal), each rank writes only its own shard files, and every restore is
bitwise: JAX's of the port's files, the port's of JAX's, across a
changed topology too, each rank getting exactly its block of the
re-partitioned stack.  The recovery: four ranks at (dp, tp, pp) = (2, 2,
1) on the flagship toy lose rank 3 at step 2, resume on the survivors'
best shape from the newest intact checkpoint, and end bitwise equal to
the golden run restored from that checkpoint on that shape, and within
the flagship bars (losses 1e-5 relative, parameters 1e-3) of JAX's
``run_elastic_training`` from the same master on the same toy.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from apex_tpu import checkpoint as jckpt
from apex_tpu import resilience as jres
from apex_tpu.contrib.optimizers import DistributedFusedAdam as JAdam
from apex_tpu.contrib.optimizers import ShardedOptState as JState
from apex_tpu.contrib.optimizers import reshard_zero_state as jreshard_zero
from apex_tpu.multi_tensor import flat as jflat
from apex_tpu.resilience import chaos as jchaos
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu.transformer.testing import (
    flagship_elastic_build as jelastic_build)
from apex_tpu.transformer.testing import gpt1p3b_config as jgpt1p3b_config
from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch import resilience as tres
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               ShardedOptState,
                                               reshard_zero_state)
from apex_tpu_torch.multi_tensor import flat as tflat
from apex_tpu_torch.multi_tensor.flat import PartitionSpec as P
from apex_tpu_torch.parallel.multiproc import spawn
from apex_tpu_torch.resilience import chaos as tchaos
from apex_tpu_torch.transformer.testing import (flagship_elastic_build,
                                                gpt1p3b_config)
from apex_tpu_torch.transformer.testing.convert import (_flatten,
                                                        master_to_jax)

import torch_ranks

WORLD = 4
AXES_212 = {"data": 2, "pipeline": 1, "tensor": 2}
AXES_222 = {"data": 2, "pipeline": 2, "tensor": 2}
# the toy of tests/L0/test_elastic.py at fp32 compute (the flagship bars
# are fp32's)
TOY_KW = dict(num_layers=2, hidden_size=256, num_attention_heads=2,
              vocab_size=512, max_position_embeddings=32, bf16=False)
LR = 1e-3
N_STEPS, LOSE_AT, LOST = 4, 2, [3]


# -- synthetic states ----------------------------------------------------------

def _state_np(lead, shard=32, seed=0):
    """(params, opt) numpy: replicated params, opt partitions stacked on
    ``lead``, the broadcast step counter."""
    rng = np.random.RandomState(seed)
    return ({"w": rng.randn(16).astype(np.float32)},
            {"step": np.full(lead, 5, np.int32),
             "exp_avg": rng.randn(*lead, shard).astype(np.float32),
             "exp_avg_sq": np.abs(rng.randn(*lead, shard)).astype(
                 np.float32)})


def _torch(state):
    params, opt = state
    return ({"w": torch.from_numpy(params["w"])},
            {k: torch.from_numpy(v) for k, v in opt.items()})


def _jax(state):
    return jax.tree_util.tree_map(jnp.asarray, state)


def _specs(axes, port=True):
    mk = P if port else JP
    return (mk(), mk(*axes))


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
        tree)


def _same_tree(a, b):
    la, lb = jax.tree_util.tree_leaves(_np(a)), jax.tree_util.tree_leaves(
        _np(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _files(d):
    """{file: {member: array}} of a checkpoint step dir, and its manifest."""
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                out[name] = {k: z[k] for k in z.files}
    with open(os.path.join(d, "manifest.json")) as f:
        return out, json.load(f)


def _same_files(d1, d2):
    f1, m1 = _files(d1)
    f2, m2 = _files(d2)
    assert m1 == m2
    assert sorted(f1) == sorted(f2)
    for name in f1:
        assert sorted(f1[name]) == sorted(f2[name]), name
        for k in f1[name]:
            a, b = f1[name][k], f2[name][k]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), (name, k)


FORMATS = {3: dict(lead=(8,), axes={"data": 8}, kw=dict(shard_axis="data")),
           4: dict(lead=(2, 2, 2), axes=AXES_222,
                   kw=dict(shard_axes=AXES_222))}


@pytest.mark.parametrize("fmt", [3, 4])
def test_port_files_are_jax_files_and_restore_both_ways(tmp_path, fmt):
    """One process holding the stacks: the port's save is JAX's (every
    shard file's arrays, the manifest with its CRC32s and topology),
    JAX restores it bitwise, and the port restores JAX's bitwise."""
    f = FORMATS[fmt]
    state = _state_np(f["lead"])
    dp, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_checkpoint(dp, _torch(state), step=3,
                          shardings=_specs(f["axes"]), **f["kw"])
    jckpt.save_checkpoint(dj, _jax(state), step=3,
                          shardings=_specs(f["axes"], port=False), **f["kw"])
    _same_files(tckpt.step_dir(dp, 3), jckpt.step_dir(dj, 3))
    got_j, _ = jckpt.restore_checkpoint(dp, _jax(state), verify=True)
    _same_tree(got_j, state)
    got_t, _ = tckpt.restore_checkpoint(dj, _torch(state), verify=True)
    _same_tree(got_t, state)
    _, man = _files(tckpt.step_dir(dp, 3))
    assert man["format"] == fmt
    flags = {k: e["replicated_shards"] for k, e in man["leaves"].items()
             if "replicated_shards" in e}
    assert [v for k, v in sorted(flags.items()) if "step" in k] == [True]


def test_bf16_state_round_trips_both_ways(tmp_path):
    """bf16 moments (the bf16_fit plan) stored as fp32 and as raw bits:
    the port's files restore in JAX and JAX's in the port, bitwise."""
    state = _state_np((4,))
    sp, sj = _torch(state), _jax(state)
    sp[1]["exp_avg"] = sp[1]["exp_avg"].to(torch.bfloat16)
    sj[1]["exp_avg"] = sj[1]["exp_avg"].astype(jnp.bfloat16)
    for portable in (True, False):
        dp = str(tmp_path / f"p{portable}")
        dj = str(tmp_path / f"j{portable}")
        tckpt.save_checkpoint(dp, sp, step=1, shardings=_specs({"data": 4}),
                              shard_axis="data", fp32_portable=portable)
        jckpt.save_checkpoint(dj, sj, step=1,
                              shardings=_specs({"data": 4}, port=False),
                              shard_axis="data", fp32_portable=portable)
        _same_files(tckpt.step_dir(dp, 1), jckpt.step_dir(dj, 1))
        got, _ = tckpt.restore_checkpoint(dj, sp, verify=True)
        assert got[1]["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(got[1]["exp_avg"], sp[1]["exp_avg"])
        gj, _ = jckpt.restore_checkpoint(dp, sj, verify=True)
        np.testing.assert_array_equal(
            np.asarray(gj[1]["exp_avg"], np.float32),
            sp[1]["exp_avg"].float().numpy())


# -- across ranks --------------------------------------------------------------

SAVES = (("f3_ranks", _state_np((4,)), 3, {"data": 4}),
         ("f4_ranks", _state_np((2, 1, 2), seed=1), 4, AXES_212))
#: (name, source dir, target axes, target shard)
RESTORES = (("own_f4_same", "f4_ranks", AXES_212, 32),
            ("own_f3_to_f4", "f3_ranks", AXES_212, 32),
            ("jax_f3_8_to_4", "jax_f3_8", {"data": 4}, 64),
            ("jax_f4_222_to_212", "jax_f4_222", AXES_212, 64),
            ("jax_grow_8_to_4", "jax_f3_8_small", {"data": 4}, 48),
            ("drop_real", "jax_f3_8", {"data": 4}, 32))


@pytest.fixture(scope="module")
def rank_saves(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    sources = {"jax_f3_8": (_state_np((8,), seed=2), {"data": 8}, 3),
               "jax_f4_222": (_state_np((2, 2, 2), seed=3), AXES_222, 4),
               "jax_f3_8_small": (_state_np((8,), 20, seed=4), {"data": 8},
                                  3)}
    for name, (state, axes, fmt) in sources.items():
        kw = (dict(shard_axis="data") if fmt == 3
              else dict(shard_axes=axes))
        jckpt.save_checkpoint(str(root / name), _jax(state), step=3,
                              shardings=_specs(axes, port=False), **kw)
    for name, state, fmt, axes in SAVES:   # the single-process twins
        kw = (dict(shard_axis="data") if fmt == 3
              else dict(shard_axes=axes))
        tckpt.save_checkpoint(str(root / (name + "_one")), _torch(state),
                              step=3, shardings=_specs(axes), **kw)
    case = dict(root=str(root), saves=SAVES, restores=RESTORES)
    spawn(torch_ranks.sharded_saves, WORLD, str(root / "store"),
          str(root), case)
    sources.update({name: (state, axes, fmt)
                    for name, state, fmt, axes in SAVES})
    return str(root), sources, torch_ranks.load_ranks(str(root), WORLD)


@pytest.mark.parametrize("name", [s[0] for s in SAVES])
def test_saves_across_ranks_write_the_one_process_files(rank_saves, name):
    """Each rank saving its block writes the files one process holding the
    stacks writes (byte for byte in content, the same manifest), JAX
    restores them bitwise, and every rank wrote only its own shard."""
    root, sources, res = rank_saves
    state, axes, fmt = sources[name]
    d = tckpt.step_dir(os.path.join(root, name), 3)
    _same_files(d, tckpt.step_dir(os.path.join(root, name + "_one"), 3))
    got, _ = jckpt.restore_checkpoint(os.path.join(root, name), _jax(state),
                                      verify=True)
    _same_tree(got, state)
    for r in range(WORLD):
        c = np.unravel_index(r, tuple(axes.values()))
        want = (tckpt.shard_file(r) if fmt == 3
                else tckpt.shard_file_coords(c))
        assert res[r]["wrote"][name] == [want]


def _want_block(state, axes_from, axes_to, shard, rank, leaf):
    """Rank ``rank``'s block of ``state``'s leaf re-partitioned from
    ``axes_from`` to ``axes_to`` (the whole-stack reshard, sliced)."""
    lead = tuple(axes_to.values())
    val = state[1][leaf]
    if leaf == "step":
        return np.full((1,) * len(lead), 5, np.int32)
    whole = jflat.reshard_stack(val, len(axes_from), lead + (shard,))
    c = np.unravel_index(rank, lead)
    return whole[c][(None,) * len(lead)]


@pytest.mark.parametrize("name", [r[0] for r in RESTORES[:-1]])
def test_restores_across_ranks_give_each_rank_its_block(rank_saves, name):
    """Same topology and changed (N -> M, format 3 into a format-4 world,
    growth): each rank's block is bitwise the re-partitioned stack's."""
    root, sources, res = rank_saves
    _, src, axes, shard = next(r for r in RESTORES if r[0] == name)
    state, axes_from, _ = sources[src]
    for r in range(WORLD):
        (params, opt), step = res[r][name]
        assert step == 3
        np.testing.assert_array_equal(params["w"].numpy(), state[0]["w"])
        for leaf in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                opt[leaf].numpy(),
                _want_block(state, axes_from, axes, shard, r, leaf))


def test_reshard_refuses_to_drop_real_state(rank_saves, tmp_path):
    """Shrinking past the schema padding raises on every rank, and in one
    process, as JAX's restore does."""
    _, _, res = rank_saves
    for r in range(WORLD):
        kind, msg = res[r]["drop_real"]
        assert kind == "ValueError" and "not all zero" in msg
    state = _state_np((8,))
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, _torch(state), step=1,
                          shardings=_specs({"data": 8}), shard_axis="data")
    target = ({"w": torch.zeros(16)},
              {"step": torch.zeros(4, dtype=torch.int32),
               "exp_avg": torch.zeros(4, 32), "exp_avg_sq": torch.zeros(4, 32)})
    with pytest.raises(ValueError, match="not all zero"):
        tckpt.restore_checkpoint(d, target)


# -- one process: reshard round trips -------------------------------------------

@pytest.mark.parametrize("m", [8, 4, 1])
def test_format3_reshard_n_to_m_bitwise(tmp_path, m):
    state = _state_np((8,))
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, _torch(state), step=2,
                          shardings=_specs({"data": 8}), shard_axis="data")
    target = ({"w": torch.zeros(16)},
              {"step": torch.zeros(m, dtype=torch.int32),
               "exp_avg": torch.zeros(m, 256 // m),
               "exp_avg_sq": torch.zeros(m, 256 // m)})
    (p, o), step = tres.restore_zero_checkpoint(d, target)
    assert step == 2 and torch.all(o["step"] == 5)
    jt = jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape, t.numpy().dtype),
                                target)
    (jp_, jo), _ = jres.restore_zero_checkpoint(d, jt)
    _same_tree((p, o), (jp_, jo))


def test_format4_round_trip_8_to_222_to_8(tmp_path):
    """(8, 1, 1) -> (2, 2, 2) -> (8, 1, 1) through two format-4 saves of
    the port: the optimizer state comes back bitwise, and each middle
    file is JAX's own save of the middle state."""
    axes8 = {"data": 8, "pipeline": 1, "tensor": 1}
    state = _state_np((8, 1, 1))
    d1, d2, dj = (str(tmp_path / n) for n in ("a", "b", "j"))
    tckpt.save_checkpoint(d1, _torch(state), step=1, shardings=_specs(axes8),
                          shard_axes=axes8)

    def target(lead):
        return ({"w": torch.zeros(16)},
                {"step": torch.zeros(lead, dtype=torch.int32),
                 "exp_avg": torch.zeros(*lead, 256 // int(np.prod(lead))),
                 "exp_avg_sq": torch.zeros(*lead, 256 // int(np.prod(lead)))})

    mid, _ = tres.restore_zero_checkpoint(d1, target((2, 2, 2)))
    tckpt.save_checkpoint(d2, mid, step=1, shardings=_specs(AXES_222),
                          shard_axes=AXES_222)
    jckpt.save_checkpoint(dj, _jax(_np(mid)), step=1,
                          shardings=_specs(AXES_222, port=False),
                          shard_axes=AXES_222)
    _same_files(tckpt.step_dir(d2, 1), jckpt.step_dir(dj, 1))
    back, _ = tres.restore_zero_checkpoint(d2, target((8, 1, 1)))
    _same_tree(back, state)


def test_in_memory_reshards_match_jax():
    """reshard_zero_state (n_shards and lead_shape forms) and reshard_tree
    give JAX's bits on the same stacks."""
    params = {"w": np.random.RandomState(1).randn(300).astype(np.float32)}
    opt, jopt = DistributedFusedAdam(), JAdam()
    sch8 = opt.make_schema({"w": torch.from_numpy(params["w"])}, 8)
    jsch4 = jopt.make_schema(_jax(params), 4)
    sch4 = opt.make_schema({"w": torch.from_numpy(params["w"])}, 4)
    rng = np.random.RandomState(2)
    raw = sum(sch8.sizes)
    m = rng.randn(sch8.total).astype(np.float32)
    v = rng.randn(sch8.total).astype(np.float32)
    m[raw:] = v[raw:] = 0
    stack = (np.full((8,), 3, np.int32), m.reshape(8, -1), v.reshape(8, -1))
    got = reshard_zero_state(ShardedOptState(*map(torch.from_numpy, stack)),
                             n_shards=4, schema=sch4)
    want = jreshard_zero(JState(*map(jnp.asarray, stack)), n_shards=4,
                         schema=jsch4)
    _same_tree(tuple(got), tuple(want))
    got3 = reshard_zero_state(ShardedOptState(*map(torch.from_numpy, stack)),
                              lead_shape=(2, 1, 2), schema=sch4)
    want3 = jreshard_zero(JState(*map(jnp.asarray, stack)),
                          lead_shape=(2, 1, 2), schema=jsch4)
    _same_tree(tuple(got3), tuple(want3))
    state = _state_np((2, 1, 2))
    tgt_lead = (1, 1, 4)
    tgt = ({"w": np.zeros(16, np.float32)},
           {"step": np.zeros(tgt_lead, np.int32),
            "exp_avg": np.zeros(tgt_lead + (32,), np.float32),
            "exp_avg_sq": np.zeros(tgt_lead + (32,), np.float32)})
    axes_to = {"data": 1, "pipeline": 1, "tensor": 4}
    got_t = tflat.reshard_tree(_torch(state), _specs(AXES_212),
                               _specs(axes_to), target=_torch(tgt),
                               axes_from=AXES_212, axes_to=axes_to)
    want_t = jflat.reshard_tree(_jax(state), _specs(AXES_212, False),
                                _specs(axes_to, False), target=_jax(tgt),
                                axes_from=AXES_212, axes_to=axes_to)
    _same_tree(got_t, want_t)
    dev = tflat.reshard_stack_device(torch.arange(6.), (2, 4))
    jdev = jflat.reshard_stack_device(jnp.arange(6.), (2, 4))
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jdev))
    for spec in (P("data"), P(("data",), "tensor"), P("x", "data"), None):
        jspec = None if spec is None else JP(*spec)
        assert tflat.spec_lead_axes(spec, AXES_222) == \
            jflat.spec_lead_axes(jspec, AXES_222)
    for val, n in ((np.full((2, 2), 3), 2), (np.arange(4).reshape(2, 2), 2),
                   (np.zeros((2, 3)), 1)):
        assert tflat.is_replicated_stack(val, n) == \
            jflat.is_replicated_stack(val, n)


# -- chaos ------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,rank", [(3, 2), (4, (1, 0, 1))])
def test_corrupt_shard_is_named_under_verify(tmp_path, fmt, rank):
    """corrupt_shard flips a byte inside the largest entry's data: the
    port's verify raises naming that file, and JAX's verify rejects it."""
    f = FORMATS[fmt]
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, _torch(_state_np(f["lead"])), step=1,
                          shardings=_specs(f["axes"]), **f["kw"])
    path = tchaos.corrupt_shard(d, 1, rank)
    name = os.path.basename(path)
    assert name == (tckpt.shard_file(rank) if fmt == 3
                    else tckpt.shard_file_coords(rank))
    with pytest.raises(tckpt.CheckpointCorruptionError, match=name):
        tckpt.verify_checkpoint(d, 1)
    with pytest.raises(jckpt.CheckpointCorruptionError):
        jckpt.verify_checkpoint(d, 1)


@pytest.mark.parametrize("fmt", [3, 4])
def test_kill_mid_async_save_newest_intact_shard_set_wins(tmp_path, fmt):
    """Step 1 lands; the step-2 async save dies mid shard set (nothing is
    committed); step 3 lands and one shard is then corrupted: the
    resilient restore skips 3, never sees 2, and lands on 1."""
    f = FORMATS[fmt]
    state = _torch(_state_np(f["lead"]))
    d = str(tmp_path / "c")
    kw = dict(shardings=_specs(f["axes"]), **f["kw"])
    tckpt.save_checkpoint(d, state, step=1, **kw)
    with tchaos.FaultyStore(fail_events=("write_shard",),
                            fail_times=None) as store:
        tckpt.save_checkpoint(d, state, step=2, blocking=False, **kw)
        with pytest.raises(tres.AsyncSaveError):
            tres.wait_for_save()
    assert store.failures_injected >= 1
    assert not os.path.isdir(tckpt.step_dir(d, 2))
    tckpt.save_checkpoint(d, state, step=3, **kw)
    tchaos.corrupt_shard(d, 3, 5 if fmt == 3 else (1, 1, 0))
    target = _torch(_state_np(f["lead"], seed=9))
    with pytest.warns(tres.CheckpointFallbackWarning) as record:
        restored, step = tres.restore_zero_checkpoint(d, target)
    assert step == 1
    assert any("step 3" in str(w.message) for w in record)
    _same_tree(restored, state)


def test_submesh_policies_match_jax():
    devs = list(range(8))
    for n in range(1, 9):
        for b in (1, 4, 6, 7, 8):
            assert tres.largest_divisor_submesh(devs[:n], b) == \
                jres.largest_divisor_submesh(devs[:n], b)
    for shape in ((4, 2, 1), (2, 2, 2), (8, 1, 1), (2, 2, 1), (1, 4, 2)):
        for n in range(1, 9):
            for b in (None, 2, 8):
                assert tres.best_surviving_submesh(
                    devs[:n], shape, batch_size=b) == \
                    jres.best_surviving_submesh(devs[:n], shape,
                                                batch_size=b)


def test_partition_specs_survive_pickling():
    """A spec crosses to and from spawned ranks whole (torch.save)."""
    import pickle

    for spec in (P(), P("data"), P("data", "pipeline", "tensor"),
                 P(("data", "tensor"), None)):
        back = pickle.loads(pickle.dumps(spec))
        assert type(back) is P and back == spec


def test_device_loss_hook_fires_once():
    dl = tchaos.DeviceLoss(at_step=2, device_ids=[3])
    dl.poll(1)
    with pytest.raises(tres.DeviceLossError) as e:
        dl.poll(2)
    assert e.value.device_ids == [3]
    dl.poll(3)   # fired: the survivors sail past


# -- recovery ---------------------------------------------------------------------

def _master():
    cfg = jgpt1p3b_config(**TOY_KW)
    return jax.tree_util.tree_map(
        np.asarray, JGPTModel(cfg).init_master(jax.random.PRNGKey(0)))


def _batches():
    """The golden stream of tests/L0/test_elastic.py (two batches
    alternating), drawn with numpy."""
    r = np.random.RandomState(300)
    pair = [r.randint(0, TOY_KW["vocab_size"], (8, 32)).astype(np.int64)
            for _ in range(2)]
    return [(torch.from_numpy(pair[i % 2]),
             torch.from_numpy(np.roll(pair[i % 2], -1, -1)))
            for i in range(N_STEPS)]


@pytest.fixture(scope="module")
def recovery(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    ckpt_dir = str(root / "ckpt")
    build = flagship_elastic_build(gpt1p3b_config(**TOY_KW), plan="fp32",
                                   lr=LR, device="cpu", master=_master())
    batches = _batches()
    it = torch_ranks.ListIterator(batches)
    dl = tchaos.DeviceLoss(at_step=LOSE_AT, device_ids=LOST)
    result = tres.run_elastic_training(
        build, list(range(WORLD)), data_iter=it, ckpt_dir=ckpt_dir,
        save_every=1, on_step=dl.poll, max_restarts=2,
        mesh_shape=(2, 2, 1), batch_size=8, work_dir=str(root / "work"))
    # the golden: the checkpoint the recovery resumed from, restored on
    # the survivors' shape, then the rest uninterrupted
    gold = root / "golden"
    gold.mkdir()
    spawn(torch_ranks.elastic_golden, 2, str(gold / "store"), str(gold),
          dict(build=build, shape=result.mesh_shape, ckpt_dir=ckpt_dir,
               step=LOSE_AT - 1, batches=batches))
    golden = torch_ranks.load_ranks(str(gold), 2)
    return result, it, golden, ckpt_dir


def test_device_loss_resumes_on_the_survivors_shape(recovery):
    result, it, _, ckpt_dir = recovery
    assert result.restarts == 1 and result.lost_devices == LOST
    assert result.mesh_shape == (1, 2, 1) and result.devices == [0, 1]
    assert result.step == N_STEPS and len(result.losses) == N_STEPS + 1
    assert it.pos == N_STEPS     # the caller's iterator at the end
    with open(os.path.join(tckpt.step_dir(ckpt_dir, N_STEPS),
                           "manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == 4 and man["data_state"] == {"pos": N_STEPS}
    assert man["topology"]["mesh_axes"] == {"data": 1, "pipeline": 1,
                                            "tensor": 2}


def test_recovery_is_bitwise_the_golden_run(recovery):
    """From the restored step on, the losses and the final state are the
    golden run's bits (the same checkpoint on the same shape)."""
    result, _, golden, _ = recovery
    assert result.losses[LOSE_AT:] == golden[0]["losses"]
    # whole stacks on the survivors' (dp, pp, tp) = (1, 1, 2)
    assert tuple(result.state[1].exp_avg.shape[:3]) == (1, 1, 2)
    assert not torch.equal(result.state[1].exp_avg[0, 0, 0],
                           result.state[1].exp_avg[0, 0, 1])
    from apex_tpu_torch.resilience.elastic import stack_rank_states
    want = stack_rank_states([g["state"] for g in golden],
                             golden[0]["shardings"],
                             {"data": 1, "pipeline": 1, "tensor": 2})
    _same_tree(result.state, want)


def test_recovery_matches_jax_run_elastic_training(recovery, tmp_path):
    """JAX's loop on the same toy, master, batches and loss: the same
    survivors' shape, losses within 1e-5 relative, parameters 1e-3."""
    result, _, _, _ = recovery
    cfg = jgpt1p3b_config(**TOY_KW)
    losses = []
    build = jelastic_build(cfg, plan="fp32", lr=LR, on_loss=losses.append)
    devs = jax.devices()[:WORLD]
    dl = jchaos.DeviceLoss(at_step=LOSE_AT, device_ids=[devs[i]
                                                        for i in LOST])
    batches = [(jnp.asarray(t.numpy().astype(np.int32)),
                jnp.asarray(lab.numpy().astype(np.int32)))
               for t, lab in _batches()]
    try:
        jr = jres.run_elastic_training(
            build, devs, batches, ckpt_dir=str(tmp_path / "ckpt"),
            save_every=1, on_step=dl.poll, max_restarts=2,
            mesh_shape=(2, 2, 1), batch_size=8)
    finally:
        jps.destroy_model_parallel()
    assert jr.mesh_shape == result.mesh_shape and jr.step == result.step
    np.testing.assert_allclose(result.losses, losses, rtol=1e-5, atol=0)
    got = _flatten(master_to_jax(result.state[0]))
    want = _flatten(jax.tree_util.tree_map(np.asarray, jr.state[0]))
    maxdw = max(float(np.max(np.abs(got[k] - want[k]))) for k in want)
    assert maxdw <= 1e-3, f"max|dw| {maxdw:.3e} vs JAX's elastic run"
