"""The port's checkpoint (``apex_tpu_torch.checkpoint``) against the JAX
package's on the same numpy trees: one on-disk format both ways.

A tree saved by either package restores in the other bit for bit (npz
and packed; fp32, int32, bf16 stored as fp32 or as raw bits, fp16); the
two manifests are equal key for key, CRC32s included; the port restores
the sharded formats 3 and 4 that JAX writes on the emulated 8-device
mesh, re-partitioned onto one card; the port's ``keystr`` is
``jax.tree_util.keystr``; corrupt, truncated and faulty-store cases raise
or retry as JAX's do; an async save copies tensors before it returns.
Everything is compared bitwise: nothing here computes.
"""

import json
import os
import warnings
from collections import OrderedDict, defaultdict
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apex_tpu import checkpoint as jckpt
from apex_tpu.checkpoint import checkpoint as jckpt_mod
from apex_tpu.resilience import async_checkpoint as jasync
from apex_tpu.resilience import chaos as jchaos
from apex_tpu.resilience import restore as jrestore
from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch.checkpoint import checkpoint as tckpt_mod
from apex_tpu_torch.multi_tensor.flat import PartitionSpec as TP
from apex_tpu_torch.resilience import async_checkpoint as tasync
from apex_tpu_torch.resilience import chaos as tchaos
from apex_tpu_torch.resilience import restore as trestore
from apex_tpu_torch.utils.tree import keystr, tree_flatten_with_path


class Moments(NamedTuple):
    step: object
    exp_avg: object
    exp_avg_sq: object


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    jckpt_mod.set_fault_hook(None)
    tckpt_mod.set_fault_hook(None)
    jasync.drain(ignore_errors=True)
    tasync.drain(ignore_errors=True)


def _np_tree(seed=0, half=True):
    """A train-state-shaped tree of numpy arrays: nested dicts (keys out
    of order), a list, a namedtuple, an int32 step, and half leaves; its
    largest leaf fills the middle of the file, where ``corrupt_arrays``
    flips a byte."""
    rng = np.random.RandomState(seed)
    params = {"w2": rng.randn(8, 4).astype(np.float32),
              "big": rng.randn(64, 64).astype(np.float32),
              "b": rng.randn(4).astype(np.float32),
              "layers": [rng.randn(3).astype(np.float32),
                         rng.randn(2, 2).astype(np.float32)]}
    tree = (params, Moments(step=np.asarray(7, np.int32),
                            exp_avg={"w2": rng.randn(8, 4).astype(np.float32)},
                            exp_avg_sq={"w2": np.abs(rng.randn(8, 4)).astype(
                                np.float32)}))
    if half:
        tree[0]["h"] = {"bf": rng.randn(5, 3).astype(np.float32),
                        "f16": rng.randn(6).astype(np.float16)}
    return tree


def _jax_tree(tree):
    """The tree as jnp arrays, the "bf" leaf in bfloat16."""
    def conv(path, x):
        if path and getattr(path[-1], "key", None) == "bf":
            return jnp.asarray(x, jnp.bfloat16)
        return jnp.asarray(x)
    return jax.tree_util.tree_map_with_path(conv, tree)


def _torch_tree(tree):
    """The tree as torch tensors, the "bf" leaf in bfloat16."""
    def conv(path, x):
        t = torch.from_numpy(np.array(x))
        return t.to(torch.bfloat16) if path and path[-1] == ("dict", "bf") \
            else t
    leaves, _ = tree_flatten_with_path(tree)
    out = {id(x): conv(p, x) for p, x in leaves}
    return jax.tree_util.tree_map(lambda x: out[id(x)], tree)


def _bits(x) -> np.ndarray:
    """Raw bytes of a leaf from either package."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        x = x.numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _same_bits(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(x).tobytes() == _bits(y).tobytes()


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


# -- keystr ------------------------------------------------------------------


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": [2, (3, 4)], "q'x": 5, 'q"y': 6, "": 7},
    (Moments(1, {"z": 2, "y": None}, [3]),),
    OrderedDict([("z", 1), ("a", 2)]),
    defaultdict(int, {"b": 1, "a": 2}),
    {3: 1, 1: 2},
    [[], {}, None, ({"k": 1},)],
], ids=["dict_quotes", "namedtuple", "ordered", "defaultdict", "int_keys",
        "empty_and_none"])
def test_keystr_and_leaf_order_are_jax_s(tree):
    want = [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = [(keystr(p), leaf) for p, leaf in tree_flatten_with_path(tree)[0]]
    assert got == want


# -- one format both ways ----------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["npz", "packed"])
@pytest.mark.parametrize("portable", [True, False],
                         ids=["fp32_portable", "uint16_bits"])
def test_jax_saves_port_restores_and_manifests_match(tmp_path, packed,
                                                     portable):
    tree = _np_tree()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jd, _jax_tree(tree), step=3, packed=packed,
                          fp32_portable=portable,
                          data_state={"pos": [1, 2]})
    tckpt.save_checkpoint(td, _torch_tree(tree), step=3, packed=packed,
                          fp32_portable=portable,
                          data_state={"pos": [1, 2]})
    jm, tm = _manifest(jd, 3), _manifest(td, 3)
    assert jm == tm     # key for key: dtypes, shapes, paths, offsets, CRCs
    assert jm["format"] == (2 if packed else 1)
    assert {e["stored_dtype"] for e in jm["leaves"].values()
            if "stored_dtype" in e} == {
        "float32" if portable else "uint16_bits"}
    # the port restores JAX's bytes, and JAX the port's
    target = _torch_tree(tree)
    got, step = tckpt.restore_checkpoint(jd, target, verify=True)
    assert step == 3
    _same_bits(got, target)
    assert got[1].step.dtype == torch.int32
    assert got[0]["h"]["bf"].dtype == torch.bfloat16
    jgot, _ = jckpt.restore_checkpoint(td, _jax_tree(tree), verify=True)
    _same_bits(jgot, _jax_tree(tree))
    assert tckpt.load_data_state(jd) == jckpt.load_data_state(td) == {
        "pos": [1, 2]}


def test_restore_without_target_gives_jax_nested_dict(tmp_path):
    tree = _np_tree(1)
    d = str(tmp_path / "c")
    jckpt.save_checkpoint(d, _jax_tree(tree), step=1)
    jgot, _ = jckpt.restore_checkpoint(d)
    tgot, _ = tckpt.restore_checkpoint(d)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, jgot)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0,
                                                            tgot))
    _same_bits(tgot, jgot)
    assert tgot["0"]["h"]["bf"].dtype == torch.bfloat16
    assert tgot["1"]["step"].dtype == torch.int32


def test_restore_casts_to_the_target_dtype_and_device(tmp_path):
    tree = _np_tree(2)
    d = str(tmp_path / "c")
    jckpt.save_checkpoint(d, _jax_tree(tree), step=1)
    # a bf16 O2 checkpoint restores into fp32 (precision portability);
    # meta target leaves describe shape and dtype only
    target = jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, dtype=torch.float64, device="meta"),
        tree)
    got, _ = tckpt.restore_checkpoint(d, target)
    jgot, _ = jckpt.restore_checkpoint(
        d, jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                  tree))
    for g, j in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jgot)):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_train_state_round_trips_with_jax_s(tmp_path):
    tree = _np_tree(3, half=False)
    jstate = jckpt.TrainState.create(_jax_tree(tree[0]), _jax_tree(tree[1]),
                                     step=9)
    tstate = tckpt.TrainState.create(_torch_tree(tree[0]),
                                     _torch_tree(tree[1]), step=9)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(jd, jstate, step=9)
    tckpt.save_checkpoint(td, tstate, step=9)
    assert _manifest(jd, 9) == _manifest(td, 9)
    got, _ = tckpt.restore_checkpoint(jd, tstate)
    assert isinstance(got, tckpt.TrainState) and int(got.step) == 9
    _same_bits(got.params, tstate.params)


# -- the sharded formats, restored onto one card -----------------------------


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), names)


def test_port_restores_format_3_from_the_8_device_mesh(tmp_path):
    mesh = _mesh((8,), ("data",))
    rng = np.random.RandomState(4)
    w = rng.randn(16).astype(np.float32)
    m = rng.randn(8, 32).astype(np.float32)
    state = ({"w": jax.device_put(w, NamedSharding(mesh, P()))},
             {"step": jax.device_put(np.full((8,), 5, np.int32),
                                     NamedSharding(mesh, P("data"))),
              "exp_avg": jax.device_put(m, NamedSharding(mesh, P("data")))})
    d = str(tmp_path / "c")
    jckpt.save_checkpoint(d, state, step=2, shardings=(P(), P("data")),
                          shard_axis="data")
    assert _manifest(d, 2)["format"] == 3
    # the whole stack onto one card: 8 -> 1 by the flat contract
    target = ({"w": torch.zeros(16)},
              {"step": torch.zeros(1, dtype=torch.int32),
               "exp_avg": torch.zeros(1, 256)})
    (p, o), step = tckpt.restore_checkpoint(d, target, verify=True)
    assert step == 2
    assert torch.equal(p["w"], torch.from_numpy(w))
    assert o["step"].tolist() == [5]
    assert torch.equal(o["exp_avg"], torch.from_numpy(m.reshape(1, 256)))
    # without a target: the stored stack, as JAX restores it
    raw, _ = tckpt.restore_checkpoint(d)
    assert torch.equal(raw["1"]["exp_avg"], torch.from_numpy(m))
    # one damaged shard file condemns the step
    jchaos.corrupt_shard(d, 2, 3)
    with pytest.raises(tckpt.CheckpointCorruptionError):
        tckpt.restore_checkpoint(d, target, verify=True)


def test_port_restores_format_4_from_the_8_device_mesh(tmp_path):
    mesh = _mesh((4, 2), ("data", "tensor"))
    rng = np.random.RandomState(5)
    a = rng.randn(4, 2, 16).astype(np.float32)
    t = rng.randn(2, 8).astype(np.float32)
    state = {"a": jax.device_put(a, NamedSharding(mesh, P("data", "tensor"))),
             "t": jax.device_put(t, NamedSharding(mesh, P("tensor"))),
             "step": jax.device_put(np.full((4, 2), 3, np.int32),
                                    NamedSharding(mesh, P("data", "tensor"))),
             "r": jnp.asarray(rng.randn(5).astype(np.float32))}
    specs = {"a": P("data", "tensor"), "t": P("tensor"),
             "step": P("data", "tensor"), "r": P()}
    d = str(tmp_path / "c")
    jckpt.save_checkpoint(d, state, step=4, shardings=specs,
                          shard_axes={"data": 4, "tensor": 2})
    man = _manifest(d, 4)
    assert man["format"] == 4
    assert any(n.startswith("shard_3_1") for n in os.listdir(
        jckpt.step_dir(d, 4)))
    target = {"a": torch.zeros(1, 1, 128), "t": torch.zeros(1, 16),
              "step": torch.zeros(1, 1, dtype=torch.int32),
              "r": torch.zeros(5)}
    got, _ = tckpt.restore_checkpoint(d, target, verify=True)
    jgot, _ = jckpt.restore_checkpoint(
        d, jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype.name),
                                  {k: v.numpy() for k, v in target.items()}),
        verify=True)
    for k in target:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]))
    assert torch.equal(got["a"].reshape(-1), torch.from_numpy(a.reshape(-1)))
    assert got["step"].item() == 3


# -- faults: corrupt, truncated, flaky storage -------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["npz", "packed"])
@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_damaged_arrays_raise_as_in_jax(tmp_path, packed, mode):
    tree = _np_tree(6)
    d = str(tmp_path / "c")
    jckpt.save_checkpoint(d, _jax_tree(tree), step=1, packed=packed)
    tchaos.corrupt_arrays(d, 1, mode=mode)
    with pytest.raises(jckpt.CheckpointCorruptionError):
        jckpt.verify_checkpoint(d, 1)
    with pytest.raises(tckpt.CheckpointCorruptionError):
        tckpt.verify_checkpoint(d, 1)
    with pytest.raises(tckpt.CheckpointCorruptionError):
        tckpt.restore_checkpoint(d, _torch_tree(tree), verify=True)


def test_flipped_packed_leaf_names_that_leaf(tmp_path):
    tree = _np_tree(7)
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, _torch_tree(tree), step=1, packed=True)
    key = "[0]['layers'][1]"
    tchaos.flip_packed_leaf_byte(d, 1, key)
    for mod in (jckpt, tckpt):
        with pytest.raises(
                mod.CheckpointCorruptionError,
                match=r"CRC32 mismatch for \"\[0\]\['layers'\]\[1\]\"") as e:
            mod.verify_checkpoint(d, 1)
        assert str(e.value).count("CRC32 mismatch") == 1


def test_truncated_marker_and_tmp_leftovers_are_tolerated(tmp_path):
    d = str(tmp_path / "c")
    tree = _torch_tree(_np_tree(8, half=False))
    tckpt.save_checkpoint(d, tree, step=1)
    tckpt.save_checkpoint(d, tree, step=2)
    os.makedirs(os.path.join(d, "step_0000000003.tmp"))
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("")
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 2


@pytest.mark.parametrize("fail_times,attempts,ok", [
    (2, 3, True), (None, 3, False), (1, 1, False)],
    ids=["retried", "always_failing", "no_retry"])
def test_faulty_store_retries_as_in_jax(tmp_path, fail_times, attempts, ok):
    tree = _np_tree(9)
    outcomes = []
    for mod, chaos, tr in ((jckpt, jchaos, _jax_tree(tree)),
                           (tckpt, tchaos, _torch_tree(tree))):
        d = str(tmp_path / mod.__name__)
        with chaos.FaultyStore(fail_events=("write_arrays",),
                               fail_times=fail_times) as store:
            try:
                mod.save_checkpoint(d, tr, step=1, retry=mod.RetryPolicy(
                    max_attempts=attempts, base_delay=0.0))
                outcomes.append(("ok", store.failures_injected,
                                 mod.latest_step(d)))
            except chaos.InjectedStorageError:
                outcomes.append(("raised", store.failures_injected,
                                 mod.latest_step(d)))
        assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1][0] == "ok") == ok


def test_failed_async_write_raises_at_the_fence(tmp_path):
    d = str(tmp_path / "c")
    with tchaos.FaultyStore(fail_events=("commit",), fail_times=None):
        tckpt.save_checkpoint(d, _torch_tree(_np_tree(10)), step=1,
                              blocking=False)
        from apex_tpu_torch.resilience import AsyncSaveError
        with pytest.raises(AsyncSaveError):
            tasync.wait_for_save()
    assert tckpt.latest_step(d) is None


def test_restore_resilient_falls_back_across_packages(tmp_path):
    """JAX writes steps 1-3, step 3 is damaged: the port warns and
    restores step 2, as JAX does; all damaged raises."""
    d = str(tmp_path / "c")
    trees = {s: _np_tree(20 + s) for s in (1, 2, 3)}
    for s, tree in trees.items():
        jckpt.save_checkpoint(d, _jax_tree(tree), step=s)
    tchaos.corrupt_arrays(d, 3)
    target = _torch_tree(trees[1])
    with pytest.warns(trestore.CheckpointFallbackWarning):
        got, step = trestore.restore_resilient(d, target)
    with pytest.warns(jrestore.CheckpointFallbackWarning):
        _, jstep = jrestore.restore_resilient(d, _jax_tree(trees[1]))
    assert step == jstep == 2
    _same_bits(got, _torch_tree(trees[2]))
    for s in (1, 2):
        tchaos.corrupt_arrays(d, s)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(tckpt.CheckpointCorruptionError,
                           match="no intact checkpoint"):
            trestore.restore_resilient(d, target)


def test_structure_mismatch_raises_key_error_not_fallback(tmp_path):
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, _torch_tree(_np_tree(11)), step=1)
    with pytest.raises(KeyError, match="missing 1 leaves"):
        trestore.restore_resilient(d, {"nope": torch.zeros(1)})


# -- the port's own contracts ------------------------------------------------


def test_async_save_holds_the_bytes_from_before_the_call(tmp_path):
    """``blocking=False`` copies every tensor before it returns: an
    in-place update right after (the optimizer's next step) does not
    reach the checkpoint, even while the write is slowed."""
    tree = _torch_tree(_np_tree(12))
    want = jax.tree_util.tree_map(lambda t: t.clone(), tree)
    d = str(tmp_path / "c")
    with tchaos.slow_writer(0.3):
        tckpt.save_checkpoint(d, tree, step=1, blocking=False)
        assert tasync.in_flight()
        for t in jax.tree_util.tree_leaves(tree):
            t.add_(1)
        tasync.wait_for_save()
    got, _ = tckpt.restore_checkpoint(d, want, verify=True)
    _same_bits(got, want)


def test_keep_prunes_and_collisions_and_sharded_saves_refuse(tmp_path):
    d = str(tmp_path / "c")
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3):
        tckpt.save_checkpoint(d, tree, step=s, keep=2)
    assert sorted(os.listdir(d)) == ["latest", "step_0000000002",
                                     "step_0000000003"]
    with pytest.raises(ValueError, match="path collision"):
        tckpt.save_checkpoint(d, OrderedDict([(0, torch.ones(1)),
                                              ("0", torch.ones(1))]),
                              step=4)
    # a sharded save names its per-rank leaves through shardings (JAX's
    # refusal); sharded saves themselves are tests/test_torch_elastic.py's
    with pytest.raises(ValueError, match="requires shardings"):
        tckpt.save_checkpoint(d, tree, step=5, shard_axis="data")
    with pytest.raises(ValueError, match="npz-only"):
        tckpt.save_checkpoint(d, tree, step=5, shard_axis="data",
                              shardings=TP(), packed=True)
    with pytest.raises(ValueError, match="JSON"):
        tckpt.save_checkpoint(d, tree, step=6, data_state={"x": object()})
