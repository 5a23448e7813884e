"""The port's data parallelism against the JAX package's: the gradient
all-reduce's semantics table, ``broadcast_params``,
``DistributedDataParallel`` and ``Reducer``, the model-parallel
``GradScaler``'s overflow verdict, the simple DDP example, the launcher
and the refusal of NCCL for ranks that share a card.

The port's ranks are processes (gloo on a ``file://`` store, rank bodies
in ``tests/torch_ranks.py``); JAX runs the same reductions inside
``shard_map`` over a data axis of the emulated mesh.  Inputs are seeded
numpy arrays given to both.

Tolerances: the reductions of two fp32 values, their division by a power
of two and the broadcast are exact (bitwise); a bf16 gradient reduced in
fp32 and cast back is bitwise too.  The DDP example trains a linear
model in bf16 (amp O2): its final loss within 1e-2 x the loss of JAX's,
2.5 bf16 spacings (2^-8) relative (read 3.6e-3: XLA's bf16 matmul on the
CPU and PyTorch's round differently within a step, and twenty steps of
SGD keep the gap at the bf16 scale).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel import all_reduce_grads as jax_all_reduce_grads
from apex_tpu.transformer.amp import GradScaler as JGradScaler
from apex_tpu_torch.parallel.multiproc import initialize_distributed, spawn

import torch_ranks

WORLD = 2
OPTIONS = (
    ("mean", {}),
    ("sum", {"gradient_average": False}),
    ("predivide", {"gradient_predivide_factor": 2.0}),
    ("predivide_sum", {"gradient_average": False,
                       "gradient_predivide_factor": 2.0}),
    ("fp32", {"allreduce_always_fp32": True}),
    ("fp32_predivide", {"allreduce_always_fp32": True,
                        "gradient_predivide_factor": 2.0}),
)
DTYPES = {"w": "float32", "b": "bfloat16"}


def _grads():
    r = np.random.RandomState(0)
    return {"w": r.standard_normal((WORLD, 4, 3)).astype(np.float32),
            # bf16-representable values: the fp32 array is exact in bf16
            "b": torch.from_numpy(r.standard_normal((WORLD, 5)).astype(
                np.float32)).bfloat16().float().numpy()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    case = {"grads": _grads(), "dtypes": DTYPES, "options": OPTIONS}
    spawn(torch_ranks.distributed_checks, WORLD, str(out / "store"),
          str(out), case)
    return torch_ranks.load_ranks(str(out), WORLD)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def _jax_reduce(kw):
    g = _grads()
    tree = {"w": jnp.asarray(g["w"]),
            "b": jnp.asarray(g["b"]).astype(jnp.bfloat16)}
    out = shard_map(lambda t: jax.tree_util.tree_map(
        lambda a: a[None], jax_all_reduce_grads(
            jax.tree_util.tree_map(lambda a: a[0], t), "data", **kw)),
        mesh=_mesh(), in_specs=P("data"), out_specs=P("data"),
        check_vma=False)(tree)
    return jax.tree_util.tree_map(np.asarray, out)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name,kw", OPTIONS, ids=[o[0] for o in OPTIONS])
def test_all_reduce_grads_semantics_table(ranks, name, kw):
    """Each option set gives JAX's values bitwise on every rank, in the
    gradient's own dtype (the bf16 leaf comes back bf16)."""
    want = _jax_reduce(kw)
    for r, res in enumerate(ranks):
        got = res["table"][name]
        assert got["b"].dtype == torch.bfloat16
        assert got["w"].dtype == torch.float32
        for k in ("w", "b"):
            np.testing.assert_array_equal(_np(got[k]),
                                          np.asarray(want[k][r], np.float32))


def test_broadcast_params(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["broadcast"][0], np.ones(3))
        np.testing.assert_array_equal(res["broadcast"][1], np.arange(4.0))


def test_distributed_data_parallel_and_reducer(ranks):
    """DDP is all_reduce_grads with its options; the Reducer averages."""
    for res in ranks:
        call, reduce = res["ddp"]
        for k in ("w", "b"):
            np.testing.assert_array_equal(_np(call[k]),
                                          _np(res["table"]["fp32_predivide"][k]))
            np.testing.assert_array_equal(_np(reduce[k]), _np(call[k]))
            np.testing.assert_array_equal(_np(res["reducer"][k]),
                                          _np(res["table"]["mean"][k]))


def test_grad_scaler_found_inf_agrees_across_tp(ranks):
    """One rank's inf makes every tp rank skip, as JAX's pmax verdict."""
    for res in ranks:
        ok, bad = res["found_inf"]
        assert not bool(ok) and bool(bad)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("tensor",))
    g = np.ones((WORLD, 2), np.float32)
    g[WORLD - 1, 1] = np.inf
    verdict = shard_map(lambda x: JGradScaler().found_inf(x)[None],
                        mesh=mesh, in_specs=P("tensor"),
                        out_specs=P("tensor"), check_vma=False)(g)
    assert np.asarray(verdict).tolist() == [True] * WORLD


def test_simple_ddp_example_against_jax(tmp_path, monkeypatch, capsys):
    """The port's example and the JAX example on the same weights and
    global batch (the JAX example's own draws, over two devices)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "examples", "simple", "distributed"))
    try:
        import distributed_data_parallel as jex
    finally:
        sys.path.pop(0)
    real = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: real(*a, **k)[:WORLD])
    jex.main()
    want = float(capsys.readouterr().out.strip().splitlines()[-1].split()[-1])
    key = jax.random.PRNGKey(0)
    case = {"params": {"w": np.asarray(jax.random.normal(key, (16, 4))),
                       "b": np.zeros(4, np.float32)},
            "x": np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                              (8 * WORLD, 16))),
            "y": np.asarray(jax.random.normal(jax.random.fold_in(key, 2),
                                              (8 * WORLD, 4)))}
    spawn(torch_ranks.ddp_example, WORLD, str(tmp_path / "store"),
          str(tmp_path), case)
    got = [res["loss"] for res in torch_ranks.load_ranks(str(tmp_path),
                                                         WORLD)]
    assert got[0] == got[1]
    assert abs(got[0] - want) <= 1e-2 * want, (got, want)


def test_nccl_refused_for_ranks_that_share_a_card():
    """NCCL with more ranks than cards raises and names gloo; the
    backend is never switched."""
    with pytest.raises(RuntimeError, match="gloo"):
        initialize_distributed("nccl", "file:///nonexistent", rank=0,
                               world_size=2)


def test_launcher_starts_ranks_and_reports_a_failure(tmp_path):
    """python -m apex_tpu_torch.parallel.multiproc starts --nproc ranks
    with RANK/WORLD_SIZE set and exits non-zero when one fails."""
    script = tmp_path / "rank.py"
    script.write_text(
        "import os, sys\n"
        "open(os.path.join(sys.argv[1], os.environ['RANK'] + '-' +\n"
        "     os.environ['WORLD_SIZE']), 'w').close()\n"
        "sys.exit(3 if sys.argv[2] == os.environ['RANK'] else 0)\n")
    run = lambda fail: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nproc", "2", str(script), str(tmp_path), fail],
        cwd=os.path.join(os.path.dirname(__file__), os.pardir),
        capture_output=True, text=True, timeout=120)
    assert run("none").returncode == 0
    assert sorted(os.listdir(tmp_path)) == ["0-2", "1-2", "rank.py"]
    assert run("1").returncode == 3


def test_rank_bodies_import_neither_jax_nor_apex_tpu():
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_ranks, "
            "apex_tpu_torch.examples.simple.distributed."
            "distributed_data_parallel, apex_tpu_torch.parallel.multiproc, "
            "apex_tpu_torch.parallel.distributed, apex_tpu_torch.parallel."
            "comm, apex_tpu_torch.transformer.amp, apex_tpu_torch."
            "transformer.parallel_state, apex_tpu_torch.transformer."
            "tensor_parallel.data; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'apex_tpu', 'bench')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.join(os.path.dirname(__file__), os.pardir))
    assert r.returncode == 0, r.stdout + r.stderr
