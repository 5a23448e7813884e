"""The ImageNet example data-parallel (``--n-devices 2``, with and without
``--sync_bn``) and a dp 2 ResNet trajectory, the port against the JAX
package.

The ranks are one launch of two gloo processes (rank body
``tests/torch_ranks.py::imagenet_dp_runs``); JAX's example and
``tests/L1/common/harness.py::run_trajectory`` run in the test process
meanwhile, on two devices of the emulated mesh, from the same initial
weights (the JAX init, converted) and the same global batches.  Held:

* ``main_amp --n-devices 2`` at O0 (momentum SGD) against the JAX
  example at ``--n-devices 2``: every step's loss (the ranks' mean), and
  the batch norms' running statistics that rank 0 keeps, evaluates and
  saves.  Without ``--sync_bn`` those are rank 0's own (device 0's in the
  JAX example, whose ``out_specs=P()`` under ``check_rep=False`` returns
  that device's), not rank 1's; with it they are the pooled ones.
* The cross-world resume: a checkpoint taken at world 2 resumed at world
  1, and one taken at world 1 resumed at world 2, each against the JAX
  example doing the same.
* ``run_trajectory(n_devices=2)``'s ResNet cell (SyncBN over the data
  axis, the gradients' mean) at O0 momentum SGD and at O2 LAMB with a
  dynamic scale; run twice in the ranks, bitwise the same.

Tolerances: the example's losses as both print them (four decimals), one
unit of the last (1e-4; every printed loss read equal); its running
statistics 1e-5 x max(1, max|ref|) (fp32 sums over the rows and the
ranks in another order; read 3.6e-7); the trajectories as the one-device
cells in tests/test_torch_resnet.py (O0 SGD 1e-6 relative: read 1.1e-7;
O2 LAMB 2e-2 absolute on losses near 2.3, bf16 convolutions in two
libraries: read 2.0e-3).  Step 0's loss at dp 2 is not held bitwise to
world 1's: the batch's fp32 sums split over two ranks round otherwise
than one sum (ROADMAP.md queue C).
"""

import contextlib
import io
import re
import threading

import numpy as np
import pytest
import torch

from apex_tpu_torch.examples.imagenet import main_amp as tmain
from apex_tpu_torch.models import resnet_state_dict_from_jax
from apex_tpu_torch.parallel.multiproc import spawn
from tests.L1.common.harness import RunConfig, _resnet_batch, run_trajectory
from tests.test_torch_resnet import (ARGS, O2_TRAJ_ATOL, SGD_TRAJ_RTOL,
                                     TINY, _jax_example, jax_init)

import torch_ranks

WORLD = 2
# every step's loss printed
RUN = ARGS[:ARGS.index("--print-freq")] + ["--print-freq", "1", "--lr",
                                           "0.01", "--opt-level", "O0"]
EXAMPLE_ATOL = 1e-4
BN_TOL = 1e-5
TRAJ = {"o0_sgd": dict(opt_level="O0", optimizer="sgd", loss_scale=1.0),
        "o2_lamb": dict(opt_level="O2", optimizer="lamb",
                        loss_scale="dynamic")}
LOSS_RE = re.compile(r"Loss (\S+) \(")


def _losses(text):
    return [float(v) for v in LOSS_RE.findall(text)]


def _argv(epochs, *extra):
    return RUN + ["--epochs", str(epochs)] + list(extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and JAX's, from one launch of ranks with JAX
    running beside it."""
    tmp = tmp_path_factory.mktemp("imagenet_dp")
    d = {k: str(tmp / k) for k in ("port1", "port2", "jax1", "jax2")}
    jmod = _jax_example()
    args = jmod.parse_args(_argv(2))
    params, state = jax_init(args.seed)
    sd = resnet_state_dict_from_jax(params, state)
    jbatch = jmod.make_batcher(args)
    batches = {(e, s, True): tuple(np.asarray(a) for a in jbatch(e, s, True))
               for e in range(2) for s in range(args.steps_per_epoch)}
    batches.update({(0, s, False): tuple(np.asarray(a) for a in
                                         jbatch(0, s, False))
                    for s in range(args.eval_steps)})

    def batcher(epoch, step, train=True):
        x, y = batches[(epoch, step, train)]
        return torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y)).long()

    # the world-1 checkpoint the ranks resume from
    port = {"w1_save": tmain.main(_argv(1, "--save-dir", d["port1"]),
                                  device="cpu", state_dict=sd,
                                  batcher=batcher)}
    traj_x = [tuple(np.asarray(a) for a in _resnet_batch(i, 0))
              for i in range(12)]
    case = dict(
        state_dict={k: v.numpy() for k, v in sd.items()}, batches=batches,
        runs={"plain": _argv(1, "--n-devices", "2", "--save-dir",
                             d["port2"]),
              "sync": _argv(1, "--n-devices", "2", "--sync_bn"),
              "resume_from_w1": _argv(2, "--n-devices", "2", "--resume",
                                      d["port1"])},
        tiny=TINY, traj_sd={k: v.numpy() for k, v in sd.items()},
        traj_batches=traj_x, trajectories=TRAJ)
    out = tmp / "ranks"
    out.mkdir()
    failed = []

    def launch():
        try:
            spawn(torch_ranks.imagenet_dp_runs, WORLD, str(out / "store"),
                  str(out), case)
        except BaseException as e:  # raised in the test process below
            failed.append(e)

    th = threading.Thread(target=launch)
    th.start()
    try:
        jax_runs = {}
        for name, argv in (
                ("plain", _argv(1, "--n-devices", "2", "--save-dir",
                                d["jax2"])),
                ("sync", _argv(1, "--n-devices", "2", "--sync_bn")),
                ("resume_from_w2", _argv(2, "--resume", d["jax2"])),
                ("w1_save", _argv(1, "--save-dir", d["jax1"])),
                ("resume_from_w1", _argv(2, "--n-devices", "2", "--resume",
                                         d["jax1"]))):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                st = jmod.main(argv)
            jax_runs[name] = {"out": text.getvalue(), "state": st}
        ref_traj = {name: run_trajectory(RunConfig(
            model="resnet", n_devices=2, **cfg)) for name, cfg in TRAJ.items()}
    finally:
        th.join()
    if failed:
        raise failed[0]
    ranks = torch_ranks.load_ranks(str(out), WORLD)
    # a checkpoint the ranks wrote, resumed at world 1
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        tmain.main(_argv(2, "--resume", d["port2"]), device="cpu",
                   state_dict=sd, batcher=batcher)
    port["resume_from_w2"] = text.getvalue()
    return dict(ranks=ranks, jax=jax_runs, port=port, ref_traj=ref_traj)


def _jax_bn(st):
    """The JAX example's batch-norm statistics under the port's names."""
    sd = resnet_state_dict_from_jax(st.params, st.model_state)
    return {k: v.numpy() for k, v in sd.items()
            if k.endswith((".mean", ".var"))}


@pytest.mark.parametrize("name", ["plain", "sync"])
def test_example_at_two_ranks_matches_jax(runs, name):
    got = runs["ranks"][0][name]["out"]
    want = runs["jax"][name]["out"]
    assert runs["ranks"][1][name]["out"] == ""       # rank 0 prints
    for out in (got, want):
        assert "Prec@1" in out and "img/s" in out
    gl, jl = _losses(got), _losses(want)
    assert len(gl) == len(jl) == 6
    np.testing.assert_allclose(gl, jl, rtol=0, atol=EXAMPLE_ATOL)
    assert runs["ranks"][0][name]["step"] == 6


@pytest.mark.parametrize("name", ["plain", "sync"])
def test_example_keeps_the_batch_norm_state_jax_keeps(runs, name):
    """Without --sync_bn rank 0 keeps its own running statistics (JAX's
    device 0's) and rank 1 others; with it both hold the pooled ones."""
    want = _jax_bn(runs["jax"][name]["state"])
    mine = [runs["ranks"][r][name]["model_state"] for r in range(WORLD)]
    for k, ref in want.items():
        got = mine[0][k].numpy()
        err = float(np.abs(got - ref).max()) / max(1.0,
                                                    float(np.abs(ref).max()))
        assert err <= BN_TOL, (k, err)
    differ = [k for k in want if not np.allclose(mine[1][k].numpy(), want[k],
                                                 atol=1e-3)]
    if name == "plain":
        assert differ, "rank 1's own statistics equal rank 0's"
    else:
        assert not differ
        assert all(torch.equal(mine[0][k], mine[1][k]) for k in want)


@pytest.mark.parametrize("direction", ["resume_from_w2", "resume_from_w1"])
def test_checkpoints_resume_across_worlds(runs, direction):
    """A world-2 checkpoint resumed at world 1, a world-1 one at world 2:
    epoch 1 continues as the JAX example continues it."""
    got = (runs["port"][direction] if direction == "resume_from_w2"
           else runs["ranks"][0][direction]["out"])
    want = runs["jax"][direction]["out"]
    for out in (got, want):
        assert "resumed from" in out and "(epoch 0)" in out
        assert "Epoch: [1]" in out and "Epoch: [0]" not in out
    gl, jl = _losses(got), _losses(want)
    assert len(gl) == len(jl) == 6
    np.testing.assert_allclose(gl, jl, rtol=0, atol=EXAMPLE_ATOL)


@pytest.mark.parametrize("name", sorted(TRAJ))
def test_dp2_trajectory_matches_run_trajectory_and_reruns_bitwise(runs,
                                                                  name):
    ref = runs["ref_traj"][name]
    first, again = runs["ranks"][0][("traj", name)]
    assert first == again                       # a rerun is bitwise
    assert runs["ranks"][1][("traj", name)] == [first, again]
    if name == "o0_sgd":
        np.testing.assert_allclose(first, ref, rtol=SGD_TRAJ_RTOL)
    else:
        np.testing.assert_allclose(first, ref, atol=O2_TRAJ_ATOL)
    assert first[-2] < first[0] and first[-1] < first[1]
