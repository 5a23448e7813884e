"""The port's ``pretrain_gpt`` across a restart: checkpoints that pass
between the JAX example and the port's, real token shards, preemption,
the watchdog and the telemetry stream.

A toy GPT (2 layers, hidden 64, 2 heads, seq 16, vocab 128, fp32, no
dropout) on raw ``--data-path`` shards written from a seed with numpy.
The JAX example runs in process as ``tests/L1/test_gpt_example.py`` runs
it; under the 8 emulated devices it is data-parallel over 8, so its
global batch is ``--micro-batch-size 1`` x 8, and the port's run takes
``--micro-batch-size 8``: both read the same records.

- JAX to port: the JAX example trains 3 steps and saves; the port's
  ``pretrain_gpt`` loads that checkpoint (``--load``) and its losses at
  steps 4-6 match the JAX example's own resumed run within the toy GPT's
  fp32 bar of ``tests/test_torch_gpt.py`` (1e-5 x max(1, |loss|)).
- Port to JAX: the reverse, with the same bar; the two examples' step-3
  checkpoints hold the same leaves and the same ``data_state``.
- Port to port: a run preempted by a real SIGTERM and resumed equals the
  uninterrupted run bitwise (losses and final weights), on checksummed
  ``--data-dir`` shards and on synthetic tokens; a corrupt newest
  checkpoint falls back with a warning and still resumes bitwise.
"""

import glob
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch.data import write_checksummed_records, write_records
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.resilience import CheckpointFallbackWarning
from apex_tpu_torch.resilience.chaos import (SimulatedPreemption,
                                             corrupt_arrays)
from apex_tpu_torch.telemetry import load_jsonl, validate_events

REPO = Path(__file__).resolve().parent.parent
JAX_EXAMPLE = REPO / "examples" / "gpt"
FP32_TOL = 1e-5         # tests/test_torch_gpt.py's bar on fp32 losses
S, VOCAB, GLOBAL_BATCH = 16, 128, 8

TOY = ["--num-layers", "2", "--hidden-size", "64", "--num-attention-heads",
       "2", "--seq-length", str(S), "--max-position-embeddings", str(S),
       "--vocab-size", str(VOCAB), "--attention-dropout", "0",
       "--hidden-dropout", "0", "--lr", "1e-2", "--log-interval", "1"]
PORT = ["--micro-batch-size", str(GLOBAL_BATCH)]
JAX = ["--micro-batch-size", "1"]     # x 8 emulated devices


@pytest.fixture(scope="module")
def jax_example():
    import jax

    assert len(jax.devices()) == GLOBAL_BATCH
    sys.path.insert(0, str(JAX_EXAMPLE))
    import pretrain_gpt as jdrv
    yield jdrv
    sys.path.remove(str(JAX_EXAMPLE))


def _ids(seed, n):
    return np.random.RandomState(seed).randint(
        0, 2 ** 31, (n, S + 1)).astype(np.uint32)


@pytest.fixture(scope="module")
def raw_shards(tmp_path_factory):
    """Two raw shards of uint32 records of S + 1 ids (the --data-path
    format), 56 records: seven steps of 8."""
    d = tmp_path_factory.mktemp("raw")
    paths = []
    for k, n in enumerate((30, 26)):
        p = str(d / f"tokens_{k}.bin")
        write_records(p, _ids(k, n).view(np.uint8).reshape(n, -1))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def crc_dir(tmp_path_factory):
    """A --data-dir of three checksummed shards."""
    d = tmp_path_factory.mktemp("crc")
    for k, n in enumerate((20, 20, 16)):
        rows = _ids(10 + k, n).view(np.uint8).reshape(n, -1)
        write_checksummed_records(str(d / f"tokens_{k}.bin"), rows)
    return str(d)


def _port(argv, **kw):
    """The port's ``pretrain_gpt`` on the CPU: its per-step losses
    {step: loss} and the final weights."""
    losses, final = {}, {}
    user = kw.pop("on_step", None)

    def record(it, loss, model):
        losses[it + 1] = float(loss)
        final.update({k: v.detach().clone()
                      for k, v in model.state_dict().items()})
        if user is not None:
            user(it, loss, model)

    ret = pretrain_gpt.main(TOY + PORT + argv, device="cpu", on_step=record,
                            **kw)
    return losses, final, ret


def _jax_losses(stream):
    """{step: loss} from the JAX example's telemetry stream (a window of
    one step: every step event carries its loss)."""
    out = {}
    for line in open(stream):
        e = json.loads(line)
        if e["type"] == "step":
            out[e["step"]] = e["scalars"]["loss"]
    return out


def _close(got, want):
    assert sorted(got) == sorted(want)
    for s in want:
        assert abs(got[s] - want[s]) <= FP32_TOL * max(1.0, abs(want[s])), (
            s, got[s], want[s])


@pytest.fixture(scope="module")
def jax_run(jax_example, raw_shards, tmp_path_factory):
    """The JAX example: 3 steps saved, then its own resumed run to 6."""
    d = tmp_path_factory.mktemp("jax")
    ck = str(d / "ckpt")
    jax_example.main(TOY + JAX + ["--data-path", *raw_shards,
                                 "--train-iters", "3", "--save", ck])
    jax_example.main(TOY + JAX + ["--data-path", *raw_shards,
                                 "--train-iters", "6", "--load", ck,
                                 "--telemetry-dir", str(d / "tele")])
    return ck, _jax_losses(str(d / "tele" / "pretrain_gpt.jsonl"))


def test_jax_checkpoint_resumes_in_the_port(jax_run, raw_shards):
    ck, want = jax_run
    assert sorted(want) == [4, 5, 6]
    got, _, _ = _port(["--data-path", *raw_shards, "--train-iters", "6",
                       "--load", ck])
    _close(got, want)


def test_port_checkpoint_resumes_in_the_jax_example(jax_example, jax_run,
                                                   raw_shards, tmp_path):
    ck = str(tmp_path / "ckpt")
    flags = ["--data-path", *raw_shards, "--train-iters", "3", "--save", ck]
    _port(flags)
    # the port's step-3 checkpoint is the JAX example's tree and position
    jck, _ = jax_run
    mine = json.load(open(os.path.join(tckpt.step_dir(ck, 3),
                                       "manifest.json")))
    theirs = json.load(open(os.path.join(tckpt.step_dir(jck, 3),
                                         "manifest.json")))
    assert mine["data_state"] == theirs["data_state"]
    assert {k: (e["shape"], e["dtype"], e["path"])
            for k, e in mine["leaves"].items()} == {
        k: (e["shape"], e["dtype"], e["path"])
        for k, e in theirs["leaves"].items()}
    port_resumed, _, _ = _port(["--data-path", *raw_shards,
                                "--train-iters", "6", "--load", ck])
    tele = str(tmp_path / "tele")
    jax_example.main(TOY + JAX + ["--data-path", *raw_shards, "--train-iters",
                                 "6", "--load", ck, "--telemetry-dir", tele])
    _close(port_resumed, _jax_losses(os.path.join(tele,
                                                  "pretrain_gpt.jsonl")))


@pytest.mark.parametrize("data", ["data_dir", "synthetic"])
def test_preempted_run_resumes_bitwise(crc_dir, tmp_path, data):
    flags = ["--train-iters", "6"] + (
        ["--data-dir", crc_dir] if data == "data_dir" else [])
    straight, w_straight, _ = _port(flags)
    ck, tele = str(tmp_path / "ckpt"), str(tmp_path / "tele")
    preempt = SimulatedPreemption(3)
    first, _, ret = _port(flags + [
        "--save", ck, "--save-interval", "2", "--telemetry-dir", tele,
        "--watchdog-timeout", "60"], on_step=lambda *a: preempt.poll())
    assert preempt.fired and ret == first[3]
    assert sorted(first) == [1, 2, 3]
    assert [s for s in range(7) if os.path.isdir(tckpt.step_dir(ck, s))] \
        == [2, 3]
    assert (tckpt.load_data_state(ck, 3) is None) == (data == "synthetic")
    second, w_second, _ = _port(flags + ["--load", ck])
    assert {**first, **second} == straight
    assert all(torch.equal(w_second[k], w_straight[k]) for k in w_straight)

    events = load_jsonl(os.path.join(tele, "pretrain_gpt.jsonl"))
    assert validate_events(events) == len(events)
    kinds = [e["type"] for e in events]
    assert kinds[0] == "run_start" and kinds.count("step") == 3
    saves = [e for e in events if e["type"] == "ckpt_save"]
    assert [(e["step"], e["blocking"]) for e in saves] == [(2, False),
                                                           (3, True)]
    assert all(e["wall_ms"] > 0 for e in saves)
    end = events[-1]
    assert end["type"] == "run_end" and end["reason"] == "SIGTERM"
    assert end["buckets_s"]["ckpt_fence"] > 0
    post = [e for e in events if e["type"] == "postmortem"]
    assert [e["reason"] for e in post] == ["SIGTERM"]
    assert validate_events(load_jsonl(post[0]["path"])) > 1


def test_corrupt_newest_checkpoint_falls_back_and_resumes_bitwise(
        crc_dir, tmp_path):
    flags = ["--data-dir", crc_dir, "--train-iters", "5"]
    straight, w_straight, _ = _port(flags)
    ck = str(tmp_path / "ckpt")
    _port(["--data-dir", crc_dir, "--train-iters", "4", "--save", ck,
           "--save-interval", "2"])
    corrupt_arrays(ck, 4)
    tele = str(tmp_path / "tele")
    with pytest.warns(CheckpointFallbackWarning):
        resumed, w, _ = _port(flags + ["--load", ck, "--telemetry-dir",
                                       tele])
    assert resumed == {s: straight[s] for s in (3, 4, 5)}
    assert all(torch.equal(w[k], w_straight[k]) for k in w_straight)
    restore = [e for e in load_jsonl(os.path.join(tele, "pretrain_gpt.jsonl"))
               if e["type"] == "ckpt_restore"]
    assert [e["step"] for e in restore] == [2]


def test_streaming_resume_needs_the_data_position(crc_dir, tmp_path):
    ck = str(tmp_path / "ckpt")
    _port(["--train-iters", "2", "--save", ck])     # synthetic: no position
    with pytest.raises(SystemExit, match="carries no data_state"):
        _port(["--data-dir", crc_dir, "--train-iters", "4", "--load", ck])
    losses, _, ret = _port(["--train-iters", "2", "--load", ck])
    assert (losses, ret) == ({}, None)      # nothing left to do
    with pytest.raises(ValueError, match="batches"):
        pretrain_gpt.main(TOY + PORT + ["--data-dir", crc_dir], device="cpu",
                          batches=[])


def test_watchdog_overrun_takes_the_grace_exit(crc_dir, tmp_path,
                                               monkeypatch):
    import time

    step = pretrain_gpt.train_step

    def slow_step(*a):
        time.sleep(0.3)
        return step(*a)

    monkeypatch.setattr(pretrain_gpt, "train_step", slow_step)
    ck, tele = str(tmp_path / "ckpt"), str(tmp_path / "tele")
    losses, _, _ = _port(["--data-dir", crc_dir, "--train-iters", "4",
                          "--save", ck, "--telemetry-dir", tele,
                          "--watchdog-timeout", "0.05"])
    assert sorted(losses) == [1] and tckpt.latest_step(ck) == 1
    events = load_jsonl(os.path.join(tele, "pretrain_gpt.jsonl"))
    validate_events(events)
    assert [e["type"] for e in events].count("watchdog") == 1
    assert events[-1]["reason"] == "watchdog_timeout(step=0)"
    assert glob.glob(os.path.join(tele, "postmortem_*.jsonl"))


def test_checkpoint_tree_round_trips_the_optimizer(tmp_path):
    args, model, opt = pretrain_gpt.setup(TOY + PORT + ["--train-iters", "1"],
                                          device="cpu")
    tokens = torch.randint(0, VOCAB, (GLOBAL_BATCH, S))
    pretrain_gpt.train_step(args, model, opt, tokens, tokens, 0)
    tckpt.save_checkpoint(str(tmp_path), pretrain_gpt.checkpoint_tree(
        model, opt), step=1)
    _, model2, opt2 = pretrain_gpt.setup(TOY + PORT, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tree, _ = tckpt.restore_checkpoint(
            str(tmp_path), pretrain_gpt.checkpoint_target(model2))
    pretrain_gpt.load_checkpoint_tree(model2, opt2, tree)
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, p2), n
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], opt2.state[p2][k]), (n, k)
        assert opt.state[p]["step"] == opt2.state[p2]["step"] == 1
    params, adam = tree
    assert tuple(params["transformer"]["layers"]["input_layernorm"][
        "weight"].shape) == (1, 2, 64)
    assert adam.step.dtype == torch.int32
