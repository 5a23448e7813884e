"""GPT training under amp: the port against the JAX package, live.

The JAX references are computed in the test, never read from
``tests/L1/baselines/``: ``run_trajectory``'s ``gpt_o0_adam`` and
``gpt_o2_adam`` cells (``tests/L1/test_golden_trajectories.py``: 2
layers, hidden 32, 2 heads of 16, vocab 64, seq 16, batch 8, 6 steps,
lr 5e-3, FusedAdam with weight decay 1e-4; O2 in bf16 with dynamic loss
scaling), and O2 in fp16 with FusedLAMB and FusedSGD on a JAX loop built
the same way (``run_trajectory``'s step body: ``cast_model`` of the fp32
master, ``scaled_value_and_grad``, ``step``, ``skip_or_step``,
``scaler.update``).  The port runs the same recipe through its own amp:
``master_params``, ``cast_model`` in place, ``scaled_value_and_grad``,
``step_if_finite``, ``copy_masters``, ``scaler.update``, on the same
weights (``state_dict_from_jax``) and the same batches
(``harness._gpt_batch``).  A run from a loss scale of 2^40 in fp16 must
skip the same steps with the same scales as JAX's, exactly.

Tolerances, on each step's loss: O0 fp32 1e-5 x |loss| (sums in another
order, the port's flash attention against the harness's fused-softmax
path; read 1.2e-7); O2 bf16 5e-3 absolute on a loss near 4.2 (the
harness's fused-softmax path rounds the scores and probabilities to
bf16, the port's flash path keeps them fp32 and rounds the context once;
read 9.1e-4); O2 fp16 on JAX's flash path 4e-3 absolute (read 5.8e-5
over five LAMB steps, 2.4e-3 over the 34 steps from 2^40, whose Adam
steps at lr 1e-2 carry the gap forward).  Skips and scales: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import optimizers as jopt
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu_torch import amp
from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel
from apex_tpu_torch.transformer.testing.convert import state_dict_from_jax
from tests.L1.common.harness import RunConfig, _gpt_batch, run_trajectory

HARNESS_GPT = dict(num_layers=2, hidden_size=32, num_attention_heads=2,
                   vocab_size=64, max_position_embeddings=16)
O0_TOL = 1e-5
O2_BF16_TOL = 5e-3
O2_FP16_TOL = 4e-3


def _master(seed=0, **cfg):
    model = JGPTModel(JGPTConfig(**HARNESS_GPT, **cfg))
    master = model.shard_master(model.init_master(jax.random.PRNGKey(seed)),
                                0)
    return jax.tree_util.tree_map(np.asarray, master)


def _port_opt(name, params, lr):
    if name == "adam":
        return topt.FusedAdam(params, lr=lr, weight_decay=1e-4)
    if name == "lamb":
        return topt.FusedLAMB(params, lr=lr, weight_decay=1e-4)
    return topt.FusedSGD(params, lr=lr, momentum=0.9)


def _jax_opt(name, lr):
    if name == "adam":
        return jopt.FusedAdam(lr=lr, weight_decay=1e-4)
    if name == "lamb":
        return jopt.FusedLAMB(lr=lr, weight_decay=1e-4)
    return jopt.FusedSGD(lr=lr, momentum=0.9)


def port_trajectory(level, half, opt_name, steps, lr, scaler=None,
                    seed=0):
    """The port's amp recipe on the harness's model and batches: per-step
    (loss, finite, loss scale after the update)."""
    ta = amp.initialize(level, half_dtype=half)
    scaler = scaler or ta.scaler
    kw = {"bf16": half == torch.bfloat16, "fp16": half == torch.float16} \
        if level != "O0" else {}
    model = GPTModel(GPTConfig(**HARNESS_GPT, use_flash_attention=True, **kw),
                     device="cpu")
    model.load_state_dict(state_dict_from_jax(_master(seed)))
    masters = ta.master_params(model)
    ta.cast_model(model)
    params = list(model.parameters())
    opt = _port_opt(opt_name, masters, lr)
    ss = scaler.init("cpu")
    fn = amp.scaled_value_and_grad(
        lambda t, l: model(t, labels=l).mean(), scaler, params)
    out = []
    for i in range(steps):
        x, y = (torch.tensor(np.asarray(a)).long()
                for a in _gpt_batch(i, seed, HARNESS_GPT["vocab_size"]))
        loss, grads, finite = fn(ss, x, y)
        opt.step_if_finite(finite, grads)
        amp.copy_masters(params, masters)
        ss = scaler.update(ss, finite)
        out.append((float(loss), bool(finite), float(ss.loss_scale)))
    return out


def jax_trajectory(half, opt_name, steps, lr, scaler=None, seed=0):
    """``run_trajectory``'s step body at O2 with ``half_dtype`` and the
    flash path (the port's), for optimizers and scalers the harness has no
    cell for: per-step (loss, finite, scale after the update)."""
    ja = jamp.initialize("O2", half_dtype=half)
    scaler = scaler or ja.scaler
    cfg = dict(HARNESS_GPT, use_flash_attention=True,
               bf16=half == jnp.bfloat16, fp16=half == jnp.float16)
    model = JGPTModel(JGPTConfig(**cfg))
    params = jax.tree_util.tree_map(jnp.asarray, _master(seed))
    opt = _jax_opt(opt_name, lr)

    def loss_fn(p, tokens, labels):
        return model.apply(p, tokens, labels=labels).mean()

    grad_fn = jamp.scaled_value_and_grad(loss_fn, scaler)

    def body(params, opt_state, ss, x, y):
        loss, grads, finite = grad_fn(ss, ja.cast_model(params), x, y)
        new_p, new_o = opt.step(grads, opt_state, params)
        params, opt_state = jamp.skip_or_step(finite, (new_p, new_o),
                                              (params, opt_state))
        return params, opt_state, scaler.update(ss, finite), loss, finite

    parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        1, 1, devices=jax.devices()[:1])
    step = jax.jit(lambda *a: shard_map(
        body, mesh=mesh, in_specs=(P(),) * 5, out_specs=(P(),) * 5,
        check_vma=False)(*a))
    opt_state, ss = opt.init(params), scaler.init()
    out = []
    for i in range(steps):
        x, y = _gpt_batch(i, seed, HARNESS_GPT["vocab_size"])
        params, opt_state, ss, loss, finite = step(params, opt_state, ss, x,
                                                   y)
        out.append((float(loss), bool(finite), float(ss.loss_scale)))
    parallel_state.destroy_model_parallel()
    return out


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_trajectory_matches_run_trajectory(level):
    """``gpt_o0_adam`` / ``gpt_o2_adam`` of the golden cells, computed
    live by ``run_trajectory``."""
    cell = RunConfig(model="gpt", opt_level=level, steps=6, lr=5e-3,
                     **({"loss_scale": 1.0} if level == "O0" else {}))
    want = run_trajectory(cell)
    got = port_trajectory(level, torch.bfloat16, "adam", 6, 5e-3)
    gaps = [abs(g[0] - w) for g, w in zip(got, want)]
    tol = [O0_TOL * abs(w) for w in want] if level == "O0" else \
        [O2_BF16_TOL] * len(want)
    assert all(g <= t for g, t in zip(gaps, tol)), (got, want, gaps)
    assert all(f for _, f, _ in got)                 # no overflow in bf16
    assert got[-1][0] < got[0][0]                    # it trains


@pytest.mark.parametrize("opt_name", ["lamb", "sgd"])
def test_o2_fp16_matches_jax(opt_name):
    want = jax_trajectory(jnp.float16, opt_name, 5, 1e-2)
    got = port_trajectory("O2", torch.float16, opt_name, 5, 1e-2)
    assert [g[1:] for g in got] == [w[1:] for w in want]   # skips, scales
    gaps = [abs(g[0] - w[0]) for g, w in zip(got, want)]
    assert max(gaps) <= O2_FP16_TOL, (got, want, gaps)


def test_fp16_from_2_40_skips_exactly_as_jax():
    """From a loss scale of 2^40 the fp16 gradients overflow until the
    scale has halved far enough; every skipped step and every scale
    equals JAX's, and once finite the run trains."""
    steps = 34
    want = jax_trajectory(jnp.float16, "adam", steps, 1e-2,
                          scaler=jamp.LossScaler(init_scale=2.0 ** 40))
    got = port_trajectory("O2", torch.float16, "adam", steps, 1e-2,
                          scaler=amp.LossScaler(init_scale=2.0 ** 40))
    skipped = [i for i, (_, f, _) in enumerate(want) if not f]
    assert skipped[:20] == list(range(20))   # 2^40 down to 2^20 at least
    assert len(skipped) < steps - 3
    assert [g[1:] for g in got] == [w[1:] for w in want], (got, want)
    gaps = [abs(g[0] - w[0]) for g, w in zip(got, want)]
    assert max(gaps) <= O2_FP16_TOL, gaps
