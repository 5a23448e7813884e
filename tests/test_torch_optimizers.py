"""Parity of the port's fused optimizers with the JAX package's.

Each of the six (``FusedAdam``, ``FusedSGD``, ``FusedLAMB``,
``FusedNovoGrad``, ``FusedAdagrad`` and ``LARC`` around ``FusedSGD``)
takes N steps over the same parameters and gradients, drawn with numpy
from a seed, beside its JAX class's ``step(grads, state, params)``, with
its knobs; at fp32, and with bf16 and fp16 parameters (fp32 state either
way).  Then ``step_if_finite``: a finite step equals ``step()`` bit for
bit, and a step with an inf or a NaN in one gradient leaves parameters,
state and the step count bitwise unchanged, as the JAX package's
``step_if_finite`` does.

Tolerances: fp32 weights and state after N steps 1e-5 x max(1, max|ref|)
(sums and norms reduced in another order; Adam-like updates divide by
sqrt(v), which lifts a relative 1e-7 in v); half weights one ulp of
their dtype at the tensor's scale (2^-7 bf16, 2^-10 fp16 x max|ref|): an
update that lands on a rounding boundary may round either way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import optimizers as jopt
from apex_tpu_torch import optimizers as topt

STEPS = 4
FP32_TOL = 1e-5
HALF_TOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
SHAPES = {"w": (8, 16), "b": (16,), "conv": (3, 4, 5), "zero": (6,)}

# (name, JAX constructor, port constructor) with the knobs under test
CASES = [
    ("adam", lambda: jopt.FusedAdam(lr=1e-2, weight_decay=1e-2),
     lambda p: topt.FusedAdam(p, lr=1e-2, weight_decay=1e-2)),
    ("adam_l2_no_bias_corr",
     lambda: jopt.FusedAdam(lr=1e-2, weight_decay=1e-2, adam_w_mode=False,
                            bias_correction=False),
     lambda p: topt.FusedAdam(p, lr=1e-2, weight_decay=1e-2,
                              adam_w_mode=False, bias_correction=False)),
    ("sgd_momentum_dampening",
     lambda: jopt.FusedSGD(lr=0.1, momentum=0.9, dampening=0.1,
                           weight_decay=1e-3),
     lambda p: topt.FusedSGD(p, lr=0.1, momentum=0.9, dampening=0.1,
                             weight_decay=1e-3)),
    ("sgd_nesterov_wd_after",
     lambda: jopt.FusedSGD(lr=0.1, momentum=0.9, nesterov=True,
                           weight_decay=1e-3, wd_after_momentum=True),
     lambda p: topt.FusedSGD(p, lr=0.1, momentum=0.9, nesterov=True,
                             weight_decay=1e-3, wd_after_momentum=True)),
    ("sgd_plain", lambda: jopt.FusedSGD(lr=0.1),
     lambda p: topt.FusedSGD(p, lr=0.1)),
    ("lamb", lambda: jopt.FusedLAMB(lr=1e-2, weight_decay=0.01),
     lambda p: topt.FusedLAMB(p, lr=1e-2, weight_decay=0.01)),
    ("lamb_nvlamb_no_wd_no_averaging",
     lambda: jopt.FusedLAMB(lr=1e-2, weight_decay=0.0, use_nvlamb=True,
                            grad_averaging=False, max_grad_norm=0.5),
     lambda p: topt.FusedLAMB(p, lr=1e-2, weight_decay=0.0, use_nvlamb=True,
                              grad_averaging=False, max_grad_norm=0.5)),
    ("lamb_no_clip_no_ratio",
     lambda: jopt.FusedLAMB(lr=1e-2, weight_decay=0.0, max_grad_norm=0.0),
     lambda p: topt.FusedLAMB(p, lr=1e-2, weight_decay=0.0,
                              max_grad_norm=0.0)),
    ("novograd", lambda: jopt.FusedNovoGrad(lr=1e-2, weight_decay=1e-3),
     lambda p: topt.FusedNovoGrad(p, lr=1e-2, weight_decay=1e-3)),
    ("novograd_init_zero_reg_inside",
     lambda: jopt.FusedNovoGrad(lr=1e-2, weight_decay=1e-3, init_zero=True,
                                reg_inside_moment=True,
                                grad_averaging=False),
     lambda p: topt.FusedNovoGrad(p, lr=1e-2, weight_decay=1e-3,
                                  init_zero=True, reg_inside_moment=True,
                                  grad_averaging=False)),
    ("adagrad", lambda: jopt.FusedAdagrad(lr=1e-1, weight_decay=1e-3),
     lambda p: topt.FusedAdagrad(p, lr=1e-1, weight_decay=1e-3)),
    ("adagrad_w_mode",
     lambda: jopt.FusedAdagrad(lr=1e-1, weight_decay=1e-3,
                               adagrad_w_mode=True),
     lambda p: topt.FusedAdagrad(p, lr=1e-1, weight_decay=1e-3,
                                 adagrad_w_mode=True)),
    ("larc_clip",
     lambda: jopt.LARC(jopt.FusedSGD(lr=0.1, momentum=0.9),
                       weight_decay=1e-3),
     lambda p: topt.LARC(topt.FusedSGD(p, lr=0.1, momentum=0.9),
                         weight_decay=1e-3)),
    ("larc_scale",
     lambda: jopt.LARC(jopt.FusedSGD(lr=0.1), clip=False,
                       trust_coefficient=0.01),
     lambda p: topt.LARC(topt.FusedSGD(p, lr=0.1), clip=False,
                         trust_coefficient=0.01)),
]
IDS = [c[0] for c in CASES]


def _params(seed):
    rng = np.random.RandomState(seed)
    out = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    out["zero"][:] = 0.0    # LAMB's and LARC's zero-norm branches
    return out


def _grads(seed, step):
    rng = np.random.RandomState(1000 * seed + step)
    return {k: (0.1 * rng.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_run(make, params, dtype, steps):
    opt = make()
    p = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    state = opt.init(p)
    for i in range(steps):
        g = {k: jnp.asarray(v, dtype) for k, v in _grads(7, i).items()}
        p, state = opt.step(g, state, p)
    return p, state


def _port(params, dtype):
    return {k: torch.tensor(v).to(dtype).requires_grad_() for k, v in
            params.items()}


def _set_grads(tp, step, dtype):
    for k, v in _grads(7, step).items():
        tp[k].grad = torch.tensor(v).to(dtype)


def _port_run(make, params, dtype, steps, explicit=False):
    """N port steps; ``explicit`` hands the gradients to ``step(grads=)``
    in fp32 (amp's route) instead of ``.grad`` in the parameters'
    dtype."""
    tp = _port(params, dtype)
    opt = make(list(tp.values()))
    for i in range(steps):
        if explicit:
            g = _grads(7, i)
            opt.step(grads=[torch.tensor(g[k]).to(dtype).float()
                            for k in tp])
        else:
            _set_grads(tp, i, dtype)
            opt.step()
    return tp, opt


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    bar = tol * max(1.0, float(np.max(np.abs(ref)))) if tol == FP32_TOL \
        else tol * float(np.max(np.abs(ref)))
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    assert err <= bar, (err, bar)


def _state_leaves(jstate, name):
    """The JAX state's per-parameter trees (momenta, sums), by key."""
    fields = {"adam": ("exp_avg", "exp_avg_sq"), "sgd": ("momentum_buffer",),
              "lamb": ("exp_avg", "exp_avg_sq"),
              "novograd": ("exp_avg", "exp_avg_sq"), "adagrad": ("sum",)}
    kind = name.split("_")[0]
    if kind == "larc":
        kind = "sgd"
    return {f: getattr(jstate, f) for f in fields[kind]}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp32_steps_match_jax(case):
    name, jmake, tmake = case
    params = _params(3)
    jp, jstate = _jax_run(jmake, params, jnp.float32, STEPS)
    tp, opt = _port_run(tmake, params, torch.float32, STEPS)
    for k in SHAPES:
        _close(tp[k].detach().numpy(), jp[k], FP32_TOL)
    for field, tree in _state_leaves(jstate, name).items():
        for k in SHAPES:
            _close(opt.state[tp[k]][field].numpy(), tree[k], FP32_TOL)
    if hasattr(jstate, "step"):
        assert int(opt.state[tp["w"]]["step"]) == int(jstate.step) == STEPS


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_half_parameters_match_jax(case, dtype):
    """Half parameters and half gradients; the port takes the gradients
    both ways (``.grad``, and widened to fp32 through ``grads=``, as amp
    hands them over), with the same result."""
    name, jmake, tmake = case
    params = _params(5)
    jp, _ = _jax_run(jmake, params, getattr(jnp, dtype), STEPS)
    tp, _ = _port_run(tmake, params, getattr(torch, dtype), STEPS)
    ep, _ = _port_run(tmake, params, getattr(torch, dtype), STEPS,
                      explicit=True)
    for k in SHAPES:
        assert torch.equal(ep[k], tp[k]), k
    for k in SHAPES:
        assert tp[k].dtype == getattr(torch, dtype)
        if not np.any(np.asarray(jp[k], np.float32)):
            assert not tp[k].detach().float().any()
            continue
        _close(tp[k].detach().float().numpy(), jp[k].astype(jnp.float32),
               HALF_TOL[dtype])


def _snapshot(tp, opt):
    out = {k: t.detach().clone() for k, t in tp.items()}
    for k, t in tp.items():
        for f, v in opt.state[t].items():
            out[f"{k}.{f}"] = v.clone() if isinstance(v, torch.Tensor) else v
    return out


def _bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if k.endswith(".step"):     # FusedAdam's step(): a host int
            assert int(x) == int(y), k
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(
                x.view(-1).view(torch.uint8) if x.dtype.is_floating_point
                else x, y.view(-1).view(torch.uint8)
                if y.dtype.is_floating_point else y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step_if_finite_skips_bitwise(case, bad):
    name, _, tmake = case
    params = _params(11)
    tp, opt = _port_run(tmake, params, torch.float32, 2)
    ref_tp, ref_opt = _port_run(tmake, params, torch.float32, 2)
    # a finite step through step_if_finite is step() itself
    _set_grads(tp, 2, torch.float32)
    opt.step_if_finite(torch.tensor(True))
    _set_grads(ref_tp, 2, torch.float32)
    ref_opt.step()
    _bitwise(_snapshot(tp, opt), _snapshot(ref_tp, ref_opt))
    # an overflowed step changes nothing, the step count included
    before = _snapshot(tp, opt)
    _set_grads(tp, 3, torch.float32)
    tp["w"].grad[2, 3] = bad
    finite = torch.isfinite(tp["w"].grad).all()
    opt.step_if_finite(finite)
    _bitwise(_snapshot(tp, opt), before)


def test_jax_step_if_finite_agrees_on_the_skip():
    """The JAX optimizers' own skip leaves params and state as they were:
    what the port's bitwise test holds it to."""
    opt = jopt.FusedAdam(lr=1e-2)
    p = {k: jnp.asarray(v) for k, v in _params(2).items()}
    state = opt.init(p)
    g = {k: jnp.asarray(v) for k, v in _grads(2, 0).items()}
    g["w"] = g["w"].at[0, 0].set(jnp.inf)
    new_p, new_state = opt.step_if_finite(g, state, p, jnp.asarray(False))
    for k in p:
        np.testing.assert_array_equal(np.asarray(new_p[k]), np.asarray(p[k]))
    assert int(new_state.step) == 0


def test_apply_updates_rounds_as_jax():
    rng = np.random.RandomState(4)
    for dtype in ("bfloat16", "float16", "float32"):
        p = rng.randn(64).astype(np.float32)
        u = (1e-3 * rng.randn(64)).astype(np.float32)
        jp = jopt.apply_updates({"a": jnp.asarray(p, getattr(jnp, dtype))},
                                {"a": jnp.asarray(u)})["a"]
        tp = torch.tensor(p).to(getattr(torch, dtype))
        topt.apply_updates([tp], [torch.tensor(u)])
        np.testing.assert_array_equal(tp.float().numpy(),
                                      np.asarray(jp, np.float32))


def test_fused_adam_step_keeps_its_host_count():
    """``step()`` keeps the host int of the route before amp (phases 7,
    11 and 14 hold it bitwise on the card); ``step_if_finite`` moves it
    to the device and ``step()`` after it goes on counting there."""
    tp = _port(_params(1), torch.float32)
    opt = topt.FusedAdam(list(tp.values()), lr=1e-3)
    _set_grads(tp, 0, torch.float32)
    opt.step()
    assert opt.state[tp["w"]]["step"] == 1
    opt.step_if_finite(torch.tensor(True))
    step = opt.state[tp["w"]]["step"]
    assert isinstance(step, torch.Tensor) and int(step) == 2
    opt.step()
    assert int(opt.state[tp["b"]]["step"]) == 3
    assert opt.state[tp["b"]]["step"] is opt.state[tp["w"]]["step"]
