"""Parity of the port's ``amp`` with the JAX package's ``apex_tpu.amp``.

Opt levels and overrides; which GPT parameters stay fp32 under O2 (the
port's ``cast_model`` on a ``GPTModel`` against JAX's on the same
weights, name by name); the loss scaler over scripted finite sequences
(growth at a small window, the ``min_scale``/``max_scale`` clamps, a
static scaler's ``skipped``) step by step against JAX's, all three state
values exactly; ``state_dict`` across the packages; scaled grads and
``finite`` against ``scaled_value_and_grad``; ``skip_or_step`` and
``copy_masters`` bitwise; the cast wrappers, ``autocast_policy``'s table
and ``OptimWrapper``.  None of the amp calls may read a device value on
the host: on the CPU that shows as no ``.item()``-style call, which the
tests see by patching ``torch.Tensor.__bool__``/``item`` to raise inside
the step.

Tolerances: grads of the scaled backward 1e-6 relative to JAX's (the
same fp32 products, reduced in another order); the scaler, casts, skips
and state dicts exact.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import optimizers as jopt
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import GPTModel as JGPTModel
from apex_tpu_torch import amp
from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.amp import lists
from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel
from apex_tpu_torch.transformer.testing.convert import (
    _flatten, jax_tree_from_state_dict, state_dict_from_jax)

GPT_TOY = dict(num_layers=2, hidden_size=32, num_attention_heads=2,
               vocab_size=64, max_position_embeddings=16)


@contextlib.contextmanager
def no_host_reads():
    """Any read of a tensor's value on the host (``bool``, ``item``,
    ``float``, ``int``, ``tolist``) raises inside the block."""
    def refuse(self, *a, **k):
        raise AssertionError("a device value was read on the host")
    names = ("__bool__", "item", "__float__", "__int__", "tolist")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


# -- opt levels ---------------------------------------------------------------


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_opt_levels_match_jax(level, half):
    j = jamp.initialize(level, half_dtype=getattr(jnp, half))
    t = amp.initialize(level, half_dtype=getattr(torch, half))

    def name(dt):
        return None if dt is None else jnp.dtype(dt).name

    tp, jp = t.props, j.props
    assert tp.opt_level == jp.opt_level
    assert (None if tp.cast_model_type is None else
            str(tp.cast_model_type).split(".")[1]) == name(jp.cast_model_type)
    assert (tp.per_op_cast, tp.keep_batchnorm_fp32, tp.master_weights,
            tp.loss_scale) == (jp.per_op_cast, jp.keep_batchnorm_fp32,
                               jp.master_weights, jp.loss_scale)
    assert (t.scaler.dynamic, t.scaler.init_scale, t.scaler.min_scale,
            t.scaler.max_scale) == (j.scaler.dynamic, j.scaler.init_scale,
                                    j.scaler.min_scale, j.scaler.max_scale)


@pytest.mark.parametrize("overrides", [
    dict(keep_batchnorm_fp32=False, loss_scale=128.0),
    dict(cast_model_type="half", master_weights=False),
    dict(loss_scale="dynamic", min_loss_scale=4.0, max_loss_scale=2.0 ** 20),
], ids=["static_no_bn", "half_no_masters", "dynamic_bounds"])
def test_overrides_match_jax(overrides):
    j = jamp.initialize("O2", half_dtype=jnp.float16, **overrides)
    t = amp.initialize("O2", half_dtype=torch.float16, **overrides)
    assert t.props.keep_batchnorm_fp32 == j.props.keep_batchnorm_fp32
    assert t.props.master_weights == j.props.master_weights
    assert t.props.cast_model_type == torch.float16
    assert t.scaler == type(t.scaler)(**{
        f: getattr(j.scaler, f) for f in ("init_scale", "scale_factor",
                                          "scale_window", "min_scale",
                                          "max_scale", "dynamic")})


def test_bad_level_raises():
    with pytest.raises(ValueError):
        amp.initialize("O4")


# -- cast_model on GPT, name by name against JAX ------------------------------


@pytest.fixture(scope="module")
def gpt_master():
    model = JGPTModel(JGPTConfig(**GPT_TOY, use_flash_attention=True))
    master = model.shard_master(model.init_master(jax.random.PRNGKey(0)), 0)
    return jax.tree_util.tree_map(np.asarray, master)


@pytest.mark.parametrize("level,keep", [("O2", None), ("O3", None),
                                        ("O2", False)])
def test_gpt_cast_keeps_the_same_leaves_fp32_as_jax(gpt_master, level,
                                                    keep):
    j = jamp.initialize(level, half_dtype=jnp.float16,
                        keep_batchnorm_fp32=keep)
    want = _flatten(jax.tree_util.tree_map(
        np.asarray, j.cast_model(jax.tree_util.tree_map(jnp.asarray,
                                                        gpt_master))))
    t = amp.initialize(level, half_dtype=torch.float16,
                       keep_batchnorm_fp32=keep)
    model = GPTModel(GPTConfig(**GPT_TOY, fp16=True,
                               use_flash_attention=True), device="cpu")
    model.load_state_dict(state_dict_from_jax(gpt_master))
    assert t.cast_model(model) is model
    got = _flatten(jax_tree_from_state_dict(dict(model.named_parameters())))
    assert sorted(got) == sorted(want)
    fp32 = sorted(n for n, a in want.items() if a.dtype == np.float32)
    assert sorted(n for n, a in got.items() if a.dtype == np.float32) == fp32
    if level == "O2" and keep is None:
        assert fp32 and all("layernorm" in n for n in fp32)
    for n in want:     # the same values: both round to nearest even
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_array_equal(got[n], want[n])
    # the dict form leaves its input alone
    sd = state_dict_from_jax(gpt_master)
    cast = t.cast_model(sd)
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert {k for k, v in cast.items() if v.dtype == torch.float32} == {
        k for k, v in dict(model.named_parameters()).items()
        if v.dtype == torch.float32}


def test_bn_name_rule_is_jax_rule():
    from apex_tpu.amp.properties import _is_bn_path as jax_rule
    from apex_tpu_torch.amp.properties import _is_bn_path as port_rule

    class K:
        def __init__(self, key):
            self.key = key

    for name in ["transformer.layers.0.input_layernorm.weight",
                 "final_layernorm.bias", "encoder.bn1.weight",
                 "net.ln_f.weight", "block.norm.scale", "mlp.dense.weight",
                 "embedding.weight", "BatchNorm.running_mean",
                 "layers.lnx.w", "bias", "down_bn.weight"]:
        parts = name.split(".")
        assert port_rule(parts) == jax_rule([K(p) for p in parts]), name


def test_master_params_and_copy_masters():
    t = amp.initialize("O2", half_dtype=torch.float16)
    model = GPTModel(GPTConfig(**GPT_TOY, fp16=True,
                               use_flash_attention=True), device="cpu")
    fp32 = [p.detach().clone() for p in model.parameters()]
    masters = t.master_params(model)
    t.cast_model(model)
    params = list(model.parameters())
    assert all(m.dtype == torch.float32 and m.requires_grad for m in masters)
    for m, p0 in zip(masters, fp32):
        assert torch.equal(m, p0) and m.data_ptr() != p0.data_ptr()
    with torch.no_grad():
        for m in masters:
            m.add_(1e-3)
    amp.copy_masters(params, masters)
    for p, m in zip(params, masters):
        assert p.dtype in (torch.float16, torch.float32)
        assert torch.equal(p, m.to(p.dtype))
    # O0 and O3 step the parameters themselves
    for level in ("O0", "O3"):
        ps = list(model.parameters())
        assert amp.initialize(level).master_params(model) == ps


def test_cast_inputs_and_o2_state_dict():
    t = amp.initialize("O2", half_dtype=torch.float16)
    batch = {"x": torch.ones(2, 3), "ids": torch.ones(2, dtype=torch.long),
             "pair": (torch.zeros(1), torch.zeros(1, dtype=torch.int32))}
    out = t.cast_inputs(batch)
    assert out["x"].dtype == torch.float16 and out["ids"].dtype == torch.long
    assert out["pair"][0].dtype == torch.float16
    assert out["pair"][1].dtype == torch.int32
    assert amp.initialize("O0").cast_inputs(batch) is batch
    sd = amp.o2_state_dict({"w": torch.ones(2, dtype=torch.float16),
                            "n": torch.ones(2, dtype=torch.long)})
    assert sd["w"].dtype == torch.float32 and sd["n"].dtype == torch.long


# -- the loss scaler, step by step against JAX --------------------------------

SEQUENCES = {
    "growth_at_window_3": (dict(scale_window=3, init_scale=4.0),
                           [True] * 7 + [False] + [True] * 4),
    "min_scale_clamp": (dict(init_scale=32.0, min_scale=8.0),
                        [False] * 5 + [True, False]),
    "max_scale_clamp": (dict(init_scale=6.0, scale_window=1,
                             max_scale=10.0), [True] * 3 + [False, True]),
    "default_overflows": (dict(), [False, True, False, False, True, True]),
    "from_2_40": (dict(init_scale=2.0 ** 40), [False] * 12 + [True] * 3),
    "odd_factor": (dict(init_scale=3.0, scale_factor=3.0, scale_window=2,
                        min_scale=0.5), [True, True, False, False, False,
                                         True]),
}


def _triple(st):
    return (float(np.asarray(st.loss_scale)), int(np.asarray(st.unskipped)),
            int(np.asarray(st.skipped)))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_scaler_sequence_matches_jax(name, static):
    kw, seq = SEQUENCES[name]
    if static:
        js = jamp.LossScaler.static(kw.get("init_scale", 2.0 ** 16))
        ts = amp.LossScaler.static(kw.get("init_scale", 2.0 ** 16))
    else:
        js = jamp.LossScaler.dynamic_scaler(**kw)
        ts = amp.LossScaler.dynamic_scaler(**kw)
    jst, tst = js.init(), ts.init("cpu")
    assert tst.loss_scale.dtype == torch.float32
    assert tst.unskipped.dtype == tst.skipped.dtype == torch.int32
    for finite in seq:
        jst = js.update(jst, jnp.asarray(finite))
        with no_host_reads():
            tst = ts.update(tst, torch.tensor(finite))
        assert _triple(tst) == _triple(jst)
    assert _triple(tst)[2] == seq.count(False)


def test_state_dict_crosses_the_packages():
    js = jamp.LossScaler.dynamic_scaler(init_scale=64.0)
    jst = js.init()
    for f in (True, False, True, True):
        jst = js.update(jst, jnp.asarray(f))
    d = jamp.state_dict(jst)
    tst = amp.load_state_dict(d)
    assert amp.state_dict(tst) == d
    assert _triple(tst) == _triple(jst)
    back = jamp.load_state_dict(amp.state_dict(tst))
    assert _triple(back) == _triple(jst)
    assert _triple(amp.load_state_dict({"loss_scale": 4.0,
                                        "unskipped": 7})) == (4.0, 7, 0)


# -- scaled grads and the skip ------------------------------------------------


def _quadratic(bad=None):
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)

    def jloss(p, x):
        out = jnp.sum((x @ p) ** 2)
        return out * bad if bad is not None else out

    def tloss(p, x):
        out = torch.sum((x @ p) ** 2)
        return out * bad if bad is not None else out

    return x, jloss, tloss


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_scaled_grads_and_finite_match_jax(dtype):
    x, jloss, tloss = _quadratic()
    p0 = (np.linspace(-1, 1, 9).reshape(3, 3) * 0.3).astype(np.float32)
    js = jamp.LossScaler.dynamic_scaler(init_scale=2.0 ** 10)
    ts = amp.LossScaler.dynamic_scaler(init_scale=2.0 ** 10)
    jp = jnp.asarray(p0, getattr(jnp, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jl, jg, jf = jamp.scaled_value_and_grad(jloss, js)(js.init(), jp, jx)
    tp = torch.tensor(p0).to(getattr(torch, dtype)).requires_grad_()
    tx = torch.tensor(x).to(getattr(torch, dtype))
    fn = amp.scaled_value_and_grad(lambda x: tloss(tp, x), ts, [tp])
    with no_host_reads():
        tl, tg, tf = fn(ts.init("cpu"), tx)
    assert bool(tf) and bool(jf)
    assert tg[0].dtype == torch.float32 and jg.dtype == jnp.float32
    np.testing.assert_allclose(tl.float().numpy(), np.float32(jl), rtol=1e-6)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_overflow_is_flagged_as_jax_flags_it(bad):
    x, jloss, tloss = _quadratic(bad)
    js, ts = jamp.LossScaler(), amp.LossScaler()
    _, _, jf = jamp.scaled_value_and_grad(jloss, js)(
        js.init(), jnp.ones((3, 3)), jnp.asarray(x))
    tp = torch.ones(3, 3, requires_grad=True)
    _, _, tf = amp.scaled_value_and_grad(lambda x: tloss(tp, x), ts, [tp])(
        ts.init("cpu"), torch.tensor(x))
    assert bool(tf) == bool(jf) is False


def test_fp16_overflow_under_a_large_scale():
    """A scale of 2^40 overflows fp16 gradients; the all-finite check sees
    the inf in the half gradient, as JAX's does."""
    js = jamp.LossScaler.dynamic_scaler(init_scale=2.0 ** 40)
    ts = amp.LossScaler.dynamic_scaler(init_scale=2.0 ** 40)
    p0 = np.full((4,), 0.5, np.float32)
    _, jg, jf = jamp.scaled_value_and_grad(
        lambda p: jnp.sum(p.astype(jnp.float32) ** 2), js)(
        js.init(), jnp.asarray(p0, jnp.float16))
    tp = torch.tensor(p0).half().requires_grad_()
    _, tg, tf = amp.scaled_value_and_grad(
        lambda: torch.sum(tp.float() ** 2), ts, [tp])(ts.init("cpu"))
    assert bool(tf) == bool(jf) is False


def test_has_aux_and_unused_parameters():
    ts = amp.LossScaler.static(4.0)
    a = torch.ones(2, requires_grad=True)
    unused = torch.ones(3, requires_grad=True)
    fn = amp.scaled_value_and_grad(
        lambda: (torch.sum(a ** 2), {"m": torch.sum(a)}), ts, [a, unused],
        has_aux=True)
    (loss, aux), grads, finite = fn(ts.init("cpu"))
    assert float(loss) == 2.0 and float(aux["m"]) == 2.0
    assert torch.equal(grads[0], torch.full((2,), 2.0))
    assert torch.equal(grads[1], torch.zeros(3)) and bool(finite)


def test_skip_or_step_bitwise():
    new = [torch.ones(2), torch.full((3,), 2.0)]
    old = [torch.tensor([0.0, -0.0]), torch.tensor([1.0, float("nan"), 3.0])]
    kept = amp.skip_or_step(torch.tensor(False), new, old)
    for k, o in zip(kept, old):
        assert torch.equal(k.view(torch.int32), o.view(torch.int32))
    stepped = amp.skip_or_step(torch.tensor(True), new, old)
    for s, n in zip(stepped, new):
        assert torch.equal(s, n)
    j = jamp.skip_or_step(jnp.asarray(False), {"w": jnp.ones(2)},
                          {"w": jnp.zeros(2)})
    np.testing.assert_array_equal(np.asarray(j["w"]), kept[0].numpy())


@pytest.mark.parametrize("opt_name", ["adam", "lamb", "sgd"])
def test_amp_step_matches_jax_and_skips_bitwise(opt_name):
    """One O2-style fp16 step on a linear model: the scaled backward, the
    fp32 masters' optimizer step, the copy back to half, the scale update,
    against the JAX run_trajectory recipe; then a step whose loss
    overflows leaves masters, half parameters, moments and the step count
    bitwise unchanged and halves the scale."""
    rng = np.random.RandomState(0)
    w0 = (0.1 * rng.randn(8, 4)).astype(np.float32)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    make = {"adam": (lambda: jopt.FusedAdam(lr=1e-2, weight_decay=1e-4),
                     lambda p: topt.FusedAdam(p, lr=1e-2, weight_decay=1e-4)),
            "lamb": (lambda: jopt.FusedLAMB(lr=1e-2, weight_decay=1e-4),
                     lambda p: topt.FusedLAMB(p, lr=1e-2, weight_decay=1e-4)),
            "sgd": (lambda: jopt.FusedSGD(lr=1e-2, momentum=0.9),
                    lambda p: topt.FusedSGD(p, lr=1e-2, momentum=0.9))}
    jmake, tmake = make[opt_name]
    ja = jamp.initialize("O2", half_dtype=jnp.float16)
    ta = amp.initialize("O2", half_dtype=torch.float16)

    def jloss(w, x, y):
        pred = (x.astype(jnp.float16) @ w).astype(jnp.float32)
        return jnp.mean((pred - y) ** 2)

    jopt_ = jmake()
    jm = {"w": jnp.asarray(w0)}
    jstate, jss = jopt_.init(jm), ja.scaler.init()
    grad_fn = jamp.scaled_value_and_grad(
        lambda p, x, y: jloss(p["w"], x, y), ja.scaler)

    w = torch.tensor(w0).requires_grad_()
    masters = ta.master_params([w])
    w.data = w.data.half()
    opt = tmake(masters)
    tss = ta.scaler.init("cpu")
    tfn = amp.scaled_value_and_grad(
        lambda x, y: torch.mean(((x.half() @ w).float() - y) ** 2),
        ta.scaler, [w])
    for step in range(3):
        bad = step == 2
        yy = y * (np.inf if bad else 1.0)
        _, jg, jf = grad_fn(jss, ja.cast_model(jm), jnp.asarray(x),
                            jnp.asarray(yy))
        new, nstate = jopt_.step(jg, jstate, jm)
        jm, jstate = jamp.skip_or_step(jf, (new, nstate), (jm, jstate))
        jss = ja.scaler.update(jss, jf)
        before = (masters[0].clone(), w.detach().clone(),
                  {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for k, v in opt.state[masters[0]].items()})
        with no_host_reads():
            _, grads, finite = tfn(tss, torch.tensor(x), torch.tensor(yy))
            opt.step_if_finite(finite, grads)
            amp.copy_masters([w], masters)
            tss = ta.scaler.update(tss, finite)
        assert bool(finite) == bool(jf) == (not bad)
        assert _triple(tss) == _triple(jss)
        if bad:
            assert torch.equal(masters[0], before[0])
            assert torch.equal(w.detach(), before[1])
            for k, v in opt.state[masters[0]].items():
                assert torch.equal(v, before[2][k]), k
        np.testing.assert_allclose(masters[0].detach().numpy(),
                                   np.asarray(jm["w"]), rtol=0, atol=1e-6)


# -- cast wrappers, the op table, OptimWrapper --------------------------------


def test_cast_wrappers():
    assert amp.half_function(lambda x: x)(torch.ones(2)).dtype == \
        torch.bfloat16
    assert amp.half_function(lambda x: x, torch.float16)(
        torch.ones(2)).dtype == torch.float16
    assert amp.float_function(lambda x: x)(
        torch.ones(2, dtype=torch.bfloat16)).dtype == torch.float32
    a, b = amp.promote_function(lambda x, y: (x, y))(
        torch.ones(2, dtype=torch.bfloat16), torch.ones(2))
    assert a.dtype == b.dtype == torch.float32
    a, b = amp.promote_function(lambda x, y: (x, y))(
        torch.ones(2, dtype=torch.bfloat16), y=torch.ones(2,
                                                          dtype=torch.half))
    assert a.dtype == b.dtype == torch.float32    # as jnp.promote_types
    ids = torch.ones(2, dtype=torch.long)
    assert amp.half_function(lambda x: x)(ids).dtype == torch.long


def test_autocast_table_is_jax_table():
    from apex_tpu.amp import lists as jlists

    for attr in ("FP16_FUNCS", "FP32_FUNCS", "CASTS", "BANNED_FUNCS"):
        assert getattr(lists, attr) == getattr(jlists, attr)
    for op in (jlists.FP16_FUNCS + jlists.FP32_FUNCS + jlists.CASTS
               + ["relu", "gelu"]):
        assert amp.autocast_policy(op) == jlists.autocast_policy(op)
    with pytest.raises(NotImplementedError):
        amp.autocast_policy("binary_cross_entropy")


def test_optim_wrapper_two_losses_scale_independently():
    w = torch.ones(4, requires_grad=True)
    wrapper = amp.OptimWrapper(topt.FusedSGD([w], lr=0.1), num_loss=2)
    x = torch.ones(4)
    _, g, finite = wrapper.scaled_grad(lambda x: torch.sum(w * x), [w], x,
                                       loss_id=0)
    wrapper.step(finite, loss_id=0)
    assert torch.allclose(w.detach(), torch.full((4,), 0.9))
    _, g, finite = wrapper.scaled_grad(
        lambda x: torch.sum(w * x) * float("inf"), [w], x, loss_id=1)
    wrapper.step(finite, loss_id=1)
    assert torch.allclose(w.detach(), torch.full((4,), 0.9))
    d = wrapper.state_dict()
    assert d["scalers"][0] == {"loss_scale": 2.0 ** 16, "unskipped": 1}
    assert d["scalers"][1] == {"loss_scale": 2.0 ** 15, "unskipped": 0}
    assert set(d) == {"opt_state", "scalers"}


def test_fp16_weights_cross_the_converter_unchanged(gpt_master):
    """``state_dict_from_jax`` / ``jax_tree_from_state_dict`` carry fp16
    leaves as fp16 (numpy has the type; only bf16 needs a widening)."""
    half = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16),
                                  gpt_master)
    sd = state_dict_from_jax(half)
    assert all(t.dtype == torch.float16 for t in sd.values())
    back = _flatten(jax_tree_from_state_dict(sd))
    for name, a in _flatten(half).items():
        assert back[name].dtype == np.float16
        np.testing.assert_array_equal(back[name], a)


def test_tree_utilities_match_jax():
    from apex_tpu.utils import tree as jtree
    from apex_tpu_torch import utils

    rng = np.random.RandomState(8)
    arrs = {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    ids = np.arange(4, dtype=np.int32)
    jt = {**{k: jnp.asarray(v) for k, v in arrs.items()},
          "i": jnp.asarray(ids)}
    tt = {**{k: torch.tensor(v) for k, v in arrs.items()},
          "i": torch.tensor(ids)}
    jc = jtree.tree_cast(jt, jnp.float16)
    tc = utils.tree_cast(tt, torch.float16)
    for k in jt:
        assert str(tc[k].dtype).split(".")[1] == jnp.dtype(jc[k].dtype).name
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    np.testing.assert_allclose(
        utils.tree_global_norm([tt["a"], tt["b"]]).numpy(),
        np.asarray(jtree.tree_global_norm({"a": jt["a"], "b": jt["b"]})),
        rtol=1e-6)
    for bad in (None, float("inf"), float("nan")):
        x = arrs["a"].copy()
        if bad is not None:
            x[1, 2] = bad
        want = bool(jtree.tree_isfinite({"x": jnp.asarray(x),
                                         "i": jt["i"]}))
        got = utils.tree_isfinite([torch.tensor(x), tt["i"]])
        assert got.dtype == torch.bool and bool(got) == want
    assert bool(utils.tree_isfinite([tt["i"]]))    # no float: finite
    sel = utils.tree_select(torch.tensor(False), [tt["a"]], [-tt["a"]])
    assert torch.equal(sel[0], -tt["a"])
