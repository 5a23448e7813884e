"""Parity of the PyTorch port's contrib multi-head attention modules
(``apex_tpu_torch.contrib.multihead_attn``) with the JAX package's
(``apex_tpu.contrib.multihead_attn``).

The JAX module's ``init`` dict goes through ``state_dict_from_jax`` into
the port's module; the same numpy inputs go through both.  On the CPU
the port runs the plain versions of its kernels (``chip_smoke.py`` holds
the kernels against those on the card and trains this stack there).
Outputs and gradients (every parameter, the query and the encoder
input) are held against ``jax.grad`` of the JAX modules, for every
variant: bias, norm-add, boolean or additive key padding, ``attn_mask``,
the encoder-decoder module with sq != sk, and a small encoder-decoder
stack of both for the slice as a whole.

Tolerance: fp32 1e-5 x max(1, max|ref|) (sums in another order).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu_torch import kernels
from apex_tpu_torch.contrib import multihead_attn as tmha

REPO = Path(__file__).resolve().parents[1]
FP32_TOL = 1e-5
HIDDEN, HEADS = 32, 4


def _close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = FP32_TOL * max(1.0, float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol, (err, tol)


def _pair(cls_name, key=0, **kw):
    """The JAX module with its init params and the port's module loaded
    from them (on the CPU)."""
    jm = getattr(jmha, cls_name)(HIDDEN, HEADS, **kw)
    params = jm.init(jax.random.PRNGKey(key))
    # a non-zero bias and LayerNorm, so their gradients are exercised
    rng = np.random.RandomState(key + 100)
    params = {n: (jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.1)
                  + (1.0 if "gamma" in n else 0.0))
              if n.endswith(("bias", "weights")) else p
              for n, p in params.items()}
    tm = getattr(tmha, cls_name)(HIDDEN, HEADS, device="cpu", **kw)
    tm.load_state_dict(tmha.state_dict_from_jax(params))
    return jm, params, tm


def _masks(rng, kind, b, sq, sk):
    """(key_padding_mask, attn_mask) numpy arrays or None."""
    lengths = rng.randint(1, sk + 1, b)
    if kind.endswith("all_padded"):
        lengths[0] = 0
    pad = np.arange(sk)[None] >= lengths[:, None]          # True = padded
    causal = np.triu(np.ones((sq, sk), bool), 1)
    additive_pad = np.where(pad, -3.0, 0.0).astype(np.float32)
    return {
        "none": (None, None),
        "bool_kpm": (pad, None),                      # the segment route
        "bool_kpm_all_padded": (pad, None),
        "additive_kpm": (additive_pad, None),         # mask_additive
        "bool_kpm_attn_mask": (pad, causal),          # the mask_bias route
        "bool_kpm_attn_mask_all_padded": (pad, causal),
        "attn_mask": (None, causal),
        "additive_attn_mask": (None, np.where(causal, -2.0, 0.0).astype(
            np.float32)),
    }[kind]


def _check_module(cls_name, kw, kind, sq=7, sk=None, b=3):
    sk = sq if sk is None else sk
    jm, params, tm = _pair(cls_name, **kw)
    rng = np.random.RandomState(len(kind) + sq)
    x = rng.randn(sq, b, HIDDEN).astype(np.float32)
    enc = rng.randn(sk, b, HIDDEN).astype(np.float32)
    w = rng.randn(sq, b, HIDDEN).astype(np.float32)   # the cotangent
    kpm, am = _masks(rng, kind, b, sq, sk)
    encdec = cls_name == "EncdecMultiheadAttn"

    def jloss(params, x, enc):
        extra = (enc,) if encdec else ()
        out = jm.apply(params, x, *extra,
                       key_padding_mask=None if kpm is None
                       else jnp.asarray(kpm),
                       attn_mask=None if am is None else jnp.asarray(am))
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(enc))
    tx = torch.tensor(x, requires_grad=True)
    tenc = torch.tensor(enc, requires_grad=True)
    extra = (tenc,) if encdec else ()
    out = tm(tx, *extra,
             key_padding_mask=None if kpm is None else torch.tensor(kpm),
             attn_mask=None if am is None else torch.tensor(am))
    (out * torch.tensor(w)).sum().backward()
    _close(out.detach(), jout)
    for name, p in tm.named_parameters():
        _close(p.grad, jgrads[0][name])
    _close(tx.grad, jgrads[1])
    if encdec:
        _close(tenc.grad, jgrads[2])
    return out.detach(), tm


SELF_VARIANTS = [
    (dict(), "none"),
    (dict(bias=True), "bool_kpm"),
    (dict(include_norm_add=True), "bool_kpm"),
    (dict(bias=True, include_norm_add=True), "bool_kpm_attn_mask"),
    (dict(bias=True), "bool_kpm_all_padded"),
    (dict(bias=True), "bool_kpm_attn_mask_all_padded"),
    (dict(include_norm_add=True), "attn_mask"),
    (dict(bias=True, mask_additive=True), "additive_kpm"),
    (dict(mask_additive=True, include_norm_add=True), "additive_attn_mask"),
]


@pytest.mark.parametrize("kw,kind", SELF_VARIANTS,
                         ids=[f"{'-'.join(k) or 'plain'}-{m}"
                              for k, m in SELF_VARIANTS])
def test_self_attention_matches_jax(kw, kind):
    out, tm = _check_module("SelfMultiheadAttn", kw, kind)
    if kind == "bool_kpm_all_padded":
        # the segment route's all-padded batch row: zero context, so the
        # output is exactly the output projection's bias
        assert torch.equal(out[:, 0],
                           tm.out_proj_bias.detach().expand_as(out[:, 0]))


ENCDEC_VARIANTS = [
    (dict(), "none"),
    (dict(bias=True), "bool_kpm"),
    (dict(bias=True, include_norm_add=True), "bool_kpm_all_padded"),
    (dict(include_norm_add=True, mask_additive=True), "additive_kpm"),
    (dict(bias=True), "bool_kpm_attn_mask"),   # attn_mask reroutes only
]


@pytest.mark.parametrize("kw,kind", ENCDEC_VARIANTS,
                         ids=[f"{'-'.join(k) or 'plain'}-{m}"
                              for k, m in ENCDEC_VARIANTS])
def test_encdec_attention_matches_jax_with_cross_length(kw, kind):
    _check_module("EncdecMultiheadAttn", kw, kind, sq=6, sk=9)


def test_stack_loss_and_grads_match_jax():
    # the slice as a whole, as chip_smoke.py's phase 9 stacks it at full
    # width: encoder self-attention (key padding) -> decoder
    # self-attention (key padding + causal attn_mask) -> encoder-decoder
    # attention (source key padding, sq != sk), MSE against a target
    kw = dict(bias=True, include_norm_add=True)
    enc_j, enc_p, enc_t = _pair("SelfMultiheadAttn", 1, **kw)
    dec_j, dec_p, dec_t = _pair("SelfMultiheadAttn", 2, **kw)
    crs_j, crs_p, crs_t = _pair("EncdecMultiheadAttn", 3, **kw)
    rng = np.random.RandomState(9)
    b, s_src, s_tgt = 3, 10, 7
    src = rng.randn(s_src, b, HIDDEN).astype(np.float32)
    tgt = rng.randn(s_tgt, b, HIDDEN).astype(np.float32)
    target = rng.randn(s_tgt, b, HIDDEN).astype(np.float32)
    src_pad = np.arange(s_src)[None] >= rng.randint(1, s_src + 1, b)[:, None]
    tgt_pad = np.arange(s_tgt)[None] >= rng.randint(1, s_tgt + 1, b)[:, None]
    causal = np.triu(np.ones((s_tgt, s_tgt), bool), 1)

    def jloss(ps):
        x = enc_j.apply(ps[0], jnp.asarray(src),
                        key_padding_mask=jnp.asarray(src_pad))
        y = dec_j.apply(ps[1], jnp.asarray(tgt),
                        key_padding_mask=jnp.asarray(tgt_pad),
                        attn_mask=jnp.asarray(causal))
        y = crs_j.apply(ps[2], y, x, key_padding_mask=jnp.asarray(src_pad))
        return jnp.mean((y - target) ** 2)

    jl, jg = jax.value_and_grad(jloss)((enc_p, dec_p, crs_p))
    x = enc_t(torch.tensor(src), key_padding_mask=torch.tensor(src_pad))
    y = dec_t(torch.tensor(tgt), key_padding_mask=torch.tensor(tgt_pad),
              attn_mask=torch.tensor(causal))
    y = crs_t(y, x, key_padding_mask=torch.tensor(src_pad))
    loss = ((y - torch.tensor(target)) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(jl)) <= FP32_TOL * abs(float(jl))
    for module, grads in zip((enc_t, dec_t, crs_t), jg):
        for name, p in module.named_parameters():
            _close(p.grad, grads[name])


def test_context_dropout_uses_the_callers_generator():
    tm = tmha.SelfMultiheadAttn(HIDDEN, HEADS, dropout=0.5, device="cpu")
    x = torch.randn(5, 2, HIDDEN)

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tm(x, generator=g, **kw)

    plain = tm(x)                                   # no generator: no dropout
    assert torch.equal(run(1, is_training=False), plain)
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert not torch.equal(run(1), plain)


def test_state_dict_from_jax_keeps_names_and_dtypes():
    for cls_name in ("SelfMultiheadAttn", "EncdecMultiheadAttn"):
        jm = getattr(jmha, cls_name)(HIDDEN, HEADS, bias=True,
                                     include_norm_add=True)
        params = jm.init(jax.random.PRNGKey(0), jnp.bfloat16)
        sd = tmha.state_dict_from_jax(params)
        tm = getattr(tmha, cls_name)(HIDDEN, HEADS, bias=True,
                                     include_norm_add=True, device="cpu",
                                     dtype=torch.bfloat16)
        assert sorted(sd) == sorted(tm.state_dict())
        tm.load_state_dict(sd)
        for name, p in tm.state_dict().items():
            assert p.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                p.float().numpy(), np.asarray(params[name], np.float32))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmha.SelfMultiheadAttn(HIDDEN, HEADS)


def test_cpu_modules_launch_no_kernel():
    before = [k.launches for k in kernels.KERNELS]
    tm = tmha.EncdecMultiheadAttn(HIDDEN, HEADS, include_norm_add=True,
                                  device="cpu")
    x = torch.randn(4, 2, HIDDEN, requires_grad=True)
    tm(x, torch.randn(6, 2, HIDDEN),
       key_padding_mask=torch.tensor([[False] * 6, [False] * 3 + [True] * 3])
       ).sum().backward()
    assert [k.launches for k in kernels.KERNELS] == before


def test_import_pulls_in_neither_jax_nor_apex_tpu():
    code = ("import sys, apex_tpu_torch.contrib, "
            "apex_tpu_torch.contrib.multihead_attn, apex_tpu_torch.ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apex_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
