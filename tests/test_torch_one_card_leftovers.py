"""The one-card leftovers of the port against the JAX package: amp's RNN
compatibility (``amp/rnn_compat.py``, reference test
``tests/L0/test_rnn.py::test_rnn_compat_half_cell``), the public kernel
route queries and ``routing_override`` (JAX ``ops/attention.py``), and
``utils.tree.tree_size`` / ``tree_zeros_like``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp import lists as jlists
from apex_tpu.amp import rnn_compat as jrnn_compat
from apex_tpu.ops import attention as jatt
from apex_tpu.rnn import cells as jcells
from apex_tpu.utils import tree as jtree
from apex_tpu_torch import ops
from apex_tpu_torch.amp import lists as tlists
from apex_tpu_torch.amp import rnn_compat
from apex_tpu_torch.ops import attention as att
from apex_tpu_torch.rnn import cells as tcells
from apex_tpu_torch.utils import tree_size, tree_zeros_like

B, I, H = 3, 5, 8


@pytest.mark.parametrize("cell", ["lstm_cell", "mlstm_cell", "gru_cell"])
@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_half_cell_against_jax(cell, half):
    """The cells run in half with the cell state in fp32: the same dtypes
    as JAX's ``half_cell`` and its outputs within a half's rounding."""
    rs = np.random.RandomState(1)
    gates = {"lstm_cell": 4, "mlstm_cell": 4, "gru_cell": 3}[cell]
    params = {"w_ih": rs.randn(gates * H, I) * 0.3,
              "w_hh": rs.randn(gates * H, H) * 0.3,
              "b_ih": rs.randn(gates * H) * 0.1,
              "b_hh": rs.randn(gates * H) * 0.1}
    if cell == "mlstm_cell":
        params.update(w_mih=rs.randn(H, I) * 0.3, w_mhh=rs.randn(H, H) * 0.3)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rs.randn(B, I).astype(np.float32)
    hid = [rs.randn(B, H).astype(np.float32)]
    if cell != "gru_cell":
        hid.append(rs.randn(B, H).astype(np.float32))
    jhalf = jnp.bfloat16 if half == torch.bfloat16 else jnp.float16
    want = jrnn_compat.half_cell(getattr(jcells, cell), jhalf)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        tuple(jnp.asarray(h) for h in hid))
    got = rnn_compat.half_cell(getattr(tcells, cell), half)(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), tuple(torch.from_numpy(h) for h in hid))
    if not isinstance(want, tuple):
        want, got = (want,), (got,) if not isinstance(got, tuple) else got
    assert len(got) == len(want)
    tol = 2.0 ** -7 if half == torch.bfloat16 else 2.0 ** -10
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=4 * tol)


def test_whitelist_rnn_cells_like_jax():
    rnn_compat.whitelist_rnn_cells()
    rnn_compat.whitelist_rnn_cells()
    jrnn_compat.whitelist_rnn_cells()
    assert rnn_compat.RNN_CELL_NAMES == jrnn_compat.RNN_CELL_NAMES
    for name in rnn_compat.RNN_CELL_NAMES:
        assert tlists.FP16_FUNCS.count(name) == 1
        assert name in jlists.FP16_FUNCS
        assert tlists.autocast_policy(name) == "half"


def test_routes_off_the_card_like_jax():
    """Off their accelerator both packages name their non-kernel route
    (the port ``"plain"``, JAX ``"xla"``)."""
    q = torch.zeros(2, 4, 64, 128, dtype=torch.bfloat16)
    assert ops.flash_attention_route(q) == {"fwd": "plain", "bwd": "plain"}
    jq = jax.ShapeDtypeStruct((8, 64, 128), jnp.bfloat16)
    assert jatt.flash_attention_route(jq) == {"fwd": "xla", "bwd": "xla"}
    assert ops.flash_decode_route(torch.zeros(1, 4, 1, 128)) == "plain"
    assert jatt.flash_decode_route(jq) == "xla"
    assert ops.flash_attention_qkv_route(2, 64, 4, 128, device="cpu") == \
        "plain"


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.float32, 128, "scalar"), (torch.bfloat16, 8, "scalar")])
def test_attention_routes_on_the_card(dtype, d, want):
    """The card's routes, asked without one: bf16 at head dims 64 and 128
    on the tensor cores, fp32 and head dim 8 on the scalar kernels;
    ``routing_override`` forces the scalar kernels and is undone on exit,
    a forced ``"sm90"`` on operands it cannot take stays scalar."""
    q = torch.zeros(1, 2, 16, d, dtype=dtype)
    assert ops.flash_attention_route(q, device="cuda") == {"fwd": want,
                                                          "bwd": want}
    with ops.routing_override(fwd="scalar"):
        assert ops.flash_attention_route(q, device="cuda") == {
            "fwd": "scalar", "bwd": want}
        with ops.routing_override(bwd="scalar"):
            assert ops.flash_attention_route(q, device="cuda")["bwd"] == \
                "scalar"
    with ops.routing_override(fwd="sm90", bwd="sm90"):
        assert ops.flash_attention_route(q, device="cuda") == {"fwd": want,
                                                              "bwd": want}
    assert att._ROUTE_OVERRIDE == {"fwd": None, "bwd": None, "decode": None}
    with pytest.raises(ValueError):
        with ops.routing_override(fwd="xla"):
            pass


def test_decode_and_qkv_routes_on_the_card():
    q = torch.zeros(2, 4, 1, 128, dtype=torch.bfloat16)
    pools = {"bf16": torch.bfloat16, "int8": torch.int8,
             "fp8": torch.float8_e4m3fn}
    for name, dt in pools.items():
        k = torch.zeros(4, 8, 4, 128, dtype=dt)
        assert ops.flash_decode_route(q, k, device="cuda") == "sm90"
        with ops.routing_override(decode="scalar"):
            assert ops.flash_decode_route(q, k, device="cuda") == (
                "scalar" if name == "bf16" else "sm90")
    q32 = torch.zeros(2, 4, 1, 8)
    assert ops.flash_decode_route(q32, torch.zeros(4, 8, 4, 8),
                                  device="cuda") == "scalar"
    for dt, want in ((torch.bfloat16, "sm90"), (torch.float16, "sm90_f16"),
                     (torch.float32, "scalar")):
        for hn in (64, 128):
            assert ops.flash_attention_qkv_route(2, 64, 4, hn,
                                                 dtype=dt) == want
    with pytest.raises(ValueError):
        ops.flash_attention_qkv_route(2, 64, 4, 96)


def test_routing_override_leaves_plain_outputs_alone():
    """On the CPU the plain versions run whatever is forced (JAX's bar:
    an override must not change outputs)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 32, 64, generator=g) for _ in range(3))
    want = ops.flash_attention(q, k, v, causal=True)
    with ops.routing_override(fwd="scalar", bwd="scalar", decode="scalar"):
        got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, want)


def test_tree_size_and_zeros_like_against_jax():
    rs = np.random.RandomState(0)
    tree = {"a": rs.randn(3, 4).astype(np.float32),
            "b": [rs.randn(5).astype(np.float32),
                  rs.randint(0, 9, (2, 2)).astype(np.int32)]}
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": [torch.from_numpy(x) for x in tree["b"]]}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    assert tree_size(tt) == jtree.tree_size(jt) == 21
    z, jz = tree_zeros_like(tt), jtree.tree_zeros_like(jt)
    assert type(z["b"]) is list and len(z["b"]) == 2
    for got, want, src in ((z["a"], jz["a"], tt["a"]),
                           (z["b"][0], jz["b"][0], tt["b"][0]),
                           (z["b"][1], jz["b"][1], tt["b"][1])):
        assert got.dtype == src.dtype and not got.any()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tree_size([]) == 0
