"""Ring attention (``apex_tpu_torch.ops.ring_attention``) against the JAX
package's ``apex_tpu.ops.ring_attention`` and against full attention.

Four gloo ranks (rank bodies in ``tests/torch_ranks.py``, one launch for
the module) run the ring at sp 4 (the whole group) and at sp 2 (the pairs
[0, 1] and [2, 3], each on its own sequence) at bench.py's ring shape
(bh 2, s 8 x world, d 8), causal and not: each rank's output and its
(dq, dk, dv) of sum(o^2) against JAX's ``ring_attention`` under
``shard_map`` over ``"sp"`` on the emulated mesh and against full
attention on the whole sequence.  Then the bytes the backward saves
(``torch.autograd.graph.saved_tensors_hooks``) at one ``s_local``, flat
from sp 2 to sp 4: the port's form of JAX's
``test_backward_memory_flat_in_world_size``.

Tolerances: against JAX (the same two fp32 passes, products in another
order) 1e-5 x max(1, max|ref|); against full attention (one softmax, not
an online one) 1e-4 x max(1, max|ref|), JAX's own bar for its ring; the
saved bytes exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.ops import ring_attention as jring
from apex_tpu_torch.ops import ring_attention
from apex_tpu_torch.parallel.multiproc import spawn

import torch_ranks

WORLD, BH, D = 4, 2, 8
S_LOCAL = 8          # bench.py's ring: s = 8 x world
JAX_TOL, FULL_TOL = 1e-5, 1e-4


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bar = tol * max(1.0, float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(got - ref)))
    assert err <= bar, (err, bar)


def _qkv(sp, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(BH, S_LOCAL * sp, D).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    case = {"sp4": [_qkv(4, 0)], "sp2": [_qkv(2, 1), _qkv(2, 2)],
            "s_local": 16}
    spawn(torch_ranks.ring_checks, WORLD, str(out / "store"), str(out),
          case)
    return case, torch_ranks.load_ranks(str(out), WORLD)


def _full(q, k, v, causal):
    """Full attention on the whole sequence, and the gradients of
    sum(o^2) (fp32, plain autograd)."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    s = q @ k.transpose(-1, -2) / np.sqrt(D)
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                          float("-inf"))
    o = torch.softmax(s, -1) @ v
    o.pow(2).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def _jax_ring(q, k, v, sp, causal):
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))

    def loss(q, k, v):
        def run(q, k, v):
            o = jring(q, k, v, "sp", causal=causal)
            return jax.lax.psum(jnp.sum(o ** 2), "sp"), o
        return shard_map(run, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                         out_specs=(P(), P(None, "sp")),
                         check_vma=False)(q, k, v)

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(o),) + tuple(np.asarray(x) for x in g)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sp", [4, 2])
def test_ring_attention_matches_jax_and_full_attention(ranks, sp, causal):
    case, runs = ranks
    for i, (q, k, v) in enumerate(case[f"sp{sp}"]):
        jref = _jax_ring(q, k, v, sp, causal)
        full = _full(q, k, v, causal)
        for r in range(sp):
            got = runs[i * sp + r][(sp, causal)]
            cut = slice(r * S_LOCAL, (r + 1) * S_LOCAL)
            for a, jb, fb in zip(got, jref, full):
                _close(a, jb[:, cut], JAX_TOL)
                _close(a, np.asarray(fb)[:, cut], FULL_TOL)


def test_backward_saves_the_same_bytes_at_every_ring_size(ranks):
    case, runs = ranks
    n = case["s_local"]
    want = 4 * BH * n * 16 * 4 + BH * n * 4     # q, k, v, o fp32 + lse
    for run in runs:
        assert run[("saved_bytes", 2)] == run[("saved_bytes", 4)] == want


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_one_rank_is_plain_attention(causal):
    q, k, v = _qkv(1, 3)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ring_attention(tq, tk, tv, None, causal=causal)
    o.pow(2).sum().backward()
    for a, b in zip((o.detach(), tq.grad, tk.grad, tv.grad),
                    _full(q, k, v, causal)):
        _close(a, b, FULL_TOL)
