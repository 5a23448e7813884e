"""Expert parallelism: a Switch-style Mixture-of-Experts MLP.

PyTorch port of the JAX package's ``apex_tpu/transformer/moe.py``
(token-choice top-1, Switch Transformer):

- gate: fp32 ``logits = h @ wg``, softmax, the expert of each token its
  ``argmax`` (the first on a tie) and its gate weight the largest
  probability;
- static-shape dispatch: each expert has ``C = ceil(T · capacity_factor /
  E)`` slots per dispatching rank; a token's slot is its position in its
  expert's queue (a cumulative sum over the one-hot of the experts), and a
  token past the capacity is dropped: its output is exactly zero (the
  caller's residual carries it);
- with an expert group of ``world`` ranks, :func:`~apex_tpu_torch.parallel.
  comm.all_to_all` sends each rank's ``[world, E_local, C, H]`` slab to the
  experts' owners, so that each rank applies its ``E / world`` experts to
  every rank's tokens, and a second one brings the results back;
- the expert FFN as two fp32 batched products over ``[E_local, world·C,
  H]`` with the biases and tanh GELU, cast back to ``h``'s dtype and
  scaled by the gate weight;
- the Switch load-balancing loss ``E · Σ_e frac_e · mean_p_e``, its two
  statistics averaged over the expert group so that every rank adds the
  same term (the gate is replicated); the mean is summed in fp64 and
  rounded once, so it has the same bits in any rank order.

Nothing here waits on the host: the routing is index arithmetic on the
device (no ``nonzero``, no boolean indexing, no ``one_hot`` range
check), a kept token is copied into a slot of its own and a dropped one
into a spare row past the ``E · C`` slots that nothing reads; the combine
gathers each token's slot back (``index_select``), whose backward adds
exactly one nonzero row into each kept slot, so it is exact.  The
products are library GEMMs in fp32, as the JAX package leaves them to
XLA; no kernel of this repository replaces them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer.tensor_parallel.layers import normal_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    ffn_hidden_size: int
    num_experts: int
    capacity_factor: float = 1.25
    # auxiliary load-balancing loss coefficient (Switch eq. 4)
    aux_loss_coeff: float = 1e-2
    init_method_std: float = 0.02


def _mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of the ranks' fp32 ``x``, summed in fp64 and rounded once:
    the same bits on every rank whatever order the backend sums in."""
    return (comm.all_reduce(x.double(), group)
            / comm.group_size(group)).to(x.dtype)


class _GroupMean(torch.autograd.Function):
    """The mean over the ranks of ``group`` (``lax.pmean``); the backward
    is the same mean of the cotangents (the transpose of a ``psum``), so
    each rank's gradient is that of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return _mean_over(g.contiguous(), ctx.group), None


class _Gate(nn.Module):
    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)


class _Experts(nn.Module):
    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(b1)
        self.w2 = nn.Parameter(w2)
        self.b2 = nn.Parameter(b2)


class SwitchMLP(nn.Module):
    """Top-1 routed MLP.  ``num_experts`` must divide by the size of the
    expert ``group`` (``None``: one rank); each rank owns the experts
    ``[r·E/w, (r+1)·E/w)`` and a replica of the gate.

    Parameters (fp32): ``gate.weight`` [H, E], ``experts.w1`` [E_local,
    H, F], ``experts.b1`` [E_local, F], ``experts.w2`` [E_local, F, H],
    ``experts.b2`` [E_local, H].  Every rank draws the whole master from
    ``generator`` (the gate, then ``w1``, then ``w2``, each N(0, std²);
    the biases zero) and keeps its experts, so expert ranks start from the
    one-rank module."""

    def __init__(self, cfg: MoEConfig, *, group=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        world = comm.group_size(group)
        if cfg.num_experts % world:
            raise ValueError(f"{cfg.num_experts} experts do not divide over "
                             f"an expert group of {world} ranks")
        self.cfg = cfg
        self.group = group
        self.world = world
        self.e_local = cfg.num_experts // world
        init = normal_init(cfg.init_method_std)
        H, Fh, E = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_experts
        gate = init((H, E), generator, dev)
        w1 = init((E, H, Fh), generator, dev)
        w2 = init((E, Fh, H), generator, dev)
        mine = slice(comm.group_rank(group) * self.e_local,
                     (comm.group_rank(group) + 1) * self.e_local)
        self.gate = _Gate(gate)
        self.experts = _Experts(
            w1[mine].clone(), torch.zeros(self.e_local, Fh, device=dev),
            w2[mine].clone(), torch.zeros(self.e_local, H, device=dev))

    def capacity(self, n_tokens: int) -> int:
        """Per-expert slot count for ``n_tokens`` LOCAL tokens (capacity is
        per dispatching rank; the world size does not enter)."""
        return max(1, math.ceil(
            n_tokens * self.cfg.capacity_factor / self.cfg.num_experts))

    def route(self, h: torch.Tensor):
        """The gate of ``h`` [T, H]: ``(expert [T], gate_w [T] fp32, slot
        [T], frac [E], mean_p [E])``.  ``slot`` is ``expert · C +
        position`` for a kept token and ``E · C`` (the spare row) for a
        dropped one; ``frac`` and ``mean_p`` are this rank's share of
        tokens and mean probability per expert (:meth:`aux_loss`)."""
        E = self.cfg.num_experts
        C = self.capacity(h.shape[0])
        logits = torch.matmul(h.float(), self.gate.weight.float())  # [T, E]
        probs = torch.softmax(logits, dim=-1)
        expert = torch.argmax(probs, dim=-1)              # first of a tie
        gate_w = probs.max(dim=-1).values
        # the one-hot expert-major [E, T], so the queue positions are a
        # scan along the contiguous dim (integers: exact in any layout)
        onehot = (torch.arange(E, device=h.device)[:, None] == expert
                  ).to(torch.int32)
        pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=0)
        slot = torch.where(pos < C, expert * C + pos, E * C)
        return expert, gate_w, slot, onehot.float().mean(dim=1), \
            probs.mean(dim=0)

    def aux_loss(self, frac: torch.Tensor, mean_p: torch.Tensor
                 ) -> torch.Tensor:
        """The Switch loss ``E · Σ frac · mean_p``; under expert
        parallelism both statistics are first averaged over the group, so
        every rank adds the same term."""
        E = self.cfg.num_experts
        if self.world > 1:
            stats = _GroupMean.apply(torch.cat([frac, mean_p]), self.group)
            frac, mean_p = stats[:E], stats[E:]
        return E * torch.sum(frac * mean_p)

    def dispatch(self, h: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        """``h`` [T, H] copied into the slots ``[world, E_local, C, H]``
        (empty slots zero; the spare row of the dropped tokens cut off)."""
        E, C = self.cfg.num_experts, self.capacity(h.shape[0])
        disp = h.new_zeros(E * C + 1, h.shape[1]).index_copy(0, slot, h)
        return disp[:E * C].view(self.world, self.e_local, C, h.shape[1])

    def combine(self, out: torch.Tensor, slot: torch.Tensor,
                gate_w: torch.Tensor) -> torch.Tensor:
        """Each token's row of ``out`` [E, C, H] (the spare row zero for a
        dropped token), scaled by its gate weight in ``out``'s dtype."""
        H = out.shape[-1]
        rows = torch.cat([out.reshape(-1, H), out.new_zeros(1, H)])
        return rows.index_select(0, slot) * gate_w[:, None].to(out.dtype)

    def forward(self, h: torch.Tensor):
        """``h`` [T, H]: this rank's tokens.  Returns ``(out [T, H] in h's
        dtype, aux)``, ``aux`` the Switch load-balancing loss (mean-
        normalized; add ``cfg.aux_loss_coeff · aux`` to the model loss)."""
        T, H = h.shape
        C, w, el = self.capacity(T), self.world, self.e_local
        _, gate_w, slot, frac, mean_p = self.route(h)
        aux = self.aux_loss(frac, mean_p)
        x = self.dispatch(h, slot)                        # [w, E_l, C, H]
        if w > 1:   # every rank's tokens for this rank's experts
            x = comm.all_to_all(x, self.group)
        x = x.transpose(0, 1).reshape(el, w * C, H)
        ex = self.experts
        out = expert_ffn(x, ex.w1, ex.b1, ex.w2, ex.b2).to(h.dtype)
        out = out.view(el, w, C, H).transpose(0, 1).contiguous()
        if w > 1:   # back to the ranks whose tokens they are
            out = comm.all_to_all(out, self.group)
        return self.combine(out, slot, gate_w), aux


def expert_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Experts ``w1`` [n_e, H, F], ``b1`` [n_e, F], ``w2`` [n_e, F, H],
    ``b2`` [n_e, H] on their tokens ``x`` [n_e, n, H]: two fp32 batched
    products with the biases and tanh GELU between (the JAX einsums);
    fp32 [n_e, n, H]."""
    inter = torch.bmm(x.float(), w1.float()) + b1[:, None]
    inter = F.gelu(inter, approximate="tanh")
    return torch.bmm(inter, w2.float()) + b2[:, None]


def _is_expert_leaf(name: str) -> bool:
    return ".experts." in "." + name


def shard_master(master, rank: int, world: int) -> dict:
    """Expert rank ``rank``'s parameters of a one-rank ``state_dict`` (a
    ``SwitchMLP``'s, ``gate.weight``, ``experts.w1`` ..., or a MoE GPT's,
    ``transformer.layers.<i>.mlp.experts.w1`` ...): every ``experts``
    leaf cut to the rank's experts ``[rank·E/w, (rank+1)·E/w)`` on its
    leading axis, everything else (the gate) whole, as the JAX
    ``SwitchMLP.shard_master`` cuts its tree."""
    out = {}
    for name, t in master.items():
        if _is_expert_leaf(name):
            e_local = t.shape[0] // world
            t = t[rank * e_local:(rank + 1) * e_local]
        out[name] = t
    return out


def unshard_master(state_dicts) -> dict:
    """The one-rank ``state_dict`` of the expert ranks' (rank order): the
    ``experts`` leaves concatenated on their leading axis, the rest rank
    0's (the inverse of :func:`shard_master`)."""
    return {name: (torch.cat([sd[name] for sd in state_dicts])
                   if _is_expert_leaf(name) else t)
            for name, t in state_dicts[0].items()}


__all__ = ["MoEConfig", "SwitchMLP", "expert_ffn", "shard_master",
           "unshard_master"]
