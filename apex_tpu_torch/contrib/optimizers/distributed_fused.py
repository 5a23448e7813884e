"""ZeRO-style sharded optimizers over a process group.

PyTorch port of the JAX package's ``apex_tpu/contrib/optimizers/
distributed_fused.py``: ``DistributedFusedAdam`` (reference
distributed_fused_adam.py) and ``DistributedFusedLAMB`` (reference
distributed_fused_lamb.py).  The communication pattern is the JAX
module's:

* the gradients are packed into one flat superblock
  (:mod:`apex_tpu_torch.multi_tensor.flat`) whose length divides the
  shard count;
* one reduce-scatter (:func:`apex_tpu_torch.parallel.comm.reduce_scatter`,
  JAX's ``lax.psum_scatter(tiled=True)``) gives each rank the summed
  shard it owns, divided by the world (``grad_average``);
* the update runs on that shard only (the state holds only the shard:
  ``params + 2 params / N`` a rank instead of ``3 params``);
* one all-gather (:func:`~apex_tpu_torch.parallel.comm.all_gather_tiled`)
  gives every rank the whole updated buffer, optionally as an e5m2 delta
  on the fp32 base (``e5m2_allgather``).

Where JAX binds a mesh axis (``axis_name``), :meth:`~Distributed
ShardedOptimizer.step` takes a process group: ``None`` (or a group of
one rank) is the world-1 step, whose collectives are the identity and
which needs no ``init_process_group``.  For the 3-D mesh the group is the
whole world, whose linear rank ``d pp tp + p tp + t`` is JAX's.

The update is the JAX module's elementwise chain in fp32, taken in plain
PyTorch (JAX leaves it to XLA; it reaches no Pallas kernel): moments
computed in fp32 and stored in ``exp_avg_dtype`` (one rounding a step),
the variance in fp32.  It walks the shard in chunks of
:data:`UPDATE_CHUNK` elements, so its fp32 temporaries stay small at
1.3 B parameters; an elementwise chain gives the same bits whatever the
chunking.  ``inplace=True`` (the flagship's donation) writes the moments,
and at world 1 the parameters, over their old values.

Memory-fit knobs (the GPT-1.3B flagship): ``scatter_dtype`` (the flat
grad buffer and its reduce-scatter), ``gather_dtype`` (the updated
shards' all-gather and the flat parameter buffer), ``exp_avg_dtype``
(first-moment storage); None / fp32 keeps fp32 everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.multi_tensor.flat import (FlatSchema, flatten,
                                              make_schema, reshard_stack,
                                              unflatten)
from apex_tpu_torch.parallel import comm

#: elements of the shard one pass of the update chain covers
UPDATE_CHUNK = 1 << 24


class ShardedOptState(NamedTuple):
    step: torch.Tensor        # int32 scalar (or a stack of them)
    exp_avg: torch.Tensor     # [shard] in exp_avg_dtype (momentum)
    exp_avg_sq: torch.Tensor  # [shard] fp32 (second moment)


def _host_bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_bits(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.dtype in (torch.bfloat16, torch.float16):
        t = t.view(like.dtype)
    return t.to(like.device)


def reshard_zero_state(opt_state: ShardedOptState, *,
                       n_shards: Optional[int] = None,
                       schema: FlatSchema,
                       lead_shape=None) -> ShardedOptState:
    """Re-partition a STACKED :class:`ShardedOptState` (leading stack axes
    on every leaf, as one process holds the flagship's state) onto a new
    topology: ``n_shards`` (``[n_shards, total / n_shards]``) or
    ``lead_shape`` (e.g. ``(dp, pp, tp)``, the old stack axes linearized
    in C order).  The flat leaves concatenate in rank order and re-split
    against the TARGET ``schema`` (only all-zero tail padding may be
    dropped: real state raises); the broadcast step counter re-broadcasts
    coordinate 0.  A host pass, bit for bit, through
    :func:`~apex_tpu_torch.multi_tensor.flat.reshard_stack` (the
    checkpoint reshard's implementation)."""
    if lead_shape is None:
        if n_shards is None:
            raise ValueError("pass n_shards or lead_shape")
        lead_shape = (int(n_shards),)
    lead_shape = tuple(int(x) for x in lead_shape)
    shard = schema.total // int(np.prod(lead_shape))
    old_step = _host_bits(opt_state.step)
    n_lead_old = old_step.ndim

    def _flat(leaf):
        out = reshard_stack(_host_bits(leaf), n_lead_old, (*lead_shape, shard),
                            label=f"opt shard stack ({old_step.shape}->"
                                  f"{lead_shape})")
        return _from_bits(out, leaf)

    return ShardedOptState(
        step=_from_bits(reshard_stack(old_step, n_lead_old, lead_shape,
                                      replicated=True,
                                      label="opt step counter"),
                        opt_state.step),
        exp_avg=_flat(opt_state.exp_avg),
        exp_avg_sq=_flat(opt_state.exp_avg_sq))


def _f32_pow(base: float, step: torch.Tensor) -> torch.Tensor:
    """``base ** step`` in fp32 on the step's device (JAX's weak-typed
    float against ``step.astype(f32)``)."""
    return torch.tensor(base, dtype=torch.float32,
                        device=step.device) ** step.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class DistributedShardedOptimizer:
    """The common reduce-scatter -> sharded update -> all-gather engine."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = True
    grad_average: bool = True
    e5m2_allgather: bool = False  # reference distributed_fused_lamb.py:93
    scatter_dtype: Optional[torch.dtype] = None
    gather_dtype: Optional[torch.dtype] = None
    exp_avg_dtype: torch.dtype = torch.float32

    # -- set-up ----------------------------------------------------------

    def make_schema(self, params, n_shards: int) -> FlatSchema:
        """Pack layout whose total length divides ``n_shards`` (leaves on
        128-element boundaries, the total a multiple of 128 n_shards).
        Leaves may be ``meta`` tensors: the schema needs shapes only."""
        return make_schema(params, align=128,
                           total_multiple_of=128 * n_shards)

    def init(self, params, schema: FlatSchema, n_shards: int,
             device=None) -> ShardedOptState:
        """One rank's zero state, on ``device`` (default: the first
        leaf's)."""
        if device is None:
            leaf = next(iter(_leaves(params)), None)
            device = leaf.device if isinstance(leaf, torch.Tensor) \
                else "cpu"
        shard = schema.total // n_shards
        return ShardedOptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            exp_avg=torch.zeros(shard, dtype=self.exp_avg_dtype,
                                device=device),
            exp_avg_sq=torch.zeros(shard, dtype=torch.float32,
                                   device=device))

    @property
    def flat_param_dtype(self) -> torch.dtype:
        """The flat parameter buffer's dtype: the gather dtype, fp32 with
        the e5m2 delta transport (it needs the fp32 base)."""
        if self.e5m2_allgather:
            return torch.float32
        return self.gather_dtype or torch.float32

    # -- the update --------------------------------------------------------

    #: the chain's output needs whole-shard quantities before it is the
    #: new parameters (LAMB's trust ratio, :meth:`_finish`)
    _whole_shard_finish = False

    def _prepare(self, p: torch.Tensor, g: torch.Tensor, group,
                 g_div: int) -> dict:
        """Whole-shard quantities the chain needs before its first chunk
        (LAMB's global grad norm)."""
        return {}

    def _chain(self, p, g, m, v, step, ctx):
        """(new p, new m fp32, new v) of one chunk, all fp32."""
        raise NotImplementedError

    def _finish(self, p, new_p, ctx, group):
        """The shard's new parameters from the chain's output (LAMB's
        trust ratio)."""
        return new_p

    def _shard_update(self, p: torch.Tensor, g: torch.Tensor,
                      state: ShardedOptState, group=None, *,
                      inplace: bool = False, p_out=None, g_div: int = 1):
        """The update of one shard (or bucket span): ``p`` and ``g`` in any
        float dtype, each chunk upcast to fp32 and ``g`` divided by
        ``g_div`` there (JAX's ``g.astype(f32) / world``, so no fp32 copy
        of the whole shard is made) -> (new fp32 p, new state).
        ``inplace`` writes the moments over ``state``'s; ``p_out``
        (optional) receives the new parameters in its dtype instead of a
        new fp32 tensor."""
        step = state.step + 1
        ctx = self._prepare(p, g, group, g_div)
        n = p.numel()
        m_out = state.exp_avg if inplace else torch.empty_like(state.exp_avg)
        v_out = state.exp_avg_sq if inplace else \
            torch.empty_like(state.exp_avg_sq)
        staged = self._whole_shard_finish
        new_p = (torch.empty(n, dtype=torch.float32, device=p.device)
                 if p_out is None or staged else None)
        for a in range(0, n, UPDATE_CHUNK):
            b = min(n, a + UPDATE_CHUNK)
            g_c = g[a:b].float()
            if g_div != 1:
                g_c = g_c / g_div
            np_, m, v = self._chain(p[a:b].float(), g_c,
                                    state.exp_avg[a:b].float(),
                                    state.exp_avg_sq[a:b], step, ctx)
            m_out[a:b] = m.to(self.exp_avg_dtype)
            v_out[a:b] = v
            if new_p is not None:
                new_p[a:b] = np_
            else:
                p_out[a:b] = np_.to(p_out.dtype)
        if staged:
            new_p = self._finish(p, new_p, ctx, group)
            if p_out is not None:
                p_out.copy_(new_p)
                new_p = None
        return (new_p if p_out is None else p_out,
                ShardedOptState(step, m_out, v_out))

    # -- the sharded step --------------------------------------------------

    def step(self, grads, state: ShardedOptState, params,
             schema: FlatSchema, group=None):
        """One ZeRO step over ``group``: ``(new_params, new_state)``, the
        parameters bitwise equal on every rank."""
        flat_g, _ = flatten(grads, schema,
                            dtype=self.scatter_dtype or torch.float32)
        flat_p, _ = flatten(params, schema, dtype=self.flat_param_dtype)
        new_flat, new_state = self.step_flat(flat_g, state, flat_p, group)
        return unflatten(new_flat, schema), new_state

    def step_flat(self, flat_g: torch.Tensor, state: ShardedOptState,
                  flat_p: torch.Tensor, group=None, *,
                  inplace: bool = False):
        """:meth:`step` on packed buffers: ``flat_g`` in the scatter dtype,
        ``flat_p`` in :attr:`flat_param_dtype`; returns ``(new flat_p,
        new state)``.  ``inplace``: the moments are updated over
        ``state``'s and, at world 1, the parameters over ``flat_p``."""
        world = comm.group_size(group)
        rank = comm.group_rank(group)
        shard = flat_p.numel() // world
        # reduce-scatter: each rank receives the summed shard it owns, in
        # the scatter dtype; the chain upcasts (and averages) chunk by chunk
        g_shard = comm.reduce_scatter(flat_g, group)
        g_div = world if self.grad_average else 1
        p_shard = flat_p[rank * shard:(rank + 1) * shard]
        if self.e5m2_allgather:
            # ship the DELTA in e5m2 so the fp32 base is preserved
            new_p_shard, new_state = self._shard_update(
                p_shard.float(), g_shard, state, group, inplace=inplace,
                g_div=g_div)
            delta = (new_p_shard - p_shard.float()).to(torch.float8_e5m2)
            gathered = comm.all_gather_tiled(delta, group).float()
            return flat_p + gathered, new_state
        out = p_shard if inplace and world == 1 else None
        new_p_shard, new_state = self._shard_update(
            p_shard, g_shard, state, group, inplace=inplace, p_out=out,
            g_div=g_div)
        if out is not None:
            return flat_p, new_state
        return (comm.all_gather_tiled(new_p_shard.to(flat_p.dtype), group),
                new_state)

    def step_buckets(self, partial_grads, state: ShardedOptState, params,
                     schema: FlatSchema, plan, group=None):
        """Bucketed twin of :meth:`step` (reference DistributedFusedAdam's
        chunked reduce-scatter pipeline): one reduce-scatter and one
        all-gather per ``plan`` bucket, each bucket a span of the per-rank
        shard (a column block of the ``[world, shard]`` view), so the
        state layout is :meth:`step`'s for every plan.  ``partial_grads``
        are this rank's unsummed gradients (their sum over the group is
        ``world`` times the data-mean gradient).  The reduce-scatter sums
        each element in rank order whatever the bucket, so every plan
        gives :meth:`step`'s bits.  ``e5m2_allgather`` is refused (the
        delta transport needs the fp32 base across the whole gather)."""
        flat_g, _ = flatten(partial_grads, schema,
                            dtype=self.scatter_dtype or torch.float32)
        flat_p, _ = flatten(params, schema, dtype=self.flat_param_dtype)
        new_flat, new_state = self.step_buckets_flat(flat_g, state, flat_p,
                                                     plan, group)
        return unflatten(new_flat, schema), new_state

    def step_buckets_flat(self, flat_g, state: ShardedOptState, flat_p,
                          plan, group=None, *, inplace: bool = False):
        """:meth:`step_buckets` on packed buffers (see :meth:`step_flat`)."""
        if self.e5m2_allgather:
            raise NotImplementedError(
                "e5m2_allgather is not supported by the bucketed step; "
                "use step() for the compressed-delta transport")
        world = comm.group_size(group)
        rank = comm.group_rank(group)
        if plan.world != world or plan.shard != flat_p.numel() // world:
            raise ValueError(
                f"bucket plan (world={plan.world}, shard={plan.shard}) "
                f"does not match this group: world={world}, shard="
                f"{flat_p.numel() // world} — re-plan after a mesh change")
        # a permuted/gapped span set would reassemble in the wrong order
        plan.validate()
        shard = plan.shard
        g_view = flat_g.reshape(world, shard)
        in_place = inplace and world == 1
        new_flat = flat_p if in_place else torch.empty_like(flat_p)
        new_view = new_flat.reshape(world, shard)
        m_out = state.exp_avg if inplace else torch.empty_like(state.exp_avg)
        v_out = state.exp_avg_sq if inplace else \
            torch.empty_like(state.exp_avg_sq)
        for lo, hi in plan.spans:
            g_b = comm.reduce_scatter(g_view[:, lo:hi].reshape(-1), group)
            p_b = flat_p[rank * shard + lo:rank * shard + hi]
            # every bucket updates off the same pre-step counter
            sub = ShardedOptState(state.step, m_out[lo:hi] if inplace
                                  else state.exp_avg[lo:hi],
                                  v_out[lo:hi] if inplace
                                  else state.exp_avg_sq[lo:hi])
            new_p_b, sub = self._shard_update(
                p_b, g_b, sub, group, inplace=inplace,
                p_out=p_b if in_place else None,
                g_div=world if self.grad_average else 1)
            if not inplace:
                m_out[lo:hi] = sub.exp_avg
                v_out[lo:hi] = sub.exp_avg_sq
            if not in_place:
                new_view[:, lo:hi] = comm.all_gather_tiled(
                    new_p_b.to(flat_p.dtype), group).reshape(world, hi - lo)
        return new_flat, ShardedOptState(state.step + 1, m_out, v_out)


def _leaves(tree):
    from apex_tpu_torch.multi_tensor.flat import _tree_flatten
    return _tree_flatten(tree)[0]


@dataclasses.dataclass(frozen=True)
class DistributedFusedAdam(DistributedShardedOptimizer):
    """Sharded AdamW (reference distributed_fused_adam.py; the update is
    multi_tensor_distopt_adam_kernel.cu's)."""

    adam_w_mode: bool = True

    def _chain(self, p, g, m, v, step, ctx):
        b1, b2 = self.betas
        if not self.adam_w_mode:
            # classic Adam: L2 decay folded into the gradient first
            g = g + self.weight_decay * p
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        if self.bias_correction:
            c1 = 1 - _f32_pow(b1, step)
            c2 = 1 - _f32_pow(b2, step)
        else:
            c1 = c2 = 1.0
        update = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        if self.adam_w_mode:
            update = update + self.weight_decay * p
        return p - self.lr * update, m, v


@dataclasses.dataclass(frozen=True)
class DistributedFusedLAMB(DistributedShardedOptimizer):
    """Sharded LAMB (reference distributed_fused_lamb.py): the global
    grad norm clips, and the trust ratio is taken per SHARD over the
    shard's parameter and update norms — the JAX module's documented
    divergence from the reference's per-tensor ratio (per-tensor ratios
    remain with the unsharded ``FusedLAMB``)."""

    max_grad_norm: float = 1.0
    weight_decay: float = 0.01
    _whole_shard_finish = True

    def step_buckets(self, partial_grads, state, params, schema, plan,
                     group=None):
        """Refused: LAMB's global grad-norm prepass needs the whole
        gradient before any shard can clip; per bucket it would be
        another optimizer."""
        raise NotImplementedError(
            "DistributedFusedLAMB has a global grad-norm prepass that "
            "a per-bucket pipeline cannot honor; use step(), or "
            "DistributedFusedAdam for the bucketed path")

    def step_buckets_flat(self, *args, **kwargs):
        return self.step_buckets(None, None, None, None, None)

    def _prepare(self, p, g, group, g_div):
        # global grad norm: the shard's square-sum, summed over the group
        g = g.float()
        if g_div != 1:
            g = g / g_div
        local_sq = torch.sum(g * g)
        global_norm = torch.sqrt(comm.all_reduce(local_sq, group))
        clip = (torch.clamp(global_norm / self.max_grad_norm, min=1.0)
                if self.max_grad_norm > 0 else None)
        return {"clip": clip, "u_sq": torch.zeros((), device=p.device)}

    def _chain(self, p, g, m, v, step, ctx):
        b1, b2 = self.betas
        if ctx["clip"] is not None:
            g = g / ctx["clip"]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        if self.bias_correction:
            c1 = 1 - _f32_pow(b1, step)
            c2 = 1 - _f32_pow(b2, step)
        else:
            c1 = c2 = 1.0
        update = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        update = update + self.weight_decay * p
        # the chain's "new p" is the update; the trust ratio needs the
        # whole shard's norms (_finish)
        return update, m, v

    def _finish(self, p, update, ctx, group):
        p = p.float()
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(update)
        one = torch.ones((), device=p.device)
        trust = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                            one)
        return p - self.lr * trust * update
