"""Pipeline-parallel schedules.

PyTorch port of the JAX package's ``apex_tpu/transformer/
pipeline_parallel/schedules.py`` (reference schedules/__init__.py:16-34
and its three schedule modules).  The JAX module runs the whole schedule
as one ``lax.scan`` under ``shard_map``, every stage the same program;
here each stage is a process (one rank of the pipeline group), its
stage an ``nn.Module`` on its own device, and the schedule an eager loop
over the same time slots, the stages handing activations and gradients
to their neighbours with point-to-point transfers
(:func:`apex_tpu_torch.parallel.comm.exchange`).  The losses, the
gradients and the bound on live activations are the JAX module's:

* the forward of microbatch ``m`` at virtual stage ``v`` runs at step
  ``t = m + v``, its backward at ``t = m + 2(V-1) - v`` (``V`` = pipeline
  size x model chunks); a step's transfers follow its slots, so an
  activation or a gradient arrives the step it is needed;
* a stage keeps only the *inputs* of its microbatches in flight, at most
  ``2(V-1-v)+1`` of them, so live activations are O(p·vpp) whatever the
  number of microbatches (:data:`STATS` records the most held); the
  forward slot runs without a graph, and the backward slot runs the stage
  again from the saved input (``jax.vjp`` in the JAX module) and pulls
  the gradients of the parameters and of the input out of that graph;
* the gradients accumulate in fp32, each microbatch's backward seeded
  with ``1/m`` at the loss; only the microbatches a slot really holds
  run, so nothing needs masking;
* the loss is summed over the pipeline group, so every stage returns it
  (the JAX module's ``psum``).

One difference of mechanism: at the last virtual stage the forward slot
and the backward slot of a microbatch fall in the same step, and the
port runs that stage once (in the backward slot) where the JAX program
also runs the graph-free forward.

``stage_fn(stage, h_in, microbatch)`` (``chunk_fn(stage, h_in,
microbatch, k)`` with interleaving, ``k`` the local chunk) and
``loss_fn(stage, y, microbatch)`` take this rank's stage module in place
of the JAX params tree.  The first virtual stage's ``h_in`` is a zero
buffer of ``tensor_shape`` (its stage embeds from the microbatch);
activations and gradients travel in ``dtype``.  ``microbatches`` is a
tensor or a dict, list or tuple of them with a leading axis of
``n_microbatches``.  Gradients come back as fp32 tensors in the order of
the stage's ``parameters()`` (a list a chunk with interleaving), the
form the port's optimizers take with ``step(grads=...)``; they are this
rank's, not reduced over data-parallel replicas.

Under tensor parallelism every tp rank of a stage runs the same slots in
the same order, so the collectives of a stage's recompute match up.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import PIPELINE_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.utils import unwrap_model
from apex_tpu_torch.utils.tree import _map

StageFn = Callable[[nn.Module, Optional[torch.Tensor], Any], torch.Tensor]
LossFn = Callable[[nn.Module, torch.Tensor, Any], torch.Tensor]


class ScheduleStats:
    """What the last pipelined schedule of this process ran, per local
    chunk: the stage inputs it held at most at once, its forward slots
    run without a graph and its backward slots (each a forward with a
    graph and a backward)."""

    def __init__(self):
        self.reset(0)

    def reset(self, chunks: int) -> None:
        self.peak_saved_inputs = [0] * chunks
        self.forward_slots = [0] * chunks
        self.backward_slots = [0] * chunks


STATS = ScheduleStats()


def _get_microbatch(microbatches, m: int):
    return _map(lambda _, a: a[m], microbatches)


def _device_of(stage: nn.Module, device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    for p in stage.parameters():
        return p.device
    raise ValueError("a stage without parameters needs device=")


def forward_backward_no_pipelining(
    forward_step_fn: Callable,
    loss_fn: Optional[LossFn] = None,
    params: Any = None,
    microbatches: Any = None,
    *,
    n_microbatches: int,
    tensor_shape: Optional[Sequence[int]] = None,
    dtype: torch.dtype = torch.float32,
    axis_name: str = PIPELINE_AXIS,
    forward_only: bool = False,
    remat: bool = False,
    device=None,
):
    """Microbatched gradient accumulation without pipelining (reference
    fwd_bwd_no_pipelining.py:29-91).  Two calling conventions, so that
    :func:`get_forward_backward_func` swaps schedules by pipeline size:

    * ``forward_step_fn(stage, microbatch) -> scalar loss`` with
      ``loss_fn=None``;
    * the pipelined ``(stage_fn, loss_fn, stage, microbatches, ...,
      tensor_shape=...)``: the stage runs as the only stage (on a zero
      input of ``tensor_shape``) and ``loss_fn`` applies the head.

    ``params`` is the stage module.  Returns ``(mean loss, grads)``, the
    gradients fp32 and averaged over the microbatches, or ``(mean
    loss,)`` with ``forward_only``.  ``remat`` recomputes each
    microbatch's forward in its backward (``torch.utils.checkpoint``)."""
    del axis_name   # one stage: no pipeline transfer
    stage = unwrap_model(params)
    if loss_fn is not None:
        if tensor_shape is None:
            raise ValueError("tensor_shape is required with a loss_fn")
        buf0 = torch.zeros(tuple(tensor_shape), dtype=dtype,
                           device=_device_of(stage, device))

        def step(st, mb):
            return loss_fn(st, forward_step_fn(st, buf0, mb), mb)
    else:
        step = forward_step_fn
    if remat:
        plain = step

        def step(st, mb):
            return checkpoint(plain, st, mb, use_reentrant=False)

    if forward_only:
        with torch.no_grad():
            losses = [step(stage, _get_microbatch(microbatches, m)).float()
                      for m in range(n_microbatches)]
        return (torch.stack(losses).mean(),)
    params_ = list(stage.parameters())
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params_]
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=_device_of(stage, device))
    for m in range(n_microbatches):
        loss = step(stage, _get_microbatch(microbatches, m)).float()
        live = [i for i, p in enumerate(params_) if p.requires_grad]
        gs = torch.autograd.grad(loss, [params_[i] for i in live],
                                 allow_unused=True)
        for i, g in zip(live, gs):
            if g is not None:
                acc[i].add_(g.float())
        loss_sum += loss.detach()
    inv = 1.0 / n_microbatches
    return loss_sum * inv, [g * inv for g in acc]


def _interleaved_one_f_one_b(
    chunk_fn: Callable,
    loss_fn: LossFn,
    chunks: Sequence[nn.Module],
    microbatches: Any,
    *,
    n_microbatches: int,
    n_stages: Optional[int] = None,
    tensor_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    axis_name: str = PIPELINE_AXIS,
    forward_only: bool = False,
):
    """The schedule over the virtual stages ``v = d + p·k`` of this rank
    ``d`` (local chunk ``k``; see the module docstring).  Returns
    ``(loss summed over the pipeline group, one fp32 gradient list a
    chunk)``, or ``(loss, None)`` with ``forward_only``, which runs the
    ``m + V - 1`` forward steps alone, without graphs."""
    group = parallel_state.group_of(axis_name)
    p = comm.group_size(group)
    if n_stages is not None and n_stages != p:
        raise ValueError(f"n_stages={n_stages} but the pipeline group has "
                         f"{p} rank(s)")
    d = comm.group_rank(group)
    mods = [unwrap_model(c) for c in chunks]
    vpp = len(mods)
    V, M = p * vpp, n_microbatches
    dev = _device_of(mods[0])
    shape = tuple(tensor_shape)
    zeros_in = torch.zeros(shape, dtype=dtype, device=dev)
    params = [list(m.parameters()) for m in mods]
    grads = (None if forward_only else
             [[torch.zeros(q.shape, dtype=torch.float32, device=q.device)
               for q in ps] for ps in params])
    seed = torch.full((), 1.0 / M, dtype=torch.float32, device=dev)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    # by local chunk: received activations and gradients, saved inputs,
    # each keyed by microbatch
    acts = [{} for _ in range(vpp)]
    dys = [{} for _ in range(vpp)]
    saved = [{} for _ in range(vpp)]
    STATS.reset(vpp)
    T = M + V - 1 if forward_only else M + 2 * (V - 1)

    def valid(m):
        return 0 <= m < M

    def forward_slot(k, v, t, sends):
        m = t - v
        if not valid(m):
            return
        h_in = zeros_in if v == 0 else acts[k].pop(m)
        mb = _get_microbatch(microbatches, m)
        if not forward_only:
            saved[k][m] = h_in
            STATS.peak_saved_inputs[k] = max(STATS.peak_saved_inputs[k],
                                             len(saved[k]))
            if v == V - 1:      # its backward slot runs it, this step
                return
        with torch.no_grad():
            y = chunk_fn(mods[k], h_in, mb, k)
            STATS.forward_slots[k] += 1
            if v == V - 1:
                loss_sum.add_(loss_fn(mods[k], y, mb).float())
            else:
                sends.append((y.to(dtype), (v + 1) % p, 2 * (v + 1)))

    def backward_slot(k, v, t, sends):
        m = t - 2 * (V - 1) + v
        if not valid(m):
            return
        x = saved[k].pop(m).detach().requires_grad_(v > 0)
        mb = _get_microbatch(microbatches, m)
        with torch.enable_grad():
            y = chunk_fn(mods[k], x, mb, k)
            if v == V - 1:
                loss = loss_fn(mods[k], y, mb).float()
                outs, seeds = (loss,), (seed,)
                loss_sum.add_(loss.detach())
            else:
                outs, seeds = (y,), (dys[k].pop(m).to(y.dtype),)
        live = [i for i, q in enumerate(params[k]) if q.requires_grad]
        inputs = [params[k][i] for i in live] + ([x] if v > 0 else [])
        gs = torch.autograd.grad(outs, inputs, seeds, allow_unused=True)
        STATS.backward_slots[k] += 1
        for i, g in zip(live, gs):
            if g is not None:
                grads[k][i].add_(g.float())
        if v > 0:
            dx = gs[-1] if gs[-1] is not None else torch.zeros_like(x)
            sends.append((dx.to(dtype), (v - 1) % p, 2 * (v - 1) + 1))

    grad_mode = torch.no_grad() if forward_only else contextlib.nullcontext()
    with grad_mode:
        for t in range(T):
            sends = []
            for k in range(vpp):
                v = d + p * k
                forward_slot(k, v, t, sends)
                if not forward_only:
                    backward_slot(k, v, t, sends)
            # what the next step's slots take from the neighbours
            recvs, into = [], []
            for k in range(vpp):
                v = d + p * k
                if v > 0 and valid(t + 1 - v) and t + 1 < T:
                    recvs.append(comm.Recv((v - 1) % p, shape, dtype, dev,
                                           2 * v))
                    into.append((acts[k], t + 1 - v))
                mb = t + 1 - 2 * (V - 1) + v
                if not forward_only and v < V - 1 and valid(mb):
                    recvs.append(comm.Recv((v + 1) % p, shape, dtype, dev,
                                           2 * v + 1))
                    into.append((dys[k], mb))
            for (box, m), got in zip(into, comm.exchange(sends, recvs,
                                                         group)):
                box[m] = got
    loss = comm.all_reduce(loss_sum * (1.0 / M), group)
    return loss, grads


def forward_backward_pipelining_without_interleaving(
    stage_fn: StageFn,
    loss_fn: LossFn,
    params: nn.Module,
    microbatches: Any,
    *,
    n_microbatches: int,
    tensor_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    axis_name: str = PIPELINE_AXIS,
    forward_only: bool = False,
    remat: bool = True,
    n_stages: Optional[int] = None,
):
    """Non-interleaved 1F1B (reference
    fwd_bwd_pipelining_without_interleaving.py:22-170): the one-chunk
    case of the interleaved schedule, as in the JAX module.  ``params``
    is this rank's stage; ``tensor_shape`` the inter-stage activation's
    shape.  Returns ``(mean loss, grads)`` or ``(mean loss,)`` with
    ``forward_only``; ``remat`` is accepted for the JAX signature (the
    backward slot always recomputes its stage)."""
    loss, grads = _interleaved_one_f_one_b(
        lambda st, h, mb, k: stage_fn(st, h, mb), loss_fn, [params],
        microbatches, n_microbatches=n_microbatches, n_stages=n_stages,
        tensor_shape=tensor_shape, dtype=dtype, axis_name=axis_name,
        forward_only=forward_only)
    return (loss,) if forward_only else (loss, grads[0])


def forward_backward_pipelining_with_interleaving(
    chunk_fn: Callable,
    loss_fn: LossFn,
    chunked_params: Sequence[nn.Module],
    microbatches: Any,
    *,
    n_microbatches: int,
    num_model_chunks: int,
    tensor_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    axis_name: str = PIPELINE_AXIS,
    forward_only: bool = False,
    remat: bool = True,
):
    """The interleaved (virtual-pipeline) schedule (reference
    fwd_bwd_pipelining_with_interleaving.py:1-308): ``chunked_params`` are
    this rank's ``num_model_chunks`` chunks (``build_model``'s list),
    chunk ``k`` the virtual stage ``rank + p·k``.  Returns ``(mean loss,
    one gradient list a chunk)`` or ``(mean loss,)``."""
    if len(chunked_params) != num_model_chunks:
        raise ValueError(f"{len(chunked_params)} chunks for "
                         f"num_model_chunks={num_model_chunks}")
    loss, grads = _interleaved_one_f_one_b(
        chunk_fn, loss_fn, chunked_params, microbatches,
        n_microbatches=n_microbatches, tensor_shape=tensor_shape,
        dtype=dtype, axis_name=axis_name, forward_only=forward_only)
    return (loss,) if forward_only else (loss, grads)


def get_forward_backward_func(
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_size: int = 1,
):
    """Schedule selector (reference schedules/__init__.py:16-34)."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining


__all__ = ["forward_backward_no_pipelining",
           "forward_backward_pipelining_without_interleaving",
           "forward_backward_pipelining_with_interleaving",
           "get_forward_backward_func", "ScheduleStats", "STATS"]
