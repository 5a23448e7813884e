"""Adam / AdamW over a flat superblock, one kernel launch per span.

PyTorch port of the JAX package's ``apex_tpu/optimizers/flat.py`` (the
reference's ``multi_tensor_apply`` driving csrc/multi_tensor_adam.cu):
the whole parameter set lives in ONE 1-D fp32 buffer (packed by
:mod:`apex_tpu_torch.multi_tensor.flat`), and one kernel walks it,
updating params and both moments in place.  The update has two
implementations of one contract:

* a kernel written by hand for Hopper, ``csrc/flat_adam.cu``
  (``flat_adam``, in place of the TPU kernel ``_span_update``), for CUDA
  tensors;
* a plain PyTorch version, :func:`_flat_adam_plain`, the JAX kernel's
  formula op by op in its order, for CPU tensors (and, on the card, as
  the reference the kernel is held against bit for bit).

Where the tensors lie picks the implementation, and nothing else does.
``step`` is functional, as the JAX package's un-jitted step is;
``jit_step()`` (the name of the JAX entry point, kept) returns the step
that updates p, m and v in place, which is what buffer donation and
``input_output_aliases`` mean on the card.  ``lr``, ``c1 = 1 - b1^t`` and
``c2 = 1 - b2^t`` are computed on the params' device and reach the kernel
as a 3-float device buffer: no step reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apex_tpu_torch.kernels import FLAT_ADAM

__all__ = ["FlatAdamState", "FlatFusedAdam"]

_ROW = 8 * 128          # superblock lengths and span starts: multiples of this
_PLAIN_SLICE = 1 << 28  # elements per pass of the plain version (temporaries)
_NONE, _L2, _ADAMW = 0, 1, 2  # flat_adam.cu's decay modes


class FlatAdamState(NamedTuple):
    step: torch.Tensor        # int32 scalar on the params' device
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor


def _decay_mode(weight_decay: float, adam_w_mode: bool) -> int:
    if not weight_decay:
        return _NONE
    return _ADAMW if adam_w_mode else _L2


def _flat_adam_plain(p, g, m, v, scal, b1, b2, eps, wd, decay) -> None:
    """The update of one span, in place, op by op in the JAX kernel's
    order.  ``scal`` stays on the device: dividing by a Python float (a
    CPU scalar) is a multiply by its reciprocal on the card, which is not
    the kernel's true division.  Walks the span in slices to bound its
    temporaries; the update is elementwise, so no bit changes."""
    lr, c1, c2 = scal[0], scal[1], scal[2]
    for lo in range(0, p.numel(), _PLAIN_SLICE):
        sl = slice(lo, lo + _PLAIN_SLICE)
        ps, gs = p[sl], g[sl]
        if decay == _L2:
            gs = gs + wd * ps
        ms = b1 * m[sl] + (1.0 - b1) * gs
        vs = b2 * v[sl] + ((1.0 - b2) * gs) * gs
        denom = torch.sqrt(vs / c2) + eps
        upd = (ms / c1) / denom
        if decay == _ADAMW:
            upd = upd + wd * ps
        ps.copy_(ps - lr * upd)
        m[sl].copy_(ms)
        v[sl].copy_(vs)


def _flat_adam_cuda(p, g, m, v, scal, b1, b2, eps, wd, decay) -> None:
    """Launch ``flat_adam`` over one span; same contract as
    :func:`_flat_adam_plain`.  Raises on what the kernel does not take."""
    dev = p.device
    for name, t in (("g", g), ("exp_avg", m), ("exp_avg_sq", v),
                    ("scalars", scal)):
        if t.device != dev:
            raise ValueError(f"flat_adam.cu: {name} is on {t.device}, the "
                             f"params on {dev}")
    for name, t in (("params", p), ("grads", g), ("exp_avg", m),
                    ("exp_avg_sq", v), ("scalars", scal)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"flat_adam.cu takes contiguous float32 "
                            f"tensors; {name} is {t.dtype}, contiguous "
                            f"{t.is_contiguous()}")
    for name, t in (("params", p), ("grads", g), ("exp_avg", m),
                    ("exp_avg_sq", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flat_adam.cu reads 16-byte vectors: {name} "
                             "is not 16-byte aligned")
    if p.numel() % 4:
        raise ValueError(f"flat_adam.cu: span length {p.numel()} is not a "
                         "multiple of 4")
    FLAT_ADAM(dev.index, p.data_ptr(), g.data_ptr(), m.data_ptr(),
              v.data_ptr(), scal.data_ptr(), p.numel(), b1, 1.0 - b1, b2,
              1.0 - b2, eps, wd, decay,
              torch.cuda.current_stream(dev).cuda_stream)


class FlatFusedAdam:
    """FusedAdam over a packed superblock (see the module docstring).

    The flat buffer length must be a multiple of 8*128 = 1024 (pack with
    ``flatten(tree, total_multiple_of=1024)``).  The JAX class's
    ``block_rows`` (its kernel's tile height) has no counterpart: the CUDA
    kernel picks its own launch shape.
    """

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0):
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def init(self, flat_params: torch.Tensor) -> FlatAdamState:
        dev = flat_params.device
        return FlatAdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=torch.zeros_like(flat_params, dtype=torch.float32),
            exp_avg_sq=torch.zeros_like(flat_params, dtype=torch.float32))

    def jit_step(self, *, donate: bool = True, plan=None):
        """The step as a callable ``(flat_grads, state, flat_params) ->
        (params, state)``.  With ``donate`` (the default) it updates
        ``flat_params`` and both moments IN PLACE and returns them, the
        twin of the JAX kernel's ``input_output_aliases``; with
        ``donate=False`` it is :meth:`step`.  ``plan`` as in :meth:`step`."""
        def run(flat_grads, state, flat_params):
            return self._step(flat_grads, state, flat_params, plan,
                              in_place=donate)
        return run

    def step(self, flat_grads, state: FlatAdamState, flat_params, *,
             plan=None):
        """One fused Adam step over the superblock, leaving its inputs
        untouched.  ``plan=None`` walks the whole buffer in one launch; a
        :class:`~apex_tpu_torch.multi_tensor.BucketPlan` with ``world=1``
        walks it span by span, one launch each.  Results are bitwise
        identical for every plan: the update is elementwise and every
        span sees the same scalars."""
        return self._step(flat_grads, state, flat_params, plan,
                          in_place=False)

    def _spans(self, plan, n: int):
        if plan is None:
            return ((0, n),)
        if plan.world != 1 or plan.shard != n:
            raise ValueError(
                f"FlatFusedAdam wants a world=1 plan over the whole "
                f"buffer (shard={n}); got world={plan.world}, "
                f"shard={plan.shard}")
        plan.validate()   # hand-built plans: no overlaps or gaps
        if any(lo % _ROW for lo, _ in plan.spans):
            raise ValueError(
                "FlatFusedAdam bucket spans must start on 8*128 "
                "sublane-row boundaries; plan with "
                "plan_buckets(..., span_align=8*128)")
        return plan.spans

    def _scalars(self, step: torch.Tensor) -> torch.Tensor:
        """[lr, c1, c2] in fp32 on the step's device, computed there."""
        dev = step.device
        if self.bias_correction:
            t = step.to(torch.float32)
            c1 = 1.0 - self.beta1 ** t
            c2 = 1.0 - self.beta2 ** t
        else:
            c1 = c2 = torch.ones((), dtype=torch.float32, device=dev)
        lr = torch.full((), self.lr, dtype=torch.float32, device=dev)
        return torch.stack([lr, c1, c2])

    @torch.no_grad()
    def _step(self, flat_grads, state: FlatAdamState, flat_params, plan, *,
              in_place: bool):
        if flat_params.ndim != 1 or flat_params.numel() % _ROW:
            raise ValueError(
                "superblock must be 1-D with length a multiple of 1024; "
                "pack with apex_tpu_torch.multi_tensor.flatten(tree, "
                "total_multiple_of=1024)")
        n = flat_params.numel()
        for name, t in (("grads", flat_grads), ("exp_avg", state.exp_avg),
                        ("exp_avg_sq", state.exp_avg_sq)):
            if t.shape != flat_params.shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                                 f"params {tuple(flat_params.shape)}")
        spans = self._spans(plan, n)
        step = state.step + 1
        scal = self._scalars(step)
        # non-fp32 params or grads are cast first, as the JAX kernel's
        # inputs are; the update then lands in a new fp32 buffer
        p = flat_params.float()
        g = flat_grads.float()
        m, v = state.exp_avg, state.exp_avg_sq
        if not in_place:
            p = p.clone() if p is flat_params else p
            m, v = m.clone(), v.clone()
        decay = _decay_mode(self.weight_decay, self.adam_w_mode)
        update = _flat_adam_cuda if p.is_cuda else _flat_adam_plain
        for lo, hi in spans:
            update(p[lo:hi], g[lo:hi], m[lo:hi], v[lo:hi], scal, self.beta1,
                   self.beta2, self.eps, self.weight_decay, decay)
        return p, FlatAdamState(step=step, exp_avg=m, exp_avg_sq=v)
