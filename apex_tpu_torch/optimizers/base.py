"""What the fused optimizers share: the skip-on-overflow step and the
update's rounding.

PyTorch port of the JAX package's ``apex_tpu/optimizers/base.py``.  The
JAX optimizers are functional (``step(grads, state, params)``) and amp
composes them with a branchless ``step_if_finite``; here they are
``torch.optim.Optimizer``s that update their parameters and state in
place, and :meth:`FusedOptimizer.step_if_finite` gives the same
contract: every tensor the step writes (parameters, fp32 state, the
step count on the device) is copied first in one fused copy, the step
runs, and each tensor takes its copy's bits back where ``finite`` is
false (``torch.where``, no host read).  A skipped step leaves all of
them bitwise as they were.

Each update is ``torch._foreach_*`` over a parameter group in fp32,
whatever the parameters' dtype, and :func:`apply_updates` rounds the
result back as the JAX package's ``apply_updates`` does: ``(p.float() +
u).to(p.dtype)``.  None of it is a hand-written kernel: the JAX package
has no Pallas kernel here either (one fused XLA computation per step).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from apex_tpu_torch.utils.tree import tree_select_


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """p <- (p.float() + u).to(p.dtype), in place: one fused add over the
    fp32 parameters, a rounding copy for the others."""
    fp32 = [(p, u) for p, u in zip(params, updates)
            if p.dtype == torch.float32]
    if fp32:
        torch._foreach_add_([p for p, _ in fp32], [u for _, u in fp32])
    for p, u in zip(params, updates):
        if p.dtype != torch.float32:
            p.copy_(p.float() + u)


def f32(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor in fp32 (itself when it already is)."""
    return [t.float() for t in tensors]


def device_step(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """A group's step count: one int32 0-d tensor on the parameters'
    device, zero."""
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def bias_corrections(beta1: float, beta2: float, step: torch.Tensor):
    """(1 - b1^t, 1 - b2^t) in fp32 on the device, t = ``step``."""
    t = step.float()
    return (1.0 - torch.full_like(t, beta1) ** t,
            1.0 - torch.full_like(t, beta2) ** t)


class FusedOptimizer(torch.optim.Optimizer):
    """Base of the port's fused optimizers.  A subclass names the state
    tensors it keeps per parameter (``STATE``) and implements
    ``_init_state(group, params)`` (creates what is missing, including
    the group's step count, one tensor shared by its parameters'
    states) and ``_device_update(group, params)`` (advances the step and
    updates parameters and state in place, reading ``p.grad``)."""

    STATE: tuple = ()

    def _with_grads(self, group, grads: Optional[Sequence] = None):
        """(params, their gradients) of a group: from ``grads`` (one for
        each parameter of every group, in order, None for none) when
        given, else each parameter's ``.grad``.  An fp32 gradient of a
        half parameter comes in through ``grads``: ``.grad`` must match
        the parameter's dtype."""
        if grads is None:
            params = [p for p in group["params"] if p.grad is not None]
            return params, [p.grad for p in params]
        pairs = [(p, g) for p, g in zip(group["params"], grads)
                 if g is not None]
        return [p for p, _ in pairs], [g for _, g in pairs]

    def _grads_by_group(self, grads):
        """``grads`` split by parameter group (or Nones)."""
        if grads is None:
            return [None] * len(self.param_groups)
        grads = list(grads)
        n = sum(len(g["params"]) for g in self.param_groups)
        if len(grads) != n:
            raise ValueError(f"{len(grads)} gradients for {n} parameters")
        out, at = [], 0
        for g in self.param_groups:
            out.append(grads[at:at + len(g["params"])])
            at += len(g["params"])
        return out

    def _step_tensors(self, group, params) -> List[torch.Tensor]:
        """Every tensor the update writes: the parameters, their state
        tensors, and the group's step count (once)."""
        out = list(params)
        for p in params:
            st = self.state[p]
            out += [st[k] for k in self.STATE]
        step = self.state[params[0]].get("step")
        if isinstance(step, torch.Tensor):
            out.append(step)
        return out

    def _init_state(self, group, params) -> None:
        raise NotImplementedError

    def _device_update(self, group, params, grads) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, *, grads=None):
        """One step from each parameter's ``.grad``, or from ``grads``
        (one for each parameter of every group, in order)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group, gg in zip(self.param_groups, self._grads_by_group(grads)):
            params, gs = self._with_grads(group, gg)
            if params:
                self._init_state(group, params)
                self._device_update(group, params, gs)
        return loss

    @torch.no_grad()
    def step_if_finite(self, finite: torch.Tensor, grads=None) -> None:
        """The step where ``finite`` (a device bool) holds; otherwise
        every tensor it writes keeps its bits (the JAX package's
        ``step_if_finite``: the reference patches ``optimizer.step`` into
        a no-op on overflow).  Reads nothing on the host.  ``grads`` as
        :meth:`step` takes them (``amp.scaled_value_and_grad``'s)."""
        for group, gg in zip(self.param_groups, self._grads_by_group(grads)):
            params, gs = self._with_grads(group, gg)
            if not params:
                continue
            self._init_state(group, params)
            written = self._step_tensors(group, params)
            saved = [torch.empty_like(t) for t in written]
            torch._foreach_copy_(saved, written)
            self._device_update(group, params, gs)
            tree_select_(finite, written, saved)


__all__ = ["FusedOptimizer", "apply_updates", "f32", "device_step",
           "bias_corrections"]
