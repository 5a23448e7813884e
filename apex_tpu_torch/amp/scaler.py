"""Loss scaling as a state machine on the device.

PyTorch port of the JAX package's ``apex_tpu/amp/scaler.py`` (reference
``LossScaler``, apex/amp/scaler.py:33-217).  Defaults as the reference:
init scale 2^16, x2 after 2000 overflow-free steps, /2 on overflow, cap
2^24.  The reference polls a ``noop_flag`` on the host every step; here
the state is three device tensors, the overflow check is one all-finite
reduction on the device (``utils.tree_isfinite``) and the update is
branchless (``torch.where``), so scale, unscale, check, skip and update
never read a device value on the host.  Methods are functional: each
returns a new :class:`LossScaleState`, as the JAX ones do.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch

from apex_tpu_torch.utils.tree import tree_isfinite


class LossScaleState(NamedTuple):
    """``loss_scale`` fp32, ``unskipped`` (overflow-free steps since the
    last growth) and ``skipped`` (steps skipped on overflow, ever) int32:
    0-d tensors on the device."""

    loss_scale: torch.Tensor
    unskipped: torch.Tensor
    skipped: torch.Tensor


def _state(scale, unskipped, skipped, device) -> LossScaleState:
    # filled on the device (torch.full), not copied from the host: a
    # blocking copy would synchronise
    return LossScaleState(
        loss_scale=torch.full((), scale, dtype=torch.float32, device=device),
        unskipped=torch.full((), unskipped, dtype=torch.int32, device=device),
        skipped=torch.full((), skipped, dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Static or dynamic loss scaler (functions over LossScaleState)."""

    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 2000
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24
    dynamic: bool = True

    @classmethod
    def static(cls, scale: float) -> "LossScaler":
        return cls(init_scale=scale, dynamic=False)

    @classmethod
    def dynamic_scaler(cls, **kw) -> "LossScaler":
        return cls(dynamic=True, **kw)

    def init(self, device=None) -> LossScaleState:
        return _state(self.init_scale, 0, 0, device)

    def scale(self, loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
        """loss * scale in fp32 (the reference's ``loss.float() *
        loss_scale``: in fp16 the product would saturate at scales near
        2^15)."""
        return loss.float() * state.loss_scale

    def unscale(self, grads: Sequence[torch.Tensor], state: LossScaleState
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(fp32 grads * (1 / scale), finite): each gradient widened to
        fp32 and multiplied by the reciprocal of the scale, then one
        all-finite check over the results.  The caller hands in
        materialised gradients (``torch.autograd.grad``'s), so the check
        reads the very values the optimizer will (the JAX package pins
        them with an ``optimization_barrier``)."""
        inv = torch.reciprocal(state.loss_scale)
        floats = [g.float() for g in grads]
        out = torch._foreach_mul(floats, inv) if floats else []
        return out, tree_isfinite(out, device=state.loss_scale.device)

    def update(self, state: LossScaleState, finite: torch.Tensor
               ) -> LossScaleState:
        """The branchless scale update, in the JAX package's order: on
        overflow scale / factor, clamped at ``min_scale``, and the window
        reset; else x factor once ``scale_window`` clean steps have
        passed, capped at ``max_scale``.  ``skipped`` counts an overflow
        even under a static scaler: the step was dropped all the same."""
        skipped = torch.where(finite, state.skipped, state.skipped + 1)
        if not self.dynamic:
            return state._replace(skipped=skipped)
        scale = state.loss_scale
        # a tensor divisor: a division by a Python number may run as a
        # product with its rounded reciprocal
        factor = torch.full_like(scale, self.scale_factor)
        unskipped = torch.where(finite, state.unskipped + 1,
                                torch.zeros_like(state.unskipped))
        grow = unskipped >= self.scale_window
        grown = torch.minimum(scale * factor,
                              torch.full_like(scale, self.max_scale))
        shrunk = torch.maximum(scale / factor,
                               torch.full_like(scale, self.min_scale))
        scale = torch.where(finite, torch.where(grow, grown, scale), shrunk)
        unskipped = torch.where(grow, torch.zeros_like(unskipped), unskipped)
        return LossScaleState(loss_scale=scale, unskipped=unskipped,
                              skipped=skipped)


def state_dict(state: LossScaleState) -> dict:
    """The serialisable amp state, the JAX dict's keys (reads the device:
    a checkpoint-time call, not a step-time one)."""
    return {"loss_scale": float(state.loss_scale),
            "unskipped": int(state.unskipped),
            "skipped": int(state.skipped)}


def load_state_dict(d: dict, device=None) -> LossScaleState:
    """The inverse of :func:`state_dict`; ``skipped`` defaults to 0 for a
    dict written before the counter existed."""
    return _state(d["loss_scale"], d["unskipped"], d.get("skipped", 0),
                  device)


__all__ = ["LossScaleState", "LossScaler", "state_dict", "load_state_dict"]
