"""``scale_loss``, ``scaled_value_and_grad`` and ``skip_or_step``: the
train-step side of amp.

PyTorch port of the JAX package's ``apex_tpu/amp/handle.py``.  The
reference's ``with amp.scale_loss(...)`` context unscales grads on exit
and patches ``optimizer.step`` to skip on overflow; here the backward is
taken through ``loss.float() * scale`` by ``torch.autograd.grad`` (the
gradients come back materialised, once, before anything reads them),
the half gradients are widened and unscaled into fp32 ones, and an
all-finite flag comes back as a device bool.  The skip is the
optimizer's ``step_if_finite`` (or :func:`skip_or_step` over tensors you
hold): branchless, no host read.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScaleState
from apex_tpu_torch.utils.tree import tree_select


def scale_loss(loss: torch.Tensor, scaler: LossScaler,
               state: LossScaleState) -> torch.Tensor:
    """The scaled loss (what the reference context manager yields), for
    hand-rolled backward passes; prefer :func:`scaled_value_and_grad`."""
    return scaler.scale(loss, state)


def scaled_value_and_grad(loss_fn: Callable, scaler: LossScaler,
                          params: Sequence[torch.Tensor], *,
                          has_aux: bool = False,
                          grad_to: Optional[Sequence[torch.Tensor]] = None):
    """``fn(scale_state, *args) -> ((loss[, aux]), grads, finite)``.

    ``loss_fn(*args)`` returns the loss (and ``aux`` with ``has_aux``);
    the backward runs through ``scaler.scale(loss)`` to ``params`` (the
    model's, possibly half, parameters), so every intermediate gradient
    lies in the scaled range.  ``grads`` are the unscaled fp32 gradients
    of ``params``, one per parameter (a parameter the loss does not reach
    gets zeros), and ``finite`` the all-finite flag over them (a device
    bool).  ``grad_to`` (the fp32 masters under O2, or the parameters
    themselves) receive the fp32 gradients as their ``.grad``, where an
    optimizer's ``step_if_finite`` reads them."""
    params = list(params)
    if grad_to is not None and len(grad_to) != len(params):
        raise ValueError(f"grad_to has {len(grad_to)} tensors for "
                         f"{len(params)} parameters")

    def wrapped(scale_state: LossScaleState, *args):
        out = loss_fn(*args)
        loss = out[0] if has_aux else out
        raw = torch.autograd.grad(scaler.scale(loss, scale_state), params,
                                  allow_unused=True)
        raw = [torch.zeros_like(p) if g is None else g
               for p, g in zip(params, raw)]
        grads, finite = scaler.unscale(raw, scale_state)
        del raw
        if grad_to is not None:
            for t, g in zip(grad_to, grads):
                t.grad = g
        payload = (loss.detach(), out[1]) if has_aux else loss.detach()
        return payload, grads, finite

    return wrapped


def skip_or_step(finite: torch.Tensor, new: Sequence[torch.Tensor],
                 old: Sequence[torch.Tensor]):
    """Branchless skip on overflow (reference handle.py:127-154): ``new``
    where ``finite``, else ``old``, tensor by tensor."""
    return tree_select(finite, new, old)


__all__ = ["scale_loss", "scaled_value_and_grad", "skip_or_step"]
