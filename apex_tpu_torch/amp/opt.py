"""The legacy ``amp.opt`` surface: :class:`OptimWrapper`.

PyTorch port of the JAX package's ``apex_tpu/amp/opt.py`` (reference
apex/amp/opt.py:9-104): an optimizer with ``num_loss`` independent
dynamic loss scalers; which scaler a backward uses is an explicit
``loss_id``, not ambient state.  The scale states live on the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from apex_tpu_torch.amp.handle import scaled_value_and_grad
from apex_tpu_torch.amp.scaler import LossScaler

__all__ = ["OptimWrapper"]


class OptimWrapper:
    """``optimizer`` (a port optimizer with ``step_if_finite``) and
    ``num_loss`` scale states, kept in ``self.scale_states``."""

    def __init__(self, optimizer, scaler: LossScaler = None,
                 num_loss: int = 1, device=None):
        self.optimizer = optimizer
        self.scaler = scaler or LossScaler()
        self.num_loss = int(num_loss)
        if device is None:
            device = optimizer.param_groups[0]["params"][0].device
        self.scale_states = [self.scaler.init(device)
                             for _ in range(self.num_loss)]

    def _opt_params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def scaled_grad(self, loss_fn: Callable, params: Sequence[torch.Tensor],
                    *args, loss_id: int = 0, has_aux: bool = False):
        """The backward under loss ``loss_id``'s scale (the reference's
        ``with wrapper.scale_loss(loss) as scaled:``): ``((loss[, aux]),
        grads, finite)``, the unscaled fp32 grads also set as the
        optimizer's parameters' ``.grad`` (``params`` are the model's, one
        for each optimizer parameter)."""
        fn = scaled_value_and_grad(loss_fn, self.scaler, params,
                                   has_aux=has_aux,
                                   grad_to=self._opt_params())
        return fn(self.scale_states[loss_id], *args)

    def step(self, finite: torch.Tensor, *, loss_id: int = 0) -> None:
        """The optimizer step if ``finite`` (skipped bitwise otherwise),
        and loss ``loss_id``'s scale state advanced either way."""
        self.optimizer.step_if_finite(finite)
        self.scale_states[loss_id] = self.scaler.update(
            self.scale_states[loss_id], finite)

    def state_dict(self) -> dict:
        """The reference's keys (opt.py:93-97): the optimizer's state and
        each scaler's loss scale and unskipped count (read to the host)."""
        return {"opt_state": self.optimizer.state_dict(),
                "scalers": [{"loss_scale": float(s.loss_scale),
                             "unskipped": int(s.unskipped)}
                            for s in self.scale_states]}
