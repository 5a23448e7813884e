"""FusedLAMB: the layerwise adaptive large-batch optimizer.

PyTorch port of the JAX package's ``apex_tpu/optimizers/fused_lamb.py``
(reference ``FusedLAMB``, csrc/multi_tensor_lamb.cu), in its two phases
and its order of operations, in fp32:

1. the global l2 norm of every gradient of the group
   (``multi_tensor_l2norm``); with ``max_grad_norm`` every gradient is
   divided by ``max(1, norm / max_grad_norm)``;
2. Adam moments (``grad_averaging``: the first moment takes ``1 - b1``
   of g, else all of it) and the update ``(m / c1) / (sqrt(v / c2) +
   eps) [+ wd p]``, scaled per tensor by the trust ratio ``||p|| /
   ||update||`` where both norms are positive (1 elsewhere), applied
   when weight decay is on or ``use_nvlamb``.

Moments are fp32 and the step count is a device tensor; nothing reads
the device on the host.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.multi_tensor.ops import multi_tensor_l2norm
from apex_tpu_torch.optimizers.base import (FusedOptimizer, apply_updates,
                                            bias_corrections, device_step,
                                            f32)


class FusedLAMB(FusedOptimizer):

    STATE = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        if not adam_w_mode:
            raise RuntimeError("FusedLAMB only supports adam_w_mode "
                               "(reference kernel mode 0 unused).")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)
        super().__init__(params, defaults)

    def _init_state(self, group, params) -> None:
        if self.state[params[0]]:
            return
        step = device_step(params)
        for p in params:
            self.state[p].update(
                step=step,
                exp_avg=torch.zeros_like(p, dtype=torch.float32),
                exp_avg_sq=torch.zeros_like(p, dtype=torch.float32))

    def _device_update(self, group, params, grads) -> None:
        step = self.state[params[0]]["step"]
        step.add_(1)
        b1, b2 = group["betas"]
        beta3 = 1.0 - b1 if group["grad_averaging"] else 1.0
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        if group["bias_correction"]:
            c1, c2 = bias_corrections(b1, b2, step)
        else:
            c1 = c2 = torch.ones((), device=params[0].device)
        gs = f32(grads)
        # phase 1: the global norm and the clip
        if group["max_grad_norm"]:
            norm = multi_tensor_l2norm(gs)
            clip = torch.clamp(norm / group["max_grad_norm"], min=1.0)
            gs = torch._foreach_div(gs, clip)
        # phase 2: moments, the update, the trust ratio
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, beta3))
        gg = torch._foreach_mul(gs, 1.0 - b2)
        torch._foreach_mul_(gg, gs)
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, gg)
        del gg, gs
        denom = torch._foreach_div(vs, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(ms, c1)
        torch._foreach_div_(upd, denom)
        del denom
        p32 = f32(params)
        if wd:
            torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
        if wd != 0.0 or group["use_nvlamb"]:
            w_norm = torch.stack(torch._foreach_norm(p32))
            u_norm = torch.stack(torch._foreach_norm(upd))
            ratio = torch.where((w_norm > 0.0) & (u_norm > 0.0),
                                w_norm / u_norm, 1.0)
            torch._foreach_mul_(upd, list((-lr * ratio).unbind()))
        else:
            torch._foreach_mul_(upd, -lr)
        apply_updates(params, upd)


__all__ = ["FusedLAMB"]
