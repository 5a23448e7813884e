"""FusedSGD: momentum SGD as one update over each parameter group.

PyTorch port of the JAX package's ``apex_tpu/optimizers/fused_sgd.py``
(reference ``FusedSGD``, csrc/multi_tensor_sgd_kernel.cu): momentum with
dampening, Nesterov, weight decay before or after the momentum
(``wd_after_momentum``), the JAX formula in its order, in fp32:

    g = g [+ wd p]                      (before the momentum)
    buf = g on the first step, else momentum buf + (1 - dampening) g
    d = g + momentum buf (Nesterov) or buf;   d = d [+ wd p] (after)
    p = p - lr d

The momentum buffers are fp32; the step count is a device tensor (the
first step is a ``torch.where``, not a host branch).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import (FusedOptimizer, apply_updates,
                                            device_step, f32)


class FusedSGD(FusedOptimizer):

    STATE = ("momentum_buffer",)

    def __init__(self, params, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        wd_after_momentum=wd_after_momentum)
        super().__init__(params, defaults)

    def _init_state(self, group, params) -> None:
        if self.state[params[0]]:
            return
        step = device_step(params)
        for p in params:
            self.state[p].update(
                step=step,
                momentum_buffer=torch.zeros_like(p, dtype=torch.float32))

    def _device_update(self, group, params, grads) -> None:
        step = self.state[params[0]]["step"]
        lr, mom, damp = group["lr"], group["momentum"], group["dampening"]
        wd = group["weight_decay"]
        after = group["wd_after_momentum"]
        gs = f32(grads)
        p32 = f32(params)
        if wd and not after:
            gs = torch._foreach_add(gs, torch._foreach_mul(p32, wd))
        if mom:
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            first = step == 0
            new = torch._foreach_mul(bufs, mom)
            torch._foreach_add_(new, torch._foreach_mul(gs, 1.0 - damp))
            for b, n, g in zip(bufs, new, gs):
                torch.where(first, g, n, out=b)
            if group["nesterov"]:
                d = torch._foreach_add(gs, torch._foreach_mul(bufs, mom))
            else:
                d = bufs
        else:
            d = gs
        if wd and after:
            d = torch._foreach_add(d, torch._foreach_mul(p32, wd))
        upd = torch._foreach_mul(d, -lr)
        apply_updates(params, upd)
        step.add_(1)


__all__ = ["FusedSGD"]
