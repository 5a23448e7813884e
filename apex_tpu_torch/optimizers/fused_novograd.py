"""FusedNovoGrad: Adam with a per-tensor second moment.

PyTorch port of the JAX package's ``apex_tpu/optimizers/fused_novograd.py``
(reference ``FusedNovoGrad``, csrc/multi_tensor_novograd.cu), in fp32:

    v = b2 v + (1 - b2) ||g||^2   (init_zero; else ||g||^2 on the first step)
    g' = g / (sqrt(v / c2) + eps) [+ wd p, reg_inside_moment]
    m = b1 m + beta3 g';   p = p - lr (m / c1 [+ wd p])

``v`` is one fp32 scalar a tensor (a 0-d tensor in each parameter's
state); ``norm_type`` 2 is the only one, as in the reference kernel.  The
step count is a device tensor.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import (FusedOptimizer, apply_updates,
                                            bias_corrections, device_step,
                                            f32)


class FusedNovoGrad(FusedOptimizer):

    STATE = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_averaging: bool = True,
                 reg_inside_moment: bool = False, norm_type: int = 2,
                 init_zero: bool = False):
        if norm_type != 2:
            raise RuntimeError("FusedNovoGrad only supports l2 norm_type=2 "
                               "(as does the reference kernel).")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        reg_inside_moment=reg_inside_moment,
                        init_zero=init_zero)
        super().__init__(params, defaults)

    def _init_state(self, group, params) -> None:
        if self.state[params[0]]:
            return
        step = device_step(params)
        for p in params:
            self.state[p].update(
                step=step,
                exp_avg=torch.zeros_like(p, dtype=torch.float32),
                exp_avg_sq=torch.zeros((), dtype=torch.float32,
                                       device=p.device))

    def _device_update(self, group, params, grads) -> None:
        step = self.state[params[0]]["step"]
        first = step == 0
        step.add_(1)
        b1, b2 = group["betas"]
        beta3 = 1.0 - b1 if group["grad_averaging"] else 1.0
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        inside = group["reg_inside_moment"]
        if group["bias_correction"]:
            c1, c2 = bias_corrections(b1, b2, step)
        else:
            c1 = c2 = torch.ones((), device=params[0].device)
        gs = f32(grads)
        p32 = f32(params)
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        g_sq = torch.stack([torch.sum(g * g) for g in gs])
        v = torch.stack(vs)
        new_v = b2 * v + (1.0 - b2) * g_sq
        if not group["init_zero"]:
            new_v = torch.where(first, g_sq, new_v)
        torch._foreach_copy_(vs, list(new_v.unbind()))
        denom = torch.sqrt(new_v / c2) + eps
        gn = torch._foreach_div(gs, list(denom.unbind()))
        del gs
        if wd and inside:
            torch._foreach_add_(gn, torch._foreach_mul(p32, wd))
        ms = [self.state[p]["exp_avg"] for p in params]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gn, beta3))
        del gn
        upd = torch._foreach_div(ms, c1)
        if wd and not inside:
            torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(upd, -lr)
        apply_updates(params, upd)


__all__ = ["FusedNovoGrad"]
