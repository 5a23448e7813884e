"""FusedAdam: Adam / AdamW over every parameter in one update.

PyTorch port of the JAX package's ``apex_tpu/optimizers/fused_adam.py``
(reference ``FusedAdam``, csrc/multi_tensor_adam.cu ``AdamFunctor``) as a
``torch.optim.Optimizer``, with the JAX formula in its order of
operations, every step in fp32 whatever the parameter's dtype:

    m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g g
    denom = sqrt(v / c2) + eps,   c_i = 1 - b_i^t (bias correction)
    upd = -lr (m / c1) / denom  [- lr wd p, decoupled, from the old p]
    p = p + upd

``torch.optim.AdamW`` orders this arithmetic differently; this class
exists so that fp32 runs match the JAX package.  The moments are fp32;
parameters, moments and the step count are updated in place.  The
update is ``torch._foreach_*`` over each parameter group: a handful of
launches per step, not one per tensor and op.
"""

from __future__ import annotations

import torch


class FusedAdam(torch.optim.Optimizer):

    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        if amsgrad:
            # parity: the reference raises too
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, adam_w_mode=adam_w_mode,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
                st["step"] += 1
            self._update(group, params)
        return loss

    def _update(self, group, params):
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        step = self.state[params[0]]["step"]
        if group["bias_correction"]:
            # fp32 powers, as the JAX package computes them on the device
            t = torch.tensor(float(step), dtype=torch.float32)
            c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
            c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        else:
            c1 = c2 = 1.0
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        gs = [p.grad.float() for p in params]
        p32 = [p.float() for p in params]
        if not group["adam_w_mode"] and wd:
            # L2 mode: the decay joins the gradient
            torch._foreach_add_(gs, torch._foreach_mul(p32, wd))
        # m = b1 m + (1 - b1) g
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
        # v = b2 v + ((1 - b2) g) g
        gg = torch._foreach_mul(gs, 1.0 - b2)
        torch._foreach_mul_(gg, gs)
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, gg)
        del gg, gs
        # denom = sqrt(v / c2) + eps;  upd = (-lr (m / c1)) / denom
        denom = torch._foreach_div(vs, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(ms, c1)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_div_(upd, denom)
        del denom
        if group["adam_w_mode"] and wd:
            torch._foreach_sub_(upd, torch._foreach_mul(p32, lr * wd))
        torch._foreach_add_(p32, upd)
        for p, new in zip(params, p32):
            if new is not p:
                p.copy_(new)
