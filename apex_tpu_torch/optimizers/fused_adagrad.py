"""FusedAdagrad.

PyTorch port of the JAX package's ``apex_tpu/optimizers/fused_adagrad.py``
(reference ``FusedAdagrad``, csrc/multi_tensor_adagrad.cu), in fp32:

    g = g [+ wd p, L2 mode];   h = h + g g
    p = p - lr g / (sqrt(h) + eps) [- lr wd p, adagrad_w_mode]

The sums ``h`` are fp32.  Adagrad has no step count.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizer, apply_updates, f32


class FusedAdagrad(FusedOptimizer):

    STATE = ("sum",)

    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay,
                        adagrad_w_mode=adagrad_w_mode)
        super().__init__(params, defaults)

    def _init_state(self, group, params) -> None:
        for p in params:
            st = self.state[p]
            if not st:
                st["sum"] = torch.zeros_like(p, dtype=torch.float32)

    def _device_update(self, group, params, grads) -> None:
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        w_mode = group["adagrad_w_mode"]
        gs = f32(grads)
        p32 = f32(params)
        if wd and not w_mode:
            gs = torch._foreach_add(gs, torch._foreach_mul(p32, wd))
        hs = [self.state[p]["sum"] for p in params]
        torch._foreach_add_(hs, torch._foreach_mul(gs, gs))
        denom = torch._foreach_sqrt(hs)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_mul(gs, -lr)
        torch._foreach_div_(upd, denom)
        del denom
        if wd and w_mode:
            torch._foreach_sub_(upd, torch._foreach_mul(p32, lr * wd))
        apply_updates(params, upd)


__all__ = ["FusedAdagrad"]
