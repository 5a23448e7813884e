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

``step()`` keeps the step count as a host int and the bias corrections
on the host; ``step_if_finite(finite)`` (amp's skip on overflow, see
:class:`~apex_tpu_torch.optimizers.base.FusedOptimizer`) keeps it as
one device tensor a group, advanced and restored on the device, so that
a skipped step leaves it unchanged without a host read.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizer, bias_corrections


def _new_state(p: torch.Tensor) -> dict:
    """A parameter's first state: step 0 (a host int), fp32 moments."""
    return {"step": 0, "exp_avg": torch.zeros_like(p, dtype=torch.float32),
            "exp_avg_sq": torch.zeros_like(p, dtype=torch.float32)}


class FusedAdam(FusedOptimizer):

    STATE = ("exp_avg", "exp_avg_sq")

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
    def step(self, closure=None, *, grads=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group, gg in zip(self.param_groups, self._grads_by_group(grads)):
            params, gs = self._with_grads(group, gg)
            if not params:
                continue
            if (grads is not None or isinstance(
                    self.state[params[0]].get("step"), torch.Tensor)):
                # the device count: explicit gradients (amp's), or after
                # step_if_finite
                self._init_state(group, params)
                self._device_update(group, params, gs)
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st.update(_new_state(p))
                st["step"] += 1
            self._update(group, params)
        return loss

    def _init_state(self, group, params) -> None:
        """The amp route's state: moments as ``step()`` makes them, and
        the group's step count moved to one device tensor."""
        for p in params:
            if not self.state[p]:
                self.state[p].update(_new_state(p))
        step = self.state[params[0]]["step"]
        if not isinstance(step, torch.Tensor):
            step = torch.full((), step, dtype=torch.int32,
                              device=params[0].device)
            for p in params:
                self.state[p]["step"] = step

    def _device_update(self, group, params, grads) -> None:
        self.state[params[0]]["step"].add_(1)
        self._update(group, params, grads)

    def _update(self, group, params, grads=None):
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        step = self.state[params[0]]["step"]
        if isinstance(step, torch.Tensor):
            c1, c2 = bias_corrections(b1, b2, step)
            if not group["bias_correction"]:
                c1 = c2 = torch.ones_like(c1)
        elif group["bias_correction"]:
            # fp32 powers, as the JAX package computes them on the device
            t = torch.tensor(float(step), dtype=torch.float32)
            c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
            c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        else:
            c1 = c2 = 1.0
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        gs = [g.float() for g in (grads or [p.grad for p in params])]
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
