"""LARC: layerwise adaptive rate control in front of an optimizer.

PyTorch port of the JAX package's ``apex_tpu/optimizers/larc.py``
(reference ``apex.parallel.LARC``): before the wrapped optimizer's step
each gradient becomes, in fp32,

    adaptive_lr = trust_coefficient ||p|| / (||g|| + wd ||p|| + eps)
    clip mode:  adaptive_lr = min(adaptive_lr / lr, 1)
    g = (g + wd p) adaptive_lr

where both norms are positive, and stays as it is elsewhere.  Weight
decay is folded in here, so the wrapped optimizer takes
``weight_decay=0``.  ``step_if_finite`` passes the skip on: the
transformed gradients are inputs only, never state.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import f32


class LARC:
    """Wraps a port optimizer; its ``param_groups`` and ``state`` are the
    wrapped one's."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay

    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def state(self):
        return self.optim.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optim.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return self.optim.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self.optim.load_state_dict(d)

    @torch.no_grad()
    def transform_grads(self, grads=None) -> list:
        """The transformed fp32 gradient of each parameter of every group
        (None where it has none), from ``grads`` as the wrapped
        optimizer's ``step`` takes them, or from each ``.grad``."""
        wd = self.weight_decay
        out_all = []
        for group, gg in zip(self.optim.param_groups,
                             self.optim._grads_by_group(grads)):
            if gg is None:
                gg = [p.grad for p in group["params"]]
            have = [i for i, g in enumerate(gg) if g is not None]
            done = [None] * len(gg)
            out_all.append(done)
            if not have:
                continue
            params = [group["params"][i] for i in have]
            gs = f32([gg[i] for i in have])
            p32 = f32(params)
            p_norm = torch.stack(torch._foreach_norm(p32))
            g_norm = torch.stack(torch._foreach_norm(gs))
            adaptive = (self.trust_coefficient * p_norm
                        / (g_norm + p_norm * wd + self.eps))
            if self.clip:
                adaptive = torch.clamp(adaptive / group["lr"], max=1.0)
            live = (p_norm > 0.0) & (g_norm > 0.0)
            out = torch._foreach_add(gs, torch._foreach_mul(p32, wd))
            torch._foreach_mul_(out, list(adaptive.unbind()))
            for i, o, g, keep in zip(have, out, gs, live.unbind()):
                done[i] = torch.where(keep, o, g)
        return [g for done in out_all for g in done]

    def step(self, closure=None, *, grads=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.optim.step(grads=self.transform_grads(grads))
        return loss

    def step_if_finite(self, finite: torch.Tensor, grads=None) -> None:
        self.optim.step_if_finite(finite, self.transform_grads(grads))


__all__ = ["LARC"]
