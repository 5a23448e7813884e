"""Fused linear + softmax cross-entropy: the LM head's projection and loss
as one differentiable op.

PyTorch port of the JAX package's ``apex_tpu/ops/fused_linear_xent.py``
with its contract: ``loss(h @ w.T, labels)`` per token, whose residuals
are the **bf16 logits and the fp32 lse**; the lse reduces the fp32
product, so the loss is fp32-exact, and the backward rebuilds the
softmax from the bf16 logits.  The fp32 logits exist one chunk of rows at
a time (at most 2^27 elements), so at the GPT-1.3B shape no fp32 [8192,
51200] tensor (1.7 GB) is ever whole.  The JAX package has no Pallas
kernel here and neither has the port: the products go to
:func:`~apex_tpu_torch.ops._gemm.mm_f32`.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops._gemm import mm_f32

__all__ = ["fused_linear_cross_entropy"]

_CHUNK_ELEMENTS = 1 << 27


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """fp32+ operands are cast to bf16: the product accumulates in fp32
    either way, and the saved residuals stay half-width."""
    return x.to(torch.bfloat16) if x.element_size() > 2 else x


def _chunks(n: int, vocab: int):
    step = max(1, _CHUNK_ELEMENTS // vocab)
    return [(r, min(n, r + step)) for r in range(0, n, step)]


class _FusedLinearXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, smoothing):
        n, vocab = h.shape[0], w.shape[0]
        loss = torch.empty(n, dtype=torch.float32, device=h.device)
        lse = torch.empty_like(loss)
        z16 = torch.empty((n, vocab), dtype=torch.bfloat16, device=h.device)
        wt = w.t()
        for r0, r1 in _chunks(n, vocab):
            z = mm_f32(h[r0:r1], wt)
            m = z.amax(-1)
            lse[r0:r1] = m + torch.log(torch.exp(z - m[:, None]).sum(-1))
            tz = z.gather(1, labels[r0:r1, None])[:, 0]
            if smoothing:
                loss[r0:r1] = (lse[r0:r1] - (1.0 - smoothing) * tz
                               - smoothing * z.mean(-1))
            else:
                loss[r0:r1] = lse[r0:r1] - tz
            z16[r0:r1] = z
        ctx.save_for_backward(h, w, labels, z16, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, z16, lse = ctx.saved_tensors
        s = ctx.smoothing
        n, vocab = z16.shape
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for r0, r1 in _chunks(n, vocab):
            dl = torch.exp(z16[r0:r1].float() - lse[r0:r1, None])
            onehot = dl.new_zeros(dl.shape).scatter_(
                1, labels[r0:r1, None], 1.0)
            target = (1.0 - s) * onehot + s / vocab if s else onehot
            dl = ((dl - target) * g[r0:r1, None].float()).to(h.dtype)
            dh[r0:r1] = mm_f32(dl, w).to(h.dtype)
            dw += mm_f32(dl.t(), h[r0:r1])
        return dh, dw.to(w.dtype), None, None


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor,
                               smoothing: float = 0.0) -> torch.Tensor:
    """Per-token smoothed cross-entropy of the projection ``h @ w.T``.

    h [N, H], w [V, H] (each cast to bf16 if wider, outside the op, so
    autograd hands the caller its own dtype back), labels int [N].
    Returns fp32 losses [N]; the caller reduces."""
    return _FusedLinearXent.apply(_narrow(h), _narrow(w), labels.long(),
                                  float(smoothing))
