"""Matrix products with fp32 accumulation and an fp32 result, as the JAX
package's ``dot_general(..., preferred_element_type=float32)`` computes
them.

On the card, bf16 operands go to cuBLAS with an fp32 output
(``torch.mm(..., out_dtype=torch.float32)``): a bf16-operand pass with
fp32 accumulation, what the TPU computes at DEFAULT precision.  On the CPU,
and for fp32 operands anywhere, the operands are multiplied in fp32 (TF32
stays off).  These are plain large GEMMs, left to the library as the JAX
package leaves them to XLA; no kernel of this repository replaces them.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k] @ b [k, n] -> fp32 [m, n], accumulated in fp32."""
    if a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _LinearF32(torch.autograd.Function):
    """y = x @ w^T in fp32 from x's dtype: w is cast to x's dtype for the
    product (the TPU's bf16 pass over an fp32 master weight), the weight
    gradient comes back in w's dtype (fp32 for a master weight), the
    input gradient in x's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2d = x.reshape(-1, x.shape[-1])
        y = mm_f32(x2d, w.to(x.dtype).t())
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2d = x.reshape(-1, x.shape[-1])
        g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm_f32(g2d, w.to(x.dtype)).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = mm_f32(g2d.t(), x2d).to(w.dtype)
        return dx, dw


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [out, in]^T -> fp32 [..., out], differentiable."""
    return _LinearF32.apply(x, w)
