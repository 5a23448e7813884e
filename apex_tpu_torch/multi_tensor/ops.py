"""The amp_C multi-tensor op suite over lists of tensors.

PyTorch port of the JAX package's ``apex_tpu/multi_tensor/ops.py``.
Each op takes any iterable of tensors (a model's gradients, or the one
superblock of :mod:`apex_tpu_torch.multi_tensor.flat`) and uses
``torch._foreach_*`` where one exists; the inf/nan poll is an all-finite
flag returned beside the result.  :func:`segment_l2norms` takes a
superblock and its schema.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from apex_tpu_torch.multi_tensor.flat import FlatSchema


def _finite(tensors: List[torch.Tensor]) -> torch.Tensor:
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def multi_tensor_scale(tensors: Iterable[torch.Tensor], scale
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """out = in * scale, plus the all-finite flag of the result."""
    out = torch._foreach_mul(list(tensors), scale)
    return out, _finite(out)


def multi_tensor_axpby(xs: Iterable[torch.Tensor], ys: Iterable[torch.Tensor],
                       a, b, *, out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """out = a*x + b*y computed in fp32, cast to ``out_dtype`` (default
    x's dtype), plus the all-finite flag."""
    out = [(a * x.float() + b * y.float()).to(out_dtype or x.dtype)
           for x, y in zip(xs, ys)]
    return out, _finite(out)


def multi_tensor_l2norm(tensors: Iterable[torch.Tensor], *,
                        per_tensor: bool = False):
    """Global l2 norm in fp32 (and the per-tensor norms with
    ``per_tensor``)."""
    tensors = [t.float() if t.dtype != torch.float32 else t
               for t in tensors]
    if not tensors:
        zero = torch.tensor(0.0)
        return (zero, torch.zeros(0)) if per_tensor else zero
    norms = torch.stack(torch._foreach_norm(tensors))
    total = torch.linalg.vector_norm(norms)
    return (total, norms) if per_tensor else total


def segment_l2norms(flat: torch.Tensor, schema: FlatSchema) -> torch.Tensor:
    """Per-leaf l2 norms [num_tensors] (fp32) over a superblock: the
    per-tensor option of multi_tensor_l2norm over the schema's offsets.
    The JAX package takes them as one segment sum; here each leaf's norm
    is taken over its view, with no atomics, so two runs on the card give
    the same bits."""
    views = [flat[schema.leaf_slice(i)].float()
             for i in range(schema.num_tensors)]
    if not views:
        return torch.zeros(0, device=flat.device)
    return torch.stack(torch._foreach_norm(views))


def clip_grad_norm(tensors: Iterable[torch.Tensor], max_norm: float, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """Global-norm clip composed from l2norm + scale: every tensor is
    multiplied IN PLACE by min(1, max_norm / (norm + eps)) (the port
    updates gradients in place to save their memory).  Returns the norm
    before clipping."""
    tensors = list(tensors)
    norm = multi_tensor_l2norm(tensors)
    clip = torch.clamp(max_norm / (norm + eps), max=1.0)
    torch._foreach_mul_(tensors, clip)
    return norm
