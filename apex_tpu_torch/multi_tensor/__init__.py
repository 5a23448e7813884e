"""Multi-tensor ops (l2 norm, scale, axpby, global-norm clipping)."""

from apex_tpu_torch.multi_tensor.ops import (  # noqa: F401
    clip_grad_norm,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
)

__all__ = ["clip_grad_norm", "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_scale"]
