"""Model-parallel amp: the gradient scaler whose overflow verdict the
model-parallel ranks agree on."""

from apex_tpu_torch.transformer.amp.grad_scaler import (  # noqa: F401
    GradScaler,
    all_finite,
)

__all__ = ["GradScaler", "all_finite"]
