"""Optimizers of the training path."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401

__all__ = ["FusedAdam"]
