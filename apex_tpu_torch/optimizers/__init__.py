"""Optimizers of the training path: ``FusedAdam`` over a model's
parameters, and ``FlatFusedAdam`` over one flat superblock (the
hand-written ``csrc/flat_adam.cu`` on the card)."""

from apex_tpu_torch.optimizers.flat import FlatAdamState, FlatFusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401

__all__ = ["FlatAdamState", "FlatFusedAdam", "FusedAdam"]
