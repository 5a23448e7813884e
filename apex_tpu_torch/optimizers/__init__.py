"""Optimizers of the training paths, each a ``torch.optim.Optimizer``
with amp's skip on overflow (``step_if_finite``): ``FusedAdam``,
``FusedSGD``, ``FusedLAMB``, ``FusedNovoGrad``, ``FusedAdagrad`` and
the ``LARC`` wrapper over a model's parameters, and ``FlatFusedAdam``
over one flat superblock (the hand-written ``csrc/flat_adam.cu`` on the
card)."""

from apex_tpu_torch.optimizers.base import (  # noqa: F401
    FusedOptimizer,
    apply_updates,
)
from apex_tpu_torch.optimizers.flat import FlatAdamState, FlatFusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB  # noqa: F401
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad  # noqa: F401
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
from apex_tpu_torch.optimizers.larc import LARC  # noqa: F401

__all__ = ["FusedOptimizer", "apply_updates", "FlatAdamState",
           "FlatFusedAdam", "FusedAdagrad", "FusedAdam", "FusedLAMB",
           "FusedNovoGrad", "FusedSGD", "LARC"]
