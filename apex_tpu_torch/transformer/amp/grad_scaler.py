"""Model-parallel gradient scaler.

PyTorch port of the JAX package's ``apex_tpu/transformer/amp/
grad_scaler.py`` (reference amp/grad_scaler.py:8-106): the amp
:class:`~apex_tpu_torch.amp.LossScaler` whose ``found_inf`` takes a max
over the model-parallel groups (pipeline, then tensor), so one shard that
overflows makes every rank of its block skip the step.  Without those
groups (one process, or sizes of one) the verdict is local.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils.tree import tree_isfinite


@dataclasses.dataclass(frozen=True)
class GradScaler(LossScaler):
    """LossScaler whose overflow verdict is agreed across the
    model-parallel block (reference grad_scaler.py:25-36, :88-98)."""

    def found_inf(self, grads: Iterable[torch.Tensor], device=None
                  ) -> torch.Tensor:
        """A device bool: True if any gradient of any rank in this rank's
        pipeline x tensor block is not finite."""
        verdict = (~tree_isfinite(list(grads), device=device)).to(torch.int32)
        if parallel_state.model_parallel_is_initialized():
            for group in parallel_state.get_model_parallel_groups():
                verdict = comm.all_reduce(verdict, group, op="max")
        return verdict.bool()


def all_finite(tensors: Iterable[torch.Tensor], device=None) -> torch.Tensor:
    """One all-finite check over the floating tensors
    (:func:`apex_tpu_torch.utils.tree.tree_isfinite`)."""
    return tree_isfinite(list(tensors), device=device)


__all__ = ["GradScaler", "all_finite"]
