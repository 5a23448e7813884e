"""The train-state tree for checkpoint/resume (port of the JAX package's
``apex_tpu/checkpoint/train_state.py``).

One namedtuple-like dataclass holding everything a resume needs:

- ``params`` — fp32 master parameters;
- ``opt_state`` — the optimizer's state (moments, step count);
- ``scaler_state`` — the dynamic loss scale's state;
- ``model_state`` — non-trained model state (BN running statistics);
- ``step`` — the global step counter (an int32 0-d tensor).

The checkpoint names its fields as the JAX package's registered
dataclass does (``.step``, ``.params``, ...), in the same order, so a
``TrainState`` written by either package restores in the other.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class TrainState(NamedTuple):
    """Everything needed to resume training exactly."""

    step: torch.Tensor  # int32 0-d
    params: Any
    opt_state: Any
    scaler_state: Any = None
    model_state: Any = None

    @classmethod
    def create(cls, params, opt_state, scaler_state=None, model_state=None,
               step=0):
        return cls(step=torch.tensor(step, dtype=torch.int32),
                   params=params, opt_state=opt_state,
                   scaler_state=scaler_state, model_state=model_state)

    def replace(self, **kw) -> "TrainState":
        return self._replace(**kw)
