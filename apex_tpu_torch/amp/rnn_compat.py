"""amp and the RNN cells (reference apex/amp/rnn_compat.py + compat.py).

PyTorch port of the JAX package's ``apex_tpu/amp/rnn_compat.py``.  The
reference makes torch's cuDNN RNN cells patchable by O1 by routing them
through a ``VariableFunctionsShim`` and whitelisting the cell functions;
the O1 policy here is explicit wrappers (:mod:`apex_tpu_torch.amp.lists`),
so, as in the JAX package:

- :func:`whitelist_rnn_cells` registers the cell names in ``FP16_FUNCS``
  (the cells are gate-GEMM bound, the class the whitelist exists for);
- :func:`half_cell` wraps a ``cell(params, x, hidden)`` of
  :mod:`apex_tpu_torch.rnn.cells` so its inputs, hidden state and
  parameters run in the half dtype while the cell state (``hidden[1:]``,
  an LSTM's ``c``) stays fp32.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp import lists
from apex_tpu_torch.utils.tree import tree_cast

RNN_CELL_NAMES = ["lstm_cell", "gru_cell", "rnn_relu_cell", "rnn_tanh_cell",
                  "mlstm_cell"]


def whitelist_rnn_cells() -> None:
    """Register the RNN cells in the O1 half list (reference
    ``whitelist_rnn_cells``, rnn_compat.py:25-53).  Idempotent."""
    for name in RNN_CELL_NAMES:
        if name not in lists.FP16_FUNCS:
            lists.FP16_FUNCS.append(name)


def half_cell(cell, half_dtype: torch.dtype = torch.bfloat16):
    """``cell`` for O1: computed in ``half_dtype``, the output hidden state
    in ``half_dtype`` and the cell state in fp32."""

    def wrapped(params, x, hidden):
        h = (tree_cast(hidden[0], half_dtype),) + tuple(
            t.float() for t in hidden[1:])
        out = cell(tree_cast(params, half_dtype), tree_cast(x, half_dtype),
                   h)
        # the fp32 cell state promotes the pointwise tail: the output
        # hidden back to half, the state to fp32
        return (out[0].to(half_dtype),) + tuple(t.float() for t in out[1:])

    return wrapped


__all__ = ["RNN_CELL_NAMES", "whitelist_rnn_cells", "half_cell"]
