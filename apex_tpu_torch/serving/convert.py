"""Carry weights across from the JAX package.

The port keeps the JAX parameter tree and its ``[in, out]`` weight layout
(``x @ W``, no transpose), so conversion is a leaf-by-leaf copy;
:func:`rank_params_from_jax` also cuts out one tensor rank's part.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.serving.model import shard_params_tp, tp_rank_params


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a dtype torch knows; the detour
        # through float32 is exact for bf16 values
        t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, device=None, dtype: Optional[torch.dtype] = None):
    """The JAX ``init_params`` tree — ``embed``, ``pos``,
    ``ln_f{g,b}``, ``layers[i]{ln1{g,b}, wqkv, wo, ln2{g,b}, w1, w2}``,
    with numpy (or array-like) leaves — as the port's parameters on
    ``device`` (``None`` means the card), cast to ``dtype`` when given."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _leaf(node, device, dtype)

    return conv(tree)


def rank_params_from_jax(tree, tp: int, rank: int, device=None,
                         dtype: Optional[torch.dtype] = None):
    """Rank ``rank``'s parameters at ``tp`` tensor ranks from a JAX
    ``init_params`` tree: :func:`params_from_jax`, the shard-major
    ``wqkv`` reorder (:func:`~apex_tpu_torch.serving.model.
    shard_params_tp`) and the rank's slice (:func:`~apex_tpu_torch.
    serving.model.tp_rank_params`), as each rank of the JAX engine's
    ``shard_map`` holds them."""
    return tp_rank_params(
        shard_params_tp(params_from_jax(tree, device, dtype), tp), tp, rank)
