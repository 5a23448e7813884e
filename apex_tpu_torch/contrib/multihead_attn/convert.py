"""Carry the attention modules' weights over from the JAX package.

The JAX ``SelfMultiheadAttn.init`` / ``EncdecMultiheadAttn.init`` return a
flat dict of arrays under the reference's parameter names, in the same
layouts as the port's modules ([out, in] weights), so the state dict is
the same dict with each array as a tensor of the same dtype.  Arrays
travel as numpy; a bfloat16 array (numpy dtype name ``bfloat16``) is
carried bit for bit through its 16-bit pattern.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port module's ``state_dict`` from a JAX module's ``init`` dict,
    dtype preserved: ``module.load_state_dict(state_dict_from_jax(p))``."""
    return {name: _tensor(a) for name, a in params.items()}
