"""Broadcast a keyed batch across the tensor group.

PyTorch port of the JAX package's ``apex_tpu/transformer/tensor_parallel/
data.py`` (reference data.py:77-113): every rank of a tensor group takes
tensor-parallel rank 0's values, so the group trains on one batch; the
dtype check is the reference's ``_check_data_types``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer.parallel_state import group_of
from apex_tpu_torch.transformer.tensor_parallel.mappings import TENSOR


def broadcast_data(keys: Sequence[str], data: Dict[str, torch.Tensor],
                   datatype: torch.dtype, group=TENSOR
                   ) -> Dict[str, torch.Tensor]:
    """``{key: tensor-parallel rank 0's data[key]}``; a value whose dtype
    is not ``datatype`` raises ``ValueError``."""
    for k in keys:
        if data[k].dtype != datatype:
            raise ValueError(f"{k} has data type {data[k].dtype} which is "
                             f"different than {datatype}")
    group = group_of(group)
    if comm.group_size(group) == 1:
        return {k: data[k] for k in keys}
    src = dist.get_global_rank(group, 0)
    return {k: comm.broadcast(data[k], src, group) for k in keys}


__all__ = ["broadcast_data"]
