"""Vocab-parallel cross entropy.

PyTorch port of the JAX package's
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``: the
numerically stable per-token loss over fp32 logits, log(sum exp(z -
max)) - (z_target - max), with the max detached.  Over a vocab sharded
across the tensor group (logits [..., vocab / tp], this rank's rows
[r n, (r + 1) n)) the collectives are the JAX module's (reference
cross_entropy.py:23-103): a max all-reduce of the row maxima, the target
logit taken on the shard that owns it and sum-reduced, and a sum
all-reduce of the exp sums.  The reductions are reduce regions
(identity backward), so autograd derives the reference's softmax minus
one-hot on each shard.  With one shard the collectives are left out.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer.parallel_state import group_of
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    TENSOR, reduce_from_tensor_model_parallel_region)


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor, group=TENSOR
                                 ) -> torch.Tensor:
    """Per-token loss [...] from this rank's logits [..., vocab / tp] and
    int targets [...] of the global vocab; ``group``: the tensor group
    (default: the registered one; ``None``: one shard)."""
    group = group_of(group)
    n = vocab_parallel_logits.shape[-1]
    z = vocab_parallel_logits.float()
    if comm.group_size(group) == 1:
        z = z - z.detach().amax(-1, keepdim=True)
        t = target.long().clamp(0, n - 1)
        t_logit = z.gather(-1, t[..., None])[..., 0]
        return torch.log(torch.exp(z).sum(-1)) - t_logit
    zmax = comm.all_reduce(z.detach().amax(-1), group, op="max")
    z = z - zmax[..., None]
    local = target.long() - comm.group_rank(group) * n
    in_range = (local >= 0) & (local < n)
    t_logit = z.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    t_logit = reduce_from_tensor_model_parallel_region(
        torch.where(in_range, t_logit, 0.0), group)
    sum_exp = reduce_from_tensor_model_parallel_region(
        torch.exp(z).sum(-1), group)
    return torch.log(sum_exp) - t_logit
