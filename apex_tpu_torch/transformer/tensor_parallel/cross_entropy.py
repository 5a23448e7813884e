"""Vocab-parallel cross entropy at tensor-parallel size 1.

PyTorch port of the JAX package's
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``: the
numerically stable per-token loss over fp32 logits, log(sum exp(z -
max)) - (z_target - max), with the max detached.  With one shard the
collectives are identities and are left out; autograd derives the
softmax-minus-one-hot gradient.
"""

from __future__ import annotations

import torch


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor) -> torch.Tensor:
    """Per-token loss [...] from logits [..., vocab] and int targets [...]."""
    n = vocab_parallel_logits.shape[-1]
    z = vocab_parallel_logits.float()
    z = z - z.detach().amax(-1, keepdim=True)
    t = target.long().clamp(0, n - 1)
    t_logit = z.gather(-1, t[..., None])[..., 0]
    return torch.log(torch.exp(z).sum(-1)) - t_logit
