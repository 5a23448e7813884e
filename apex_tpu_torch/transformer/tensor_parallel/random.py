"""Dropout streams and activation checkpointing.

PyTorch port of the JAX package's
``apex_tpu/transformer/tensor_parallel/random.py``.  JAX keys become
integer seeds: :func:`fold_in` derives a site's seed from a parent seed
and integers, as ``jax.random.fold_in`` derives keys, and each dropout
site draws its mask from a ``torch.Generator`` seeded with its own seed,
created where the mask is drawn.  So a checkpointed layer that runs again
in the backward redraws the same masks: ``torch.utils.checkpoint``
restores the global RNG state, not a generator object, and a generator
carried across the recompute would draw new masks.  The bits differ from
JAX's threefry (they cannot match); the rules match: a TP-replicated
activation drops with the base seed, a TP-sharded one (attention probs)
with :func:`model_parallel_dropout_seed`.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A 64-bit seed derived from ``seed`` and each integer of ``data`` in
    turn (the counterpart of ``jax.random.fold_in``)."""
    x = seed & _M64
    for d in data:
        x = _splitmix64(x ^ _splitmix64(d & _M64))
    return x


def model_parallel_dropout_seed(seed: int, tp_rank: int = 0) -> int:
    """The per-TP-rank stream of a replicated base seed (the reference's
    model-parallel seed = seed + 2718 + tp_rank): activations sharded over
    TP must drop different elements on each rank."""
    return fold_in(seed, 2718, tp_rank)


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout: zero with probability ``rate``, kept elements
    scaled by 1 / (1 - rate) in x's dtype; the mask is drawn from a
    generator seeded with ``seed`` on x's device."""
    if rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed & _M64)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def checkpoint(function, *args, context_fn=None):
    """Activation checkpointing: ``function(*args)`` recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant).  ``context_fn``
    selects what is saved instead (a selective checkpoint policy)."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False, **kw)
