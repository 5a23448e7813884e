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

The reference's RNG tracker is a registry of named seeds here
(:class:`RngStatesTracker`): :func:`model_parallel_cuda_manual_seed`
registers the replicated ``default`` stream and the per-tp-rank
``model-parallel-rng`` stream, and ``fork`` derives a site's seed from a
stream and a counter.  :func:`split_tensor_into_1d_equal_chunks` and
:func:`gather_split_1d_tensor` split a flattened activation across the
tensor group and gather it back (reference random.py:247-266).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.utils.checkpoint

from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import group_of
from apex_tpu_torch.transformer.tensor_parallel.mappings import TENSOR

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


_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"


class RngStatesTracker:
    """Named seeds (reference CudaRNGStatesTracker random.py:113):
    ``add(name, seed)`` registers a stream, ``fork(name, counter)``
    returns the seed a random op of that stream draws with."""

    def __init__(self):
        self.states_: Dict[str, int] = {}

    def reset(self) -> None:
        self.states_ = {}

    def get_states(self) -> Dict[str, int]:
        return dict(self.states_)

    def set_states(self, states) -> None:
        self.states_ = dict(states)

    def add(self, name: str, seed: int) -> None:
        if name in self.states_:
            raise Exception(f"seed {name} already exists")
        if seed in self.states_.values():
            raise Exception(f"seed {seed} already exists")
        self.states_[name] = seed

    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME,
             counter: int = 0) -> int:
        if name not in self.states_:
            raise Exception(f"seed {name} is not added")
        return fold_in(self.states_[name], counter)


_RNG_STATE_TRACKER = RngStatesTracker()


def get_cuda_rng_tracker() -> RngStatesTracker:
    """The process's tracker (reference random.py:188)."""
    return _RNG_STATE_TRACKER


get_rng_tracker = get_cuda_rng_tracker


def model_parallel_cuda_manual_seed(seed: int, tp_rank=None) -> None:
    """Register both streams (reference random.py:193-221): ``default`` =
    ``seed`` (the same on every tp rank) and ``model-parallel-rng``, the
    per-rank stream of ``seed + 2718`` folded with the tp rank (default:
    the registered one, 0 without)."""
    if tp_rank is None:
        tp_rank = (parallel_state.get_tensor_model_parallel_rank()
                   if parallel_state.model_parallel_is_initialized() else 0)
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.states_["default"] = seed
    _RNG_STATE_TRACKER.states_[_MODEL_PARALLEL_RNG_TRACKER_NAME] = fold_in(
        seed + 2718, tp_rank)


model_parallel_seed = model_parallel_cuda_manual_seed


def split_tensor_into_1d_equal_chunks(x: torch.Tensor, group=TENSOR
                                      ) -> torch.Tensor:
    """This rank's equal chunk of the flattened ``x``."""
    return comm.split(x.reshape(-1), group_of(group), dim=0)


def gather_split_1d_tensor(x: torch.Tensor, group=TENSOR) -> torch.Tensor:
    """The ranks' 1-D chunks concatenated (the inverse of
    :func:`split_tensor_into_1d_equal_chunks`)."""
    return comm.all_gather(x, group_of(group), dim=0)
