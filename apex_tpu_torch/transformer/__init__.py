"""Megatron-style transformer pieces of the training path: the rank
layout and its process groups (:mod:`.parallel_state`), the
tensor-parallel regions and layers, the model-parallel gradient scaler,
the Switch Mixture-of-Experts MLP (:mod:`.moe`) and the standalone GPT
and BERT of :mod:`apex_tpu_torch.transformer.testing`."""

from apex_tpu_torch.transformer import (  # noqa: F401
    amp, parallel_state, tensor_parallel, testing)

__all__ = ["amp", "parallel_state", "tensor_parallel", "testing"]
