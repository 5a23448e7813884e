"""Megatron-style transformer pieces of the training path: the
tensor-parallel layers (at tp=1) and the standalone GPT of
:mod:`apex_tpu_torch.transformer.testing`."""

from apex_tpu_torch.transformer import tensor_parallel, testing  # noqa: F401

__all__ = ["tensor_parallel", "testing"]
