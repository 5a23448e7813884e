"""The standalone Megatron GPT of the training path, its flagship
configuration, the Megatron argument parser and the JAX weight
converter."""

from apex_tpu_torch.transformer.testing.flagship import (  # noqa: F401
    GPT1P3B_KW,
    gpt1p3b_config,
    gpt_param_count,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: F401
    GPTConfig,
    GPTModel,
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
)

__all__ = ["GPT1P3B_KW", "gpt1p3b_config", "gpt_param_count", "GPTConfig",
           "GPTModel", "ParallelAttention", "ParallelMLP",
           "ParallelTransformer", "ParallelTransformerLayer"]
