"""The standalone Megatron GPT and BERT of the training paths, the GPT
flagship configuration, the Megatron argument parser, the JAX weight
converter and the resilient training loop."""

from apex_tpu_torch.transformer.testing.flagship import (  # noqa: F401
    GPT1P3B_KW,
    gpt1p3b_config,
    gpt_param_count,
)
from apex_tpu_torch.transformer.testing.standalone_bert import (  # noqa: F401
    BertConfig,
    BertModel,
    bert_model_provider,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: F401
    GPTConfig,
    GPTModel,
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
)
from apex_tpu_torch.transformer.testing.train_loop import (  # noqa: F401
    LoopResult,
    run_resilient_training,
)

__all__ = ["BertConfig", "BertModel", "bert_model_provider", "GPT1P3B_KW",
           "gpt1p3b_config", "gpt_param_count", "GPTConfig",
           "GPTModel", "LoopResult", "ParallelAttention", "ParallelMLP",
           "ParallelTransformer", "ParallelTransformerLayer",
           "run_resilient_training"]
