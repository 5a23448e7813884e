"""The standalone Megatron GPT and BERT of the training paths, the GPT
flagship configuration and its ZeRO train step, the Megatron argument
parser, the JAX weight converter and the resilient training loop."""

from apex_tpu_torch.transformer.testing.flagship import (  # noqa: F401
    FIT_PLANS,
    GPT1P3B_KW,
    FlagshipSetup,
    ZeroFitPlan,
    build_flagship_train_step,
    flagship_elastic_build,
    flagship_state_bytes,
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
    gpt_model_provider,
    make_gpt_stage_fns,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
)
from apex_tpu_torch.transformer.testing.train_loop import (  # noqa: F401
    LoopResult,
    run_resilient_training,
)

__all__ = ["BertConfig", "BertModel", "bert_model_provider", "GPT1P3B_KW",
           "FIT_PLANS", "FlagshipSetup", "ZeroFitPlan",
           "build_flagship_train_step", "flagship_elastic_build",
           "flagship_state_bytes", "gpt1p3b_config", "gpt_param_count",
           "GPTConfig",
           "GPTModel", "gpt_model_provider", "LoopResult",
           "make_gpt_stage_fns", "ParallelAttention", "ParallelMLP",
           "ParallelTransformer", "ParallelTransformerLayer",
           "run_resilient_training"]
