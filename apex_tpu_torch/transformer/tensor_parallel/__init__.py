"""Tensor-parallel building blocks at tensor-parallel size 1."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    normal_init,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    checkpoint,
    dropout,
    fold_in,
    model_parallel_dropout_seed,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "normal_init",
           "vocab_parallel_cross_entropy", "checkpoint", "dropout", "fold_in",
           "model_parallel_dropout_seed"]
