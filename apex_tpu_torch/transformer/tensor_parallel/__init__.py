"""Megatron tensor parallelism over the registered tensor group
(reference apex/transformer/tensor_parallel/__init__.py; the exports of
the JAX package's ``apex_tpu.transformer.tensor_parallel``)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data  # noqa: F401
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    normal_init,
    param_is_not_tensor_parallel_duplicate,
    set_tensor_model_parallel_attributes,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    RngStatesTracker,
    checkpoint,
    dropout,
    fold_in,
    gather_split_1d_tensor,
    get_cuda_rng_tracker,
    get_rng_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_dropout_seed,
    model_parallel_seed,
    split_tensor_into_1d_equal_chunks,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (  # noqa: F401
    VocabUtility,
    divide,
    ensure_divisibility,
    split_tensor_along_last_dim,
)

__all__ = ["vocab_parallel_cross_entropy", "broadcast_data",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "normal_init",
           "param_is_not_tensor_parallel_duplicate",
           "set_tensor_model_parallel_attributes",
           "copy_to_tensor_model_parallel_region",
           "gather_from_tensor_model_parallel_region",
           "reduce_from_tensor_model_parallel_region",
           "scatter_to_tensor_model_parallel_region", "RngStatesTracker",
           "checkpoint", "dropout", "fold_in", "gather_split_1d_tensor",
           "get_cuda_rng_tracker", "get_rng_tracker",
           "model_parallel_cuda_manual_seed", "model_parallel_dropout_seed",
           "model_parallel_seed", "split_tensor_into_1d_equal_chunks",
           "VocabUtility", "divide", "ensure_divisibility",
           "split_tensor_along_last_dim"]
