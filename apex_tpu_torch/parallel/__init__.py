"""apex_tpu_torch.parallel: data parallelism over ``torch.distributed``.

The port of the JAX package's ``apex_tpu.parallel``: the gradient
all-reduce with the reference DDP's numerics options
(:mod:`.distributed`), the launcher and process-group set-up
(:mod:`.multiproc`), the collectives every model-parallel module runs
(:mod:`.comm`), SyncBatchNorm with its statistics over a group of ranks
(:mod:`.sync_batchnorm`) and ``LARC``.
"""

from apex_tpu_torch.optimizers.larc import LARC  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    all_reduce_grads,
    broadcast_params,
)
from apex_tpu_torch.parallel.multiproc import initialize_distributed  # noqa: F401
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    bn_state_dict_from_jax,
    convert_syncbn_model,
    create_syncbn_process_group,
    resolve_group,
    sync_batch_norm,
    sync_batch_norm_stats,
    update_running_stats,
)

__all__ = ["LARC", "DistributedDataParallel", "Reducer", "all_reduce_grads",
           "broadcast_params", "initialize_distributed", "SyncBatchNorm",
           "bn_state_dict_from_jax", "convert_syncbn_model",
           "create_syncbn_process_group", "resolve_group", "sync_batch_norm",
           "sync_batch_norm_stats", "update_running_stats"]
