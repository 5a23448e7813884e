"""apex_tpu_torch.contrib.optimizers — ZeRO-style sharded optimizers (the
JAX package's ``apex_tpu.contrib.optimizers``; reference
apex/contrib/optimizers/)."""

from apex_tpu_torch.contrib.optimizers.distributed_fused import (  # noqa: F401
    DistributedFusedAdam,
    DistributedFusedLAMB,
    DistributedShardedOptimizer,
    ShardedOptState,
    reshard_zero_state,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB",
           "DistributedShardedOptimizer", "ShardedOptState",
           "reshard_zero_state"]
