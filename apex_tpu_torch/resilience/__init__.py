"""Training and serving resilience (port of the JAX package's
``apex_tpu/resilience``; host-only Python).

- **async checkpointing** — ``save_checkpoint(..., blocking=False)``
  overlaps the disk write with training; fence-on-next-save/exit
  semantics, exponential-backoff retry on transient storage errors
  (:mod:`~apex_tpu_torch.resilience.async_checkpoint`,
  :class:`~apex_tpu_torch.checkpoint.RetryPolicy`);
- **integrity** — per-array CRC32 digests in the manifest;
  :func:`restore_resilient` verifies on load and falls back to the newest
  intact older checkpoint on corruption
  (:mod:`~apex_tpu_torch.resilience.restore`);
- **preemption** — :class:`GracePeriodHandler` turns SIGTERM/SIGINT into
  a flag the train loop polls at step boundaries: final checkpoint, clean
  exit (:mod:`~apex_tpu_torch.resilience.preemption`);
- **divergence guards** — :class:`StepGuard` unifies skip-on-non-finite
  for amp and non-amp runs and raises a diagnostic naming the first
  non-finite leaf after K consecutive skips
  (:mod:`~apex_tpu_torch.resilience.guards`);
- **the step watchdog** — :class:`Watchdog`, a deadline armed around each
  step that escalates on overrun, and :class:`WatchdogTimeout`
  (:mod:`~apex_tpu_torch.resilience.elastic`);
- **sharded ZeRO checkpoints and elastic recovery** —
  :func:`save_zero_checkpoint` / :func:`restore_zero_checkpoint`
  (formats 3 and 4, cross-topology, each rank its own shard), and
  :func:`run_elastic_training`, which survives the loss of ranks by
  restoring the newest intact shard set on the survivors' world
  (:func:`largest_divisor_submesh`, :func:`best_surviving_submesh`);
- **fault injection** — :mod:`~apex_tpu_torch.resilience.chaos`: storage,
  data and preemption faults for training, and the serving engine's
  (:class:`SlowDecode`, :class:`ServingDeviceLoss` raising
  :class:`DeviceLossError`, :func:`corrupt_page`,
  :class:`CorruptLivePage`), and the mesh faults (:class:`DeviceLoss`,
  :func:`corrupt_shard`, :func:`slow_collective`), and the serving
  fleet's (``KillReplica``, ``SlowReplica``, ``BlackholeReplica``, in
  the chaos module).
"""

from apex_tpu_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruptionError,
    RetryPolicy,
    verify_checkpoint,
)
from apex_tpu_torch.resilience.async_checkpoint import (  # noqa: F401
    AsyncSaveError,
    in_flight,
    wait_for_save,
)
from apex_tpu_torch.resilience.chaos import (  # noqa: F401
    CorruptLivePage,
    DeviceLoss,
    DeviceLossError,
    ServingDeviceLoss,
    SlowDecode,
    corrupt_page,
    corrupt_shard,
    slow_collective,
)
from apex_tpu_torch.resilience.elastic import (  # noqa: F401
    ElasticResult,
    Watchdog,
    WatchdogTimeout,
    best_surviving_submesh,
    largest_divisor_submesh,
    restore_zero_checkpoint,
    run_elastic_training,
    save_zero_checkpoint,
)
from apex_tpu_torch.resilience.guards import (  # noqa: F401
    DivergenceError,
    StepGuard,
    first_nonfinite_leaf,
    global_grad_norm,
)
from apex_tpu_torch.resilience.preemption import (  # noqa: F401
    GracePeriodHandler,
)
from apex_tpu_torch.resilience.restore import (  # noqa: F401
    CheckpointFallbackWarning,
    restore_resilient,
)

__all__ = [
    "AsyncSaveError",
    "CheckpointCorruptionError",
    "CheckpointFallbackWarning",
    "CorruptLivePage",
    "DeviceLoss",
    "DeviceLossError",
    "ElasticResult",
    "DivergenceError",
    "GracePeriodHandler",
    "RetryPolicy",
    "ServingDeviceLoss",
    "SlowDecode",
    "StepGuard",
    "Watchdog",
    "WatchdogTimeout",
    "best_surviving_submesh",
    "corrupt_page",
    "corrupt_shard",
    "first_nonfinite_leaf",
    "global_grad_norm",
    "in_flight",
    "largest_divisor_submesh",
    "restore_resilient",
    "restore_zero_checkpoint",
    "run_elastic_training",
    "save_zero_checkpoint",
    "slow_collective",
    "verify_checkpoint",
    "wait_for_save",
]
