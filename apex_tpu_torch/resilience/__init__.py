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
- **fault injection** — :mod:`~apex_tpu_torch.resilience.chaos`: storage,
  data and preemption faults for training, and the serving engine's
  (:class:`SlowDecode`, :class:`ServingDeviceLoss` raising
  :class:`DeviceLossError`, :func:`corrupt_page`,
  :class:`CorruptLivePage`).

Not ported yet (ROADMAP.md): sharded ZeRO checkpoints, the elastic
training loop, the mesh-aware and fleet faults.
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
    DeviceLossError,
    ServingDeviceLoss,
    SlowDecode,
    corrupt_page,
)
from apex_tpu_torch.resilience.elastic import (  # noqa: F401
    Watchdog,
    WatchdogTimeout,
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
    "DeviceLossError",
    "DivergenceError",
    "GracePeriodHandler",
    "RetryPolicy",
    "ServingDeviceLoss",
    "SlowDecode",
    "StepGuard",
    "Watchdog",
    "WatchdogTimeout",
    "corrupt_page",
    "first_nonfinite_leaf",
    "global_grad_norm",
    "in_flight",
    "restore_resilient",
    "verify_checkpoint",
    "wait_for_save",
]
