"""Resilience for the port (the serving faults of the JAX package's
``apex_tpu/resilience/chaos.py`` and the step :class:`Watchdog` of its
``elastic.py``; host-only Python).

- :mod:`~apex_tpu_torch.resilience.chaos` — deterministic serving fault
  injection through the engine's fault hook: :class:`SlowDecode`,
  :class:`ServingDeviceLoss` (raises :class:`DeviceLossError`),
  :func:`corrupt_page` and :class:`CorruptLivePage`;
- :mod:`~apex_tpu_torch.resilience.elastic` — :class:`Watchdog`, a
  deadline armed around each step that escalates on overrun, and
  :class:`WatchdogTimeout`.

Not ported yet (ROADMAP.md): async checkpointing, the checkpoint, data
and fleet faults, the elastic training loop, guards, preemption and
restore.
"""

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

__all__ = [
    "CorruptLivePage",
    "DeviceLossError",
    "ServingDeviceLoss",
    "SlowDecode",
    "Watchdog",
    "WatchdogTimeout",
    "corrupt_page",
]
