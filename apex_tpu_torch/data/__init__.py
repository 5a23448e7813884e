"""Fault-tolerant input pipeline (port of the JAX package's
``apex_tpu/data``; numpy, the standard library and, for the copy to the
card, torch).

- :class:`ShardedRecordIterator` — deterministic, **checkpointable**
  sharded iterator: seeded shuffle windows, per-slot substreams, dp-axis
  shard ownership as a slot range; its position serializes to a compact
  ``data_state`` record saved through ``save_checkpoint(...,
  data_state=...)`` so a killed run resumes **exactly-once**; the record
  order and the record are the JAX package's, bit for bit;
- :class:`AsyncPrefetcher` — double-buffered background prefetch with
  the copy to the card on the loader thread (:func:`to_device`),
  bounded-queue backpressure, ``data_wait`` accounting, ``data_stall``
  telemetry, and loud loader-thread death;
- **degradation** — damaged records are quarantined
  (:class:`QuarantinePolicy`, hard-fail via
  :class:`QuarantineOverflowError` above a configurable rate); slow or
  dead shard reads ride a retry → backoff → re-assignment ladder
  (:class:`~apex_tpu_torch.data.records.RecordFileSet`);
- :class:`NativeRecordLoader` — the C++ threaded loader
  (``_native/dataloader.cpp``), the optional non-checkpointable fast
  path behind the prefetcher.

The chaos knobs are in :mod:`apex_tpu_torch.resilience.chaos`
(``corrupt_record``, ``SlowShardRead``, ``DropShard``).
"""

from apex_tpu_torch.data.iterator import (  # noqa: F401
    DATA_STATE_VERSION,
    QuarantineOverflowError,
    QuarantinePolicy,
    ShardedRecordIterator,
    merge_data_states,
)
from apex_tpu_torch.data.native import (  # noqa: F401
    NativeRecordLoader,
    native_available,
)
from apex_tpu_torch.data.prefetch import (  # noqa: F401
    AsyncPrefetcher,
    DataLoaderError,
    DeviceBatch,
    to_device,
)
from apex_tpu_torch.data.records import (  # noqa: F401
    RECORD_CRC_BYTES,
    DataShardError,
    RecordFileSet,
    check_record_crc,
    set_read_hook,
    write_checksummed_records,
    write_records,
)

__all__ = [
    "AsyncPrefetcher",
    "DATA_STATE_VERSION",
    "DataLoaderError",
    "DataShardError",
    "DeviceBatch",
    "NativeRecordLoader",
    "QuarantineOverflowError",
    "QuarantinePolicy",
    "RECORD_CRC_BYTES",
    "RecordFileSet",
    "ShardedRecordIterator",
    "check_record_crc",
    "merge_data_states",
    "native_available",
    "set_read_hook",
    "to_device",
    "write_checksummed_records",
    "write_records",
]
