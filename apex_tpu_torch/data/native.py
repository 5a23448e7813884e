"""Native (C++) threaded record loader — the non-checkpointable fast
path (port of the JAX package's ``apex_tpu/data/native.py``).

``apex_tpu_torch/_native/dataloader.cpp`` is the DALI/torch-DataLoader
role from the reference's examples: fixed-size binary records, deterministic
per-epoch reshuffle, a worker-thread pool ``pread``-ing into a prefetch
ring with no Python in the hot path.  It is kept (not deleted — the
decision recorded in docs/data.md) as an **optional fast
path** behind :class:`~apex_tpu_torch.data.prefetch.AsyncPrefetcher`: wrap it
when raw ingest throughput matters and iterator checkpointing does not
(evaluation sweeps, benchmark feeds).  The fault-tolerant,
exactly-once-resumable path is the pure-Python
:class:`~apex_tpu_torch.data.iterator.ShardedRecordIterator` — the native
loader's cursor lives inside the C++ ring and cannot serialize, so it
must never be handed to a checkpointing train loop (the loops reject
any iterator without ``state_dict``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from apex_tpu_torch import _native


def native_available() -> bool:
    """True when the native library builds (it is built on the first
    call); :class:`NativeRecordLoader` raises the build's error
    otherwise."""
    try:
        _native.get_lib()
    except _native.NativeBuildError:
        return False
    return True


class NativeRecordLoader:
    """Iterator over batches of fixed-size records, prefetched by the C++
    worker pool.

    Yields ``decode(batch_bytes)`` where ``batch_bytes`` is a
    [batch, record_bytes] uint8 array (a fresh buffer each step — safe to
    hand straight to ``torch.from_numpy``).  The stream is infinite with a
    deterministic per-epoch reshuffle; use :attr:`batches_per_epoch` to
    delimit epochs (the reference CLI's len(loader) role).
    """

    def __init__(self, paths: Sequence[str], record_bytes: int,
                 batch_size: int, *, shuffle: bool = True, seed: int = 0,
                 num_threads: int = 4, queue_depth: int = 4,
                 decode: Optional[Callable[[np.ndarray], object]] = None):
        lib = _native.get_lib()
        self._lib = lib
        self.record_bytes = int(record_bytes)
        self.batch_size = int(batch_size)
        self.decode = decode
        enc = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        self._h = lib.axl_open(arr, len(enc), self.record_bytes,
                               self.batch_size, 1 if shuffle else 0,
                               seed, num_threads, queue_depth)
        if not self._h:
            raise RuntimeError(
                f"axl_open failed for {list(paths)[:3]}... (records must "
                f"be >= batch_size and files readable)")
        self.num_records = lib.axl_num_records(self._h)

    @property
    def batches_per_epoch(self) -> int:
        return self.num_records // self.batch_size

    @property
    def error_count(self) -> int:
        """Records zero-filled because a read failed (truncated/rotated
        file).  Nonzero means delivered data is suspect — check after
        each epoch (or each batch for strict pipelines)."""
        return int(self._lib.axl_error_count(self._h)) if self._h else 0

    def next_batch(self) -> object:
        out = np.empty((self.batch_size, self.record_bytes), np.uint8)
        rc = self._lib.axl_next(self._h, ctypes.c_void_p(out.ctypes.data))
        if rc != 0:
            raise RuntimeError("axl_next failed (loader closed?)")
        return self.decode(out) if self.decode is not None else out

    def __iter__(self) -> Iterator[object]:
        return self

    def __next__(self) -> object:
        return self.next_batch()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.axl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
