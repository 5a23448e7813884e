"""Restore with integrity verification and fallback to older checkpoints
(port of the JAX package's ``apex_tpu/resilience/restore.py``).

``restore_checkpoint`` trusts the bytes on disk; after a storage incident
(partial write that still got renamed by a buggy FUSE layer, bit rot,
truncation) that trust loses the whole run.  :func:`restore_resilient`
walks complete checkpoints newest-first, verifies each against its
manifest CRC32 digests, and restores the newest *intact* one — reporting
every corrupt step it skipped via ``warnings.warn`` so the incident is
visible in logs, not silent.

Sharded (format 3 and 4) checkpoints verify per shard file, so one
damaged shard condemns exactly that step and the walk falls back to the
newest step whose whole shard set is intact."""

from __future__ import annotations

import warnings
from typing import Any, Optional

import os

from apex_tpu_torch.checkpoint.checkpoint import (
    CheckpointCorruptionError,
    _complete_steps,
    latest_step,
    restore_checkpoint,
    step_dir,
    verify_checkpoint,
)


class CheckpointFallbackWarning(UserWarning):
    """Emitted when the newest checkpoint was corrupt and an older intact
    one was restored instead."""


def _candidates(ckpt_dir: str, max_fallbacks: Optional[int]) -> list:
    """Complete steps newest-first by WRITE RECENCY, the marker step first
    (the semantics of latest_step and keep-GC: a rollback-resume may have
    written a LOWER step more recently than a higher one still on disk,
    and that rolled-back state must not be resurrected because its step
    number is bigger)."""
    steps = _complete_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found under {ckpt_dir}")
    marked = latest_step(ckpt_dir)
    candidates = sorted(
        steps,
        key=lambda s: (s == marked,
                       os.path.getmtime(step_dir(ckpt_dir, s)), s),
        reverse=True)
    if max_fallbacks is not None:
        candidates = candidates[: max_fallbacks + 1]
    return candidates


def newest_intact_step(ckpt_dir: str,
                       max_fallbacks: Optional[int] = None) -> int:
    """The step :func:`restore_resilient` would restore: the newest
    candidate whose every file verifies, each corrupt one skipped with a
    :class:`CheckpointFallbackWarning` (no tree is materialized)."""
    failures = []
    for s in _candidates(ckpt_dir, max_fallbacks):
        try:
            verify_checkpoint(ckpt_dir, s)
        except CheckpointCorruptionError as e:
            failures.append((s, str(e)))
            warnings.warn(
                f"checkpoint step {s} at {step_dir(ckpt_dir, s)} is corrupt "
                f"({e}); falling back to the next older checkpoint",
                CheckpointFallbackWarning, stacklevel=2)
            continue
        return s
    detail = "; ".join(f"step {s}: {msg}" for s, msg in failures)
    raise CheckpointCorruptionError(
        f"no intact checkpoint under {ckpt_dir} — all {len(failures)} "
        f"candidate(s) failed verification: {detail}")


def restore_resilient(
    ckpt_dir: str,
    target: Any = None,
    *,
    device=None,
    max_fallbacks: Optional[int] = None,
):
    """Restore the newest intact checkpoint under ``ckpt_dir``.

    Tries complete checkpoint steps newest-first; each candidate is
    CRC32-verified (``restore_checkpoint(..., verify=True)``).  A corrupt
    candidate is skipped with a :class:`CheckpointFallbackWarning` naming
    the step and the failure; the walk continues (up to ``max_fallbacks``
    older steps, default unlimited).  A *structure* mismatch (missing
    leaves for ``target``) is NOT treated as corruption — it raises
    immediately, because every older checkpoint would fail the same way.

    Returns ``(tree, step)`` like ``restore_checkpoint``.  Raises
    :class:`CheckpointCorruptionError` when checkpoints exist but none are
    intact, :class:`FileNotFoundError` when none exist at all."""
    candidates = _candidates(ckpt_dir, max_fallbacks)
    failures = []
    for s in candidates:
        try:
            tree, step = restore_checkpoint(
                ckpt_dir, target, step=s, device=device, verify=True)
        except CheckpointCorruptionError as e:
            failures.append((s, str(e)))
            warnings.warn(
                f"checkpoint step {s} at {step_dir(ckpt_dir, s)} is corrupt "
                f"({e}); falling back to the next older checkpoint",
                CheckpointFallbackWarning, stacklevel=2)
            continue
        if failures:
            warnings.warn(
                f"restored step {step} after skipping {len(failures)} "
                f"corrupt newer checkpoint(s): "
                f"{[s for s, _ in failures]}",
                CheckpointFallbackWarning, stacklevel=2)
        return tree, step
    detail = "; ".join(f"step {s}: {msg}" for s, msg in failures)
    raise CheckpointCorruptionError(
        f"no intact checkpoint under {ckpt_dir} — all {len(failures)} "
        f"candidate(s) failed verification: {detail}")
