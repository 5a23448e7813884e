"""Checkpoint/resume of the full train state, in the JAX package's
on-disk format (port of ``apex_tpu/checkpoint``).

Usage::

    from apex_tpu_torch import checkpoint as ckpt

    state = ckpt.TrainState.create(params, opt_state)
    ckpt.save_checkpoint(dir, state, step=int(state.step))
    state, step = ckpt.restore_checkpoint(dir, target=state)
"""

from apex_tpu_torch.checkpoint.checkpoint import (
    CheckpointCorruptionError,
    RetryPolicy,
    latest_step,
    load_data_state,
    restore_checkpoint,
    save_checkpoint,
    shard_file,
    shard_file_coords,
    step_dir,
    verify_checkpoint,
)
from apex_tpu_torch.checkpoint.train_state import TrainState

__all__ = [
    "TrainState",
    "save_checkpoint",
    "restore_checkpoint",
    "verify_checkpoint",
    "latest_step",
    "load_data_state",
    "shard_file",
    "shard_file_coords",
    "step_dir",
    "CheckpointCorruptionError",
    "RetryPolicy",
]
