"""Pipeline model construction (reference
apex/transformer/pipeline_parallel/schedules/common.py:18-106).

PyTorch port of the JAX package's ``apex_tpu/transformer/
pipeline_parallel/build_model.py``: :func:`build_model` calls the
provider once a model chunk (one chunk, or one for each virtual stage
with interleaving), with the virtual-rank cursor set around each call
and restored after, and optionally wraps each chunk in
:class:`apex_tpu_torch.parallel.DistributedDataParallel`.

A deliberate difference from the JAX module: there one SPMD program
spans every stage, so its flags are True on every chunk that *could* sit
at an end of the pipe.  Here each rank is one process holding its own
stage, so the flags say where this rank's chunk really sits, as in the
reference's ``common.py``: ``pre_process`` only on pipeline rank 0's
first chunk, ``post_process`` only on the last rank's last chunk.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from apex_tpu_torch.transformer import parallel_state


def build_model(
    model_provider_func: Callable[..., Any],
    wrap_with_ddp: bool = True,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    *args,
    **kwargs,
) -> List[Any]:
    """The list of this rank's model chunks, each
    ``model_provider_func(*args, pre_process=..., post_process=...,
    **kwargs)``; with ``wrap_with_ddp`` each in a
    ``DistributedDataParallel`` over the data-parallel group (the module
    at ``.module``, its attributes read through)."""
    pp = parallel_state.get_pipeline_model_parallel_world_size()
    rank = parallel_state.get_pipeline_model_parallel_rank()
    vpp = virtual_pipeline_model_parallel_size
    chunks = vpp if pp > 1 and vpp is not None else 1
    models = []
    for v in range(chunks):
        if chunks > 1:
            # the provider may read the virtual cursor (common.py:49-52)
            parallel_state.set_virtual_pipeline_model_parallel_rank(v)
        models.append(model_provider_func(
            *args, pre_process=rank == 0 and v == 0,
            post_process=rank == pp - 1 and v == chunks - 1, **kwargs))
    if chunks > 1:
        parallel_state.set_virtual_pipeline_model_parallel_rank(0)
    if wrap_with_ddp:
        from apex_tpu_torch.parallel import DistributedDataParallel

        models = [DistributedDataParallel(module=m) for m in models]
    return models


__all__ = ["build_model"]
