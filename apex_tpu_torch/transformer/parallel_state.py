"""Model-parallel state: the ranks' layout and their process groups.

PyTorch port of the JAX package's ``apex_tpu/transformer/
parallel_state.py`` (reference apex/transformer/parallel_state.py).  The
JAX module lays the devices out as a mesh ``reshape(dp, pp, tp)`` with
the tensor axis innermost; here one process is one rank and the same
layout places rank ``(dp_i * pp + pp_i) * tp + tp_i`` at mesh coordinate
``(dp_i, pp_i, tp_i)`` (:func:`rank_grid`, a pure function the tests
hold against the JAX mesh).  :func:`initialize_model_parallel` builds the
``torch.distributed`` groups the reference builds (tensor, pipeline,
data, model-parallel, embedding) and registers them; the getters read
them from anywhere.  Without a process group (one process) only sizes of
one are accepted and every group is ``None``, which the collectives of
:mod:`apex_tpu_torch.parallel.comm` treat as the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

# the JAX mesh's axis names, in its coordinate order
DATA_AXIS = "data"
PIPELINE_AXIS = "pipeline"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, PIPELINE_AXIS, TENSOR_AXIS)


def rank_grid(world: int, tp: int, pp: int = 1) -> np.ndarray:
    """The global ranks at mesh coordinates [dp, pp, tp] (tp innermost),
    the order of the JAX mesh's devices ``reshape(dp, pp, tp)``."""
    if tp < 1 or pp < 1 or world % (tp * pp) != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor ({tp}) x "
            f"pipeline ({pp}) parallel sizes")
    return np.arange(world).reshape(world // (tp * pp), pp, tp)


def group_ranks(world: int, tp: int, pp: int = 1) -> Dict[str, List[List[int]]]:
    """Every group's ranks by kind: ``tensor`` (ranks that differ only in
    the tp coordinate), ``pipeline``, ``data``, ``model`` (one pipeline x
    tensor block) and ``embedding`` (the first and last stage of each
    pipeline, the reference's tied-embedding group)."""
    g = rank_grid(world, tp, pp)
    dp = g.shape[0]
    pipes = [g[d, :, t].tolist() for d in range(dp) for t in range(tp)]
    return {
        "tensor": [g[d, p, :].tolist() for d in range(dp) for p in range(pp)],
        "pipeline": pipes,
        "data": [g[:, p, t].tolist() for p in range(pp) for t in range(tp)],
        "model": [g[d].reshape(-1).tolist() for d in range(dp)],
        "embedding": [sorted({r[0], r[-1]}) for r in pipes],
    }


def coordinates(rank: int, world: int, tp: int, pp: int = 1
                ) -> Tuple[int, int, int]:
    """(tp, pp, dp) coordinates of global ``rank`` (the reference's
    ``get_rank_info`` order)."""
    d, p, t = (int(i[0]) for i in np.nonzero(rank_grid(world, tp, pp) == rank))
    return t, p, d


@dataclasses.dataclass
class _ParallelState:
    tensor_model_parallel_size: int
    pipeline_model_parallel_size: int
    data_parallel_size: int
    rank_info: Tuple[int, int, int]
    groups: Dict[str, object]
    grid: np.ndarray
    virtual_pipeline_model_parallel_size: Optional[int] = None
    virtual_pipeline_model_parallel_rank: int = 0


_STATE: Optional[_ParallelState] = None


def _new_groups(rank_lists: List[List[int]], timeout=None):
    """One process group per list, created on every rank in the same
    order (``torch.distributed.new_group`` must be called by all); the
    group holding this rank."""
    mine = None
    for ranks in rank_lists:
        g = dist.new_group(ranks=ranks, timeout=timeout)
        if dist.get_rank() in ranks:
            mine = g
    return mine


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        *, timeout=None) -> np.ndarray:
    """Build and register the groups (reference parallel_state.py:58) on
    the default group's backend; returns :func:`rank_grid`.  dp = world /
    (tp x pp), the world being the default process group's (1 without
    one).  ``timeout`` (a ``datetime.timedelta``; None is the backend's
    default) bounds how long a collective of these groups waits for a
    rank that never joins it."""
    global _STATE
    tp, pp = tensor_model_parallel_size_, pipeline_model_parallel_size_
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    grid = rank_grid(world, tp, pp)
    if virtual_pipeline_model_parallel_size_ is not None and pp <= 2:
        raise RuntimeError(
            "pipeline-model-parallel size should be greater than 2 with "
            "interleaved schedule")
    groups: Dict[str, object] = {}
    if on:
        for kind, lists in group_ranks(world, tp, pp).items():
            groups[kind] = _new_groups(lists, timeout)
    _STATE = _ParallelState(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        data_parallel_size=grid.shape[0],
        rank_info=coordinates(rank, world, tp, pp), groups=groups,
        grid=grid,
        virtual_pipeline_model_parallel_size=(
            virtual_pipeline_model_parallel_size_))
    return grid


def model_parallel_is_initialized() -> bool:
    return _STATE is not None


def _state() -> _ParallelState:
    if _STATE is None:
        raise RuntimeError("model parallel state is not initialized: call "
                           "initialize_model_parallel() first")
    return _STATE


def get_mesh() -> np.ndarray:
    """The registered rank grid [dp, pp, tp] (the JAX mesh's devices)."""
    return _state().grid


def mesh_axis_sizes() -> dict:
    st = _state()
    return {DATA_AXIS: st.data_parallel_size,
            PIPELINE_AXIS: st.pipeline_model_parallel_size,
            TENSOR_AXIS: st.tensor_model_parallel_size}


# -- world sizes -------------------------------------------------------------

def get_tensor_model_parallel_world_size() -> int:
    return _state().tensor_model_parallel_size


def get_pipeline_model_parallel_world_size() -> int:
    return _state().pipeline_model_parallel_size


def get_data_parallel_world_size() -> int:
    return _state().data_parallel_size


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _state().virtual_pipeline_model_parallel_size


# -- groups (None without a process group) -----------------------------------

def get_tensor_model_parallel_group():
    return _state().groups.get("tensor")


def get_pipeline_model_parallel_group():
    return _state().groups.get("pipeline")


def get_data_parallel_group():
    return _state().groups.get("data")


def get_model_parallel_group():
    """The pipeline x tensor block of this rank (reference :188)."""
    return _state().groups.get("model")


def get_model_parallel_groups() -> tuple:
    """(pipeline group, tensor group): what the model-parallel
    ``GradScaler`` reduces ``found_inf`` over, as the JAX module's pair
    of axes."""
    return (get_pipeline_model_parallel_group(),
            get_tensor_model_parallel_group())


def get_embedding_group():
    """The first and last pipeline stage of this rank's pipeline."""
    return _state().groups.get("embedding")


def group_of(group):
    """A group named by its kind (``"tensor"``, ``"pipeline"``, ``"data"``,
    ``"model"`` or ``"embedding"``) -> the registered group of that kind
    (None when nothing is registered: one rank); any other value as it
    is (a process group, or None)."""
    if isinstance(group, str):
        return _STATE.groups.get(group) if _STATE is not None else None
    return group


def tensor_parallel_group(tp: int):
    """The tensor group a ``tp``-way serving engine runs over (the JAX
    module's ``tensor_parallel_mesh``): this rank's tensor group of the
    initialized state, whose size must be ``tp``.  One process is one
    rank here, so with the state uninitialized, or initialized without a
    process group, there is no group to return and ``tp > 1`` raises."""
    if not model_parallel_is_initialized():
        raise RuntimeError(
            f"tp={tp} needs an initialized tensor-parallel group: start "
            "one process per rank, join torch.distributed and call "
            f"initialize_model_parallel({tp}) on every rank first")
    world = get_tensor_model_parallel_world_size()
    if tp != world:
        raise ValueError(
            f"tp={tp} does not match the initialized tensor-"
            f"parallel world size {world}")
    return get_tensor_model_parallel_group()


# -- ranks -------------------------------------------------------------------

def get_tensor_model_parallel_rank() -> int:
    return _state().rank_info[0]


def get_pipeline_model_parallel_rank() -> int:
    return _state().rank_info[1]


def get_data_parallel_rank() -> int:
    return _state().rank_info[2]


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    st = _state()
    first = get_pipeline_model_parallel_rank() == 0
    if (not ignore_virtual
            and st.virtual_pipeline_model_parallel_size is not None):
        first = first and st.virtual_pipeline_model_parallel_rank == 0
    return first


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    st = _state()
    last = (get_pipeline_model_parallel_rank()
            == st.pipeline_model_parallel_size - 1)
    if (not ignore_virtual
            and st.virtual_pipeline_model_parallel_size is not None):
        last = last and (st.virtual_pipeline_model_parallel_rank
                         == st.virtual_pipeline_model_parallel_size - 1)
    return last


def get_virtual_pipeline_model_parallel_rank() -> int:
    return _state().virtual_pipeline_model_parallel_rank


def set_virtual_pipeline_model_parallel_rank(rank: int) -> None:
    _state().virtual_pipeline_model_parallel_rank = rank


def get_tensor_model_parallel_src_rank() -> int:
    """The global rank of tensor-parallel rank 0 in this rank's tensor
    group (reference :349-355): the source of ``broadcast_data``."""
    st = _state()
    t, p, d = st.rank_info
    return int(st.grid[d, p, 0])


def get_rank_info() -> Tuple[int, int, int]:
    """(tp, pp, dp) coordinates of this rank ((0, 0, 0) uninitialised)."""
    return (0, 0, 0) if _STATE is None else _STATE.rank_info


def destroy_model_parallel() -> None:
    """Forget the registered state and destroy its process groups
    (reference :373-396); the default group stays."""
    global _STATE
    if _STATE is not None and dist.is_available() and dist.is_initialized():
        seen = set()
        for g in _STATE.groups.values():
            if g is not None and id(g) not in seen:
                seen.add(id(g))
                dist.destroy_process_group(g)
    _STATE = None


@contextlib.contextmanager
def uninitialized_scope():
    """Hide the registered state inside the ``with`` block and restore it
    untouched on exit (the JAX module's scope for code that must build a
    fixed geometry whatever the surrounding process registered)."""
    global _STATE
    saved, _STATE = _STATE, None
    try:
        yield
    finally:
        _STATE = saved


__all__ = [
    "DATA_AXIS", "PIPELINE_AXIS", "TENSOR_AXIS", "MESH_AXES", "rank_grid",
    "group_ranks", "coordinates", "initialize_model_parallel",
    "model_parallel_is_initialized", "get_mesh", "mesh_axis_sizes",
    "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size", "get_data_parallel_world_size",
    "get_virtual_pipeline_model_parallel_world_size",
    "get_tensor_model_parallel_group", "get_pipeline_model_parallel_group",
    "get_data_parallel_group", "get_model_parallel_group",
    "tensor_parallel_group",
    "get_model_parallel_groups", "get_embedding_group", "group_of",
    "get_tensor_model_parallel_rank", "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank", "is_pipeline_first_stage",
    "is_pipeline_last_stage", "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "get_tensor_model_parallel_src_rank",
    "get_rank_info", "destroy_model_parallel", "uninitialized_scope"]
