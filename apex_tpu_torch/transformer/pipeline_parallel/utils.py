"""Pipeline-parallel utilities.

PyTorch port of the JAX package's ``apex_tpu/transformer/
pipeline_parallel/utils.py`` (reference pipeline_parallel/utils.py): the
microbatch-calculator globals, microbatch slicing, loss averaging over
the data-parallel group, parameter-norm reporting, the autoresume hooks,
Megatron's left-to-right masks and position ids, and the card's memory
report.

The calculator lives in one place: the registry of
:mod:`apex_tpu_torch.transformer.testing.global_vars`, which
:func:`setup_microbatch_calculator` fills and the getters here read, so
``set_global_variables`` and these functions see the same calculator.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch import nn

from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (
    build_num_microbatches_calculator,
)
from apex_tpu_torch.utils.tree import _map, keystr, tree_flatten_with_path


def _registry():
    # imported here: the testing package imports the models, which must
    # not be loaded to use the schedules' helpers
    from apex_tpu_torch.transformer.testing import global_vars

    return global_vars


def setup_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    """Reference utils.py:57-75 (refuses a second calculator)."""
    gv = _registry()
    if gv._GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise RuntimeError("num microbatches calculator is already initialized")
    gv._GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def destroy_microbatch_calculator() -> None:
    _registry()._GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True) -> None:
    _registry().update_num_microbatches(consumed_samples,
                                        consistency_check=consistency_check)


def get_num_microbatches() -> int:
    return _registry().get_num_microbatches()


def get_current_global_batch_size() -> int:
    return _registry().get_current_global_batch_size()


def get_micro_batch_size() -> int:
    calc = _registry()._GLOBAL_NUM_MICROBATCHES_CALCULATOR
    assert calc is not None, "num microbatches calculator is not initialized."
    return calc.micro_batch_size


def listify_model(model: Any) -> List[Any]:
    """Reference utils.py:104-107."""
    return model if isinstance(model, list) else [model]


def unwrap_model(model, module_instances=()):
    """Reference utils.py:110-128: the module inside each wrapper (a
    ``DistributedDataParallel`` built with a module holds it as
    ``.module``); a list in, a list out."""
    return_list = isinstance(model, list)
    unwrapped = [getattr(m, "module", m) for m in listify_model(model)]
    return unwrapped if return_list else unwrapped[0]


def get_kth_microbatch(batch: Any, k: int, micro_batch_size: int) -> Any:
    """Reference utils.py:137-147: microbatch ``k`` of a global batch, the
    rows ``[k * micro_batch_size, (k + 1) * micro_batch_size)`` of every
    tensor."""
    return _map(lambda _, a: a.narrow(0, k * micro_batch_size,
                                      micro_batch_size), batch)


def split_into_microbatches(batch: Any, n_microbatches: int) -> Any:
    """[B, ...] -> [n_micro, B / n_micro, ...] for every tensor: the
    schedules' stacked-microbatch input."""
    return _map(lambda _, a: a.reshape(n_microbatches,
                                       a.shape[0] // n_microbatches,
                                       *a.shape[1:]), batch)


def average_losses_across_data_parallel_group(losses: Sequence[torch.Tensor],
                                              group="data") -> torch.Tensor:
    """Reference utils.py:218-226: the losses stacked and averaged over
    the data-parallel group (default the registered one)."""
    group = parallel_state.group_of(group)
    stacked = torch.stack([torch.as_tensor(l).float() for l in losses])
    return comm.all_reduce(stacked, group) / comm.group_size(group)


def _named_leaves(params: Any):
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    leaves, _ = tree_flatten_with_path(params)
    return [(keystr(path), leaf) for path, leaf in leaves]


def calc_params_l2_norm(params: Any) -> torch.Tensor:
    """Reference utils.py:189-215 without the tensor-parallel duplicate
    filter (pass this rank's unique shards): the fp32 l2 norm of every
    tensor of ``params`` (a module or a tree)."""
    leaves = [t for _, t in _named_leaves(params)]
    return torch.sqrt(sum(t.detach().float().pow(2).sum() for t in leaves))


def print_params_min_max_norm(params: Any, *, iteration: int = 0) -> str:
    """Reference utils.py:241-259: each tensor's min, max and l2 norm
    (``named_parameters`` of a module, ``keystr`` paths of a tree),
    printed and returned."""
    lines = []
    for name, leaf in _named_leaves(params):
        a = leaf.detach().float()
        lines.append(
            f"iteration {iteration}, {name}: min {float(a.min()):+.6e} "
            f"max {float(a.max()):+.6e} norm "
            f"{float(torch.sqrt(torch.sum(a * a))):.6e}")
    msg = "\n".join(lines)
    print(msg, flush=True)
    return msg


def get_autoresume():
    """Reference utils.py:131-133: the hook of a cluster's auto-resume
    service; there is none, so None (restarts go through
    :mod:`apex_tpu_torch.checkpoint`)."""
    return None


def check_adlr_autoresume_termination(iteration, state, args=None,
                                      save_fn=None):
    """Reference utils.py:262-277: True when an auto-resume service asks
    the run to stop (after ``save_fn(iteration, state)``); always False
    without a service."""
    svc = get_autoresume()
    if svc is None:
        return False
    if svc.termination_requested():  # pragma: no cover - no service here
        if save_fn is not None:
            save_fn(iteration, state)
        svc.request_resume()
        return True
    return False


def get_ltor_masks_and_position_ids(
    data: torch.Tensor,
    eod_token: int,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """Left-to-right (causal) masks and position ids (reference
    utils.py:279-333): ``(attention_mask, loss_mask, position_ids)``, the
    mask boolean [b, 1, s, s] with True = masked out, the loss mask fp32
    1.0 where a token counts.  The per-document resets are cumulative
    sums and maxima over the sequence, not the reference's loop over end
    tokens, as in the JAX module."""
    b, seq = data.shape
    dev = data.device
    causal = ~torch.ones(seq, seq, dtype=torch.bool, device=dev).tril()
    attention_mask = causal.expand(b, 1, seq, seq)

    loss_mask = torch.ones(b, seq, dtype=torch.float32, device=dev)
    if eod_mask_loss:
        loss_mask = torch.where(data == eod_token, 0.0, loss_mask)

    position_ids = torch.arange(seq, device=dev).expand(b, seq)

    if reset_position_ids or reset_attention_mask:
        # a document starts after each end token
        starts = torch.nn.functional.pad(data[:, :-1] == eod_token, (1, 0))
        doc_id = starts.long().cumsum(1)
        if reset_attention_mask:
            same_doc = doc_id[:, None, :, None] == doc_id[:, None, None, :]
            attention_mask = attention_mask | ~same_doc
        if reset_position_ids:
            idx = torch.arange(seq, device=dev)[None, :]
            doc_start = torch.where(starts, idx, 0).cummax(1).values
            position_ids = idx - doc_start

    return attention_mask, loss_mask, position_ids


def report_memory(name: str) -> str:
    """Reference utils.py:229-238: the allocator's allocated and peak
    allocated MiB on each visible card (none listed without one), printed
    and returned."""
    lines = [f"memory ({name})"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            lines.append(
                f"  cuda:{i}: allocated "
                f"{torch.cuda.memory_allocated(i) / 2 ** 20:.1f}MiB max "
                f"allocated {torch.cuda.max_memory_allocated(i) / 2 ** 20:.1f}"
                "MiB")
    msg = "\n".join(lines)
    print(msg, flush=True)
    return msg


__all__ = ["setup_microbatch_calculator", "destroy_microbatch_calculator",
           "update_num_microbatches", "get_num_microbatches",
           "get_current_global_batch_size", "get_micro_batch_size",
           "listify_model", "unwrap_model", "get_kth_microbatch",
           "split_into_microbatches",
           "average_losses_across_data_parallel_group",
           "calc_params_l2_norm", "print_params_min_max_norm",
           "get_autoresume", "check_adlr_autoresume_termination",
           "get_ltor_masks_and_position_ids", "report_memory"]
