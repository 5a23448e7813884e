"""Pipeline-stage point-to-point transfer.

PyTorch port of the JAX package's ``apex_tpu/transformer/
pipeline_parallel/p2p_communication.py`` (reference
p2p_communication.py:31-404).  The JAX module's transfer is one ring
``ppermute`` over the mesh's pipeline axis, whose wrap edge carries
values the schedules mask; here each wrapper posts the sends and
receives of one step over the pipeline group
(:func:`apex_tpu_torch.parallel.comm.exchange`: all posted before any is
waited on, as the reference's ``_run_p2pops``) between real neighbours
only.  The first stage receives no activation and sends no gradient; the
last stage sends no activation and receives no gradient (``None`` where
the reference returns ``None``).  "First" and "last" are the virtual
stage's (:func:`~apex_tpu_torch.transformer.parallel_state.
is_pipeline_first_stage`): with interleaving the last device's chunk k
feeds device 0's chunk k + 1, so the neighbours wrap around the
pipeline group.

``tensor_shape`` and ``dtype`` size the receive buffer, as in the
reference; a received tensor lies on ``device`` (default the card, as
every entry point of the port) or, where the call also sends, on the
sent tensor's device.  The reference's scatter-gather option is not
kept (its ``override_scatter_gather_tensors_in_pipeline`` is accepted
and does nothing), as in the JAX module.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import parallel_state

#: message tags: an activation and a gradient between the same two ranks
FORWARD_TAG, BACKWARD_TAG = 0, 1


def _peers():
    group = parallel_state.get_pipeline_model_parallel_group()
    n = parallel_state.get_pipeline_model_parallel_world_size()
    r = parallel_state.get_pipeline_model_parallel_rank()
    return group, (r + 1) % n, (r - 1) % n


def _communicate(*, send_next: Optional[torch.Tensor] = None,
                 send_prev: Optional[torch.Tensor] = None,
                 recv_prev: bool = False, recv_next: bool = False,
                 tensor_shape: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32, device=None):
    """One step's transfers (reference ``_communicate``): returns (the
    tensor from the previous stage or None, the one from the next stage
    or None)."""
    group, nxt, prv = _peers()
    like = send_next if send_next is not None else send_prev
    dev = like.device if like is not None else resolve_device(device)
    sends, recvs = [], []
    if send_next is not None:
        sends.append((send_next, nxt, FORWARD_TAG))
    if send_prev is not None:
        sends.append((send_prev, prv, BACKWARD_TAG))
    if (recv_prev or recv_next) and tensor_shape is None:
        raise ValueError("tensor_shape is required to receive")
    if recv_prev:
        recvs.append(comm.Recv(prv, tuple(tensor_shape), dtype, dev,
                               FORWARD_TAG))
    if recv_next:
        recvs.append(comm.Recv(nxt, tuple(tensor_shape), dtype, dev,
                               BACKWARD_TAG))
    got = iter(comm.exchange(sends, recvs, group))
    return (next(got) if recv_prev else None,
            next(got) if recv_next else None)


def _first() -> bool:
    return parallel_state.is_pipeline_first_stage()


def _last() -> bool:
    return parallel_state.is_pipeline_last_stage()


def recv_forward(tensor_shape: Sequence[int],
                 override_scatter_gather_tensors_in_pipeline: bool = False,
                 *, dtype: torch.dtype = torch.float32, device=None,
                 timers=None) -> Optional[torch.Tensor]:
    """The activation from the previous stage (None on the first)."""
    if _first():
        return None
    return _communicate(recv_prev=True, tensor_shape=tensor_shape,
                        dtype=dtype, device=device)[0]


def send_forward(output_tensor: torch.Tensor,
                 override_scatter_gather_tensors_in_pipeline: bool = False,
                 *, timers=None) -> None:
    """The activation to the next stage (nothing on the last)."""
    if not _last():
        _communicate(send_next=output_tensor)


def recv_backward(tensor_shape: Sequence[int], *,
                  dtype: torch.dtype = torch.float32, device=None,
                  timers=None) -> Optional[torch.Tensor]:
    """The gradient from the next stage (None on the last)."""
    if _last():
        return None
    return _communicate(recv_next=True, tensor_shape=tensor_shape,
                        dtype=dtype, device=device)[1]


def send_backward(input_tensor_grad: torch.Tensor, *, timers=None) -> None:
    """The input's gradient to the previous stage (nothing on the
    first)."""
    if not _first():
        _communicate(send_prev=input_tensor_grad)


def send_forward_recv_backward(output_tensor: torch.Tensor,
                               tensor_shape: Sequence[int], *,
                               dtype: torch.dtype = torch.float32,
                               timers=None) -> Optional[torch.Tensor]:
    """The activation to the next stage and its gradient back (None on the
    last stage, which does neither)."""
    if _last():
        return None
    return _communicate(send_next=output_tensor, recv_next=True,
                        tensor_shape=tensor_shape, dtype=dtype)[1]


def send_backward_recv_forward(input_tensor_grad: torch.Tensor,
                               tensor_shape: Sequence[int], *,
                               dtype: torch.dtype = torch.float32,
                               timers=None) -> Optional[torch.Tensor]:
    """The input's gradient to the previous stage and the next
    microbatch's activation from it (None on the first stage)."""
    if _first():
        return None
    return _communicate(send_prev=input_tensor_grad, recv_prev=True,
                        tensor_shape=tensor_shape, dtype=dtype)[0]


def send_forward_recv_forward(output_tensor: torch.Tensor, recv_prev: bool,
                              tensor_shape: Sequence[int], *,
                              dtype: torch.dtype = torch.float32,
                              timers=None) -> Optional[torch.Tensor]:
    """The activation to the next stage (unless this is the last) and,
    when ``recv_prev``, one from the previous stage (unless this is the
    first)."""
    return _communicate(send_next=None if _last() else output_tensor,
                        recv_prev=recv_prev and not _first(),
                        tensor_shape=tensor_shape, dtype=dtype,
                        device=output_tensor.device)[0]


def send_backward_recv_backward(input_tensor_grad: torch.Tensor,
                                recv_next: bool,
                                tensor_shape: Sequence[int], *,
                                dtype: torch.dtype = torch.float32,
                                timers=None) -> Optional[torch.Tensor]:
    """The input's gradient to the previous stage (unless this is the
    first) and, when ``recv_next``, one from the next stage (unless this
    is the last)."""
    return _communicate(send_prev=None if _first() else input_tensor_grad,
                        recv_next=recv_next and not _last(),
                        tensor_shape=tensor_shape, dtype=dtype,
                        device=input_tensor_grad.device)[1]


__all__ = ["recv_forward", "send_forward", "recv_backward", "send_backward",
           "send_forward_recv_backward", "send_backward_recv_forward",
           "send_forward_recv_forward", "send_backward_recv_backward"]
