"""The collectives the model-parallel code runs, over ``torch.distributed``.

Every function takes a process group (``None`` or a group of one rank:
the identity, no collective is issued) and returns a new tensor in its
input's dtype and on its input's device.  Two rules hold on every
backend:

* A sum of bf16 or fp16 tensors over more than two ranks is taken in
  fp32 and rounded once (the row-parallel rounding rule of the JAX
  layers: the bf16 partials summed, one rounding).  A sum over two ranks
  is carried in the half dtype, since a two-operand sum rounds once
  either way (bitwise the fp32 route, at half the bytes); a max, a
  gather and a broadcast are exact in any dtype.
* Under gloo a CUDA tensor is staged through the host: the current
  stream is synchronised, the tensor copied to the host, the collective
  run there and the result copied back.  Every such collective is a
  host synchronisation (under NCCL none is).  Two ranks that share one
  card cannot use NCCL, so they run this way.  Under NCCL a host tensor
  (a checkpoint's leaf) makes the trip to the card and back.

:data:`STATS` counts the collectives (calls, bytes carried, and the host
seconds of the synchronous ones: everything under gloo, from after the
stream synchronisation to the copy back) so that a run can report what
share of its wall time the transport took.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

_HALF = (torch.bfloat16, torch.float16)


class CommStats:
    """Counters of the collectives this process ran."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "seconds": self.seconds}


STATS = CommStats()


def group_size(group) -> int:
    """The number of ranks of ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank within ``group`` (0 for ``None``)."""
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _carrier(t: torch.Tensor, group, widen: bool) -> torch.Tensor:
    """A contiguous tensor the backend takes: fp32 for a half tensor when
    ``widen`` (widened where it lies), on the host for a CUDA tensor under
    gloo (after a stream sync), on the current card for a host tensor
    under NCCL."""
    c = t.float() if widen and t.dtype in _HALF else t
    if _staged(t, group):
        torch.cuda.current_stream(t.device).synchronize()
        c = c.to("cpu")
    elif not t.is_cuda and dist.get_backend(group) == "nccl":
        c = c.cuda()
    if c is t:   # the collectives write in place; the input stays as it was
        c = t.clone()
    return c.contiguous()


def _run(t: torch.Tensor, group, fn, widen: bool = False) -> torch.Tensor:
    """``fn(carrier) -> result`` on the carrier of ``t``, the result
    brought back to ``t``'s device and dtype, counted in :data:`STATS`."""
    c = _carrier(t, group, widen)
    t0 = time.perf_counter()
    out = fn(c).to(t.device).to(t.dtype)   # narrowed where it will lie
    if not t.is_cuda or _staged(t, group):   # synchronous: the host waited
        STATS.seconds += time.perf_counter() - t0
    STATS.calls += 1
    STATS.bytes += c.numel() * c.element_size()
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction (``"sum"``, ``"max"`` or ``"min"``) of ``t`` over the
    ranks of ``group``."""
    n = group_size(group)
    if n == 1:
        return t

    def fn(c):
        dist.all_reduce(c, op=_OPS[op], group=group)
        return c

    return _run(t, group, fn, widen=op == "sum" and n > 2)


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return t

    def fn(c):
        # as one SUM all-reduce of a zero buffer holding this rank's slot:
        # gloo has no all_gather for CUDA tensors, and x + 0 is exact
        parts = [torch.zeros_like(c) for _ in range(n)]
        parts[group_rank(group)] = c
        buf = torch.cat(parts, dim=dim)
        if buf.dtype == torch.bool:
            buf = buf.to(torch.uint8)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf

    return _run(t, group, fn)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank) on every rank of ``group``."""
    if group_size(group) == 1:
        return t

    def fn(c):
        dist.broadcast(c, src=src, group=group)
        return c

    return _run(t, group, fn)


def gather(t: torch.Tensor, group, dim: int = 0) -> Optional[torch.Tensor]:
    """The ranks' ``t`` concatenated along ``dim`` on the group's rank 0
    (None on the others)."""
    n = group_size(group)
    if n == 1:
        return t
    dst = dist.get_global_rank(group, 0)
    mine = group_rank(group) == 0

    def fn(c):
        parts = [torch.empty_like(c) for _ in range(n)] if mine else None
        dist.gather(c, parts, dst=dst, group=group)
        return torch.cat(parts, dim=dim) if mine else c

    got = _run(t, group, fn)
    return got if mine else None


def split(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's equal chunk of ``t`` along ``dim`` (a contiguous copy)."""
    n = group_size(group)
    if n == 1:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"into {n} equal chunks")
    chunk = size // n
    return t.narrow(dim, group_rank(group) * chunk, chunk).contiguous()


__all__ = ["CommStats", "STATS", "all_gather", "all_reduce", "broadcast",
           "gather", "group_rank", "group_size", "split"]
