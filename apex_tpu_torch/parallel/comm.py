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

The ZeRO pair, :func:`reduce_scatter` and :func:`all_gather_tiled`
(``lax.psum_scatter`` and ``lax.all_gather`` with ``tiled=True`` over
dim 0), carry raw bytes (a ``uint8`` view: gloo takes neither
``float8_e5m2`` nor ``int16``) and are exact transports.  The
reduce-scatter's sum is taken on the caller's device, each element
summed in rank order 0, 1, ..., world - 1 (in fp32 for a half or 8-bit
float dtype, rounded once), so it does not depend on how a caller cuts
a buffer into buckets: a bucketed step and a serialized one give the
same bits.

Point to point (:func:`send`, :func:`recv`, :func:`exchange`) follows
the same rules, peers named by their rank in the group.
:func:`exchange` posts every send and receive of a step before it waits
on any (``dist.batch_isend_irecv`` under NCCL; gloo's ``isend`` /
``irecv`` of host tensors, each tagged, under gloo), so two neighbours
that send to each other at once do not deadlock, as the reference's
``_run_p2pops`` (p2p_communication.py:31-69) posts its ops.  A message
to this rank itself is handed over without a transfer.  Each message
counts as one call in :data:`STATS`, its bytes those on the wire.

:func:`all_to_all` (``lax.all_to_all`` tiled over dim 0, the
expert-parallel exchange of :mod:`apex_tpu_torch.transformer.moe`)
carries raw bytes as the ZeRO pair does, and is differentiable: its
backward is the same exchange.

``STATS.by_op`` names every call: ``all_reduce``, ``all_gather`` (both
gathers), ``reduce_scatter``, ``all_to_all``, ``broadcast``, ``gather``,
and each message of :func:`exchange` as ``send`` or ``recv``.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
        self.by_op = {}     # calls by collective name

    def count(self, op: str) -> None:
        self.by_op[op] = self.by_op.get(op, 0) + 1

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "seconds": self.seconds, "by_op": dict(self.by_op)}


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


def _run(t: torch.Tensor, group, fn, widen: bool = False,
         op: str = "") -> torch.Tensor:
    """``fn(carrier) -> result`` on the carrier of ``t``, the result
    brought back to ``t``'s device and dtype, counted in :data:`STATS`."""
    c = _carrier(t, group, widen)
    t0 = time.perf_counter()
    out = fn(c).to(t.device).to(t.dtype)   # narrowed where it will lie
    if not t.is_cuda or _staged(t, group):   # synchronous: the host waited
        STATS.seconds += time.perf_counter() - t0
    STATS.calls += 1
    STATS.bytes += c.numel() * c.element_size()
    if op:
        STATS.count(op)
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

    return _run(t, group, fn, widen=op == "sum" and n > 2, op="all_reduce")


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

    return _run(t, group, fn, op="all_gather")


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a flat ``uint8`` tensor of its bytes (contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _dim0_chunks(t: torch.Tensor, n: int) -> int:
    if t.dim() == 0 or t.shape[0] % n:
        raise ValueError(f"dim 0 of a {tuple(t.shape)} tensor does not split "
                         f"into {n} equal chunks")
    return t.shape[0] // n


_EXACT_SUM = (torch.float32, torch.float64)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's dim-0 chunk of the sum of the ranks' ``t`` (``lax.
    psum_scatter(..., tiled=True)``): rank r gets ``sum_j t_j[r k : (r +
    1) k]`` with ``k = t.shape[0] / world``, in ``t``'s dtype and on its
    device.  The chunks travel as raw bytes (one all-to-all) and each
    element is summed here in rank order, in fp32 for a narrower float
    dtype (one rounding), so the result does not depend on how a caller
    cut the buffer it came from."""
    n = group_size(group)
    if n == 1:
        return t
    k = _dim0_chunks(t, n)
    src = _bytes_of(t)
    staged = _staged(t, group)
    nccl = dist.get_backend(group) == "nccl"
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
        src = src.to("cpu")
    elif not t.is_cuda and nccl:
        src = src.cuda()
    recv = torch.empty_like(src)
    t0 = time.perf_counter()
    dist.all_to_all_single(recv, src, group=group)
    if not t.is_cuda or staged:
        STATS.seconds += time.perf_counter() - t0
    parts = recv.to(t.device).view(t.dtype).reshape(n, k, *t.shape[1:])
    acc_dtype = t.dtype if t.dtype in _EXACT_SUM or not \
        t.is_floating_point() else torch.float32
    acc = parts[0].to(acc_dtype)
    for j in range(1, n):
        acc = acc + parts[j].to(acc_dtype)
    STATS.calls += 1
    STATS.bytes += src.numel()
    STATS.count("reduce_scatter")
    return acc.to(t.dtype)


def all_gather_tiled(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in rank order (``lax.
    all_gather(..., axis=0, tiled=True)``), carried as raw bytes: exact
    in every dtype, ``float8_e5m2`` included."""
    n = group_size(group)
    if n == 1:
        return t
    src = _bytes_of(t)
    staged = _staged(t, group)
    nccl = dist.get_backend(group) == "nccl"
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
        src = src.to("cpu")
    elif not t.is_cuda and nccl:
        src = src.cuda()
    parts = [torch.empty_like(src) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, src, group=group)
    if not t.is_cuda or staged:
        STATS.seconds += time.perf_counter() - t0
    out = torch.cat(parts).to(t.device).view(t.dtype)
    STATS.calls += 1
    STATS.bytes += src.numel()
    STATS.count("all_gather")
    return out.reshape(n * t.shape[0] if t.dim() else n, *t.shape[1:])


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return t
    _dim0_chunks(t, n)
    src = _bytes_of(t)
    staged = _staged(t, group)
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
        src = src.to("cpu")
    elif not t.is_cuda and dist.get_backend(group) == "nccl":
        src = src.cuda()
    recv = torch.empty_like(src)
    t0 = time.perf_counter()
    dist.all_to_all_single(recv, src, group=group)
    if not t.is_cuda or staged:
        STATS.seconds += time.perf_counter() - t0
    STATS.calls += 1
    STATS.bytes += src.numel()
    STATS.count("all_to_all")
    return recv.to(t.device).view(t.dtype).reshape(t.shape)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its transpose is the same exchange (chunk j of
    rank r goes to rank j as chunk r, and back)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-to-all over dim 0 (``lax.all_to_all(t, axis,
    split_axis=0, concat_axis=0, tiled=True)``): ``t`` cut into ``world``
    equal chunks along dim 0, chunk j sent to group rank j, and the chunks
    received from ranks 0, 1, ..., world - 1 concatenated in that order.
    Carried as raw bytes, so exact in every dtype; differentiable (the
    backward is the same exchange of the cotangent)."""
    if group_size(group) == 1:
        return t
    return _AllToAll.apply(t, group)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank) on every rank of ``group``."""
    if group_size(group) == 1:
        return t

    def fn(c):
        dist.broadcast(c, src=src, group=group)
        return c

    return _run(t, group, fn, op="broadcast")


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

    got = _run(t, group, fn, op="gather")
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


# -- point to point ----------------------------------------------------------

class Recv(NamedTuple):
    """A receive of :func:`exchange`: a tensor of ``shape`` and ``dtype``
    from group rank ``peer``, to lie on ``device``, matched to the send
    of the same ``tag``."""

    peer: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    tag: int = 0


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Recv], group) -> List[torch.Tensor]:
    """Every ``(tensor, peer, tag)`` of ``sends`` sent and every receive
    of ``recvs`` taken, all posted before any is waited on; returns the
    received tensors in the order of ``recvs``.  Messages between two
    ranks match by tag (under NCCL, which has no tags, by their order:
    both sides post them sorted by tag).  A peer equal to this rank takes
    the send of its tag directly (a pipeline of one rank)."""
    me = group_rank(group)
    local = {tag: t for t, peer, tag in sends if peer == me}
    sends = sorted(((t, p, g) for t, p, g in sends if p != me),
                   key=lambda s: s[2])
    order = sorted((i for i, r in enumerate(recvs) if r.peer != me),
                   key=lambda i: recvs[i].tag)
    out: List[Optional[torch.Tensor]] = [None] * len(recvs)
    for i, r in enumerate(recvs):
        if r.peer == me:
            out[i] = local[r.tag].to(r.device, r.dtype)
    if not sends and not order:
        return out
    nccl = dist.get_backend(group) == "nccl"
    wire_s = []
    for t, peer, tag in sends:
        c = t.detach()
        if c.is_cuda and not nccl:
            torch.cuda.current_stream(c.device).synchronize()
            c = c.to("cpu")
        elif not c.is_cuda and nccl:
            c = c.cuda()
        wire_s.append((c.contiguous(), dist.get_global_rank(group, peer),
                       tag))
    wire_r = []
    for i in order:
        r = recvs[i]
        wire_r.append((i, torch.empty(r.shape, dtype=r.dtype,
                                      device="cuda" if nccl else "cpu"),
                       dist.get_global_rank(group, r.peer), r.tag))
    t0 = time.perf_counter()
    if nccl:
        ops = ([dist.P2POp(dist.isend, c, peer, group) for c, peer, _ in
                wire_s]
               + [dist.P2POp(dist.irecv, b, peer, group) for _, b, peer, _
                  in wire_r])
        works = dist.batch_isend_irecv(ops)
    else:
        works = ([dist.isend(c, peer, group=group, tag=tag)
                  for c, peer, tag in wire_s]
                 + [dist.irecv(b, peer, group=group, tag=tag)
                    for _, b, peer, tag in wire_r])
    for w in works:
        w.wait()
    for i, b, _, _ in wire_r:
        out[i] = b.to(recvs[i].device)
    if not nccl:     # synchronous: the host waited
        STATS.seconds += time.perf_counter() - t0
    for c, _, _ in wire_s:
        STATS.calls += 1
        STATS.bytes += c.numel() * c.element_size()
        STATS.count("send")
    for _, b, _, _ in wire_r:
        STATS.calls += 1
        STATS.bytes += b.numel() * b.element_size()
        STATS.count("recv")
    return out


def send(t: torch.Tensor, peer: int, group, tag: int = 0) -> None:
    """``t`` to group rank ``peer`` (blocking until it is taken)."""
    if peer == group_rank(group):
        raise ValueError("send to this rank itself: use exchange")
    exchange([(t, peer, tag)], [], group)


def recv(shape, dtype: torch.dtype, device, peer: int, group,
         tag: int = 0) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from group rank ``peer``, on
    ``device``."""
    if peer == group_rank(group):
        raise ValueError("receive from this rank itself: use exchange")
    return exchange([], [Recv(peer, tuple(shape), dtype,
                              torch.device(device), tag)], group)[0]


__all__ = ["CommStats", "STATS", "Recv", "all_gather", "all_gather_tiled",
           "all_reduce", "all_to_all", "broadcast", "exchange", "gather", "group_rank",
           "group_size", "recv", "reduce_scatter", "send", "split"]
