"""Gradient-bucket planner over a superblock.

PyTorch port of the JAX package's ``apex_tpu/multi_tensor/buckets.py``,
host-only Python with the same logic.  Reference lineage: DDP gradient
bucketing (apex/parallel/distributed.py: close a bucket when the next
parameter would push it past the ``bucket_bytes`` cap) and
DistributedFusedAdam's chunked reduce-scatter pipeline
(contrib/optimizers/distributed_fused_adam.py:316-362).

Layout contract.  Rank ``r`` of a ``world``-way shard owns the contiguous
slice ``flat[r*S : (r+1)*S]`` with ``S = schema.total // world``.  A
bucket is a span of the per-rank shard ``[lo, hi)`` within ``[0, S)``:
the column block ``flat.reshape(world, S)[:, lo:hi]`` of the canonical
buffer, so the optimizer state keeps the canonical layout for every
plan.  Leaves are walked in pack order and a bucket closes at the cap;
each canonical boundary maps onto the shard as ``offset // world``
rounded down to ``span_align``.  On one device (``world=1``) a plan is
the span walk of :meth:`apex_tpu_torch.optimizers.FlatFusedAdam.step`:
one kernel launch per span.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from apex_tpu_torch.multi_tensor.flat import FlatSchema

__all__ = ["BucketPlan", "DEFAULT_BUCKET_BYTES", "plan_buckets"]

#: Default bucket cap.  The reference DDP default is 10 MB
#: (apex/parallel/distributed.py ``message_size``); torch DDP uses 25 MB.
#: 32 MiB gives a 1.3B-parameter fp32 grad buffer (~5.3 GB) ~170 buckets.
DEFAULT_BUCKET_BYTES = 32 << 20

_LANE = 128  # the JAX package's lane width; the least span alignment


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static, hashable bucket plan.

    ``spans`` partition the per-rank shard ``[0, shard)`` in order;
    bucket ``b`` covers canonical elements ``r*shard + [lo, hi)`` on
    every rank ``r`` (see module docstring for the layout contract).
    """

    spans: Tuple[Tuple[int, int], ...]
    shard: int           # per-rank shard length S = total // world
    world: int
    bucket_bytes: Optional[int]  # the cap that produced the plan

    @property
    def num_buckets(self) -> int:
        return len(self.spans)

    def span_elements(self, b: int) -> int:
        lo, hi = self.spans[b]
        return hi - lo

    def collective_elements(self, b: int) -> int:
        """Elements moved by bucket ``b``'s reduce-scatter (and its
        all-gather): the whole column block, ``world`` shard spans."""
        return self.span_elements(b) * self.world

    def validate(self) -> None:
        pos = 0
        for lo, hi in self.spans:
            if lo != pos or hi <= lo:
                raise ValueError(
                    f"bucket spans must partition [0, {self.shard}) in "
                    f"order; got {self.spans}")
            pos = hi
        if pos != self.shard:
            raise ValueError(
                f"bucket spans cover [0, {pos}) but the shard is "
                f"[0, {self.shard})")


def plan_buckets(schema: FlatSchema, world: int, *,
                 bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                 itemsize: int = 4,
                 span_align: int = _LANE) -> BucketPlan:
    """Partition ``schema``'s superblock into size-targeted buckets.

    Reference-DDP cap semantics over the canonical pack order: leaves
    accumulate into the current bucket until adding the next leaf's
    padded bytes would exceed ``bucket_bytes`` (a bucket always takes
    at least one leaf, so a single oversized leaf becomes its own
    bucket — ``bucket_bytes=1`` is the one-param-per-bucket edge).
    ``bucket_bytes=None`` produces the single-bucket plan, which is
    exactly the serialized ZeRO data path (one monolithic
    reduce-scatter + all-gather).

    Each canonical bucket boundary is then mapped to the per-rank
    shard as ``boundary // world`` rounded down to ``span_align``
    (default 128; ``FlatFusedAdam`` wants ``8*128``), so tiny adjacent
    leaves may merge into one span (their per-rank share is below one
    alignment row) — the plan never has more than ``shard //
    span_align`` buckets.
    ``itemsize`` is the grad transport dtype's byte width (the
    reduce-scatter payload the cap governs).
    """
    world = int(world)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    span_align = int(span_align)
    if span_align < _LANE or span_align % _LANE:
        raise ValueError(
            f"span_align must be a multiple of the {_LANE} lane width, "
            f"got {span_align}")
    if schema.total % world:
        raise ValueError(
            f"schema.total={schema.total} does not divide world={world}"
            " — pack with make_schema(total_multiple_of=128*world)")
    shard = schema.total // world
    if shard % span_align:
        raise ValueError(
            f"per-rank shard {shard} is not aligned (multiple of "
            f"{span_align}); pack with make_schema(total_multiple_of="
            f"{span_align}*world)")
    if bucket_bytes is None:
        return BucketPlan(spans=((0, shard),), shard=shard, world=world,
                          bucket_bytes=None)
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")

    # canonical bucket boundaries at padded-leaf granularity (DDP cap)
    boundaries = []  # canonical end offsets of closed buckets
    cur_bytes = 0
    n = schema.num_tensors
    for i in range(n):
        end = schema.offsets[i + 1] if i + 1 < n else schema.total
        padded = (end - schema.offsets[i]) * itemsize
        if cur_bytes and cur_bytes + padded > bucket_bytes:
            boundaries.append(schema.offsets[i])
            cur_bytes = 0
        cur_bytes += padded

    # map canonical boundaries onto the per-rank shard (lane-rounded);
    # dedupe collapsed spans, always close the final span at `shard`
    cuts = [0]
    for b in boundaries:
        x = b // world // span_align * span_align
        if x > cuts[-1] and x < shard:
            cuts.append(x)
    cuts.append(shard)
    spans = tuple((cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1))
    plan = BucketPlan(spans=spans, shard=shard, world=world,
                      bucket_bytes=bucket_bytes)
    plan.validate()
    return plan
