"""Migration planning (port of the JAX package's
``apex_tpu/serving/fleet/migrate.py``): partition a fenced replica's
snapshot records over healthy targets, validated before any engine
mutates.

The planner is PURE — it reads target headroom/geometry and returns an
assignment; execution (``adopt`` per target, re-handling, telemetry)
stays in the router.  Pure planning is what makes refusal atomic at
the fleet level: if any live record cannot be placed, the plan raises
:class:`FleetCapacityError` and nothing has moved — zero silent drops,
the snapshot is intact, and the operator sees exactly which request
did not fit.

Records travel in the engine's snapshot format (format 1, host-only,
JSON-serializable by construction); they ship to each
target through the fleet transport's serialize → deliver →
deserialize pipeline, so the in-process fast path exercises exactly
the serialization a process/RPC boundary will.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence


class FleetCapacityError(RuntimeError):
    """No healthy target can take one or more live migrating requests.

    Carries the FULL refusal shape, not just the first
    failure: ``unplaceable`` lists every rid that fit no target,
    ``pages_required`` the pool pages their worst-case footprints
    need, ``pages_available`` the free pages across the candidate
    targets — the numbers an operator sizes capacity from (the router
    also emits them on a ``migrate_refused`` event)."""

    def __init__(self, msg: str, *,
                 unplaceable: Sequence[int] = (),
                 pages_required: int = 0,
                 pages_available: int = 0):
        super().__init__(msg)
        self.unplaceable = list(unplaceable)
        self.pages_required = int(pages_required)
        self.pages_available = int(pages_available)


def _servable_by(target, record: Dict[str, Any]) -> bool:
    """Geometry check without mutating the target: mirrors
    ``check_servable`` over the snapshot record's worst case."""
    sched = target.engine.sched
    cache = target.engine.cache
    worst = len(record["prompt"]) + int(record["max_new_tokens"])
    if worst > sched.max_position:
        return False
    if cache.pages_needed(worst) > cache.max_pages_per_request:
        return False
    if worst > sched.prefill_budget and sched.chunk_size is None:
        return False
    return True


def plan_migration(records: Sequence[Dict[str, Any]],
                   targets: Sequence) -> Dict[str, List[Dict[str, Any]]]:
    """Assign snapshot ``records`` to healthy ``targets``
    (:class:`~apex_tpu_torch.serving.fleet.replica.ReplicaProxy`), least
    loaded first, respecting each target's bounded-queue headroom and
    geometry.  Returns ``{replica_name: [records...]}`` covering EVERY
    record, or raises :class:`FleetCapacityError` — a migration plan
    never quietly sheds.

    Done-at-capture records retire immediately on adoption (they never
    enter the waiting queue), so they don't consume headroom; live
    records do.  Assignment order is rid order for determinism."""
    done = [r for r in records if _record_done(r)]
    live = [r for r in records if not _record_done(r)]
    if not targets:
        raise FleetCapacityError(
            f"no healthy targets for {len(records)} migrating requests",
            unplaceable=[int(r["rid"]) for r in
                         sorted(live, key=lambda r: int(r["rid"]))])
    plan: Dict[str, List[Dict[str, Any]]] = {t.name: [] for t in targets}
    headroom = {t.name: t.queue_headroom() for t in targets}
    # fractional load tiebreak frozen at plan time; planned placements
    # added on top so a burst spreads instead of piling on one target
    load = {t.name: t.load_score() for t in targets}
    by_name = {t.name: t for t in targets}
    # a refused plan reports EVERY request that fit nowhere, not just
    # the first — one fence, one error, the complete capacity gap
    unplaceable: List[Dict[str, Any]] = []
    for rec in sorted(live, key=lambda r: int(r["rid"])):
        candidates = [
            n for n, t in by_name.items()
            if (headroom[n] is None or headroom[n] > 0)
            and _servable_by(t, rec)
        ]
        if not candidates:
            unplaceable.append(rec)
            continue
        name = min(candidates, key=lambda n: (load[n], n))
        plan[name].append(rec)
        load[name] += 1
        if headroom[name] is not None:
            headroom[name] -= 1
    if unplaceable:
        rids = [int(r["rid"]) for r in unplaceable]
        required = sum(
            min(t.engine.cache.pages_needed(
                len(r["prompt"]) + int(r["max_new_tokens"]))
                for t in targets)
            for r in unplaceable)
        available = sum(t.engine.cache.pages_free for t in targets)
        raise FleetCapacityError(
            f"{len(rids)} of {len(live)} migrating requests fit no "
            f"healthy target (rids {rids}; worst-case pages required "
            f"{required}, free across targets {available}; headroom "
            f"{dict(headroom)}) — refuse the whole plan, drop nothing",
            unplaceable=rids, pages_required=required,
            pages_available=available)
    for rec in sorted(done, key=lambda r: int(r["rid"])):
        name = min(by_name, key=lambda n: (load[n], n))
        plan[name].append(rec)
    return plan


def _record_done(rec: Dict[str, Any]) -> bool:
    """Snapshot-record twin of ``Request.done``: generation budget
    exhausted or EOS sampled (the engine retires these immediately on
    adopt instead of re-prefilling past max_new_tokens)."""
    gen = rec["generated"]
    if len(gen) >= int(rec["max_new_tokens"]):
        return True
    eos = rec["eos_id"]
    return eos is not None and bool(gen) and gen[-1] == eos
