"""The SLO-aware fleet router (port of the JAX package's
``apex_tpu/serving/fleet/router.py``; host code over the port's
:class:`~apex_tpu_torch.serving.ServingEngine`).

:class:`FleetRouter` fronts N replicas behind one submit surface:

* **Placement** — :meth:`~FleetRouter.route` picks the least-loaded
  healthy replica with bounded-queue headroom (signals:
  queue depth + running batch + page-pool occupancy, all read through
  the :class:`~apex_tpu_torch.serving.fleet.replica.ReplicaProxy` seam).
  When every bounded queue is full, the pick falls back to the
  least-loaded healthy replica so the ENGINE rejects loudly
  (``request_reject`` ``reason="queue_full"``) instead of the router
  inventing a second shedding policy.
* **SLO classes** — deadlines are existing per-request knobs; the
  router just assigns them per tenant class
  (:class:`SLOClass`), so SLO enforcement stays where it already
  works: the engine's shed/timeout machinery.
* **Fault handling, two nested nets** — an engine absorbs device
  faults up to its own ``max_recoveries``; only then does the fault
  propagate to the router, which retries the replica with exponential
  round backoff up to ``fault_retries`` before FENCING it: out of
  rotation, ``replica_fence`` emitted, live requests migrated.
* **Migration** — ``snapshot()`` →
  :func:`~apex_tpu_torch.serving.fleet.migrate.plan_migration` → one
  transport ``migrate`` message per target (the transport's
  serialize → deliver → deserialize pipeline IS the serializability
  pin the old inline JSON round-trip carried), adopted by an
  idempotent rid-deduping handler.  Atomic at both levels (plan
  refuses whole — with the full unplaceable list on
  ``migrate_refused`` — and adopt validates before mutating); every
  hop is a ``request_migrate`` event; zero silent drops.  Migrated
  streams are bitwise the unmigrated control's — KV is rebuilt by
  deterministic re-prefill, exactly the single-engine recovery
  contract.
* **Rolling restart** — :func:`rolling_restart` drains, migrates,
  restarts and readmits one replica at a time; a fleet of one
  readmits its own snapshot after the restart (nothing to migrate
  onto).
* **Autoscaling signal** — :func:`scale_hint` is a pure function of
  shed rate / occupancy / deadline attainment; the router only ever
  EMITS ``fleet_scale_hint`` (testable against recorded traces via
  :func:`scale_hint_from_events`) — acting on it is the operator's
  job.

The router owns the fleet-global rid namespace and the rid → handle
map (``handles``); a handle *is* a rid, which is what survives an RPC
boundary.  All replicas share ONE clock — per-replica clocks would
skew deadline math across a migration hop.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from apex_tpu_torch.serving.fleet.migrate import (FleetCapacityError,
                                            plan_migration)
from apex_tpu_torch.serving.fleet.replica import (FENCED, HealthCheckTimeout,
                                            ReplicaProxy)
from apex_tpu_torch.serving.fleet.transport import (LocalTransport, Transport,
                                              TransportCorruption,
                                              TransportTimeout,
                                              register_error)
from apex_tpu_torch.serving.kv_cache import PagePoolCorruption
from apex_tpu_torch.serving.scheduler import Request

# the one replica-owned exception that legitimately crosses the
# transport as a typed error reply (a ping probe timing out on the
# REMOTE side must re-raise as itself on the router side)
register_error(HealthCheckTimeout)


@dataclass(frozen=True)
class SLOClass:
    """A tenant tier mapped onto existing per-request knobs: the
    router assigns ``deadline_s`` at submit; ``None`` = best effort
    (no deadline, shed last)."""

    name: str
    deadline_s: Optional[float] = None


def scale_hint(*, shed_rate: float, occupancy: float,
               deadline_hit_rate: Optional[float] = None) -> str:
    """The autoscaling SIGNAL (never an action): pure thresholds over
    the three pressure signals the serving tier already measures.
    Shedding or missed deadlines mean the fleet is refusing work it
    was asked to do — scale up; a near-idle pool with perfect SLO
    attainment is paying for capacity it does not use — scale down;
    anything between holds."""
    if shed_rate > 0.05 or occupancy > 0.85:
        return "scale_up"
    if deadline_hit_rate is not None and deadline_hit_rate < 0.90:
        return "scale_up"
    if shed_rate == 0.0 and occupancy < 0.25 and (
            deadline_hit_rate is None or deadline_hit_rate >= 0.99):
        return "scale_down"
    return "hold"


def scale_hint_from_events(events: Sequence[Dict[str, Any]]) -> str:
    """Derive the hint from a RECORDED telemetry stream (a list of
    schema-valid event dicts), so the policy is testable against
    traces without standing a fleet up.  Terminal outcomes =
    retires + rejects + timeouts; shed rate counts the refused/dropped
    share; occupancy averages ``decode_step`` pool pressure over the
    allocatable pool (page 0 is scratch)."""
    retires = [e for e in events if e.get("type") == "request_retire"]
    rejects = [e for e in events if e.get("type") == "request_reject"]
    timeouts = [e for e in events if e.get("type") == "request_timeout"]
    steps = [e for e in events if e.get("type") == "decode_step"]
    total = len(retires) + len(rejects) + len(timeouts)
    shed_rate = (len(rejects) + len(timeouts)) / max(1, total)
    occ = 0.0
    if steps:
        occ = sum(e["pool_used"] / max(1, e["pool_pages"] - 1)
                  for e in steps) / len(steps)
    hits = [e["deadline_hit"] for e in retires if "deadline_hit" in e]
    hit_rate = (sum(1 for h in hits if h) / len(hits)) if hits else None
    return scale_hint(shed_rate=shed_rate, occupancy=occ,
                      deadline_hit_rate=hit_rate)


class FleetRouter:
    """Route requests over ``replicas``
    (:class:`~apex_tpu_torch.serving.fleet.replica.ReplicaProxy`), fencing
    and migrating around faults.  ``fault_retries`` is the
    router-level retry budget AFTER a replica's engine has exhausted
    its own recoveries; ``health_timeout_s`` is the deterministic ping
    latency budget; ``scale_hint_every`` emits ``fleet_scale_hint``
    every N fleet rounds (0 = never).  ``on_round`` fires once at the
    end of every fleet round — the virtual-clock injection point: all
    replicas step CONCURRENTLY in a real fleet, so a shared
    :class:`~apex_tpu_torch.serving.engine.SimClock` (which ticks per
    engine step, i.e. N ticks per round) would charge N replicas N×
    the time of one; a router-ticked clock charges one round one
    tick regardless of fleet width (TTFT on a virtual clock is
    measured on exactly this)."""

    def __init__(self, replicas: Sequence[ReplicaProxy], *,
                 telemetry=None,
                 slo_classes: Sequence[SLOClass] = (),
                 fault_retries: int = 2,
                 health_timeout_s: float = 0.25,
                 scale_hint_every: int = 50,
                 on_round: Optional[Callable[[], None]] = None,
                 transport: Optional[Transport] = None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas: List[ReplicaProxy] = list(replicas)
        self._by_name = {r.name: r for r in self.replicas}
        self.telemetry = telemetry
        # EVERY cross-replica payload — health pings, migration
        # snapshots, KV page shipments — goes through the transport
        # seam (serialize → deliver → deserialize, per-message ids).
        # Default is the plain in-process LocalTransport; tests wrap it
        # in ChaosTransport to lose/delay/duplicate/reorder/corrupt
        # messages in flight.
        self.transport = transport if transport is not None \
            else LocalTransport()
        for rep in self.replicas:
            self.transport.register(
                rep.name, "ping",
                lambda p, rep=rep:
                    {"latency_s": rep.ping(float(p["timeout_s"]))})
            self.transport.register(
                rep.name, "migrate",
                lambda p, rep=rep: self._migrate_handler(rep, p))
        self.slo_classes = {c.name: c for c in slo_classes}
        self.fault_retries = int(fault_retries)
        self.health_timeout_s = float(health_timeout_s)
        self.scale_hint_every = int(scale_hint_every)
        self.on_round = on_round
        #: fleet-global rid namespace — rid collisions across replicas
        #: would make migration ambiguous (pinned in adopt())
        self._next_rid = 0
        #: rid -> live Request handle; REBOUND on migration (the old
        #: engine's object is dead).  A handle is a rid — the only
        #: thing that survives an RPC boundary.
        self.handles: Dict[int, Request] = {}
        #: rid -> replica name (current placement)
        self.placement: Dict[int, str] = {}
        self.round = 0

    # -- lifecycle -------------------------------------------------------

    def warmup(self) -> float:
        return sum(rep.warmup() for rep in self.replicas)

    # -- intake ----------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               slo: Optional[str] = None,
               deadline_s: Optional[float] = None,
               arrival_t: Optional[float] = None) -> int:
        """Place one request on the fleet; returns its rid (THE
        handle).  ``slo`` names a registered :class:`SLOClass` whose
        deadline overrides ``deadline_s``; rejection semantics are the
        engine's (terminal ``rejected`` + ``request_reject`` event) —
        check ``handles[rid].finish_reason``."""
        if slo is not None:
            cls = self.slo_classes.get(slo)
            if cls is None:
                raise ValueError(
                    f"unknown SLO class {slo!r}; registered: "
                    f"{sorted(self.slo_classes)}")
            deadline_s = cls.deadline_s
        rep = self.route(prompt=prompt)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival_t=(rep.engine.clock() if arrival_t is None
                                 else arrival_t),
                      deadline_s=deadline_s)
        rep.engine.submit_request(req)
        self.handles[rid] = req
        self.placement[rid] = rep.name
        return rid

    def route(self, prompt: Optional[Sequence[int]] = None,
              roles: Optional[Sequence[str]] = None) -> ReplicaProxy:
        """Pick the least-loaded healthy replica, preferring ones with
        bounded-queue headroom; with every queue full the least-loaded
        healthy replica takes the submission and its engine rejects
        loudly (backpressure stays ONE policy, the engine's).  Raises
        when no replica is healthy — a dead fleet is not a routing
        decision.

        ``roles`` restricts the candidates to the named replica roles
        (the disaggregation axis; ``None`` considers everyone).
        ``prompt`` enables PREFIX AFFINITY: among the
        candidate pool, replicas whose local
        :class:`~apex_tpu_torch.serving.kv_cache.PrefixIndex` already holds
        a usable prefix of the prompt are preferred — the deepest hit
        wins, least-loaded tiebreak — so repeated prompts land where
        their pages are already warm instead of re-prefilling cold on
        a less-loaded peer.  No index state is shipped or shared: the
        affinity reads each replica's existing local hit signal, and a
        fleet with no sharing enabled routes exactly as before."""
        healthy = [r for r in self.replicas if r.healthy]
        if roles is not None:
            healthy = [r for r in healthy if r.role in roles]
        if not healthy:
            raise RuntimeError(
                "no healthy replicas in the fleet" if roles is None else
                f"no healthy replica with role in {tuple(roles)}")
        with_room = [r for r in healthy
                     if r.queue_headroom() is None or r.queue_headroom() > 0]
        pool = with_room or healthy
        if prompt is not None:
            hits = {}
            for r in pool:
                idx = r.engine.prefix_index
                if idx is not None:
                    m, _ = idx.lookup(list(prompt))
                    if m > 0:
                        hits[r.name] = m
            if hits:
                best = max(hits.values())
                pool = [r for r in pool if hits.get(r.name) == best]
        return min(pool, key=lambda r: (r.load_score(), r.name))

    # -- health + fencing ------------------------------------------------

    def _health_check(self) -> None:
        """Probe every in-rotation replica THROUGH the transport; a
        probe timing out remotely, or the probe message itself lost /
        late / corrupted in flight, fences the replica on the spot and
        reroutes its live requests — an unreachable replica and an
        unhealthy one get the same treatment, because the router
        cannot tell them apart (and must not block finding out: the
        probe is virtual-latency, no sleep)."""
        for rep in self.replicas:
            if not rep.healthy:
                continue
            try:
                self.transport.call(rep.name, "ping",
                                    {"timeout_s": self.health_timeout_s})
            except HealthCheckTimeout:
                self._fence(rep, cause="health_check_timeout")
            except TransportTimeout:
                self._fence(rep, cause="transport_timeout")
            except TransportCorruption:
                self._fence(rep, cause="transport_corruption")

    def _clock(self) -> float:
        """The fleet's shared clock (all replicas share ONE clock by
        construction — see the module docstring), read through any
        replica's engine."""
        return self.replicas[0].engine.clock()

    def _call_with_retry(self, dst: str, msg_class: str,
                         payload: Dict[str, Any], *,
                         trace: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        """Transport call with the router's bounded retry budget:
        ``fault_retries + 1`` immediate attempts absorbing in-flight
        loss/corruption (each retry re-serializes, so a corrupted
        message goes out clean; the receiver's idempotency makes a
        delayed-but-processed message's retry harmless).  Exhaustion
        raises ``RuntimeError`` — control-plane operations like
        migration have no fallback tier, failing them loudly beats
        silently dropping requests."""
        last: Optional[Exception] = None
        for _ in range(self.fault_retries + 1):
            try:
                return self.transport.call(dst, msg_class, payload,
                                           trace=trace)
            except (TransportTimeout, TransportCorruption) as e:
                last = e
        raise RuntimeError(
            f"{msg_class} to {dst} failed after "
            f"{self.fault_retries + 1} attempts: {last}") from last

    @staticmethod
    def _migrate_handler(rep: ReplicaProxy,
                         payload: Dict[str, Any]) -> Dict[str, Any]:
        """Receiver side of a migration shipment: adopt the records
        this replica does NOT already hold.  The rid-dedupe makes the
        handler idempotent — a duplicated wire message, or a sender
        retry after a delayed-but-processed delivery, finds the rids
        live and adopts nothing twice."""
        records = payload["records"]
        fresh = [r for r in records
                 if rep.find_request(int(r["rid"])) is None]
        if fresh:
            rep.adopt(fresh)
        return {"ok": True,
                "adopted": [int(r["rid"]) for r in records]}

    def _fence(self, rep: ReplicaProxy, cause: str,
               migrate: bool = True) -> None:
        live = rep.queue_depth() + rep.running()
        rep.fence()
        self._emit("replica_fence", replica=rep.name, cause=cause,
                   live_requests=live, recoveries=rep.engine.recoveries,
                   fault_retries=rep.fault_attempts)
        # flight recorder: a fence is a fault boundary — dump the
        # fenced replica's recent-event ring while the evidence is hot
        from apex_tpu_torch.telemetry.tracing import maybe_dump_flight_record
        maybe_dump_flight_record(rep.engine.telemetry,
                                 f"replica_fence:{cause}",
                                 step=self.round)
        if migrate:
            self._migrate_requests(rep)

    def _migration_targets(self, source: ReplicaProxy
                           ) -> List[ReplicaProxy]:
        """Candidate adopters for ``source``'s live requests: healthy
        peers.  Overridable — the disaggregated router excludes
        prefill-only replicas, whose engines would queue migrated
        decode work forever."""
        return [r for r in self.replicas
                if r.healthy and r.name != source.name]

    def _migrate_requests(self, source: ReplicaProxy) -> List[Request]:
        """Move every live request off ``source`` onto healthy peers,
        THROUGH the transport (serialize → deliver → deserialize is
        now the serializability pin the old inline JSON round-trip
        carried; in-flight loss/corruption costs bounded immediate
        retries against the idempotent migrate handler).  The plan
        validates headroom + geometry before any adopt, and each adopt
        validates atomically again — a failure anywhere leaves every
        engine untouched and raises loudly; a REFUSED plan additionally
        emits ``migrate_refused`` with the full unplaceable list and
        the required-vs-available page counts, so operators can size
        capacity from the stream.  Handles are REBOUND to the adopting
        engine's request objects; token streams continue bitwise
        (deterministic re-prefill)."""
        records = source.snapshot()["requests"]
        if not records:
            return []
        targets = self._migration_targets(source)
        try:
            plan = plan_migration(records, targets)
        except FleetCapacityError as e:
            self._emit("migrate_refused", replica=source.name,
                       unplaceable=list(e.unplaceable),
                       requests=len(e.unplaceable),
                       pages_required=e.pages_required,
                       pages_available=e.pages_available)
            from apex_tpu_torch.telemetry.tracing import \
                maybe_dump_flight_record
            maybe_dump_flight_record(self.telemetry, "migrate_refused",
                                     step=self.round)
            raise
        moved: List[Request] = []
        for name, recs in sorted(plan.items()):
            if not recs:
                continue
            self._call_with_retry(name, "migrate", {"records": recs})
            for rec in recs:
                req = self._by_name[name].find_request(int(rec["rid"]))
                self.handles[req.rid] = req
                self.placement[req.rid] = name
                self._emit("request_migrate", rid=req.rid,
                           from_replica=source.name, to_replica=name,
                           tokens_done=len(req.generated),
                           was_running=bool(rec["was_running"]))
                self._emit_hop_span(req.rid, source.name, name)
                moved.append(req)
        return moved

    def _emit_hop_span(self, rid: int, src: str, dst: str) -> None:
        """Point ``migrate_hop`` span on the fleet bus.  Root
        level (no parent): a hop can move a QUEUED request whose
        admission spans never existed, so parenting on them would
        dangle; the trace CLI stitches hops to the rid's tree by
        trace id alone."""
        now = self._clock()
        self._emit("span", rid=rid,
                   span_id=f"{rid}:migrate_hop:{src}:{dst}:{self.round}",
                   kind="migrate_hop", t_start=now, t_end=now,
                   replica=src)

    # -- the fleet round -------------------------------------------------

    def step(self) -> None:
        """One fleet round: health-check everything, then step each
        in-rotation replica with work.  A propagated fault (the
        engine's own recovery budget is already spent by the time it
        reaches here) costs one retry: the replica sits out
        ``2^attempts`` rounds of backoff, and past ``fault_retries``
        it is fenced and drained."""
        from apex_tpu_torch.resilience.chaos import DeviceLossError

        self.round += 1
        self._health_check()
        for rep in self.replicas:
            if not rep.healthy or rep.idle:
                continue
            if rep.backoff_until > self.round:
                continue
            try:
                rep.step()
            except (DeviceLossError, PagePoolCorruption) as e:
                rep.fault_attempts += 1
                if rep.fault_attempts > self.fault_retries:
                    self._fence(rep, cause=type(e).__name__)
                else:
                    rep.backoff_until = self.round + (1 << rep.fault_attempts)
        if self.on_round is not None:
            self.on_round()

    def _fleet_busy(self) -> bool:
        """Live work remains somewhere in the fleet (the
        :meth:`run` drain predicate).  Overridable: the disaggregated
        router also counts in-flight page transfers, which can be
        backing off while every engine is momentarily idle."""
        return any(r.healthy and not r.idle for r in self.replicas)

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Round until every in-rotation replica drains; returns the
        handles in rid order.  Non-drain raises — a backing-off
        replica still counts as live work, so the budget must cover
        backoff rounds too."""
        for _ in range(max_steps):
            if not self._fleet_busy():
                break
            self.step()
            if self.scale_hint_every and \
                    self.round % self.scale_hint_every == 0:
                self.emit_scale_hint()
        else:
            raise RuntimeError(
                f"fleet did not drain in {max_steps} rounds")
        for rep in self.replicas:
            if rep.healthy:
                rep.engine._retire(rep.engine.clock())
        return [self.handles[rid] for rid in sorted(self.handles)]

    # -- autoscaling signal ----------------------------------------------

    def signals(self) -> Dict[str, Any]:
        """Fleet-aggregate pressure signals over in-rotation replicas
        (the inputs to :func:`scale_hint`, also emitted verbatim on
        ``fleet_scale_hint`` so recorded traces can replay the
        decision)."""
        healthy = [r for r in self.replicas if r.healthy]
        occ = (sum(r.occupancy() for r in healthy) / len(healthy)
               if healthy else 1.0)
        shed = sum(r.shed_count() for r in healthy)
        shed_rate = shed / max(1, len(self.handles))
        hits = []
        for rep in healthy:
            for req in rep.engine.sched.finished:
                if req.deadline_t is not None and req.finish_t is not None:
                    hits.append(req.finish_t <= req.deadline_t)
        hit_rate = (sum(1 for h in hits if h) / len(hits)) if hits else None
        return {"shed_rate": shed_rate, "occupancy": occ,
                "deadline_hit_rate": hit_rate,
                "replicas": len(self.replicas), "healthy": len(healthy)}

    def emit_scale_hint(self) -> str:
        sig = self.signals()
        hint = scale_hint(shed_rate=sig["shed_rate"],
                          occupancy=sig["occupancy"],
                          deadline_hit_rate=sig["deadline_hit_rate"])
        ev = dict(hint=hint, shed_rate=sig["shed_rate"],
                  occupancy=sig["occupancy"], replicas=sig["replicas"],
                  healthy=sig["healthy"])
        if sig["deadline_hit_rate"] is not None:
            # optional means absent, never a sentinel
            ev["deadline_hit_rate"] = sig["deadline_hit_rate"]
        self._emit("fleet_scale_hint", **ev)
        return hint

    # -- plumbing --------------------------------------------------------

    def _emit(self, type_: str, **payload) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(type_, step=self.round, **payload)


def rolling_restart(router: FleetRouter, *, serve_between: int = 0) -> None:
    """Drain, migrate, restart, readmit — one replica at a time, so
    N-1 replicas keep serving and p99 TTFT holds.  Each replica's turn: fence with
    ``cause="rolling_restart"`` (out of rotation + ``replica_fence``
    event), migrate its live requests onto the still-healthy peers,
    rebuild its engine from the factory (fresh warmup — zero compiles
    later, by the standing contract), and rejoin rotation empty.
    ``serve_between`` is the replica's DOWNTIME WINDOW in fleet
    rounds: those rounds run between its fence and its restart, so
    the still-healthy peers keep serving (first tokens keep landing)
    while the replica is conceptually down — the in-process stand-in
    for peers serving concurrently while one process respawns.

    A fleet of ONE has nowhere to migrate: it snapshots, sits out the
    same downtime window with NOTHING serving (its queue just ages —
    the honest cost of single-replica stop-the-world), restarts, and
    re-adopts its own records.

    FENCED replicas rejoin too: their live requests already migrated
    at fence time, so a bare restart returns them to rotation — the
    rolling restart is also the repair operation after a chaos kill."""
    for rep in list(router.replicas):
        if not rep.healthy:
            # fenced at some earlier fault: drained already, restart
            # brings it back empty
            if rep.state == FENCED:
                rep.restart()
            continue
        peers = [r for r in router.replicas
                 if r.healthy and r.name != rep.name]
        if peers:
            router._fence(rep, cause="rolling_restart")
            for _ in range(serve_between):
                router.step()
            rep.restart()
        else:
            snap = json.loads(json.dumps(rep.snapshot()))
            router._fence(rep, cause="rolling_restart", migrate=False)
            for _ in range(serve_between):
                router.step()
            rep.restart()
            records = snap["requests"]
            if records:
                adopted = rep.adopt(records)
                for req, rec in zip(adopted, records):
                    router.handles[req.rid] = req
                    router.placement[req.rid] = rep.name
                    router._emit("request_migrate", rid=req.rid,
                                 from_replica=rep.name, to_replica=rep.name,
                                 tokens_done=len(req.generated),
                                 was_running=bool(rec["was_running"]))
                    router._emit_hop_span(req.rid, rep.name, rep.name)
