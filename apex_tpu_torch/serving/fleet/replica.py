"""The replica seam: one :class:`ReplicaProxy` per engine (port of the
JAX package's ``apex_tpu/serving/fleet/replica.py``).

The router never touches :class:`~apex_tpu_torch.serving.ServingEngine`
internals — everything it needs (placement signals, stepping, health,
snapshot/adopt, restart) goes through this proxy, which is in-process
today and the process/RPC boundary later.  Two consequences shape the
surface:

* every method speaks plain data (ints, floats, snapshot dicts) or
  raises a typed exception — nothing here would break across a wire;
* the fleet chaos hook lives HERE, not in the engine: ``KillReplica``
  / ``SlowReplica`` / ``BlackholeReplica`` model the *replica*
  failing (its process, its link), which is invisible to the engine
  inside it.  The serving fault hook (``engine.set_fault_hook``)
  keeps modeling the *device* failing.

Health checks are deterministic: :meth:`ReplicaProxy.ping` fires the
fleet fault point with a mutable ``{"latency_s": 0.0}`` payload that
injectors inflate; a latency past the budget raises
:class:`HealthCheckTimeout` without any real sleeping, so a
blackholed replica is detected in virtual time and chaos tests never
hang the suite.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from apex_tpu_torch.serving.kv_cache import PagePoolCorruption

#: ReplicaProxy lifecycle states (the fence/backoff state machine is
#: :class:`~apex_tpu_torch.serving.fleet.router.FleetRouter`'s).
HEALTHY = "healthy"
DRAINING = "draining"
FENCED = "fenced"
RESTARTING = "restarting"


class ReplicaDead(RuntimeError):
    """An operation was routed to a fenced/restarting replica."""


class HealthCheckTimeout(RuntimeError):
    """A replica's health probe exceeded its latency budget."""


# -- fleet chaos hook --------------------------------------------------------
# The fleet twin of engine.set_fault_hook: the chaos tier installs an
# injector here to kill / slow / blackhole a named REPLICA at a fleet
# event ("step" before a proxy steps its engine, "ping" during a
# health probe — the ping payload is a mutable dict whose "latency_s"
# the injector inflates).  Production never sets it.

_FLEET_FAULT_HOOK: Optional[Callable[[str, str, Any], None]] = None


def set_fleet_fault_hook(hook: Optional[Callable[[str, str, Any], None]]):
    """Install (or clear) the fleet fault hook; returns the previous
    hook so context-manager injectors can chain/restore."""
    global _FLEET_FAULT_HOOK
    prev = _FLEET_FAULT_HOOK
    _FLEET_FAULT_HOOK = hook
    return prev


def _fleet_fault_point(event: str, replica: str, info: Any) -> None:
    if _FLEET_FAULT_HOOK is not None:
        _FLEET_FAULT_HOOK(event, replica, info)


class ReplicaProxy:
    """Router-facing handle on one serving engine.

    ``engine_factory`` is a zero-arg callable returning a fresh,
    un-warmed :class:`~apex_tpu_torch.serving.ServingEngine`; the proxy owns
    the engine's lifecycle (construction, warmup, restart) so the
    router can treat "replica" as an opaque unit of capacity.  The
    factory is also the restart path: :meth:`restart` swaps in a
    brand-new engine, which is exactly what a process respawn will do
    at the RPC boundary.
    """

    def __init__(self, name: str, engine_factory, *, telemetry=None,
                 role: str = "mixed"):
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r} "
                             "(expected mixed / prefill / decode)")
        self.name = name
        self.engine_factory = engine_factory
        self.telemetry = telemetry
        #: disaggregation role axis: "mixed" replicas do everything
        #: (the colocated fleet); "prefill" replicas only admit +
        #: chunk-prefill (their engines are ``prefill_only``); "decode"
        #: replicas receive shipped pages (``kv_import``) and decode.
        #: The role is a PLACEMENT attribute — the proxy itself treats
        #: every engine identically.
        self.role = role
        self.engine = engine_factory()
        self.state = HEALTHY
        #: router-level retry budget consumed (engine-level recovery
        #: is counted separately by ``engine.recoveries``)
        self.fault_attempts = 0
        #: router round before which this replica is skipped (backoff)
        self.backoff_until = 0
        self.restarts = 0

    # -- lifecycle -------------------------------------------------------

    def warmup(self) -> float:
        return self.engine.warmup()

    def restart(self) -> float:
        """Replace the engine with a fresh factory build and warm it;
        the old engine's state is gone (the caller migrates/readmits
        requests around this — see ``rolling_restart``)."""
        self.state = RESTARTING
        self.engine = self.engine_factory()
        secs = self.engine.warmup()
        self.state = HEALTHY
        self.fault_attempts = 0
        self.backoff_until = 0
        self.restarts += 1
        return secs

    def fence(self) -> None:
        self.state = FENCED

    @property
    def healthy(self) -> bool:
        return self.state == HEALTHY

    # -- health ----------------------------------------------------------

    def ping(self, timeout_s: float) -> float:
        """Deterministic health probe: injectors inflate the probe's
        virtual latency through the fleet fault hook; past the budget
        the probe raises :class:`HealthCheckTimeout` (no real sleep —
        a blackholed replica reports ``inf`` and fails instantly)."""
        probe = {"latency_s": 0.0}
        _fleet_fault_point("ping", self.name, probe)
        latency = float(probe["latency_s"])
        if latency > timeout_s:
            raise HealthCheckTimeout(
                f"replica {self.name}: health probe {latency:.3f}s "
                f"exceeds budget {timeout_s:.3f}s")
        return latency

    # -- work ------------------------------------------------------------

    def step(self) -> None:
        """One engine step behind the replica fault point.  A fault
        injected here (or raised by the engine itself) first burns the
        ENGINE's recovery budget via its own ``_handle_fault`` path —
        only an exhausted/disabled engine lets the fault propagate to
        the router, which then spends its retry-with-backoff budget
        before fencing.  Two nested nets, each observable."""
        if self.state != HEALTHY:
            raise ReplicaDead(f"step on {self.state} replica {self.name}")
        from apex_tpu_torch.resilience.chaos import DeviceLossError

        try:
            _fleet_fault_point("step", self.name, self.engine.steps)
            self.engine.step()
        except (DeviceLossError, PagePoolCorruption) as e:
            self.engine._handle_fault(e)

    # -- placement signals ----------------------------------------------

    @property
    def idle(self) -> bool:
        return self.engine.sched.idle

    def queue_depth(self) -> int:
        return len(self.engine.sched.waiting)

    def running(self) -> int:
        return len(self.engine.sched.running)

    def queue_headroom(self) -> Optional[int]:
        """Remaining bounded-queue slots (``None`` = unbounded)."""
        mq = self.engine.sched.max_queue
        if mq is None:
            return None
        return mq - len(self.engine.sched.waiting)

    def occupancy(self) -> float:
        """Page-pool occupancy in [0, 1] over the allocatable pool
        (page 0 is scratch, never allocatable)."""
        cache = self.engine.cache
        allocatable = max(1, cache.num_pages - 1)
        return cache.pages_used / allocatable

    def shed_count(self) -> int:
        """Requests this engine refused or dropped (rejects live on
        ``engine.rejected``; deadline sheds/timeouts retire with a
        timeout reason)."""
        timeouts = sum(1 for r in self.engine.sched.finished
                       if r.finish_reason in ("timeout", "shed"))
        return len(self.engine.rejected) + timeouts

    def load_score(self) -> float:
        """Least-loaded placement key: live request pressure plus pool
        occupancy (the fractional tiebreak between equally-queued
        replicas)."""
        return (self.queue_depth() + self.running()) + self.occupancy()

    # -- migration -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return self.engine.snapshot()

    def adopt(self, records: List[Dict[str, Any]]):
        return self.engine.adopt(records)

    def find_request(self, rid: int):
        """This replica's live :class:`Request` handle for ``rid``
        (running, waiting, or finished), or ``None``.  The rebinding
        step after a transport-mediated transfer: the wire carries
        records, not handles, so after a migrate/ship reply the router
        looks the adopted request up by rid to hand the caller a live
        handle."""
        rid = int(rid)
        for pool in (self.engine.sched.running,
                     self.engine.sched.waiting,
                     self.engine.sched.finished):
            for req in pool:
                if req.rid == rid:
                    return req
        return None
