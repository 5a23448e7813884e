"""Serving fleet tier (port of the JAX package's
``apex_tpu/serving/fleet``): an SLO-aware router over N
:class:`~apex_tpu_torch.serving.ServingEngine` replicas.  Host code only:
the replicas' device work is their engines' (K1 on prefill, K5 on
decode), and several replicas can share one card.

Five modules, outside-in:

* :mod:`~apex_tpu_torch.serving.fleet.router` — :class:`FleetRouter`:
  per-tenant :class:`SLOClass` assignment, least-loaded placement on
  live telemetry signals, retry-with-backoff on replica fault, fencing
  + live migration, :func:`rolling_restart`, and the autoscaling
  *signal* (:func:`scale_hint` — never an action).
* :mod:`~apex_tpu_torch.serving.fleet.replica` — :class:`ReplicaProxy`:
  the in-process stand-in for the process/RPC boundary.  The router
  talks ONLY to this surface (submit/step/ping/snapshot/adopt/restart),
  so promoting a replica to its own process later changes the proxy,
  not the router.
* :mod:`~apex_tpu_torch.serving.fleet.migrate` — the migration planner:
  pure partition of snapshot records over healthy targets, headroom-
  and geometry-validated before any engine mutates, loud
  :class:`FleetCapacityError` instead of silent drops.
* :mod:`~apex_tpu_torch.serving.fleet.transport` — the message-level
  seam every cross-replica payload (pings, migration snapshots, KV page
  shipments) flows through: :class:`LocalTransport` (in-process,
  RPC-shaped: serialize → deliver → deserialize with per-message ids)
  and :class:`ChaosTransport` (per-message-class drop / delay /
  duplicate / reorder / corrupt injection).  The wire is JSON text in
  the JAX package's format, so messages cross between the two packages.
* :mod:`~apex_tpu_torch.serving.fleet.disagg` — disaggregated
  prefill/decode: :class:`DisaggRouter` ships finished prefills' KV
  pages from prefill replicas to decode replicas (idempotent,
  resumable, CRC-verified, retried with backoff, falling back to
  local prefill past the budget — zero dropped requests).

The fleet faults (:class:`~apex_tpu_torch.resilience.chaos.KillReplica`,
``SlowReplica``, ``BlackholeReplica``) install through
:func:`set_fleet_fault_hook`."""

from apex_tpu_torch.serving.fleet.disagg import (  # noqa: F401
    DisaggRouter,
    PageImporter,
)
from apex_tpu_torch.serving.fleet.migrate import (  # noqa: F401
    FleetCapacityError,
    plan_migration,
)
from apex_tpu_torch.serving.fleet.replica import (  # noqa: F401
    FENCED,
    HEALTHY,
    RESTARTING,
    HealthCheckTimeout,
    ReplicaDead,
    ReplicaProxy,
    set_fleet_fault_hook,
)
from apex_tpu_torch.serving.fleet.router import (  # noqa: F401
    FleetRouter,
    SLOClass,
    rolling_restart,
    scale_hint,
    scale_hint_from_events,
)
from apex_tpu_torch.serving.fleet.transport import (  # noqa: F401
    ChaosTransport,
    LocalTransport,
    Transport,
    TransportCorruption,
    TransportTimeout,
    register_error,
)

__all__ = [
    "FleetRouter",
    "SLOClass",
    "rolling_restart",
    "scale_hint",
    "scale_hint_from_events",
    "ReplicaProxy",
    "ReplicaDead",
    "HealthCheckTimeout",
    "set_fleet_fault_hook",
    "HEALTHY",
    "FENCED",
    "RESTARTING",
    "FleetCapacityError",
    "plan_migration",
    "Transport",
    "LocalTransport",
    "ChaosTransport",
    "TransportTimeout",
    "TransportCorruption",
    "register_error",
    "DisaggRouter",
    "PageImporter",
]
