"""Twin fleets for the fleet tests: one scenario, built the same way on
the JAX package and on the port (on the CPU), so a test can run it on
both and hold the port's streams, events, plans and chaos decisions
against JAX's without a tolerance.

The model is the JAX serving toy (vocab 64, hidden 32, 4 heads, 2
layers, max_position 96, page 8, fp32) with JAX's ``init_params``
weights carried across by ``params_from_jax``; every engine reads a
``SimClock``.  A :class:`Side` carries one package's modules, so a
scenario is written once against ``side.sv`` (serving), ``side.fleet``,
``side.chaos`` and ``side.tel`` (telemetry).
"""

from __future__ import annotations

import random

import jax
import numpy as np

from apex_tpu import serving as jsv
from apex_tpu import telemetry as jtel
from apex_tpu.resilience import chaos as jchaos
from apex_tpu.serving import fleet as jfleet
from apex_tpu_torch import serving as tsv
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.resilience import chaos as tchaos
from apex_tpu_torch.serving import fleet as tfleet

TOY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
           max_position=96)

#: event fields compared between the packages: everything but the bus's
#: own stamps (run id, mesh, wall time)
STAMPS = ("run_id", "mesh", "t", "ts")


class Side:
    """One package's serving stack at the toy configuration."""

    def __init__(self, name, sv, fleet, chaos, tel, params, **engine_kw):
        self.name = name
        self.sv, self.fleet, self.chaos, self.tel = sv, fleet, chaos, tel
        self.cfg = sv.ServingModelConfig(**TOY)
        self.params = params
        self.engine_kw = engine_kw

    def factory(self, clock, **kw):
        """The JAX fleet tests' engine factory: 64 pages of 8, batch 4,
        whole-row prefill, a queue of 16."""
        kw.setdefault("num_pages", 64)
        kw.setdefault("page_size", 8)
        kw.setdefault("max_batch", 4)
        kw.setdefault("prefill_budget", TOY["max_position"])
        kw.setdefault("max_queue", 16)
        kw.update(self.engine_kw)

        def build():
            return self.sv.ServingEngine(self.cfg, self.params, clock=clock,
                                         **kw)

        return build

    def bus(self, run_id="fleet"):
        mem = self.tel.MemorySink()
        return self.tel.TelemetryBus(run_id=run_id, sinks=[mem]), mem

    def colocated(self, n=2, *, telemetry=None, clock=None, factory_kw=None,
                  **router_kw):
        clock = clock if clock is not None else self.sv.SimClock()
        reps = [self.fleet.ReplicaProxy(
            f"r{i}", self.factory(clock, **(factory_kw or {})))
            for i in range(n)]
        return self.fleet.FleetRouter(reps, telemetry=telemetry,
                                      **router_kw), reps

    def disagg(self, *, n_prefill=1, n_decode=1, telemetry=None, clock=None,
               factory_kw=None, prefill_kw=None, decode_kw=None,
               **router_kw):
        """Role-split fleet: ``p*`` replicas are prefill-only, ``d*``
        replicas import pages."""
        clock = clock if clock is not None else self.sv.SimClock()
        pkw = dict(factory_kw or {}, **(prefill_kw or {}))
        dkw = dict(factory_kw or {}, **(decode_kw or {}))
        reps = [self.fleet.ReplicaProxy(
            f"p{i}", self.factory(clock, prefill_only=True, **pkw),
            role="prefill") for i in range(n_prefill)]
        reps += [self.fleet.ReplicaProxy(
            f"d{i}", self.factory(clock, kv_import=True, **dkw),
            role="decode") for i in range(n_decode)]
        return self.fleet.DisaggRouter(reps, telemetry=telemetry,
                                       **router_kw), reps

    def control(self, prompts, max_new=5, **kw):
        """Uninterrupted single-engine control: the same prompts in the
        same submit order on one plain engine."""
        eng = self.factory(self.sv.SimClock(), **kw)()
        eng.warmup()
        for p in prompts:
            eng.submit(list(p), max_new_tokens=max_new)
        eng.run()
        return {r.rid: list(r.generated) for r in eng.sched.finished}


def make_sides():
    """``(jax_side, port_side)`` over one set of weights."""
    jparams = jsv.init_params(jsv.ServingModelConfig(**TOY), seed=0)
    tparams = tsv.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return (Side("jax", jsv, jfleet, jchaos, jtel, jparams),
            Side("torch", tsv, tfleet, tchaos, ttel, tparams, device="cpu"))


def prompts(n, seed=0, lo=4, hi=10):
    rng = random.Random(seed)
    return [[rng.randrange(1, TOY["vocab_size"])
             for _ in range(rng.randrange(lo, hi))] for _ in range(n)]


def streams(fleet):
    return {rid: list(h.generated) for rid, h in fleet.handles.items()}


def events(mem, types=None):
    """The recorded events without the bus's stamps, in order."""
    return [{k: v for k, v in e.items() if k not in STAMPS}
            for e in mem.events if types is None or e["type"] in types]


def of_type(mem, type_):
    return [e for e in mem.events if e["type"] == type_]
