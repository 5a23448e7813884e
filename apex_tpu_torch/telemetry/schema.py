"""Telemetry event schema: the single-sourced field-spec tables (a copy
of the JAX package's ``apex_tpu/telemetry/schema.py``, table for table, so
one stream validates under either package).

Telemetry is only useful if every producer agrees on the record shape —
a stream a tool can't parse is a ``print`` with extra steps.  This
module owns that contract:

- :data:`EVENT_FIELDS` — per event type, every known payload field with
  its allowed types and whether it is required.  This is THE table:
  :func:`validate_event` (the runtime validator) consumes it;
- :data:`EVENT_TYPES` — **derived** from :data:`EVENT_FIELDS`
  (``frozenset(EVENT_FIELDS)``), re-exported by
  :mod:`apex_tpu_torch.telemetry.bus` whose ``emit`` rejects anything else.
  An event type therefore cannot exist without a field spec;
- the universal stamp every event carries (:data:`STAMP_REQUIRED`);
- bool-not-int discipline: ``bool`` is an ``int`` subclass in Python,
  so an int-typed field must explicitly reject bools and vice versa —
  a ``1`` where the schema says ``True`` breaks every downstream
  ``is True`` check and the ``--diff`` ratio math.

The table covers every producer of the JAX package (training, data,
fleet) as well as the ported serving engine, so the two packages' tables
stay equal.  Stdlib-only.

Tests run every emitted event through :func:`validate_event`;
:func:`validate_jsonl` checks a whole file (e.g. a postmortem).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, NamedTuple

NUMBER = (int, float)
OPT_NUMBER = (int, float, type(None))


class FieldSpec(NamedTuple):
    """One payload field's contract: allowed types + requiredness.

    ``required=False`` fields are OPTIONAL — absent entirely when the
    producer has nothing to say (a one-token request has no TPOT, a
    CPU backend has no HBM stats).  Optionality must be explicit in
    the schema, never smuggled via sentinel values.

    ``choices`` closes a string field over an enum: a
    reason/hint field whose consumers branch on its value must not
    grow ad-hoc spellings — ``validate_event`` rejects values outside
    the set, the same single-source discipline as bool-not-int."""

    types: tuple
    required: bool = True
    choices: tuple = ()


def opt(*types, choices=()) -> FieldSpec:
    """An optional field spec (shorthand for the table below)."""
    return FieldSpec(tuple(types), required=False, choices=tuple(choices))


def req(*types, choices=()) -> FieldSpec:
    """A required field spec (shorthand for the table below)."""
    return FieldSpec(tuple(types), required=True, choices=tuple(choices))


#: The closed event vocabulary WITH its per-field contracts.  Every
#: field a producer names literally at an emit site must appear here —
#: the TL001 lint rule enforces that; ``validate_event`` type-checks
#: required fields always and optional fields whenever present.
EVENT_FIELDS: Dict[str, Dict[str, FieldSpec]] = {
    # loop (re)entered: config snapshot, start step.  workload/config/
    # fast come from the bench and example entrypoints (bench.py,
    # pretrain_gpt.py) — the table covers EVERY producer in the repo,
    # not just the apex_tpu package, or TL001 flags them
    "run_start": {
        "save_every": opt(int),
        "async_saves": opt(bool),
        "sharded": opt(bool),
        "watchdog": opt(bool),
        "guarded": opt(bool),
        "workload": opt(str),
        "config": opt(dict),
        "fast": opt(bool),
    },
    # loop exited: goodput buckets, stop reason
    "run_end": {
        "goodput": req(*NUMBER),
        "steps": req(int),
        "wall_s": req(*NUMBER),
        "reason": req(str),
        "skips": opt(int),
        "steps_per_sec": opt(*NUMBER),
        "buckets_s": opt(dict),
        "scalars": opt(dict),
    },
    # one train step: wall split + windowed scalars
    "step": {
        "step_ms": req(*NUMBER),
        "compile_ms": opt(*NUMBER),
        "data_wait_ms": opt(*NUMBER),
        "skipped": opt(bool),
        "scalars": opt(dict),
        "timing": opt(str),
    },
    # checkpoint write started (blocking or async)
    "ckpt_save": {
        "blocking": req(bool),
        "wall_ms": opt(*NUMBER),
    },
    # restore completed (incl. elastic re-partition)
    "ckpt_restore": {
        "wall_ms": opt(*NUMBER),
        "n_shards": opt(int),
        "reason": opt(str),
    },
    # divergence guard skipped a non-finite step
    "skip": {
        "consecutive": req(int),
        "total_skipped": req(int),
        "total_steps": opt(int),
        "grad_norm": opt(*OPT_NUMBER),
        "loss_scale": opt(*OPT_NUMBER),
    },
    # collective watchdog fired: straggler report
    "watchdog": {
        "report": req(dict),
    },
    # mesh device(s) disappeared; elastic rebuild
    "device_loss": {
        "device_ids": req(list),
        "survivors": opt(int),
        "restarts": opt(int),
        "recoverable": opt(bool),
        "mesh_axes": opt(dict),
    },
    # XLA backend compile observed mid-run
    "recompile": {
        "duration_ms": opt(*NUMBER),
        "source": opt(str),
    },
    # chaos tier injected a fault (test streams)
    "fault_injected": {
        "kind": req(str),
        "event": opt(str),
        "path": opt(str),
        "device_ids": opt(list),
        "at_poll": opt(int),
        "at_step": opt(int),
        "at_decode_step": opt(int),
        "axis": opt(str, type(None)),
        "delay_s": opt(*NUMBER),
        "page": opt(int),
        "use_signal": opt(bool),
        # fleet chaos: the replica the injector targeted
        "replica": opt(str),
    },
    # pipeline-parallel Timers.log snapshot
    "timers": {
        "timers_ms": req(dict),
        "normalizer": opt(*NUMBER),
    },
    # flight-recorder flush header
    "postmortem": {
        "reason": req(str),
        "ring_events": req(int),
        "path": opt(str),
        "watchdog": opt(dict),
    },
    # input pipeline made the step wait (dry prefetch queue, slow
    # shard read, shard re-assignment)
    "data_stall": {
        "wait_ms": req(*NUMBER),
        "cause": req(str),
        "depth": opt(int),
    },
    # a damaged record was skipped and counted
    "data_quarantine": {
        "record_id": req(int),
        "reason": req(str),
        "total": req(int),
        "rate": opt(*NUMBER),
    },
    # serving: latency fields (ttft_ms/tpot_ms on retire,
    # step_ms/evicted on decode_step) are optional — a one-token
    # request has no TPOT
    "request_admit": {
        "rid": req(int),
        "context_tokens": req(int),
        "pages": req(int),
        "preemptions": req(int),
        # a REAL bool, present only when the request admitted into
        # chunked prefill — absent means whole-row
        "chunked": opt(bool),
        # a REAL bool: present on EVERY admit while prefix
        # sharing is on — True when the page-aligned prompt prefix
        # matched the PrefixIndex (shared pages pinned, prefill
        # resumed past the match), False on a miss.  Emitting misses
        # too is what gives summarize its hit-rate denominator;
        # absent entirely means sharing was off
        "prefix_hit": opt(bool),
    },
    "request_retire": {
        "rid": req(int),
        "reason": req(str),
        "new_tokens": req(int),
        "preemptions": req(int),
        "ttft_ms": opt(*NUMBER),
        "tpot_ms": opt(*NUMBER),
        # a REAL bool, present only when the request carried a deadline
        "deadline_hit": opt(bool),
        # shipping-aware SLO accounting: the kv_ship wall this
        # request paid between prefill-side export and decode-side
        # adoption (== its kv_export.start -> kv_import.end span
        # segment).  Present only on shipped requests — ttft_ms on
        # those is STREAM TTFT (first token available to the decode
        # replica), so the ship wall lands in TTFT, not TPOT
        "ship_ms": opt(*NUMBER),
    },
    "decode_step": {
        "batch": req(int),
        "new_tokens": req(int),
        "pool_used": req(int),
        "pool_pages": req(int),
        "evicted": opt(list),
        "step_ms": opt(*NUMBER),
        # speculative verify boundaries: present only when
        # the step ran the draft–verify executable.  spec_verify is a
        # REAL bool; spec_drafted/spec_accepted count draft tokens
        # launched/model-endorsed this step (new_tokens carries the
        # committed total, so accepted-tokens-per-step falls out of
        # new_tokens / batch on ANY stream, speculative or not)
        "spec_verify": opt(bool),
        "spec_drafted": opt(int),
        "spec_accepted": opt(int),
        # prefix sharing: pages currently referenced by more
        # than one holder (an int COUNT, never a bool — pairs with
        # pool_used for the memory-saved story); present only while
        # prefix sharing is on
        "pool_shared_pages": opt(int),
    },
    # serving resilience: overload rejects, deadline deaths
    # (where = "queued" shed / "running" timeout), crash recovery.
    # pool_rebuilt is a REAL bool (bool-not-int discipline).
    # reason is CLOSED: "queue_full" is backpressure (retry
    # elsewhere / later), "unservable" is permanent refusal by this
    # engine's geometry (retrying the same replica is futile) — the
    # fleet router branches on exactly this distinction
    "request_reject": {
        "rid": req(int),
        "reason": req(str, choices=("queue_full", "unservable")),
        "queue_depth": req(int),
    },
    "request_timeout": {
        "rid": req(int),
        "where": req(str),
        "overshoot_ms": req(*NUMBER),
    },
    "serving_recovery": {
        "cause": req(str),
        "pool_rebuilt": req(bool),
        "running_restored": req(int),
        "waiting_restored": req(int),
    },
    # a wedged engine is observable: run()/serve()
    # exhausted their step budget with live requests still queued
    "serving_stall": {
        "waiting": req(int),
        "running": req(int),
        "budget": req(int),
    },
    # serving fleet: a replica leaving rotation (its engine
    # burned through max_recoveries, its health check timed out, or a
    # rolling restart is draining it), each live request's migration
    # hop, and the autoscaling SIGNAL (never an action) derived from
    # SLO attainment / shed rate / pool occupancy
    "replica_fence": {
        "replica": req(str),
        "cause": req(str),
        "live_requests": req(int),
        "recoveries": opt(int),
        "fault_retries": opt(int),
    },
    "request_migrate": {
        "rid": req(int),
        "from_replica": req(str),
        "to_replica": req(str),
        "tokens_done": req(int),
        # a REAL bool: the request was mid-flight (holding pages) on
        # the source when fenced, vs still queued
        "was_running": req(bool),
    },
    "fleet_scale_hint": {
        "hint": req(str, choices=("scale_up", "hold", "scale_down")),
        "shed_rate": req(*NUMBER),
        "occupancy": req(*NUMBER),
        "replicas": req(int),
        "healthy": req(int),
        # absent when no request carried a deadline in the window —
        # optional means absent, never a sentinel
        "deadline_hit_rate": opt(*NUMBER),
    },
    # disaggregated prefill/decode: one kv_ship per completed
    # KV page shipment (prefill replica -> decode replica; attempts
    # counts transfer-level retries that preceded success),
    # kv_ship_retry per bounded retry (reason is CLOSED: transport
    # loss/lateness, in-flight corruption caught at the envelope, a
    # page refused by the receiver's CRC check, pages missing at
    # commit, or a capacity refusal by the decode engine), and
    # kv_ship_fallback when the retry budget is spent and the request
    # degrades to LOCAL prefill on the decode replica — slower, never
    # dropped
    "kv_ship": {
        "rid": req(int),
        "from_replica": req(str),
        "to_replica": req(str),
        "pages": req(int),
        "payload_bytes": req(int),
        "attempts": req(int),
    },
    "kv_ship_retry": {
        "rid": req(int),
        "from_replica": req(str),
        "to_replica": req(str),
        "attempt": req(int),
        "reason": req(str, choices=("timeout", "corrupt",
                                    "crc_mismatch", "missing_pages",
                                    "no_capacity")),
        # absent on immediate per-page re-sends (no backoff round)
        "backoff_rounds": opt(int),
    },
    "kv_ship_fallback": {
        "rid": req(int),
        "from_replica": req(str),
        "to_replica": req(str),
        "attempts": req(int),
        "reason": req(str, choices=("timeout", "corrupt",
                                    "crc_mismatch", "missing_pages",
                                    "no_capacity")),
    },
    # distributed request tracing: one `span` event per closed
    # causal interval in a request's fleet-wide life.  trace_id IS the
    # fleet rid; span_id/parent_id are DERIVED from application-level
    # identity (rid, admission life, transfer attempt, hop endpoints)
    # — never from transport msg ids, whose sender retries mint fresh
    # ones — so re-emission under at-most-once redelivery is
    # idempotent (reconstruction merges identical ids).  t_start/t_end
    # are on the fleet's SHARED engine clock (monotonic / SimClock),
    # NOT the per-bus stamp `t`, so spans recorded on different
    # replicas' streams join on one time base.  kind is CLOSED;
    # kv_ship spans carry one span PER ATTEMPT with the outcome typed
    # (ok / retry / fallback / retarget) and the retry reason
    "span": {
        "rid": req(int),
        "span_id": req(str),
        # absent = root-level span of its trace (never a dangling ref)
        "parent_id": opt(str),
        "kind": req(str, choices=("queue_wait", "admit",
                                  "prefill_chunk", "kv_export",
                                  "kv_ship", "kv_import",
                                  "decode_wait", "decode_steps",
                                  "migrate_hop", "stream_emit")),
        "t_start": req(*NUMBER),
        "t_end": req(*NUMBER),
        # emitting side, when fleet-scoped (absent on bare engines)
        "replica": opt(str),
        # kv_ship / kv_import: 1-based transfer attempt
        "attempt": opt(int),
        # kv_ship per-attempt outcome — typed annotations, CLOSED
        "outcome": opt(str, choices=("ok", "retry", "fallback",
                                     "retarget")),
        # retry/fallback cause (the kv_ship_retry reason vocabulary)
        "reason": opt(str, choices=("timeout", "corrupt",
                                    "crc_mismatch", "missing_pages",
                                    "no_capacity")),
    },
    # a migration plan refused whole: the FULL
    # unplaceable rid list plus required-vs-available page counts —
    # the numbers an operator sizes capacity from
    "migrate_refused": {
        "replica": req(str),
        "unplaceable": req(list),
        "requests": req(int),
        "pages_required": req(int),
        "pages_available": req(int),
    },
    # in-run attribution: the ProfileSampler's window result.
    # exposed_collective_ms is the overlap-analysis headline;
    # overhead_ms is the sampler's own host cost for this window (also
    # booked to the `profile` goodput bucket)
    "profile": {
        "window_steps": req(int),
        "phase_ms": req(dict),
        "exposed_collective_ms": req(*NUMBER),
        "collective_ms": req(*NUMBER),
        "total_device_ms": req(*NUMBER),
        "overhead_ms": req(*NUMBER),
        "span_ms": opt(*NUMBER),
        "n_ops": opt(int),
        "top_ops": opt(list),
    },
    # HBM sample: stats_available is a REAL bool; byte fields are
    # present only when the backend exposes memory_stats
    "memory": {
        "stats_available": req(bool),
        "n_devices": req(int),
        "live_bytes": opt(int),
        "peak_bytes": opt(int),
        "limit_bytes": opt(int),
    },
}

#: The typed event vocabulary — DERIVED from the field table, so an
#: event type without a field spec cannot exist.  ``bus.EVENT_TYPES``
#: re-exports this object.
EVENT_TYPES = frozenset(EVENT_FIELDS)

#: Legacy view: per-type REQUIRED payload fields -> allowed types
#: (kept for callers written against the older shape).
PAYLOAD_REQUIRED: Dict[str, Dict[str, tuple]] = {
    etype: {f: spec.types for f, spec in fields.items() if spec.required}
    for etype, fields in EVENT_FIELDS.items()
}

#: Universal stamp: field -> allowed types (None allowed where noted).
STAMP_REQUIRED: Dict[str, tuple] = {
    "type": (str,),
    "run_id": (str,),
    "step": (int, type(None)),
    "t": NUMBER,
    "ts": NUMBER,
    "mesh": (dict,),
}


class SchemaError(ValueError):
    """An event violates the telemetry schema."""


def _type_names(types: tuple) -> str:
    return "/".join(t.__name__ for t in types)


def _check_field(etype: str, field: str, v: Any, types: tuple,
                 choices: tuple = ()) -> None:
    # bool is an int subclass; an int-typed field must not accept it
    if isinstance(v, bool) and bool not in types:
        raise SchemaError(
            f"{etype}.{field} must be {_type_names(types)}, got bool")
    if not isinstance(v, types):
        raise SchemaError(
            f"{etype}.{field} must be {_type_names(types)}, got "
            f"{type(v).__name__} ({v!r})")
    if choices and v not in choices:
        raise SchemaError(
            f"{etype}.{field} must be one of {sorted(choices)}, got {v!r}")


def validate_event(event: Any) -> Dict[str, Any]:
    """Validate one event dict; returns it (for chaining) or raises
    :class:`SchemaError` naming the offending field.

    Required fields must be present with a spec-conforming type;
    optional fields are type-checked whenever present.  Fields not in
    the spec are tolerated at runtime (producers may attach ad-hoc
    context via ``**payload``) — but fields named *literally* at an
    emit site are held to the table by the TL001 lint rule."""
    if not isinstance(event, dict):
        raise SchemaError(f"event must be a dict, got {type(event).__name__}")
    for field, types in STAMP_REQUIRED.items():
        if field not in event:
            raise SchemaError(f"missing stamp field {field!r}: {event}")
        if not isinstance(event[field], types):
            raise SchemaError(
                f"stamp field {field!r} must be {_type_names(types)}, got "
                f"{type(event[field]).__name__} ({event[field]!r})")
    etype = event["type"]
    if etype not in EVENT_FIELDS:
        raise SchemaError(
            f"unknown event type {etype!r}; known: {sorted(EVENT_TYPES)}")
    for field, spec in EVENT_FIELDS[etype].items():
        if field not in event:
            if spec.required:
                raise SchemaError(
                    f"{etype} event missing required field {field!r}: "
                    f"{event}")
            continue
        _check_field(etype, field, event[field], spec.types, spec.choices)
    try:
        json.dumps(event)
    except (TypeError, ValueError) as e:
        raise SchemaError(f"event not JSON-serializable: {e}") from e
    return event


def validate_events(events: Iterable[Dict[str, Any]]) -> int:
    """Validate an iterable of events; returns the count."""
    n = 0
    for ev in events:
        validate_event(ev)
        n += 1
    return n


def load_jsonl(path: str,
               tolerate_torn_tail: bool = False) -> List[Dict[str, Any]]:
    """Parse a telemetry/postmortem JSONL file (blank lines skipped).

    ``tolerate_torn_tail`` — a SIGKILL/OOM-kill or ENOSPC can leave one
    partial final line despite the sink's per-event flush; the
    *summarize* path drops that torn last line instead of refusing the
    stream (the crashed stream is exactly the one an operator most
    needs summarized).  ``validate`` stays strict."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    last_payload = max((i for i, ln in enumerate(lines, 1) if ln.strip()),
                       default=0)
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if tolerate_torn_tail and i == last_payload:
                break
            raise SchemaError(f"{path}:{i}: not valid JSON: {e}") from e
    return out


def validate_jsonl(path: str) -> int:
    """Validate every event in a JSONL file; returns the count."""
    return validate_events(load_jsonl(path))
