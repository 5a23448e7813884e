"""Fleet-wide distributed request tracing (a copy of the JAX package's
``apex_tpu/telemetry/tracing.py``).

The serving fleet's telemetry is N independent per-replica event
streams; this module gives them a causal join.  Every boundary in a
request's life — queueing, admission, chunked prefill, KV export /
per-attempt shipment / import over the transport seam, decode, the
first-token stream emission, and migration hops — is emitted as a
``span`` event through the ordinary closed schema/bus, and
:func:`build_traces` reconstructs per-request span trees from ANY set
of recorded streams, in any file order.

Identity rules (the part that survives a lossy wire):

* **trace_id is the fleet rid** — rids are fleet-global,
  so spans recorded on different replicas' buses join by payload
  alone.
* **span ids derive from application-level identity** — admission
  life (``preemptions:admit_t``), transfer attempt number, hop
  endpoints — never from transport ``msg_id``s (sender retries mint
  fresh ones).  Re-emission of the same id under at-most-once
  redelivery is harmless: :func:`build_traces` MERGES identical ids
  (earliest start, latest end, first non-null attribute).
* **parents are only ever spans guaranteed emitted**: ``admit`` is
  parented to its own life's ``queue_wait`` (emitted together),
  ``kv_import`` to the successful ``kv_ship`` attempt whose span id
  rode the wire envelope's trace context verbatim, ``migrate_hop``
  and ``queue_wait`` are root-level.  Zero dangling parents by
  construction, under any ChaosTransport fault pattern.

Span times are on the fleet's SHARED engine clock (``time.monotonic``
or a ``SimClock``), not the per-bus stamp ``t`` — that is what lets
prefill-side and decode-side spans share one time base.

TTFT decomposition (:func:`ttft_decomposition`) telescopes the
critical path into ``ttft_queue_ms`` / ``ttft_prefill_ms`` /
``ttft_ship_ms`` / ``ttft_decode_wait_ms``; the components sum to the
engine's measured (shipping-aware) ``ttft_ms`` within
:data:`TTFT_SUM_TOLERANCE_MS` — the residual is only float rounding,
and the trace CLI enforces the bound (exit 1 on violation).

The fleet **flight recorder** rides the bus's existing
:class:`~apex_tpu_torch.telemetry.recorder.FlightRecorder` ring:
:func:`maybe_dump_flight_record` dumps a replica's recent
spans+events as a schema-valid ``postmortem_*.jsonl`` trace bundle on
``replica_fence``, ``migrate_refused``, and recovery exhaustion.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence

from apex_tpu_torch.telemetry.schema import EVENT_FIELDS, load_jsonl

#: The closed span-kind vocabulary — derived from the single-sourced
#: schema table (an unknown kind cannot be emitted OR reconstructed).
SPAN_KINDS = tuple(EVENT_FIELDS["span"]["kind"].choices)

#: Documented bound on |sum(components) - measured ttft_ms|: each of
#: the four components and the measured total is rounded to 3 decimals
#: independently, so the worst-case drift is 5 half-ulps = 0.0025 ms.
TTFT_SUM_TOLERANCE_MS = 0.01

_EPS = 1e-9


def admission_life(preemptions: int, admit_t: float) -> str:
    """The admission-life discriminator spans of one (re)admission
    share: ``preemptions`` alone is not unique (a fallback re-admission
    keeps the count), but no two lives of one rid admit at the same
    shared-clock instant, so ``preemptions:admit_t`` is."""
    return f"{int(preemptions)}:{float(admit_t):.6f}"


@dataclasses.dataclass
class Span:
    """One reconstructed span (a closed ``[t_start, t_end]`` causal
    interval of a request's fleet-wide life)."""

    rid: int
    span_id: str
    kind: str
    t_start: float
    t_end: float
    parent_id: Optional[str] = None
    replica: Optional[str] = None
    attempt: Optional[int] = None
    outcome: Optional[str] = None
    reason: Optional[str] = None

    @property
    def wall_ms(self) -> float:
        return (self.t_end - self.t_start) * 1e3

    @classmethod
    def from_event(cls, ev: Dict[str, Any]) -> "Span":
        return cls(rid=int(ev["rid"]), span_id=str(ev["span_id"]),
                   kind=str(ev["kind"]), t_start=float(ev["t_start"]),
                   t_end=float(ev["t_end"]),
                   parent_id=ev.get("parent_id"),
                   replica=ev.get("replica"),
                   attempt=ev.get("attempt"),
                   outcome=ev.get("outcome"), reason=ev.get("reason"))

    def merge(self, other: "Span") -> None:
        """Idempotent-redelivery merge: same id re-emitted (duplicated
        wire message, overlapping stream files, a flight-recorder dump
        replaying its ring) widens the interval and fills gaps —
        never forks the tree."""
        self.t_start = min(self.t_start, other.t_start)
        self.t_end = max(self.t_end, other.t_end)
        for f in ("parent_id", "replica", "attempt", "outcome",
                  "reason"):
            if getattr(self, f) is None:
                setattr(self, f, getattr(other, f))


class Trace:
    """The span tree of one request (trace_id == fleet rid)."""

    def __init__(self, rid: int):
        self.rid = rid
        self.spans: Dict[str, Span] = {}
        self.duplicates = 0   # merged re-emissions (diagnostic only)

    def add(self, span: Span) -> None:
        have = self.spans.get(span.span_id)
        if have is None:
            self.spans[span.span_id] = span
        else:
            have.merge(span)
            self.duplicates += 1

    def by_kind(self, kind: str) -> List[Span]:
        out = [s for s in self.spans.values() if s.kind == kind]
        out.sort(key=lambda s: (s.t_start, s.t_end, s.span_id))
        return out

    def roots(self) -> List[Span]:
        out = [s for s in self.spans.values() if s.parent_id is None]
        out.sort(key=lambda s: (s.t_start, s.t_end, s.span_id))
        return out

    def children(self, span_id: str) -> List[Span]:
        out = [s for s in self.spans.values()
               if s.parent_id == span_id]
        out.sort(key=lambda s: (s.t_start, s.t_end, s.span_id))
        return out

    def orphans(self) -> List[Span]:
        """Spans whose parent_id references no reconstructed span —
        the completeness invariant the chaos_disagg leg pins at zero."""
        out = [s for s in self.spans.values()
               if s.parent_id is not None
               and s.parent_id not in self.spans]
        out.sort(key=lambda s: s.span_id)
        return out

    def ancestors(self, span: Span) -> List[Span]:
        """Parent chain of ``span``, nearest first; stops at a root or
        a dangling reference (cycle-guarded)."""
        out: List[Span] = []
        seen = {span.span_id}
        cur = span
        while cur.parent_id is not None and cur.parent_id in self.spans:
            if cur.parent_id in seen:
                break
            cur = self.spans[cur.parent_id]
            seen.add(cur.span_id)
            out.append(cur)
        return out


def build_traces(events: Iterable[Dict[str, Any]]
                 ) -> Dict[int, Trace]:
    """Reconstruct per-request span trees from any iterable of
    recorded events (concatenate as many per-replica streams as you
    have, in ANY order — reconstruction keys on payload identity, not
    stream position)."""
    traces: Dict[int, Trace] = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        span = Span.from_event(ev)
        traces.setdefault(span.rid, Trace(span.rid)).add(span)
    return traces


def load_trace_streams(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Concatenate recorded jsonl streams (torn tails tolerated — a
    crashed replica's stream still joins the trace)."""
    events: List[Dict[str, Any]] = []
    for p in paths:
        events.extend(load_jsonl(p, tolerate_torn_tail=True))
    return events


def validate_trace(trace: Trace) -> List[str]:
    """Structural completeness problems (empty list = complete):
    orphan spans (dangling parent references) and kind values outside
    the closed vocabulary.  An *unfinished* trace (no ``stream_emit``
    yet) is not a problem — incompleteness in time is normal,
    incompleteness in STRUCTURE is never."""
    problems: List[str] = []
    for s in trace.orphans():
        problems.append(
            f"rid {trace.rid}: orphan span {s.span_id} ({s.kind}) — "
            f"dangling parent {s.parent_id}")
    for s in trace.spans.values():
        if s.kind not in SPAN_KINDS:
            problems.append(
                f"rid {trace.rid}: span {s.span_id} has unknown kind "
                f"{s.kind!r}")
        if s.t_end < s.t_start - _EPS:
            problems.append(
                f"rid {trace.rid}: span {s.span_id} ends before it "
                f"starts ({s.t_start} -> {s.t_end})")
    return problems


def _stream_span(trace: Trace) -> Optional[Span]:
    streams = trace.by_kind("stream_emit")
    return streams[-1] if streams else None


def _ship_segment(trace: Trace) -> float:
    """Wall seconds of the successful ship segment on the critical
    path: ``kv_export.start -> kv_import.end`` (0.0 when the request
    never shipped — the colocated control's built-in sanity zero)."""
    imports = trace.by_kind("kv_import")
    if not imports:
        return 0.0
    imp = imports[-1]
    exp: Optional[Span] = None
    # follow the causal links when they resolved (kv_import -> the
    # winning kv_ship attempt -> kv_export) ...
    for anc in trace.ancestors(imp):
        if anc.kind == "kv_export":
            exp = anc
            break
    if exp is None:
        # ... else fall back to the latest export that precedes it
        cand = [s for s in trace.by_kind("kv_export")
                if s.t_start <= imp.t_end + _EPS]
        exp = cand[-1] if cand else None
    if exp is None:
        return 0.0
    return max(0.0, imp.t_end - exp.t_start)


def critical_path(trace: Trace) -> List[Span]:
    """The causal chain that produced the request's first streamed
    token: the ``stream_emit`` span's ancestor chain, spliced with the
    successful ship chain (export -> winning attempt -> import) when
    the request was disaggregated.  Ordered by start time."""
    stream = _stream_span(trace)
    if stream is None:
        return []
    chain = {stream.span_id: stream}
    for anc in trace.ancestors(stream):
        chain[anc.span_id] = anc
    imports = trace.by_kind("kv_import")
    if imports:
        imp = imports[-1]
        chain[imp.span_id] = imp
        for anc in trace.ancestors(imp):
            chain[anc.span_id] = anc
    return sorted(chain.values(),
                  key=lambda s: (s.t_start, s.t_end, s.span_id))


def ttft_decomposition(trace: Trace) -> Optional[Dict[str, float]]:
    """Decompose the request's measured TTFT along its critical path.

    Returns ``None`` until the trace holds a first-token emission
    (``stream_emit``).  The four components telescope over the
    boundaries arrival -> admit -> prefill-done -> (+ship) -> stream:

    * ``ttft_queue_ms``   — arrival to admission,
    * ``ttft_prefill_ms`` — admission to the first sampled token,
    * ``ttft_ship_ms``    — the kv_export.start -> kv_import.end wall
      (0.0 colocated / fallback),
    * ``ttft_decode_wait_ms`` — the residual: export-pump wait plus
      adoption-to-stream — so the sum is EXACT by construction and
      only per-key rounding (≤ :data:`TTFT_SUM_TOLERANCE_MS`)
      separates it from the engine's emitted ``ttft_ms``.
    """
    stream = _stream_span(trace)
    if stream is None:
        return None
    decode_wait = trace.spans.get(stream.parent_id or "")
    if decode_wait is None or decode_wait.kind != "decode_wait":
        waits = trace.by_kind("decode_wait")
        decode_wait = waits[-1] if waits else None
    if decode_wait is None:
        return None
    admit = trace.spans.get(decode_wait.parent_id or "")
    if admit is None or admit.kind != "admit" \
            or admit.t_start > decode_wait.t_start + _EPS:
        # a preempted request's final life admits AFTER its first
        # token; the prefill that produced the token belongs to the
        # latest life that STARTED before it
        cand = [s for s in trace.by_kind("admit")
                if s.t_start <= decode_wait.t_start + _EPS]
        admit = cand[-1] if cand else admit
    if admit is None:
        return None
    queue = trace.spans.get(admit.parent_id or "")
    if queue is None or queue.kind != "queue_wait":
        return None
    total_ms = (stream.t_end - queue.t_start) * 1e3
    queue_ms = (admit.t_start - queue.t_start) * 1e3
    prefill_ms = (decode_wait.t_start - admit.t_start) * 1e3
    ship_ms = _ship_segment(trace) * 1e3
    wait_ms = total_ms - queue_ms - prefill_ms - ship_ms
    return {
        "rid": trace.rid,
        "ttft_ms": round(total_ms, 3),
        "ttft_queue_ms": round(queue_ms, 3),
        "ttft_prefill_ms": round(prefill_ms, 3),
        "ttft_ship_ms": round(ship_ms, 3),
        "ttft_decode_wait_ms": round(wait_ms, 3),
    }


# -- the fleet flight recorder ------------------------------------------


def maybe_dump_flight_record(bus, reason: str, *,
                             step: Optional[int] = None
                             ) -> Optional[str]:
    """Dump a replica bus's flight-recorder ring (recent spans AND
    events) as a schema-valid ``postmortem_*.jsonl`` trace bundle.

    The fleet calls this on ``replica_fence``, ``migrate_refused``,
    and recovery exhaustion.  Only buses with a file-backed
    (:class:`~apex_tpu_torch.telemetry.bus.JsonlSink`) stream dump — a
    memory-only bus has nowhere sensible to put a bundle, and a chaos
    *test* must not litter the working directory.  Returns the bundle
    path, or None when no dump was taken."""
    if bus is None:
        return None
    from apex_tpu_torch.telemetry.bus import JsonlSink

    if not any(isinstance(s, JsonlSink)
               for s in getattr(bus, "sinks", ())):
        return None
    return bus.flush_postmortem(reason, step=step)


# -- the trace CLI ------------------------------------------------------


def _format_span(s: Span) -> str:
    bits = [f"{s.kind} [{s.t_start:.6f} -> {s.t_end:.6f}] "
            f"{s.wall_ms:.3f}ms"]
    if s.replica:
        bits.append(f"@{s.replica}")
    if s.attempt is not None:
        bits.append(f"attempt={s.attempt}")
    if s.outcome:
        bits.append(f"outcome={s.outcome}")
    if s.reason:
        bits.append(f"reason={s.reason}")
    return " ".join(bits)


def format_trace(trace: Trace) -> str:
    """Render one request's span tree plus its critical path and TTFT
    decomposition."""
    lines = [f"rid {trace.rid}: {len(trace.spans)} spans"
             + (f" ({trace.duplicates} merged re-emissions)"
                if trace.duplicates else "")]

    def walk(span: Span, depth: int) -> None:
        lines.append("  " * (depth + 1) + _format_span(span))
        for child in trace.children(span.span_id):
            walk(child, depth + 1)

    for root in trace.roots():
        walk(root, 0)
    for s in trace.orphans():
        lines.append(f"  ORPHAN {_format_span(s)} "
                     f"(dangling parent {s.parent_id})")
    cp = critical_path(trace)
    if cp:
        lines.append("  critical path: "
                     + " -> ".join(s.kind for s in cp))
    d = ttft_decomposition(trace)
    if d is not None:
        lines.append(
            "  ttft {ttft_ms}ms = queue {ttft_queue_ms} + prefill "
            "{ttft_prefill_ms} + ship {ttft_ship_ms} + decode-wait "
            "{ttft_decode_wait_ms}".format(**d))
    return "\n".join(lines)


def run_trace_cli(paths: Sequence[str], *, rid: Optional[int] = None,
                  as_json: bool = False, echo=print) -> int:
    """``python -m apex_tpu_torch.telemetry trace`` body.  Exit codes follow
    the regress convention: 0 = complete trees and every decomposition
    sums to its measured TTFT; 1 = structural problems (orphans,
    dangling parents, kind drift) or a sum outside
    :data:`TTFT_SUM_TOLERANCE_MS`; 2 = an unreadable stream."""
    try:
        events = load_trace_streams(paths)
    except Exception as e:
        echo(f"error: {e}")
        return 2
    traces = build_traces(events)
    if rid is not None:
        traces = {r: t for r, t in traces.items() if r == rid}
        if not traces:
            echo(f"error: no spans for rid {rid} in "
                 f"{len(events)} events")
            return 2
    # the engine's measured (shipping-aware) TTFT, for the sum pin
    measured: Dict[int, float] = {}
    for ev in events:
        if ev.get("type") == "request_retire" and "ttft_ms" in ev:
            measured[int(ev["rid"])] = float(ev["ttft_ms"])
    problems: List[str] = []
    rows: List[Dict[str, Any]] = []
    for r in sorted(traces):
        trace = traces[r]
        problems.extend(validate_trace(trace))
        d = ttft_decomposition(trace)
        if d is not None and r in measured:
            parts = (d["ttft_queue_ms"] + d["ttft_prefill_ms"]
                     + d["ttft_ship_ms"] + d["ttft_decode_wait_ms"])
            if abs(parts - measured[r]) > TTFT_SUM_TOLERANCE_MS:
                problems.append(
                    f"rid {r}: decomposition sums to {parts:.3f}ms "
                    f"but measured ttft_ms is {measured[r]:.3f} "
                    f"(tolerance {TTFT_SUM_TOLERANCE_MS}ms)")
        rows.append({
            "rid": r, "spans": len(trace.spans),
            "duplicates_merged": trace.duplicates,
            "orphans": len(trace.orphans()),
            "critical_path": [s.kind for s in critical_path(trace)],
            "ttft_decomposition": d,
            "measured_ttft_ms": measured.get(r),
        })
    if as_json:
        echo(json.dumps({"traces": rows, "problems": problems},
                        indent=1, sort_keys=True))
    else:
        for r in sorted(traces):
            echo(format_trace(traces[r]))
        echo(f"{len(traces)} traces from {len(paths)} streams "
             f"({len(events)} events)")
        for p in problems:
            echo(f"PROBLEM: {p}")
    return 1 if problems else 0
