"""Telemetry: the event bus, its schema, the flight recorder, request
tracing and offline summaries (port of the JAX package's
``apex_tpu/telemetry``; host-only Python).

- **bus** — :class:`TelemetryBus` with a closed set of typed events
  (:data:`EVENT_TYPES`) and pluggable sinks (:class:`JsonlSink`,
  :class:`MemorySink`, :class:`StdoutSink`); every event stamped with
  run id, step, monotonic time, and mesh topology;
- **flight recorder** — :class:`FlightRecorder` ring of the last N
  events, flushed to ``postmortem_*.jsonl`` (``bus.flush_postmortem``);
- **accounting** — :class:`StepAccountant` (``bus.accountant()``): the
  per-step wall split, windowed scalar reads and the goodput ledger of
  ``run_end``;
- **schema** — :func:`validate_event` / :func:`validate_jsonl`, the
  contract every producer is tested against (the JAX package's table);
- **tracing** — request-scoped causal spans (``span`` events; trace id
  = rid), reconstruction of per-request span trees from any set of
  streams, critical-path extraction, TTFT decomposition, and
  :func:`maybe_dump_flight_record`;
- **CLI** — ``python -m apex_tpu_torch.telemetry summarize run.jsonl``
  (``--diff`` A/B), ``validate``, and ``trace STREAM.jsonl...``.

Not ported yet (ROADMAP.md): the profile sampler and the
benchmark-record ``regress`` gate; the JAX package's XLA recompile
listener has no counterpart in eager PyTorch.
"""

from apex_tpu_torch.telemetry.accounting import (  # noqa: F401
    PAUSE_KINDS,
    StepAccountant,
)
from apex_tpu_torch.telemetry.bus import (  # noqa: F401
    EVENT_TYPES,
    JsonlSink,
    MemorySink,
    StdoutSink,
    TelemetryBus,
    TelemetryError,
    default_mesh_topology,
)
from apex_tpu_torch.telemetry.recorder import FlightRecorder  # noqa: F401
from apex_tpu_torch.telemetry.schema import (  # noqa: F401
    SchemaError,
    load_jsonl,
    validate_event,
    validate_events,
    validate_jsonl,
)
from apex_tpu_torch.telemetry.summarize import (  # noqa: F401
    format_diff,
    format_summary,
    summarize_events,
    summarize_file,
)
from apex_tpu_torch.telemetry.tracing import (  # noqa: F401
    SPAN_KINDS,
    TTFT_SUM_TOLERANCE_MS,
    Span,
    Trace,
    admission_life,
    build_traces,
    critical_path,
    format_trace,
    load_trace_streams,
    maybe_dump_flight_record,
    run_trace_cli,
    ttft_decomposition,
    validate_trace,
)

__all__ = [
    "EVENT_TYPES",
    "FlightRecorder",
    "SPAN_KINDS",
    "Span",
    "TTFT_SUM_TOLERANCE_MS",
    "Trace",
    "admission_life",
    "build_traces",
    "critical_path",
    "format_trace",
    "load_trace_streams",
    "maybe_dump_flight_record",
    "run_trace_cli",
    "ttft_decomposition",
    "validate_trace",
    "JsonlSink",
    "MemorySink",
    "PAUSE_KINDS",
    "SchemaError",
    "StdoutSink",
    "StepAccountant",
    "TelemetryBus",
    "TelemetryError",
    "default_mesh_topology",
    "format_diff",
    "format_summary",
    "load_jsonl",
    "summarize_events",
    "summarize_file",
    "validate_event",
    "validate_events",
    "validate_jsonl",
]
