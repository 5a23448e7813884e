"""CLI: ``python -m apex_tpu_torch.telemetry summarize run.jsonl [--diff b.jsonl]``
(port of the JAX package's; its ``regress`` subcommand, which reads that
package's benchmark records, is not ported).

Subcommands:

- ``summarize RUN.jsonl`` — step-time p50/p95/p99, goodput %, time
  buckets, phase breakdown (when the run sampled profiles), per-event-
  type counts.  ``--diff OTHER.jsonl`` renders an A/B table instead
  (RUN is the A/baseline column).  ``--json`` emits the raw summary
  record(s) for tooling.
- ``validate FILE.jsonl`` — schema-check every event (exit 1 on the
  first violation); works on run streams and postmortem files alike.
- ``trace STREAM.jsonl [STREAM2.jsonl ...]`` — reconstruct per-request
  span trees from any set of per-replica streams: renders
  each request's causal tree, marks the critical path, and prints the
  TTFT decomposition.  ``--rid N`` restricts to one request (exit 2
  when it has no spans); ``--json`` emits the trees + decompositions
  as a record.  Exit 1 when any tree is structurally broken (orphan
  spans, dangling parents) or a decomposition fails to sum to the
  measured TTFT within tolerance.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry",
        description="Telemetry stream tools")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_sum = sub.add_parser("summarize",
                           help="aggregate one run (or A/B-diff two)")
    p_sum.add_argument("jsonl", help="telemetry JSONL stream")
    p_sum.add_argument("--diff", metavar="OTHER",
                       help="second stream: render an A/B table "
                            "(JSONL = A/baseline, OTHER = B)")
    p_sum.add_argument("--json", action="store_true",
                       help="emit the summary record(s) as JSON")

    p_val = sub.add_parser("validate",
                           help="schema-check every event in a file")
    p_val.add_argument("jsonl")

    p_tr = sub.add_parser(
        "trace", help="reconstruct per-request span trees from one or "
                      "more per-replica streams (exit 1 on broken "
                      "trees or TTFT decomposition mismatch)")
    p_tr.add_argument("jsonl", nargs="+",
                      help="telemetry JSONL stream(s) — any subset of "
                           "the fleet's per-replica files")
    p_tr.add_argument("--rid", type=int, default=None,
                      help="restrict to one request id (exit 2 when "
                           "it has no spans)")
    p_tr.add_argument("--json", action="store_true",
                      help="emit trees + decompositions as JSON")

    args = parser.parse_args(argv)

    if args.cmd == "trace":
        from apex_tpu_torch.telemetry.tracing import run_trace_cli

        return run_trace_cli(args.jsonl, rid=args.rid,
                             as_json=args.json)

    if args.cmd == "validate":
        from apex_tpu_torch.telemetry.schema import SchemaError, validate_jsonl

        try:
            n = validate_jsonl(args.jsonl)
        except SchemaError as e:
            print(f"INVALID: {e}", file=sys.stderr)
            return 1
        print(f"ok: {n} events valid")
        return 0

    from apex_tpu_torch.telemetry.summarize import (
        format_diff, format_summary, summarize_file)

    summary = summarize_file(args.jsonl)
    if args.diff:
        other = summarize_file(args.diff)
        if args.json:
            print(json.dumps({"a": summary, "b": other}, indent=1))
        else:
            print(format_diff(summary, other))
        return 0
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(format_summary(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
