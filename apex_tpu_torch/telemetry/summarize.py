"""Offline aggregation of a telemetry JSONL stream.

``python -m apex_tpu_torch.telemetry summarize run.jsonl`` renders the
operator's one-screen view of a run — step-time percentiles, goodput
with its loss buckets, per-event-type counts — and ``--diff b.jsonl``
turns two runs into an A/B table (the diffable-stream payoff: "did the
new remat policy move p95, and did goodput pay for it?").
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from apex_tpu_torch.telemetry.schema import load_jsonl


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def summarize_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a stream into the summary record.

    Goodput comes from the last ``run_end`` event when the run exited
    through its accounting (the accountant's ledger is authoritative —
    it spans elastic restarts); a crashed stream without one falls back
    to productive-step seconds over the stream's time extent.
    """
    counts: Dict[str, int] = {}
    step_ms: List[float] = []
    skipped_steps = 0
    run_end: Optional[Dict[str, Any]] = None
    t_lo = t_hi = None
    tpot_ms: List[float] = []
    ttft_ms: List[float] = []
    pool_occ: List[float] = []
    commit_tokens = commit_rows = 0
    spec_drafted = spec_accepted = 0
    prefix_hits = prefix_total = 0
    shared_pages_peak = None
    deadline_hits = deadline_total = 0
    queue_sheds = run_timeouts = 0
    phase_ms: Dict[str, List[float]] = {}
    exposed_ms: List[float] = []
    profile_overhead_ms = 0.0
    hbm_peak = None
    for ev in events:
        counts[ev.get("type", "?")] = counts.get(ev.get("type", "?"), 0) + 1
        t = ev.get("t")
        if isinstance(t, (int, float)):
            t_lo = t if t_lo is None else min(t_lo, t)
            t_hi = t if t_hi is None else max(t_hi, t)
        if ev.get("type") == "step":
            step_ms.append(float(ev.get("step_ms", 0.0)))
            if ev.get("skipped"):
                skipped_steps += 1
        elif ev.get("type") == "run_end":
            run_end = ev
        elif ev.get("type") == "request_retire":
            if ev.get("tpot_ms") is not None:
                tpot_ms.append(float(ev["tpot_ms"]))
            if ev.get("ttft_ms") is not None:
                ttft_ms.append(float(ev["ttft_ms"]))
            if ev.get("deadline_hit") is not None:
                deadline_total += 1
                deadline_hits += 1 if ev["deadline_hit"] else 0
        elif ev.get("type") == "request_admit":
            # prefix sharing: the field is present on every admit
            # while sharing is on — misses included, which is what makes
            # hits/total a real hit RATE rather than a hit count
            if ev.get("prefix_hit") is not None:
                prefix_total += 1
                prefix_hits += 1 if ev["prefix_hit"] else 0
        elif ev.get("type") == "request_timeout":
            # a timed-out request HAD a deadline by definition and
            # missed it — it counts in the hit-rate denominator even
            # though it never produced a retire record
            deadline_total += 1
            if ev.get("where") == "queued":
                queue_sheds += 1
            else:
                run_timeouts += 1
        elif ev.get("type") == "decode_step":
            if ev.get("pool_pages"):
                pool_occ.append(ev.get("pool_used", 0)
                                / ev["pool_pages"])
            # accepted tokens per step: committed tokens
            # over occupied batch rows — exactly 1.0 for a plain
            # decode stream, > 1.0 whenever speculation lands
            commit_tokens += int(ev.get("new_tokens", 0))
            commit_rows += int(ev.get("batch", 0))
            spec_drafted += int(ev.get("spec_drafted", 0))
            spec_accepted += int(ev.get("spec_accepted", 0))
            if ev.get("pool_shared_pages") is not None:
                sp = int(ev["pool_shared_pages"])
                shared_pages_peak = (sp if shared_pages_peak is None
                                     else max(shared_pages_peak, sp))
        elif ev.get("type") == "profile":
            for k, v in (ev.get("phase_ms") or {}).items():
                phase_ms.setdefault(k, []).append(float(v))
            if ev.get("exposed_collective_ms") is not None:
                exposed_ms.append(float(ev["exposed_collective_ms"]))
            profile_overhead_ms += float(ev.get("overhead_ms", 0.0))
        elif ev.get("type") == "memory":
            if ev.get("peak_bytes") is not None:
                pk = float(ev["peak_bytes"])
                hbm_peak = pk if hbm_peak is None else max(hbm_peak, pk)

    s = sorted(step_ms)
    run_ids = list(dict.fromkeys(
        e.get("run_id") for e in events if e.get("run_id")))
    out: Dict[str, Any] = {
        "run_id": run_ids[0] if run_ids else None,
        "n_events": len(events),
        "counts": dict(sorted(counts.items())),
        "steps": len(step_ms),
        # a skipped step may surface twice (a `skip` event from the
        # guard AND the skipped flag on its `step` event): take the max,
        # never the sum
        "skipped_steps": max(skipped_steps, counts.get("skip", 0)),
        "step_ms_p50": round(percentile(s, 0.50), 3) if s else None,
        "step_ms_p95": round(percentile(s, 0.95), 3) if s else None,
        "step_ms_p99": round(percentile(s, 0.99), 3) if s else None,
        # data-plane health: stall/quarantine counts are
        # first-class summary fields, not just rows in the counts dict —
        # an input-bound or data-damaged run must be visible on the one-
        # screen view
        "data_stalls": counts.get("data_stall", 0),
        "records_quarantined": counts.get("data_quarantine", 0),
    }
    if counts.get("request_retire") or counts.get("decode_step") \
            or counts.get("request_timeout") or counts.get("request_reject"):
        # serving summary: the one-screen view of a serving
        # stream is latency percentiles + pool pressure, not step time
        st, sf = sorted(tpot_ms), sorted(ttft_ms)
        out["serving_requests"] = counts.get("request_retire", 0)
        out["serving_decode_steps"] = counts.get("decode_step", 0)
        out["serving_tpot_p50"] = (round(percentile(st, 0.50), 3)
                                   if st else None)
        out["serving_tpot_p95"] = (round(percentile(st, 0.95), 3)
                                   if st else None)
        out["serving_ttft_p50"] = (round(percentile(sf, 0.50), 3)
                                   if sf else None)
        out["serving_pool_peak"] = (round(max(pool_occ), 4)
                                    if pool_occ else None)
        out["serving_accepted_tokens_per_step"] = (
            round(commit_tokens / commit_rows, 4) if commit_rows
            else None)
        if spec_drafted:
            # proposer quality (pre-truncation): how much of what it
            # guessed did the model's own argmax endorse
            out["serving_spec_drafted"] = spec_drafted
            out["serving_spec_accept_rate"] = round(
                spec_accepted / spec_drafted, 4)
        # overload/deadline health: sheds = explicit load
        # refusal (bounded-queue rejects + queued deadline sheds);
        # timeouts = in-flight deadline deaths; deadline hit rate =
        # hits over every deadline-carrying request seen (completions
        # AND deadline deaths — rejects are excluded because a reject
        # event does not say whether a deadline existed)
        out["serving_rejects"] = counts.get("request_reject", 0)
        out["serving_sheds"] = out["serving_rejects"] + queue_sheds
        out["serving_timeouts"] = run_timeouts
        out["serving_deadline_hit_rate"] = (
            round(deadline_hits / deadline_total, 4)
            if deadline_total else None)
        # prefix sharing: hit rate over every sharing-on admit,
        # and the pool's peak count of pages held by >1 reader
        out["serving_prefix_hit_rate"] = (
            round(prefix_hits / prefix_total, 4)
            if prefix_total else None)
        out["serving_shared_pages_peak"] = shared_pages_peak
        # disaggregated prefill/decode: shipment health over
        # every transfer OUTCOME (success or fallback — retries are a
        # cost, not an outcome, so they scale neither rate); None when
        # the stream carried no ship traffic at all
        ships = counts.get("kv_ship", 0)
        fallbacks = counts.get("kv_ship_fallback", 0)
        out["serving_ship_success_rate"] = (
            round(ships / (ships + fallbacks), 4)
            if ships + fallbacks else None)
        out["serving_ship_fallback_rate"] = (
            round(fallbacks / (ships + fallbacks), 4)
            if ships + fallbacks else None)
        # distributed tracing: p50 TTFT decomposition over every
        # request whose span tree is complete enough to decompose —
        # where the waiting actually happened, not just how long it was
        if counts.get("span"):
            from apex_tpu_torch.telemetry.tracing import (build_traces,
                                                    ttft_decomposition)
            decomps = [d for d in (ttft_decomposition(t)
                                   for t in build_traces(events).values())
                       if d is not None]
            if decomps:
                out["serving_traced_requests"] = len(decomps)
                for comp in ("ttft_queue_ms", "ttft_prefill_ms",
                             "ttft_ship_ms", "ttft_decode_wait_ms"):
                    vals = sorted(d[comp] for d in decomps)
                    out[f"serving_{comp}"] = round(
                        percentile(vals, 0.50), 3)
    if counts.get("profile"):
        # phase attribution: mean per-phase device ms over the
        # run's sampled windows — the answer to "where do a step's
        # milliseconds go" on the same one-screen view that says the
        # p95 moved
        out["profile_samples"] = counts["profile"]
        out["phase_ms"] = {
            k: round(sum(v) / len(v), 3)
            for k, v in sorted(phase_ms.items())}
        out["exposed_collective_ms"] = (
            round(sum(exposed_ms) / len(exposed_ms), 3)
            if exposed_ms else None)
        out["profile_overhead_ms"] = round(profile_overhead_ms, 3)
    if hbm_peak is not None:
        out["hbm_peak_gb"] = round(hbm_peak / 1e9, 3)
    if len(run_ids) > 1:
        # JsonlSink appends: a restarted job continues its stream file
        # under a new run_id.  Aggregating across runs is legitimate,
        # but the record must say it happened.
        out["run_ids"] = run_ids
    if run_end is not None:
        out["goodput"] = run_end.get("goodput")
        out["buckets_s"] = run_end.get("buckets_s", {})
        out["wall_s"] = run_end.get("wall_s")
        out["steps_per_sec"] = run_end.get("steps_per_sec")
        out["stop_reason"] = run_end.get("reason")
    elif s and t_hi is not None and t_hi > t_lo:
        productive_s = sum(
            float(e.get("step_ms", 0.0)) for e in events
            if e.get("type") == "step" and not e.get("skipped")) / 1e3
        out["goodput"] = round(min(1.0, productive_s / (t_hi - t_lo)), 4)
        out["wall_s"] = round(t_hi - t_lo, 3)
        out["goodput_estimated"] = True  # no run_end: crashed stream
    return out


def summarize_file(path: str) -> Dict[str, Any]:
    # tolerant load: a crashed stream may end in a torn line, and the
    # crashed stream is the one that most needs summarizing
    return summarize_events(load_jsonl(path, tolerate_torn_tail=True))


def _pct(v) -> str:
    return "n/a" if v is None else f"{100.0 * v:.1f}%"


def _ms(v) -> str:
    return "n/a" if v is None else f"{v:.1f}ms"


def format_summary(s: Dict[str, Any]) -> str:
    runs = s.get("run_ids")
    lines = [
        f"run {' + '.join(runs) if runs else s.get('run_id')}  "
        f"events {s.get('n_events')}  "
        f"steps {s.get('steps')} ({s.get('skipped_steps', 0)} skipped)",
        f"step time   p50 {_ms(s.get('step_ms_p50'))}  "
        f"p95 {_ms(s.get('step_ms_p95'))}  "
        f"p99 {_ms(s.get('step_ms_p99'))}",
        f"goodput     {_pct(s.get('goodput'))}"
        + (" (estimated: no run_end)" if s.get("goodput_estimated") else ""),
    ]
    buckets = s.get("buckets_s")
    if buckets:
        lines.append("time split  " + "  ".join(
            f"{k} {v:.2f}s" for k, v in sorted(buckets.items())))
    if s.get("serving_requests") is not None:
        parts = [f"serving     requests {s['serving_requests']}"]
        if s.get("serving_tpot_p50") is not None:
            parts.append(f"tpot p50 {_ms(s['serving_tpot_p50'])} "
                         f"p95 {_ms(s.get('serving_tpot_p95'))}")
        if s.get("serving_ttft_p50") is not None:
            parts.append(f"ttft p50 {_ms(s['serving_ttft_p50'])}")
        if s.get("serving_pool_peak") is not None:
            parts.append(f"pool peak {_pct(s['serving_pool_peak'])}")
        if s.get("serving_accepted_tokens_per_step") is not None:
            parts.append(
                f"acc {s['serving_accepted_tokens_per_step']:.2f} tok/step")
        if s.get("serving_spec_accept_rate") is not None:
            parts.append(
                f"spec accept {_pct(s['serving_spec_accept_rate'])}")
        if s.get("serving_sheds") or s.get("serving_timeouts"):
            parts.append(f"shed {s.get('serving_sheds', 0)} "
                         f"timeout {s.get('serving_timeouts', 0)}")
        if s.get("serving_deadline_hit_rate") is not None:
            parts.append(
                f"deadline hit {_pct(s['serving_deadline_hit_rate'])}")
        if s.get("serving_prefix_hit_rate") is not None:
            parts.append(
                f"prefix hit {_pct(s['serving_prefix_hit_rate'])}")
        if s.get("serving_shared_pages_peak"):
            parts.append(
                f"shared pages peak {s['serving_shared_pages_peak']}")
        if s.get("serving_ship_success_rate") is not None:
            parts.append(
                f"ship ok {_pct(s['serving_ship_success_rate'])} "
                f"fallback {_pct(s.get('serving_ship_fallback_rate'))}")
        lines.append("  ".join(parts))
        if s.get("serving_traced_requests"):
            lines.append(
                f"ttft split  queue {_ms(s.get('serving_ttft_queue_ms'))}"
                f"  prefill {_ms(s.get('serving_ttft_prefill_ms'))}"
                f"  ship {_ms(s.get('serving_ttft_ship_ms'))}"
                f"  decode-wait {_ms(s.get('serving_ttft_decode_wait_ms'))}"
                f"  (p50 over {s['serving_traced_requests']} traces)")
    if s.get("profile_samples"):
        parts = ["phases      " + "  ".join(
            f"{k} {v:.2f}ms" for k, v in (s.get("phase_ms") or {}).items())]
        if s.get("exposed_collective_ms") is not None:
            parts.append(f"exposed coll {_ms(s['exposed_collective_ms'])}")
        parts.append(f"({s['profile_samples']} samples)")
        lines.append("  ".join(parts))
    if s.get("hbm_peak_gb") is not None:
        lines.append(f"hbm peak    {s['hbm_peak_gb']:.2f} GB")
    if s.get("data_stalls") or s.get("records_quarantined"):
        parts = [f"data        stalls {s.get('data_stalls', 0)}"]
        if s.get("records_quarantined"):
            parts.append(f"quarantined {s['records_quarantined']}")
        if buckets and buckets.get("data_wait"):
            parts.append(f"wait {buckets['data_wait']:.2f}s")
        lines.append("  ".join(parts))
    if s.get("stop_reason"):
        lines.append(f"stop        {s['stop_reason']}"
                     + (f"  ({s.get('steps_per_sec')} steps/s)"
                        if s.get("steps_per_sec") is not None else ""))
    counts = s.get("counts", {})
    if counts:
        lines.append("events      " + "  ".join(
            f"{k}={v}" for k, v in counts.items()))
    return "\n".join(lines)


#: Scalar rows the A/B diff table compares.
_DIFF_ROWS = (
    ("steps", "steps", "{:d}"),
    ("skipped_steps", "skipped", "{:d}"),
    ("step_ms_p50", "p50 (ms)", "{:.2f}"),
    ("step_ms_p95", "p95 (ms)", "{:.2f}"),
    ("step_ms_p99", "p99 (ms)", "{:.2f}"),
    ("goodput", "goodput", "{:.3f}"),
    ("steps_per_sec", "steps/s", "{:.3f}"),
    ("data_stalls", "data stalls", "{:d}"),
    ("serving_tpot_p50", "tpot p50 (ms)", "{:.2f}"),
    # speculation health: committed tokens per decode-step
    # row — the accepted-tokens-per-step headline
    ("serving_accepted_tokens_per_step", "acc tok/step", "{:.3f}"),
    # overload health: did the change move the SLO story?
    ("serving_deadline_hit_rate", "deadline hit", "{:.3f}"),
    # memory-lean serving: did prefix sharing land, and did the
    # quantized pool move the occupancy high-water mark?
    ("serving_prefix_hit_rate", "prefix hit", "{:.3f}"),
    ("serving_pool_peak", "pool peak", "{:.3f}"),
    # disaggregation health: did the change push shipments past
    # their retry budget into local-prefill fallbacks?
    ("serving_ship_fallback_rate", "ship fallback", "{:.3f}"),
    # TTFT decomposition: WHERE did the first-token wait move —
    # intake queue, prefill compute, the KV ship wall, or decode entry?
    ("serving_ttft_queue_ms", "ttft queue", "{:.2f}"),
    ("serving_ttft_prefill_ms", "ttft prefill", "{:.2f}"),
    ("serving_ttft_ship_ms", "ttft ship", "{:.2f}"),
    ("serving_ttft_decode_wait_ms", "ttft dec-wait", "{:.2f}"),
    # phase-attribution rows: did the change move exposed
    # communication or the memory high-water mark?
    ("exposed_collective_ms", "exposed (ms)", "{:.2f}"),
    ("hbm_peak_gb", "hbm peak (GB)", "{:.2f}"),
)


#: Per-phase diff rows are dynamic (phases present in either summary).
def _phase_diff_rows(a: Dict[str, Any], b: Dict[str, Any]):
    pa, pb = a.get("phase_ms") or {}, b.get("phase_ms") or {}
    for k in sorted(set(pa) | set(pb)):
        yield (k, pa.get(k), pb.get(k))


def format_diff(a: Dict[str, Any], b: Dict[str, Any]) -> str:
    """A/B comparison table of two summaries (A = first file, the
    baseline; delta = B - A, with a ratio where it makes sense)."""
    name_a = str(a.get("run_id"))[:24]
    name_b = str(b.get("run_id"))[:24]
    lines = [f"{'':<12} {'A: ' + name_a:>28} {'B: ' + name_b:>28} "
             f"{'delta':>12}"]
    for key, label, fmt in _DIFF_ROWS:
        va, vb = a.get(key), b.get(key)
        fa = fmt.format(va) if va is not None else "n/a"
        fb = fmt.format(vb) if vb is not None else "n/a"
        if va is not None and vb is not None:
            d = vb - va
            delta = f"{d:+.3f}" if isinstance(d, float) else f"{d:+d}"
            if va not in (0, None) and key not in ("steps", "skipped_steps",
                                                   "data_stalls"):
                delta += f" ({vb / va:.2f}x)"
        else:
            delta = "n/a"
        lines.append(f"{label:<12} {fa:>28} {fb:>28} {delta:>12}")
    for phase, va, vb in _phase_diff_rows(a, b):
        fa = f"{va:.2f}" if va is not None else "n/a"
        fb = f"{vb:.2f}" if vb is not None else "n/a"
        if va is not None and vb is not None:
            delta = f"{vb - va:+.3f}"
            if va:
                delta += f" ({vb / va:.2f}x)"
        else:
            delta = "n/a"
        lines.append(f"{'ph:' + phase:<12} {fa:>28} {fb:>28} {delta:>12}")
    return "\n".join(lines)
