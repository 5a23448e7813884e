"""Disaggregated prefill/decode serving (port of the JAX package's
``apex_tpu/serving/fleet/disagg.py``).

:class:`DisaggRouter` splits the fleet along the role axis: dedicated
PREFILL replicas (``role="prefill"``, engines built ``prefill_only``)
admit and chunk-prefill requests, then ship the finished KV pages to
DECODE replicas (``role="decode"``, engines built ``kv_import``) that
import the pages into their own pool and decode as if they had
prefilled locally.  ``mixed`` replicas can do either — a fleet of
only mixed replicas behaves exactly like the colocated router.

Everything rides the transport seam, and the shipment protocol is
built for a lossy wire:

* **one transfer per request** — ``transfer_id = "t<rid>"``, N
  ``kv_page`` messages (one per page: base64 C-order page slices,
  quantized scale planes, per-page CRC stamped at export —
  :meth:`~apex_tpu_torch.serving.kv_cache.PagedKVCache.export_page_bytes`)
  followed by one ``kv_commit`` carrying the request record.
* **idempotent + resumable** — the receiver
  (:class:`PageImporter`) buffers pages per transfer id, dedupes
  repeats (same page landing twice is a no-op), verifies each page's
  CRC host-side BEFORE buffering (a corrupted page answers
  ``crc_mismatch`` and is re-sent — NEVER adopted), and memoizes the
  commit reply so a duplicated/retried commit cannot double-admit.
  A commit that finds pages missing (dropped in flight) answers
  ``missing_pages`` and the sender re-ships exactly those — partial
  transfers resume, they never restart.
* **bounded retries, then graceful degradation** — transport
  timeouts/corruption cost ``kv_ship_retry`` + exponential round
  backoff (the router's ``1 << attempts`` discipline); past the router's
  ``fault_retries`` budget the transfer FALLS BACK
  (``kv_ship_fallback``): the request record migrates to the decode
  replica over the ordinary migrate path and is re-prefilled LOCALLY
  there — deterministic re-prefill, the same machinery every
  recovery/migration path uses.  Zero dropped requests by
  construction, under any fault pattern.

The decode replica then owns the request end-to-end; its token stream
is bitwise the colocated control's whichever path admitted it: a
shipped page lands verbatim (codes + scales included), a fallback
re-prefill is deterministic, and decode rows are independent of batch
composition.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from apex_tpu_torch.serving.engine import AdmissionRefused
from apex_tpu_torch.serving.fleet.replica import ReplicaProxy
from apex_tpu_torch.serving.fleet.router import FleetRouter
from apex_tpu_torch.serving.fleet.transport import (TransportCorruption,
                                              TransportTimeout)
from apex_tpu_torch.serving.kv_cache import (PagePoolExhausted,
                                       verify_page_payload)


class PageImporter:
    """Decode-replica receiver for KV page shipments: the ``kv_page``
    / ``kv_commit`` handlers one replica registers on the transport.

    State is per-transfer-id: ``_buf`` accumulates verified pages
    (order-independent — reordered deliveries reassemble by
    ``page_index``), ``_done`` memoizes commit replies so the
    at-least-once wire cannot admit a request twice (a retried commit
    after a delayed-but-processed one returns the memoized success)."""

    def __init__(self, rep: ReplicaProxy, transport=None):
        self.rep = rep
        self.transport = transport
        self._buf: Dict[str, Dict[int, Dict[str, Any]]] = {}
        self._done: Dict[str, Dict[str, Any]] = {}
        #: transfer_id -> engine-clock time the FIRST page arrived —
        #: the kv_import span opens at first byte, not at commit
        self._t0: Dict[str, float] = {}

    def on_page(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        tid = payload["transfer_id"]
        if tid in self._done:
            # a page re-sent after its transfer already committed
            # (delayed reply → sender retry): the transfer is over
            return {"ok": True}
        self._t0.setdefault(tid, self.rep.engine.clock())
        buf = self._buf.setdefault(tid, {})
        idx = int(payload["page_index"])
        if idx in buf:
            return {"ok": True}   # duplicate page: a no-op
        if not verify_page_payload(payload["data"]):
            # corrupted in flight — refuse it so the sender re-ships;
            # the damaged bytes never touch this replica's pool
            return {"ok": False, "reason": "crc_mismatch",
                    "page_index": idx}
        buf[idx] = payload["data"]
        return {"ok": True}

    def on_commit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        tid = payload["transfer_id"]
        if tid in self._done:
            return self._done[tid]
        rid = int(payload["record"]["rid"])
        if self.rep.find_request(rid) is not None:
            # the request is already live here — an earlier commit
            # landed (its reply was lost), or a fallback/fence
            # migration raced the retry.  rid-level idempotency, same
            # as the migrate handler: adopt nothing twice.
            reply = {"ok": True, "rid": rid}
            self._done[tid] = reply
            self._buf.pop(tid, None)
            self._t0.pop(tid, None)
            return reply
        n_pages = int(payload["n_pages"])
        buf = self._buf.get(tid, {})
        missing = [i for i in range(n_pages) if i not in buf]
        if missing:
            # dropped/reordered pages: the sender re-ships exactly
            # these — the transfer resumes, it never restarts
            return {"ok": False, "reason": "missing_pages",
                    "missing": missing}
        pages_payload = [buf[i] for i in range(n_pages)]
        try:
            self.rep.engine.adopt_prefilled(
                payload["record"], pages_payload,
                int(payload["kv_len"]))
        except (AdmissionRefused, PagePoolExhausted) as e:
            # capacity, not corruption: the sender backs off and
            # retries into the SAME buffered pages
            return {"ok": False, "reason": "no_capacity",
                    "detail": str(e)}
        reply = {"ok": True, "rid": int(payload["record"]["rid"])}
        self._done[tid] = reply
        del self._buf[tid]
        self._emit_import_span(tid, rid)
        return reply

    def _emit_import_span(self, tid: str, rid: int) -> None:
        """The receiver half of the ship pair: ``kv_import`` spans
        first-page-arrival → adopted, parented on the LITERAL sender
        ``kv_ship`` span id carried in the wire trace context — the
        causal join survives retries/duplicates because the context
        rides the envelope verbatim."""
        ctx = (self.transport.current_trace
               if self.transport is not None else None) or {}
        now = self.rep.engine.clock()
        self.rep.engine._emit(
            "span", rid=rid,
            span_id=f"{rid}:kv_import:{int(ctx.get('attempt', 0))}",
            parent_id=ctx.get("span_id"), kind="kv_import",
            t_start=self._t0.pop(tid, now), t_end=now,
            replica=self.rep.name, attempt=int(ctx.get("attempt", 0)))


class _Transfer:
    """Sender-side state for one in-flight shipment."""

    def __init__(self, rid: int, src: str, dst: str,
                 record: Dict[str, Any],
                 pages: List[Dict[str, Any]], kv_len: int):
        self.rid = rid
        self.src = src
        self.dst = dst
        self.record = record
        self.pages = pages
        self.kv_len = kv_len
        self.transfer_id = f"t{rid}"
        self.acked: set = set()
        self.attempts = 0
        self.backoff_until = 0
        # tracing state for the CURRENT drive attempt (one kv_ship
        # span per attempt; ids carry the destination + attempt no)
        self.span_t0: Optional[float] = None
        self.span_id: Optional[str] = None
        self.span_attempt = 0


class DisaggRouter(FleetRouter):
    """Fleet router with the prefill/decode role split.

    Intake routes to prefill-capable replicas (``prefill``/``mixed``)
    with the usual least-loaded + prefix-affinity policy; every fleet
    round, finished prefills are exported off prefill replicas and
    shipped — pages then commit — to the least-loaded decode-capable
    replica, where they enter the decode batch directly
    (:meth:`~apex_tpu_torch.serving.engine.ServingEngine.adopt_prefilled`).
    Migration never targets prefill-only replicas (they cannot decode
    adopted work).  Requires at least one prefill-capable AND one
    decode-capable replica; a fleet of only mixed replicas is legal
    and behaves exactly like the base router plus a (trivially
    colocated) ship path.
    """

    def __init__(self, replicas: Sequence[ReplicaProxy], **kwargs):
        super().__init__(replicas, **kwargs)
        if not [r for r in self.replicas
                if r.role in ("prefill", "mixed")]:
            raise ValueError("disaggregated fleet needs at least one "
                             "prefill-capable (prefill/mixed) replica")
        if not [r for r in self.replicas
                if r.role in ("decode", "mixed")]:
            raise ValueError("disaggregated fleet needs at least one "
                             "decode-capable (decode/mixed) replica")
        #: rid -> in-flight shipment
        self._transfers: Dict[int, _Transfer] = {}
        self._importers: Dict[str, PageImporter] = {}
        for rep in self.replicas:
            if rep.role in ("decode", "mixed"):
                imp = PageImporter(rep, transport=self.transport)
                self._importers[rep.name] = imp
                self.transport.register(rep.name, "kv_page", imp.on_page)
                self.transport.register(rep.name, "kv_commit",
                                        imp.on_commit)

    # -- placement overrides ----------------------------------------------

    def route(self, prompt=None, roles=None) -> ReplicaProxy:
        """Intake goes to prefill-capable replicas unless the caller
        already restricted the roles (migration targeting passes its
        own set)."""
        if roles is None:
            roles = ("prefill", "mixed")
        return super().route(prompt=prompt, roles=roles)

    def _migration_targets(self, source: ReplicaProxy
                           ) -> List[ReplicaProxy]:
        """Healthy peers that can DECODE — migrating a live request
        onto a prefill-only replica would strand it (those engines
        never run decode rows)."""
        return [r for r in self.replicas
                if r.healthy and r.name != source.name
                and r.role != "prefill"]

    # -- the disaggregated round ------------------------------------------

    def step(self) -> None:
        super().step()
        self._pump_disagg()

    def _fleet_busy(self) -> bool:
        # a transfer sitting out its backoff is live work even when
        # every engine is momentarily idle — run() must not drain
        # under it
        return super()._fleet_busy() or bool(self._transfers)

    def _decode_target(self) -> Optional[ReplicaProxy]:
        """Least-loaded healthy decode-capable replica, counting
        IN-FLIGHT transfers against their destination (one pending
        shipment weighs one live request) — without it a burst of
        simultaneous prefill completions would all target the replica
        whose load_score hasn't moved yet and serialize behind its
        batch capacity."""
        pool = [r for r in self.replicas
                if r.healthy and r.role in ("decode", "mixed")]
        if not pool:
            return None
        pending: Dict[str, int] = {}
        for t in self._transfers.values():
            pending[t.dst] = pending.get(t.dst, 0) + 1
        return min(pool, key=lambda r: (r.load_score()
                                        + pending.get(r.name, 0), r.name))

    def _pump_disagg(self) -> None:
        """Export every finished prefill on a prefill replica into a
        transfer, then drive all in-flight transfers past their
        backoff.  Done-at-prefill requests (budget of one token / EOS
        on the first sample) retire locally — nothing to ship."""
        for rep in self.replicas:
            if not rep.healthy or rep.role != "prefill":
                continue
            ready = [r for r in list(rep.engine.sched.running)
                     if r.prefill_pos is None and r.generated
                     and not r.done and r.rid not in self._transfers]
            for req in ready:
                dst = self._decode_target()
                if dst is None:
                    raise RuntimeError(
                        "no healthy decode-capable replica to ship "
                        f"rid {req.rid} to — a disaggregated fleet "
                        "cannot serve without its decode tier")
                record, pages, kv_len = rep.engine.export_request(req.rid)
                self._transfers[req.rid] = _Transfer(
                    req.rid, rep.name, dst.name, record, pages, kv_len)
        for rid in sorted(self._transfers):
            t = self._transfers.get(rid)
            if t is None:
                continue
            if not self._by_name[t.dst].healthy:
                # the destination fenced mid-transfer: retarget to a
                # live decode replica and re-ship from scratch (the
                # old buffer died with the fence; acked means nothing
                # against a different pool)
                dst = self._decode_target()
                if dst is None:
                    raise RuntimeError(
                        "no healthy decode-capable replica to "
                        f"retarget rid {t.rid}'s transfer to")
                now = self._clock()
                self._by_name[t.src].engine._emit(
                    "span", rid=t.rid,
                    span_id=(f"{t.rid}:kv_ship:{t.dst}"
                             f":retarget:{self.round}"),
                    parent_id=t.record.get("export_span"),
                    kind="kv_ship", t_start=now, t_end=now,
                    replica=t.src, outcome="retarget")
                t.dst = dst.name
                t.acked = set()
            if t.backoff_until > self.round:
                continue
            self._drive(t)

    def _drive(self, t: _Transfer) -> None:
        """One attempt at completing transfer ``t``: ship every
        unacked page, then commit.  Any transport fault, missing-page
        report, or capacity refusal costs one attempt + backoff; a
        per-page CRC refusal re-ships that page immediately (bounded
        by the same attempt budget); past the budget the transfer
        falls back to local prefill on the decode replica."""
        n = len(t.pages)
        t.span_attempt = t.attempts + 1
        t.span_t0 = self._clock()
        t.span_id = f"{t.rid}:kv_ship:{t.dst}:{t.span_attempt}"
        # the trace context every wire message of this attempt carries
        # (envelope-level, outside the payload CRC): the receiver
        # parents its kv_import span on the literal span id
        ctx = {"rid": t.rid, "span_id": t.span_id,
               "attempt": t.span_attempt}
        try:
            for i in range(n):
                if i in t.acked:
                    continue
                reply = self.transport.call(
                    t.dst, "kv_page",
                    {"transfer_id": t.transfer_id, "page_index": i,
                     "n_pages": n, "data": t.pages[i]}, trace=ctx)
                retries = 0
                while not reply.get("ok"):
                    # corrupted in flight: the receiver refused the
                    # page (never adopted) — re-ship it clean
                    self._emit_retry(t, reason="crc_mismatch")
                    retries += 1
                    if retries > self.fault_retries:
                        self._fallback(t, reason="crc_mismatch")
                        return
                    reply = self.transport.call(
                        t.dst, "kv_page",
                        {"transfer_id": t.transfer_id, "page_index": i,
                         "n_pages": n, "data": t.pages[i]}, trace=ctx)
                t.acked.add(i)
            reply = self.transport.call(
                t.dst, "kv_commit",
                {"transfer_id": t.transfer_id, "record": t.record,
                 "kv_len": t.kv_len, "n_pages": n}, trace=ctx)
        except TransportTimeout:
            self._bump(t, reason="timeout")
            return
        except TransportCorruption:
            self._bump(t, reason="corrupt")
            return
        if reply.get("ok"):
            self._emit_ship_span(t, outcome="ok")
            req = self._by_name[t.dst].find_request(t.rid)
            self.handles[t.rid] = req
            self.placement[t.rid] = t.dst
            self._emit("kv_ship", rid=t.rid, from_replica=t.src,
                       to_replica=t.dst, pages=n,
                       payload_bytes=sum(
                           len(p["k"]) + len(p["v"])
                           + len(p.get("k_scale", ""))
                           + len(p.get("v_scale", ""))
                           for p in t.pages),
                       attempts=t.attempts)
            del self._transfers[t.rid]
            return
        if reply.get("reason") == "missing_pages":
            # reordered/lost pages the receiver never saw: resume the
            # transfer by re-shipping exactly those
            t.acked -= set(int(i) for i in reply["missing"])
            self._bump(t, reason="missing_pages")
            return
        self._bump(t, reason=str(reply.get("reason", "no_capacity")))

    def _bump(self, t: _Transfer, *, reason: str) -> None:
        t.attempts += 1
        if t.attempts > self.fault_retries:
            self._fallback(t, reason=reason)
            return
        self._emit_ship_span(t, outcome="retry", reason=reason)
        t.backoff_until = self.round + (1 << t.attempts)
        self._emit_retry(t, reason=reason,
                         backoff_rounds=t.backoff_until - self.round)

    def _emit_retry(self, t: _Transfer, *, reason: str,
                    **extra) -> None:
        self._emit("kv_ship_retry", rid=t.rid, from_replica=t.src,
                   to_replica=t.dst, attempt=t.attempts,
                   reason=reason, **extra)

    def _emit_ship_span(self, t: _Transfer, *, outcome: str,
                        reason: Optional[str] = None) -> None:
        """Close the CURRENT attempt's ``kv_ship`` span with a typed
        outcome — one span per drive attempt, parented on the
        sender's ``kv_export`` span (carried in the transfer record);
        retries/fallbacks/retargets are outcomes, not separate
        kinds."""
        if t.span_id is None:
            return
        ev: Dict[str, Any] = dict(
            rid=t.rid, span_id=t.span_id,
            parent_id=t.record.get("export_span"), kind="kv_ship",
            t_start=t.span_t0, t_end=self._clock(), replica=t.src,
            attempt=t.span_attempt, outcome=outcome)
        if reason is not None:
            ev["reason"] = reason
        self._by_name[t.src].engine._emit("span", **ev)

    def _fallback(self, t: _Transfer, *, reason: str) -> None:
        """Graceful degradation past the retry budget: the request
        record migrates to the decode replica over the ordinary
        (idempotent) migrate path and re-prefills LOCALLY there —
        slower, but the stream stays bitwise (deterministic
        re-prefill) and the request is never dropped.  If the commit
        actually landed and only its reply was lost, the migrate
        handler's rid-dedupe finds the request live and adopts
        nothing — the rebind below picks up the shipped copy."""
        self._emit_ship_span(t, outcome="fallback", reason=reason)
        self._emit("kv_ship_fallback", rid=t.rid, from_replica=t.src,
                   to_replica=t.dst, attempts=t.attempts, reason=reason)
        self._call_with_retry(
            t.dst, "migrate", {"records": [t.record]},
            trace=({"rid": t.rid, "span_id": t.span_id,
                    "attempt": t.span_attempt}
                   if t.span_id is not None else None))
        req = self._by_name[t.dst].find_request(t.rid)
        self.handles[t.rid] = req
        self.placement[t.rid] = t.dst
        del self._transfers[t.rid]
