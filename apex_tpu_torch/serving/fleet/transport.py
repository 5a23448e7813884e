"""The message-level transport seam (port of the JAX package's
``apex_tpu/serving/fleet/transport.py``; host code, no device work).

Every cross-replica payload — health pings, migration snapshots, and
the disaggregation tier's KV page shipments — flows through ONE
surface: :meth:`Transport.call`.  The in-process implementation
(:class:`LocalTransport`) is deliberately RPC-shaped: an explicit
serialize → deliver → deserialize pipeline with a per-message id, a
JSON wire envelope, and a body CRC — so a network transport later
replaces :meth:`LocalTransport.deliver` and nothing above the seam
changes.  The router's old inline ``json.loads(json.dumps(...))``
serializability pin now lives here, where the real boundary will be.

Wire discipline:

* **envelope** — ``{"msg_id", "class", "dst", "payload",
  "body_crc"}``, JSON text.  ``body_crc`` is a crc32 of the
  canonically-serialized payload, stamped at serialize time; the
  receiver recomputes it before dispatch and answers a typed
  ``corrupt_envelope`` error on mismatch (the sender sees
  :class:`TransportCorruption` — retryable, like a timeout).
* **at-most-once processing per wire message** — the receiver memoizes
  replies by ``msg_id``, so a DUPLICATED wire message is processed
  once and the second copy gets the memoized reply.  Sender-level
  retries mint a new ``msg_id``, so end-to-end idempotency is the
  application's job (migration dedupes by rid, shipments by transfer
  id — see :mod:`~apex_tpu_torch.serving.fleet.disagg`).
* **typed errors over the wire** — a handler exception whose type was
  :func:`register_error`-ed serializes into the reply and re-raises
  sender-side as the same type (``HealthCheckTimeout`` crossing the
  ping boundary); unregistered exceptions propagate raw, loudly — a
  handler bug must not be laundered into a retry.

:class:`ChaosTransport` wraps any transport and injects per-message-
class faults (drop / delay / duplicate / reorder / corrupt), each a
``fault_injected`` telemetry event.  The injection semantics encode
the failure modes the disaggregation contract must survive; each
(message class × fault) cell has its outcome:

* **drop** — the message is never delivered; the sender gets
  :class:`TransportTimeout`.
* **delay** — the message IS delivered and processed, but the reply
  arrives past the budget: the sender still gets
  :class:`TransportTimeout`.  This is the at-least-once ambiguity
  that forces receiver-side idempotency — the sender cannot tell a
  dropped request from a dropped reply, and its retry re-delivers
  work the receiver already did.
* **duplicate** — the same wire message is delivered twice; the
  msg-id memo makes the second copy a no-op.
* **reorder** — a ``kv_page`` message is stashed (its sender gets a
  synthesized ack) and delivered late, after the NEXT message to the
  same destination; a ``kv_commit`` flushes the stash first, so the
  commit always fences the data plane.  Control classes (ping /
  migrate) are request-reply ordered by construction — reorder never
  fires on them (a no-op, documented as such in the chaos matrix).
* **corrupt** — ping/migrate payloads are mutated WITHOUT fixing the
  envelope CRC (the receiver's envelope check catches it →
  :class:`TransportCorruption`); a ``kv_page`` payload has its page
  BYTES mutated with the envelope CRC re-stamped — the envelope reads
  clean and only the application-level per-page export CRC catches
  it, which is exactly the corruption class the re-request path
  exists for.

No real sleeping anywhere: delays are virtual (the exception IS the
late reply), so chaos tests never slow the suite.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class TransportTimeout(RuntimeError):
    """No reply within the (virtual) budget — the message or its
    reply was lost in flight.  The sender cannot know which: retry
    against an idempotent receiver, or fence/fall back past the
    budget."""


class TransportCorruption(RuntimeError):
    """The receiver's envelope CRC check rejected the message — a
    corrupted-in-flight request.  Retryable, like a timeout (the
    next copy re-serializes clean)."""


#: Exception types allowed to cross the wire as typed error replies
#: (name -> class).  Populated by the modules that own the types
#: (:mod:`router` registers ``HealthCheckTimeout``); anything NOT
#: here propagates raw at the handler — in-process that is a loud
#: crash, which is what a handler BUG deserves.
_ERROR_TYPES: Dict[str, type] = {}


def register_error(exc_type: type) -> type:
    """Allow ``exc_type`` to serialize across the transport as a
    typed error reply; returns the type (usable as a decorator)."""
    _ERROR_TYPES[exc_type.__name__] = exc_type
    return exc_type


def _body_crc(payload: Any) -> int:
    """crc32 of the canonical (sorted-key) JSON payload bytes — the
    envelope integrity stamp."""
    return zlib.crc32(
        json.dumps(payload, sort_keys=True).encode("utf-8"))


class Transport:
    """The seam: message-class handlers register per destination, and
    every cross-replica payload goes through :meth:`call`.

    ``trace`` is the distributed-tracing context: an opaque
    JSON-serializable dict carried VERBATIM inside the wire envelope
    (never inside the payload, so payload CRC / corruption faults
    cannot touch it), exposed to the receiving handler as
    :attr:`current_trace` for the duration of its dispatch.  Span
    identity lives in the context itself — transport msg ids are
    useless for it, since sender retries mint fresh ones."""

    #: the in-flight message's trace context while its handler runs
    current_trace: Optional[Dict[str, Any]] = None

    def register(self, dst: str, msg_class: str,
                 handler: Callable[[Dict[str, Any]], Dict[str, Any]]
                 ) -> None:
        raise NotImplementedError

    def call(self, dst: str, msg_class: str, payload: Dict[str, Any],
             *, trace: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process transport with the full RPC pipeline: per-message
    ids, JSON envelope + body CRC, receiver-side dispatch, JSON
    reply.  Payloads and replies MUST be JSON-serializable — the
    round-trip is the serializability pin the router used to carry
    inline."""

    def __init__(self):
        #: (dst, msg_class) -> handler(payload) -> reply dict
        self._handlers: Dict[Tuple[str, str], Callable] = {}
        self._next_msg_id = 0
        #: msg_id -> serialized reply (at-most-once processing per
        #: wire message; bounded by the life of the transport, which
        #: is the life of the fleet — a few bytes per message)
        self._replies: Dict[int, str] = {}
        self.current_trace: Optional[Dict[str, Any]] = None

    # -- registration -----------------------------------------------------

    def register(self, dst: str, msg_class: str,
                 handler: Callable[[Dict[str, Any]], Dict[str, Any]]
                 ) -> None:
        self._handlers[(dst, msg_class)] = handler

    # -- the pipeline ------------------------------------------------------

    def serialize(self, dst: str, msg_class: str,
                  payload: Dict[str, Any],
                  trace: Optional[Dict[str, Any]] = None) -> str:
        """Mint a message: assign the next msg id, stamp the body
        CRC, return the JSON wire text.  ``trace`` rides in the
        envelope OUTSIDE the payload: the body CRC does not cover it,
        corruption faults do not touch it, and duplicated wire copies
        carry the identical context — span ids stay idempotent."""
        msg_id = self._next_msg_id
        self._next_msg_id += 1
        return json.dumps({"msg_id": msg_id, "class": msg_class,
                           "dst": dst, "payload": payload,
                           "trace": trace,
                           "body_crc": _body_crc(payload)})

    def deliver(self, wire: str) -> str:
        """Receiver side: parse the envelope, verify the body CRC,
        dedupe by msg id, dispatch to the registered handler, and
        return the serialized reply."""
        env = json.loads(wire)
        msg_id = int(env["msg_id"])
        if msg_id in self._replies:
            # a duplicated wire message: processed once, the second
            # copy gets the memoized reply
            return self._replies[msg_id]
        if _body_crc(env["payload"]) != env["body_crc"]:
            reply = json.dumps({"__error__": {
                "type": "TransportCorruption",
                "message": f"envelope CRC mismatch on msg {msg_id} "
                           f"(class {env['class']!r})"}})
            self._replies[msg_id] = reply
            return reply
        handler = self._handlers.get((env["dst"], env["class"]))
        if handler is None:
            raise KeyError(
                f"no handler for class {env['class']!r} on "
                f"{env['dst']!r} — register before calling")
        self.current_trace = env.get("trace")
        try:
            out = handler(env["payload"])
        except Exception as e:   # noqa: BLE001 — typed re-raise below
            if type(e).__name__ not in _ERROR_TYPES:
                raise
            out = {"__error__": {"type": type(e).__name__,
                                 "message": str(e)}}
        finally:
            self.current_trace = None
        reply = json.dumps(out)
        self._replies[msg_id] = reply
        return reply

    def deserialize_reply(self, reply_wire: str) -> Dict[str, Any]:
        """Sender side: parse the reply; a typed error reply
        re-raises as its registered exception type."""
        reply = json.loads(reply_wire)
        err = reply.get("__error__") if isinstance(reply, dict) else None
        if err is not None:
            if err["type"] == "TransportCorruption":
                raise TransportCorruption(err["message"])
            raise _ERROR_TYPES[err["type"]](err["message"])
        return reply

    def call(self, dst: str, msg_class: str, payload: Dict[str, Any],
             *, trace: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        return self.deserialize_reply(
            self.deliver(self.serialize(dst, msg_class, payload, trace)))


#: The injectable fault classes, in injection-priority order (at most
#: ONE fault per message; when a schedule/rate arms several for the
#: same message, the first in this order wins).
FAULTS = ("drop", "delay", "duplicate", "reorder", "corrupt")


class ChaosTransport(Transport):
    """Fault-injecting wrapper around a real transport.

    Two arming modes, composable:

    * ``schedule`` — ``{(msg_class, fault): {n, ...}}``: inject
      ``fault`` on the n-th message of ``msg_class`` (1-based, counted
      per class).  Deterministic — the chaos matrix test pins each
      cell with exactly this.
    * ``rates`` — ``{(msg_class, fault): p}``: inject with
      probability ``p`` per message, seeded (``np.random.RandomState``
      — same discipline as every other chaos injector).

    Every injection emits a ``fault_injected`` event
    (``kind="transport_<fault>"``, ``event=<msg_class>``,
    ``replica=<dst>``).  Reorder only ever fires on ``kv_page``
    messages (see the module docstring); arming it on a control class
    is accepted and never fires.
    """

    def __init__(self, inner: LocalTransport, *,
                 schedule: Optional[Dict[Tuple[str, str], Any]] = None,
                 rates: Optional[Dict[Tuple[str, str], float]] = None,
                 seed: int = 0, telemetry=None):
        self.inner = inner
        self.schedule = {k: set(v) for k, v in (schedule or {}).items()}
        self.rates = dict(rates or {})
        self._rng = np.random.RandomState(seed)
        self.telemetry = telemetry
        self._seen: Dict[str, int] = {}      # per-class message count
        self._stash: Dict[str, List[str]] = {}  # dst -> reordered wires
        self.injected: Dict[str, int] = {}   # f"{class}:{fault}" -> n

    def register(self, dst, msg_class, handler) -> None:
        self.inner.register(dst, msg_class, handler)

    @property
    def current_trace(self) -> Optional[Dict[str, Any]]:
        # handlers dispatch on the inner transport; delegate so code
        # holding the chaos wrapper sees the same context
        return self.inner.current_trace

    # -- fault selection ---------------------------------------------------

    def _pick(self, msg_class: str) -> Optional[str]:
        n = self._seen.get(msg_class, 0) + 1
        self._seen[msg_class] = n
        for fault in FAULTS:
            if fault == "reorder" and msg_class != "kv_page":
                continue
            if n in self.schedule.get((msg_class, fault), ()):
                return fault
            p = self.rates.get((msg_class, fault), 0.0)
            if p > 0.0 and self._rng.random_sample() < p:
                return fault
        return None

    def _emit(self, fault: str, msg_class: str, dst: str) -> None:
        key = f"{msg_class}:{fault}"
        self.injected[key] = self.injected.get(key, 0) + 1
        if self.telemetry is not None:
            self.telemetry.emit("fault_injected",
                                kind=f"transport_{fault}",
                                event=msg_class, replica=dst)

    def _corrupt(self, wire: str, msg_class: str) -> str:
        """Mutate the message in flight.  Control classes: flip a
        payload value WITHOUT re-stamping the envelope CRC (caught at
        the envelope).  ``kv_page``: flip the page's data bytes and
        RE-STAMP the envelope — clean envelope, damaged content; only
        the per-page export CRC can catch it on import."""
        env = json.loads(wire)
        if msg_class == "kv_page":
            data = env["payload"]["data"]
            # mutate the b64 text of the K plane — any in-alphabet
            # change decodes to different bytes, so the export CRC
            # recorded at the source can no longer match
            k = data["k"]
            data["k"] = ("BBBB" + k[4:]) if not k.startswith("BBBB") \
                else ("CCCC" + k[4:])
            env["body_crc"] = _body_crc(env["payload"])
        else:
            env["payload"] = {"__corrupted__": True,
                              "was": env["payload"]}
        return json.dumps(env)

    def _flush(self, dst: str) -> None:
        """Deliver every stashed (reordered) message for ``dst`` —
        their synthesized acks were already returned, so the replies
        go nowhere; the content lands late, which is the point."""
        for wire in self._stash.pop(dst, []):
            self.inner.deliver(wire)

    # -- the wrapped call --------------------------------------------------

    def call(self, dst: str, msg_class: str, payload: Dict[str, Any],
             *, trace: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        fault = self._pick(msg_class)
        wire = self.inner.serialize(dst, msg_class, payload, trace)
        if fault == "drop":
            self._emit(fault, msg_class, dst)
            raise TransportTimeout(
                f"{msg_class} to {dst} dropped in flight")
        if fault == "corrupt":
            self._emit(fault, msg_class, dst)
            wire = self._corrupt(wire, msg_class)
        if fault == "reorder":
            # stash; the sender gets an optimistic synthesized ack and
            # the content lands after the NEXT message to this dst
            self._emit(fault, msg_class, dst)
            self._stash.setdefault(dst, []).append(wire)
            return {"ok": True, "reordered": True}
        if msg_class == "kv_commit":
            # the commit fences the data plane: reordered pages land
            # before it, so order-independent reassembly always sees
            # everything that was actually sent
            self._flush(dst)
        reply = self.inner.deliver(wire)
        if fault == "duplicate":
            self._emit(fault, msg_class, dst)
            self.inner.deliver(wire)   # msg-id memo: processed once
        self._flush(dst)
        if fault == "delay":
            # delivered AND processed — only the reply is late.  The
            # sender's retry re-delivers work the receiver already
            # did; idempotency makes that harmless.
            self._emit(fault, msg_class, dst)
            raise TransportTimeout(
                f"{msg_class} to {dst}: reply past the virtual budget")
        return self.inner.deserialize_reply(reply)
