"""Continuous-batching scheduler: host-side admission / growth /
preemption / deadline / retirement policy (a copy of the JAX package's
``apex_tpu/serving/scheduler.py`` for the whole-row prefill engine).

Pure Python: it owns request lifecycles and the page accounting and
never touches device state.  Every decision is deterministic (FIFO
queues, lowest-first page allocation), so a seeded arrival trace
replays identically — and identically to the JAX package's scheduler.

* **admission**: FIFO over the waiting queue while a batch slot is open,
  this step's prefill-token budget has room for the request's context,
  and the pool can supply its context pages.  ``prefill_budget`` is both
  the fixed prefill row width (``submit`` rejects contexts that could
  outgrow it) and the per-step cap on admitted prefill tokens.  The
  first failure stops admission for the step.
* **growth**: before each decode step every running request crossing a
  page boundary gets one page.
* **preemption**: when growth finds the pool empty, the MOST RECENTLY
  admitted running request under ``preempt_cap`` preemptions is evicted:
  its pages are freed, its generated tokens kept, and it rejoins the
  FRONT of the waiting queue; re-admission re-prefills prompt +
  generated tokens, so preemption is invisible in the output stream.
* **deadlines**: queued requests that can no longer meet ``deadline_s``
  are shed; running requests past it time out with their pages freed.
* **retirement**: EOS or ``max_new_tokens`` reached -> pages freed.

Chunked prefill and prefix sharing are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from apex_tpu_torch.serving.kv_cache import PagedKVCache, PagePoolExhausted

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"


class QueueFullError(RuntimeError):
    """The bounded submit queue is full — the overload reject signal,
    not an error in the request itself."""


@dataclasses.dataclass
class Request:
    """One serving request and its runtime state."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_t: float = 0.0
    # completion deadline, seconds after arrival (None = no SLO); stored
    # relative so serve()'s arrival rebase moves it too
    deadline_s: Optional[float] = None
    # runtime
    state: str = WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    kv_len: int = 0               # tokens whose K/V sit in the pool
    preemptions: int = 0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    finish_reason: Optional[str] = None

    @property
    def deadline_t(self) -> Optional[float]:
        """Absolute deadline on the engine clock (None = no SLO)."""
        if self.deadline_s is None:
            return None
        return self.arrival_t + self.deadline_s

    @property
    def context(self) -> List[int]:
        """Tokens whose K/V must be cached at (re-)admission: the prompt
        plus everything generated before a preemption."""
        return self.prompt + self.generated

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.generated \
                and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens


class ContinuousBatchingScheduler:
    """Admission/growth/preemption/retirement over a shared page pool."""

    def __init__(self, cache: PagedKVCache, *, max_batch: int,
                 prefill_budget: int, max_position: int,
                 max_queue: Optional[int] = None,
                 preempt_cap: Optional[int] = 4):
        self.cache = cache
        self.max_batch = max_batch
        self.prefill_budget = prefill_budget
        self.max_position = max_position
        self.max_queue = max_queue
        self.preempt_cap = preempt_cap
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []   # admission order
        self.finished: List[Request] = []

    # -- intake ----------------------------------------------------------

    def check_servable(self, req: Request) -> None:
        """Raise ``ValueError`` if ``req`` could NEVER be served by this
        scheduler's geometry, so capacity failures later are always
        transient."""
        worst = len(req.prompt) + req.max_new_tokens
        if worst > self.max_position:
            raise ValueError(
                f"request {req.rid}: prompt+max_new {worst} exceeds "
                f"max_position {self.max_position}")
        if self.cache.pages_needed(worst) > \
                self.cache.max_pages_per_request:
            raise ValueError(
                f"request {req.rid}: needs up to "
                f"{self.cache.pages_needed(worst)} pages > "
                f"max_pages_per_request "
                f"{self.cache.max_pages_per_request}")
        if worst > self.prefill_budget:
            # a preempted request must always fit the prefill row again
            raise ValueError(
                f"request {req.rid}: prompt+max_new {worst} exceeds "
                f"prefill budget {self.prefill_budget}")

    def submit(self, req: Request) -> None:
        """Queue a request; rejects up front what could never be served
        and raises :class:`QueueFullError` when the bounded queue is
        full."""
        self.check_servable(req)
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            raise QueueFullError(
                f"request {req.rid}: submit queue full "
                f"({len(self.waiting)}/{self.max_queue})")
        self.waiting.append(req)

    # -- admission -------------------------------------------------------

    def admit(self) -> List[Request]:
        """Admit FIFO-eligible requests for this step (pages for the
        whole context allocated, state RUNNING).  Never raises on
        capacity — a full pool just admits fewer — unless nothing runs
        and the head request's context alone exceeds the pool (a sizing
        bug)."""
        budget = self.prefill_budget
        admitted: List[Request] = []
        while self.waiting and \
                len(self.running) + len(admitted) < self.max_batch:
            req = self.waiting[0]
            ctx = req.seq_len
            if ctx > budget:
                break
            try:
                pages = self.cache.allocate(self.cache.pages_needed(ctx),
                                            req.rid)
            except PagePoolExhausted:
                if not self.running and not admitted:
                    raise
                break
            self.waiting.popleft()
            req.pages = pages
            req.state = RUNNING
            budget -= ctx
            admitted.append(req)
        self.running.extend(admitted)
        return admitted

    # -- growth / preemption ---------------------------------------------

    def preempt_one(self) -> Optional[Request]:
        """Evict the newest running request still under ``preempt_cap``
        (or the plain newest when all are capped): free its pages, keep
        its tokens, requeue it at the FRONT of the waiting queue."""
        if not self.running:
            return None
        victim = None
        if self.preempt_cap is not None:
            for req in reversed(self.running):
                if req.preemptions < self.preempt_cap:
                    victim = req
                    break
        if victim is None:
            victim = self.running[-1]
        self.running.remove(victim)
        self.cache.free(victim.pages)
        victim.pages = []
        victim.kv_len = 0
        victim.state = WAITING
        victim.preemptions += 1
        self.waiting.appendleft(victim)
        return victim

    def ensure_decode_capacity(self) -> List[Request]:
        """Give every running request the page its next token needs,
        preempting from the back of the batch when the pool runs dry.
        Returns the requests preempted."""
        evicted: List[Request] = []
        for req in list(self.running):
            while req in self.running:
                need_pages = self.cache.pages_needed(req.seq_len)
                if len(req.pages) >= need_pages:
                    break
                try:
                    req.pages.extend(self.cache.allocate(
                        need_pages - len(req.pages), req.rid))
                except PagePoolExhausted:
                    # the victim can be ``req`` itself; the membership
                    # check then ends its growth and it waits its turn
                    evicted.append(self.preempt_one())
        return evicted

    # -- deadlines -------------------------------------------------------

    def expire_deadlines(self, now: float, *, min_service_s: float = 0.0
                         ) -> Tuple[List[Request], List[Request]]:
        """Enforce per-request deadlines; returns ``(shed, timed_out)``:
        queued requests that can no longer meet their deadline
        (``now + min_service_s`` at or past it) finish as ``"shed"``;
        running requests past it finish as ``"timeout"`` with their pages
        freed."""
        shed: List[Request] = []
        timed_out: List[Request] = []
        for req in list(self.waiting):
            dt = req.deadline_t
            if dt is not None and now + min_service_s >= dt:
                self.waiting.remove(req)
                self._finish(req, now, "shed")
                shed.append(req)
        for req in list(self.running):
            dt = req.deadline_t
            if req.done:
                continue  # complete, just not swept by retire_finished yet
            if dt is not None and now >= dt:
                self.running.remove(req)
                self.cache.free(req.pages)
                req.pages = []
                req.kv_len = 0
                self._finish(req, now, "timeout")
                timed_out.append(req)
        return shed, timed_out

    # -- retirement ------------------------------------------------------

    def retire_finished(self, now: float) -> List[Request]:
        """Move done requests out of the batch and free their pages."""
        done = [r for r in self.running if r.done]
        for req in done:
            self.running.remove(req)
            self.cache.free(req.pages)
            req.pages = []
            self._finish(req, now,
                         "eos" if req.eos_id is not None and req.generated
                         and req.generated[-1] == req.eos_id else "length")
        return done

    def _finish(self, req: Request, now: float, reason: str) -> None:
        req.state = FINISHED
        req.finish_t = now
        req.finish_reason = reason
        self.finished.append(req)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running
