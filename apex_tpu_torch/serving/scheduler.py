"""Continuous-batching scheduler: host-side admission / growth /
preemption / deadline / retirement policy (a copy of the JAX package's
``apex_tpu/serving/scheduler.py``).

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
* **chunked prefill** (``chunk_size``): a context longer than
  ``chunk_size`` is admitted into chunked prefill instead, one chunk of
  at most ``chunk_size`` tokens a step under the same budget
  (:meth:`ContinuousBatchingScheduler.schedule_prefill`); pages for the
  whole context are still reserved at admission.  A chunked scheduler
  lifts the prefill-row bound on request size.
* **prefix sharing** (``prefix_index``): admission looks up the longest
  registered prefix of the context, shares its pages and prefills only
  the suffix, always through the chunk path.  A hit ending mid-page
  copies that page at admission (copy-on-write).  Allocation pressure
  evicts index entries, oldest first, before it preempts live work.
* **growth**: before each decode step every running request crossing a
  page boundary gets one page (and, with ``extra``, the pages its draft's
  K/V will need).
* **preemption**: when growth finds the pool empty, the MOST RECENTLY
  admitted running request under ``preempt_cap`` preemptions is evicted:
  its pages are freed, its generated tokens kept, and it rejoins the
  FRONT of the waiting queue; re-admission re-prefills prompt +
  generated tokens (a mid-chunk victim starts its prefill over), so
  preemption is invisible in the output stream.
* **deadlines**: queued requests that can no longer meet ``deadline_s``
  are shed; running requests past it time out with their pages freed.
* **retirement**: EOS or ``max_new_tokens`` reached -> pages freed.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from apex_tpu_torch.serving.kv_cache import (PagedKVCache, PagePoolExhausted,
                                             PrefixIndex)

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
    # chunked prefill: context tokens already computed into pages; None
    # when not mid-chunk (whole-row prefill, or prefill complete).  A
    # preemption resets it: the prefill starts over
    prefill_pos: Optional[int] = None
    # the current admission covered a context prefix with shared pages
    prefix_hit: bool = False
    preemptions: int = 0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    finish_reason: Optional[str] = None
    # when the first token became STREAMABLE: first_token_t on a
    # colocated engine, the adoption on the decode engine for a shipped
    # request, whose ship wall (export -> adoption) is ship_s; TTFT runs
    # to stream_t
    stream_t: Optional[float] = None
    ship_s: float = 0.0

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
                 preempt_cap: Optional[int] = 4,
                 chunk_size: Optional[int] = None,
                 prefix_index: Optional[PrefixIndex] = None):
        if chunk_size is not None and chunk_size > prefill_budget:
            raise ValueError(
                f"chunk_size {chunk_size} exceeds the per-step prefill "
                f"budget {prefill_budget} — a chunk could never launch")
        if prefix_index is not None and chunk_size is None:
            # a hit's suffix is prefilled against the shared pages, which
            # only the chunk step can do
            raise ValueError(
                "prefix sharing requires chunked prefill "
                "(chunk_size=None)")
        self.cache = cache
        self.max_batch = max_batch
        self.prefill_budget = prefill_budget
        self.max_position = max_position
        self.max_queue = max_queue
        self.preempt_cap = preempt_cap
        self.chunk_size = chunk_size
        self.prefix_index = prefix_index
        self.cows = 0                      # copy-on-writes at admission
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
        if worst > self.prefill_budget and self.chunk_size is None:
            # a preempted request must always fit the prefill row again;
            # a chunked scheduler prefills any context in chunks
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
        bug).  Whole-row only: a chunked scheduler plans through
        :meth:`schedule_prefill`."""
        if self.chunk_size is not None:
            raise RuntimeError(
                "admit() on a chunked scheduler — use schedule_prefill()")
        _, admitted = self.schedule_prefill()
        return admitted

    def schedule_prefill(self) -> Tuple[list, List[Request]]:
        """Plan this step's prefill work under the shared prefill-token
        budget; returns ``(chunks, admitted)``.

        ``chunks``: ``(request, start, n_tokens)`` launches in order, one
        chunk for each request already mid-chunk (admission order), then
        the first chunk of each request admitted now into chunked
        prefill.  ``admitted``: the requests admitted now, pages for the
        whole context reserved; those taking the whole-row prefill
        (contexts up to ``chunk_size``, or any without chunking) appear
        only here.  A chunk costs its tokens, a whole-row admission its
        context, a chunked admission its first chunk.  The first failure
        stops each phase (FIFO)."""
        budget = self.prefill_budget
        chunks: list = []
        if self.chunk_size is not None:
            for req in self.running:
                if req.prefill_pos is None:
                    continue
                n = min(self.chunk_size, req.seq_len - req.prefill_pos)
                if n > budget:
                    break
                chunks.append((req, req.prefill_pos, n))
                budget -= n
        admitted: List[Request] = []
        while self.waiting and \
                len(self.running) + len(admitted) < self.max_batch:
            req = self.waiting[0]
            ctx = req.seq_len
            m, shared = (0, [])
            if self.prefix_index is not None:
                m, shared = self.prefix_index.lookup(req.context)
            if m:
                chunked = True
                need = min(self.chunk_size, ctx - m)
            else:
                chunked = (self.chunk_size is not None
                           and ctx > self.chunk_size)
                need = self.chunk_size if chunked else ctx
            if need > budget:
                break
            if shared:
                # pinned first: an eviction below may otherwise free them
                self.cache.share(shared)
            try:
                fresh = self._allocate_evicting(
                    self.cache.pages_needed(ctx) - len(shared), req.rid)
            except PagePoolExhausted:
                if shared:
                    self.cache.free(shared)
                if not self.running and not admitted:
                    raise
                break
            pages = list(shared) + fresh
            if m % self.cache.page_size:
                # the hit ends mid-page: the first chunk writes position m
                # into the last shared page, so it is copied now, while
                # exhaustion is still an ordinary stop-admitting event
                try:
                    self._privatize(pages, m // self.cache.page_size,
                                    req.rid)
                except PagePoolExhausted:
                    self.cache.free(pages)
                    if not self.running and not admitted:
                        raise
                    break
            self.waiting.popleft()
            req.pages = pages
            req.state = RUNNING
            req.prefix_hit = bool(m)
            budget -= need
            if chunked:
                req.prefill_pos = m
                chunks.append((req, m, min(self.chunk_size, ctx - m)))
            admitted.append(req)
        self.running.extend(admitted)
        return chunks, admitted

    def _allocate_evicting(self, n: int, rid: int) -> List[int]:
        """:meth:`PagedKVCache.allocate`, evicting prefix-index entries
        (oldest first) under pressure before it gives up."""
        while True:
            try:
                return self.cache.allocate(n, rid)
            except PagePoolExhausted:
                if self.prefix_index is None or \
                        len(self.prefix_index) == 0:
                    raise
                self.prefix_index.evict_one()

    def _privatize(self, pages: List[int], idx: int, rid: int) -> None:
        """Copy-on-write ``pages[idx]`` in place for ``rid``, evicting
        index entries under pressure.  If an eviction leaves the caller
        the page's only reader, no copy is needed."""
        while self.cache.is_shared(pages[idx]):
            try:
                pages[idx] = self.cache.cow(pages[idx], rid)
                self.cows += 1
                return
            except PagePoolExhausted:
                if self.prefix_index is None or \
                        len(self.prefix_index) == 0:
                    raise
                self.prefix_index.evict_one()

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
        victim.prefill_pos = None
        victim.prefix_hit = False
        victim.state = WAITING
        victim.preemptions += 1
        self.waiting.appendleft(victim)
        return victim

    def ensure_decode_capacity(self, extra: Optional[Dict[int, int]]
                               = None) -> List[Request]:
        """Give every running request the page its next token needs,
        preempting from the back of the batch when the pool runs dry.
        ``extra`` maps a rid to more tokens of headroom this step (a
        draft's K/V, written at ``seq_len .. seq_len + draft - 1``).
        Prefix-index entries are evicted before anything is preempted.
        Returns the requests preempted."""
        evicted: List[Request] = []
        for req in list(self.running):
            while req in self.running:
                want = req.seq_len + (extra.get(req.rid, 0)
                                      if extra else 0)
                need_pages = self.cache.pages_needed(want)
                if len(req.pages) >= need_pages:
                    break
                try:
                    req.pages.extend(self.cache.allocate(
                        need_pages - len(req.pages), req.rid))
                except PagePoolExhausted:
                    if self.prefix_index is not None and \
                            len(self.prefix_index):
                        self.prefix_index.evict_one()
                        continue
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
                req.prefill_pos = None
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
