"""The serving engine: the device-facing half of continuous batching
(port of the JAX package's ``apex_tpu/serving/engine.py``, default mode).

:class:`ServingEngine` turns the :class:`~apex_tpu_torch.serving.
scheduler.ContinuousBatchingScheduler`'s host-side decisions into two
device steps:

* **prefill** — one fixed-width packed row (``[1, prefill_budget]``
  tokens + segment ids + positions, ONE request per row at offset 0)
  through :meth:`~apex_tpu_torch.serving.model.PagedDecoder.prefill`; the
  engine scatters the returned per-layer K/V into the request's freshly
  allocated pages and samples the first token greedily.
* **decode** — a fixed-width ``[max_batch]`` step through
  :meth:`~apex_tpu_torch.serving.model.PagedDecoder.decode`: append each
  row's newest K/V into its current page, attend over the row's page
  list, sample greedily.  Idle rows point at the scratch page.

**The isolation contract.**  Batched continuous decoding produces
exactly the tokens that submitting the requests one at a time produces,
at the same ``max_batch``: decode is row-wise, the attention kernels are
deterministic and row-independent, and every request is prefilled alone
in its own row.  On the card the GEMMs of a decode step always have
``max_batch`` rows, whatever the number of live requests, so cuBLAS picks
the same kernel either way; whether a different ``max_batch`` (another
GEMM shape) gives the same tokens is a separate question (ROADMAP.md).
For the same reason the engine turns off cuBLAS's reduced-precision
bf16 reductions (``allow_bf16_reduced_precision_reduction``, a
process-wide PyTorch setting): with them, a bf16 GEMM may sum in bf16
along a split reduction whose shape-dependent grouping perturbs logits.

Each step moves its small int operands to the device in ONE copy (from
pageable memory, so the host waits for that copy on an idle stream) and
reads back ONE result (the sampled token ids): one wait for the device's
work per step, as the JAX engine's ``np.asarray`` of its argmax.

Not ported yet (ROADMAP.md), and refused when asked for: speculative
decoding and chunked prefill (``spec``), tensor parallelism (``tp``),
the quantized pool (``kv_quant``), prefix sharing, disaggregated
prefill/decode (``prefill_only``/``kv_import``), the telemetry bus, the
watchdog, per-page CRC validation, and ``snapshot``/``restore``/
``recover``/``adopt``/``adopt_prefilled``/``export_request``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.serving.kv_cache import PagedKVCache
from apex_tpu_torch.serving.model import (PagedDecoder, ServingModelConfig,
                                          init_params, params_to)
from apex_tpu_torch.serving.scheduler import (FINISHED, WAITING,
                                              ContinuousBatchingScheduler,
                                              QueueFullError, Request)

#: JAX engine options that have no port yet, with the value that means
#: "off"; any other value is refused.
_UNPORTED_OPTIONS = {"telemetry": None, "watchdog": None,
                     "validate_pages": False, "spec": None, "tp": 1,
                     "kv_quant": None, "prefix_sharing": False,
                     "prefill_only": False, "kv_import": False}


class SimClock:
    """Deterministic virtual clock for tests: ``now()`` returns the
    current virtual time; the engine's step advances it by a fixed tick,
    so a seeded arrival trace replays identically with no wall clock in
    the loop."""

    def __init__(self, tick: float = 1.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self.tick


def poisson_trace(seed: int, n_requests: int, *, rate: float,
                  prompt_len: Tuple[int, int], max_new: Tuple[int, int],
                  vocab_size: int,
                  eos_id: Optional[int] = None,
                  deadline_s: Optional[Tuple[float, float]] = None,
                  rid_base: int = 0) -> List[Request]:
    """Seeded Poisson arrival trace: exponential inter-arrival gaps at
    ``rate`` requests/s, uniform prompt lengths and generation budgets —
    the same draws, in the same order, as the JAX package's generator,
    so one seed gives both engines the same trace."""
    rng = np.random.RandomState(seed)
    t = 0.0
    out: List[Request] = []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.randint(prompt_len[0], prompt_len[1] + 1))
        out.append(Request(
            rid=rid_base + rid,
            prompt=[int(x) for x in rng.randint(0, vocab_size, plen)],
            max_new_tokens=int(rng.randint(max_new[0], max_new[1] + 1)),
            eos_id=eos_id,
            arrival_t=t,
            deadline_s=(None if deadline_s is None else
                        float(rng.uniform(deadline_s[0], deadline_s[1]))),
        ))
    return out


def _not_ported(name: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"ServingEngine.{name} is not ported yet (ROADMAP.md, queue A)")
    method.__name__ = name
    return method


class ServingEngine:
    """Continuous-batching inference over a paged KV cache.

    ``num_pages``/``page_size`` size the shared pool; ``prefill_budget``
    fixes the packed prefill row width (default ``cfg.max_position``) and
    bounds prompt + generation per request; ``max_batch`` fixes the
    decode batch width.  ``clock`` is an optional ``() -> float`` (tests
    pass :class:`SimClock`); timing feeds metrics and, for requests with
    deadlines, the deadline policy.  ``max_queue`` bounds the submit
    queue (overflow -> ``rejected``), ``preempt_cap`` is the aging cap of
    evict-newest preemption, ``shed_min_service_s`` the SLO floor used to
    shed queued requests before their deadline expires.

    ``device=None`` means the card; without one the constructor raises
    instead of falling back.  ``device="cpu"`` runs the plain PyTorch
    versions of the kernels.  ``params`` (as :func:`init_params` makes
    them) are moved to ``device``; ``None`` draws them from ``seed``."""

    snapshot = _not_ported("snapshot")
    restore = _not_ported("restore")
    recover = _not_ported("recover")
    adopt = _not_ported("adopt")
    adopt_prefilled = _not_ported("adopt_prefilled")
    export_request = _not_ported("export_request")

    def __init__(self, cfg: ServingModelConfig, params=None, *,
                 num_pages: int, page_size: int = 64,
                 max_batch: int = 8,
                 max_pages_per_request: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 seed: int = 0,
                 max_queue: Optional[int] = None,
                 preempt_cap: Optional[int] = 4,
                 shed_min_service_s: float = 0.0,
                 reject_unservable: bool = False,
                 device=None,
                 **options):
        for name, value in options.items():
            if name not in _UNPORTED_OPTIONS:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value != _UNPORTED_OPTIONS[name]:
                raise NotImplementedError(
                    f"ServingEngine option {name}={value!r} is not ported "
                    "yet (ROADMAP.md, queue A)")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.cfg = cfg
        self.params = (init_params(cfg, seed, self.device) if params is None
                       else params_to(params, self.device))
        self.prefill_budget = (cfg.max_position if prefill_budget is None
                               else prefill_budget)
        if max_pages_per_request is None:
            max_pages_per_request = min(-(-self.prefill_budget // page_size),
                                        max(1, num_pages - 1))
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_pages=num_pages,
            page_size=page_size, num_heads=cfg.num_heads,
            head_dim=cfg.head_dim,
            max_pages_per_request=max_pages_per_request,
            dtype=cfg.dtype, device=self.device)
        self.sched = ContinuousBatchingScheduler(
            self.cache, max_batch=max_batch,
            prefill_budget=self.prefill_budget,
            max_position=cfg.max_position,
            max_queue=max_queue, preempt_cap=preempt_cap)
        self.decoder = PagedDecoder(cfg)
        self.max_batch = max_batch
        self.clock = clock if clock is not None else time.monotonic
        self.shed_min_service_s = float(shed_min_service_s)
        self.reject_unservable = bool(reject_unservable)
        self.rejected: List[Request] = []
        self._next_rid = 0
        self.steps = 0
        self.decode_steps = 0

    # -- intake ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               arrival_t: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Create and queue a request; returns its :class:`Request`
        handle (tokens accumulate on ``.generated``).  A full bounded
        queue does NOT raise: the returned request is already terminal
        (``finish_reason == "rejected"``)."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not prompt:
            raise ValueError("empty prompt")
        req = Request(rid=self._next_rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival_t=(self.clock() if arrival_t is None
                                 else arrival_t),
                      deadline_s=deadline_s)
        self._next_rid += 1
        return self._try_submit(req)

    def submit_request(self, req: Request) -> Request:
        """Queue a pre-built request (trace replay); rids must be unique
        per engine.  Same reject semantics as :meth:`submit`."""
        self._next_rid = max(self._next_rid, req.rid + 1)
        return self._try_submit(req)

    def _try_submit(self, req: Request) -> Request:
        """Queue ``req`` or reject it: a never-servable request raises
        ``ValueError`` (caller bug) unless ``reject_unservable``; a full
        queue finishes it as ``rejected``."""
        try:
            self.sched.submit(req)
        except QueueFullError:
            self._reject(req)
        except ValueError:
            if not self.reject_unservable:
                raise
            self._reject(req)
        return req

    def _reject(self, req: Request) -> None:
        req.state = FINISHED
        req.finish_t = self.clock()
        req.finish_reason = "rejected"
        self.rejected.append(req)

    # -- device steps ------------------------------------------------------

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(host).to(self.device)

    @torch.no_grad()
    def warmup(self) -> float:
        """Run one prefill row, one admission scatter and one decode step
        into the scratch page before any request arrives, so the first
        request pays for no kernel build, library load or cuBLAS
        set-up; returns the seconds spent.  No reader ever sees what the
        warm-up writes."""
        t0 = time.perf_counter()
        S, b = self.prefill_budget, self.max_batch
        z = self._to_device(np.zeros((1, S), np.int32))
        _, k, v = self.decoder.prefill(self.params, z, z, z, 0)
        zs = z[0]
        self.cache.write_tokens(k[:, 0], v[:, 0], zs, zs)
        p_max = self.cache.max_pages_per_request
        host = np.zeros(3 * b + b * p_max, np.int32)
        host[2 * b:3 * b] = 1   # kv_len 1: each idle row sees its own slot
        dev = self._to_device(host)
        self.decoder.decode(self.params, self.cache.k, self.cache.v,
                            dev[:b], dev[b:2 * b],
                            dev[3 * b:].view(b, p_max), dev[2 * b:3 * b])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @torch.no_grad()
    def _prefill_request(self, req: Request) -> None:
        """One fixed-width prefill for one request: compute K/V for the
        whole context (prompt + pre-preemption tokens), scatter it into
        the request's pages, sample the next token."""
        S = self.prefill_budget
        ctx = req.context
        C = len(ctx)
        ps = self.cache.page_size
        need = self.cache.pages_needed(C)
        if len(req.pages) < need:
            raise RuntimeError(
                f"request {req.rid}: prefill found {len(req.pages)} "
                f"reserved pages, context needs {need} — pages must be "
                "reserved at admission")
        # rows: tokens, segment ids, positions, then each packed
        # position's (page, offset); padding -> scratch page 0
        host = np.zeros((5, S), np.int32)
        idx = np.arange(C)
        host[0, :C] = ctx
        host[1, :C] = 1
        host[2, :C] = idx
        host[3, :C] = np.asarray(req.pages, np.int32)[idx // ps]
        host[4, :C] = idx % ps
        dev = self._to_device(host)
        logits, k, v = self.decoder.prefill(self.params, dev[0:1], dev[1:2],
                                            dev[2:3], C - 1)
        self.cache.write_tokens(k[:, 0], v[:, 0], dev[3], dev[4])
        req.kv_len = C
        req.generated.append(int(logits[0, 0].argmax()))
        if req.first_token_t is None:
            req.first_token_t = self.clock()

    @torch.no_grad()
    def _decode_batch(self, rows: List[Request]) -> None:
        """One decode step for ``rows`` (<= max_batch), idle-padded to
        the fixed batch width."""
        b = self.max_batch
        p_max = self.cache.max_pages_per_request
        # tokens [b] | positions [b] | kv_len [b] | page_table [b, p_max]
        host = np.zeros(3 * b + b * p_max, np.int32)
        host[2 * b:3 * b] = 1
        for i, req in enumerate(rows):
            host[i] = req.generated[-1]
            host[b + i] = req.seq_len - 1
            host[2 * b + i] = req.seq_len
        host[3 * b:] = self.cache.page_table([r.pages for r in rows],
                                             rows=b).ravel()
        dev = self._to_device(host)
        logits = self.decoder.decode(
            self.params, self.cache.k, self.cache.v, dev[:b], dev[b:2 * b],
            dev[3 * b:].view(b, p_max), dev[2 * b:3 * b])
        next_tok = logits.argmax(-1).cpu().numpy()
        for i, req in enumerate(rows):
            req.kv_len = req.seq_len
            req.generated.append(int(next_tok[i]))

    # -- the engine step ---------------------------------------------------

    def _retire(self, now: float) -> List[Request]:
        return self.sched.retire_finished(now)

    def _expire(self, now: float) -> bool:
        """Deadline enforcement for this step boundary: shed queued
        requests that can no longer meet their SLO, time out running
        ones whose deadline passed."""
        shed, timed_out = self.sched.expire_deadlines(
            now, min_service_s=self.shed_min_service_s)
        return bool(shed or timed_out)

    def step(self) -> bool:
        """One engine iteration: expire deadlines -> retire ->
        admit+prefill -> retire -> grow/preempt -> decode.  Returns True
        if any work was done."""
        now = self.clock()
        progress = self._expire(now)
        progress = bool(self._retire(now)) or progress
        for req in self.sched.admit():
            req.admit_t = now
            self._prefill_request(req)
            progress = True
        # a request whose budget was a single token is done at prefill
        progress = bool(self._retire(now)) or progress
        evicted = (self.sched.ensure_decode_capacity()
                   if self.sched.running else [])
        if self.sched.running:
            self._decode_batch(list(self.sched.running))
            self.decode_steps += 1
            progress = True
        elif evicted:
            progress = True
        self.steps += 1
        if isinstance(self.clock, SimClock):
            self.clock.advance()
        return progress

    # -- run and serve -----------------------------------------------------

    def run(self, max_steps: int = 100_000, *,
            raise_on_stall: bool = True) -> List[Request]:
        """Step until every queued request has finished; returns the
        finished list (scheduler order).  Exhausting ``max_steps`` with
        live requests is a stall: the engine raises, or returns the
        partial list under ``raise_on_stall=False``."""
        for _ in range(max_steps):
            if self.sched.idle:
                break
            self.step()
        else:
            if raise_on_stall:
                raise RuntimeError(
                    f"engine did not drain in {max_steps} steps")
        self._retire(self.clock())
        return self.sched.finished

    def serve(self, trace: Sequence[Request], *,
              max_steps: int = 1_000_000,
              raise_on_stall: bool = True) -> List[Request]:
        """Run an arrival trace: each request is submitted once the clock
        passes its arrival time; with a real clock the engine sleeps
        through idle gaps, with a :class:`SimClock` it advances virtual
        time.  Arrival times are RELATIVE to the start of the call and
        are rebased in place onto the engine clock, so requests are
        single-use: a request that is not fresh is refused up front."""
        pending = sorted(trace, key=lambda r: (r.arrival_t, r.rid))
        for req in pending:
            if req.state != WAITING or req.generated or req.pages \
                    or req.kv_len:
                raise ValueError(
                    f"request {req.rid} is not fresh "
                    f"(state={req.state!r}) — trace requests are "
                    "single-use; regenerate the trace")
        t_base = self.clock()
        for req in pending:
            req.arrival_t += t_base
        i = 0
        for _ in range(max_steps):
            now = self.clock()
            while i < len(pending) and pending[i].arrival_t <= now:
                self.submit_request(pending[i])
                i += 1
            if not self.sched.idle:
                self.step()
            elif i < len(pending):
                gap = pending[i].arrival_t - now
                if isinstance(self.clock, SimClock):
                    self.clock.advance()
                elif gap > 0:
                    time.sleep(min(gap, 0.05))
            else:
                break
        else:
            if raise_on_stall:
                raise RuntimeError(
                    f"trace did not drain in {max_steps} steps")
        self._retire(self.clock())
        return self.sched.finished
