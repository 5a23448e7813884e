"""The serving engine: the device-facing half of continuous batching
(port of the JAX package's ``apex_tpu/serving/engine.py``: the default
mode, the quantized pool, speculative decoding, chunked prefill and
prefix sharing).

:class:`ServingEngine` turns the :class:`~apex_tpu_torch.serving.
scheduler.ContinuousBatchingScheduler`'s host-side decisions into device
steps:

* **prefill** — one fixed-width packed row (``[1, prefill_budget]``
  tokens + segment ids + positions, ONE request per row at offset 0)
  through :meth:`~apex_tpu_torch.serving.model.PagedDecoder.prefill`; the
  engine scatters the returned per-layer K/V into the request's freshly
  allocated pages and samples the first token greedily.
* **decode** — a fixed-width ``[max_batch]`` step through
  :meth:`~apex_tpu_torch.serving.model.PagedDecoder.decode`: append each
  row's newest K/V into its current page, attend over the row's page
  list, sample greedily.  Idle rows point at the scratch page.

With ``spec=SpecConfig(k, proposer, chunk_size)`` two more steps run
through :meth:`~apex_tpu_torch.serving.model.PagedDecoder.extend`:

* **verify** (``[max_batch, k + 1]``) — a host-side proposer drafts up
  to ``k`` tokens a request; one step scores every row's last committed
  token and draft, commits the longest prefix the model's own argmax
  endorses plus the bonus token, and rolls the rest back by ``kv_len``
  and page accounting.  A row without a draft is a decode step computed
  at the verify shape; when no row has a draft the decode step runs.
* **chunk** (``[1, chunk_size]``) — a context longer than ``chunk_size``
  is prefilled one chunk a step against the pages earlier chunks filled,
  interleaved with decode steps.  Only the last chunk reads a token
  back.

``prefix_sharing=True`` (which needs ``chunk_size``) registers every
finished prefill's page-aligned prefix in a
:class:`~apex_tpu_torch.serving.kv_cache.PrefixIndex`; a later request
with the same prompt head shares those pages and prefills only its
suffix, copying a page first where the hit ends mid-page.

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
reads back ONE result (the sampled token ids; the verify step's
``[max_batch, k + 1]`` argmax ids; nothing for a chunk that is not the
last): one wait for the device's work per step, as the JAX engine's
``np.asarray`` of its argmax.

With speculation on, a decode-phase token comes from a verify step or,
when no row of the batch has a draft, from the decode step: which one
depends on the other requests' drafts.  cuBLAS picks a GEMM's kernel by
its row count (on an H100 the MLP's down-projection rounds 0.16 % of its
outputs apart at 8 and 40 rows), and PyTorch's row reductions (the
LayerNorm means) pick their thread layout by it too.  So a speculative
engine runs its decode step idle-padded to the verify step's
``max_batch * (k + 1)`` rows (``decode_rows``): every decode-phase token
is computed at one row count, and batched == sequential holds with the
modes on.

``kv_quant="int8"`` or ``"fp8"`` stores the pool as codes plus fp32
per-(page, slot, head) scales: tokens are quantized on write (the
admission scatter and each decode step's append) and dequantized inside
the decode attention's kernel.  A quantized stream is deterministic and
batched == sequential like the default one, but is not the default
pool's stream.

The engine keeps plain counters in place of the JAX package's telemetry
bus: ``prefills`` (whole-row), ``decode_steps``, ``verify_steps``,
``chunk_steps``, ``spec_drafted``/``spec_accepted``/``spec_committed``
tokens, ``prefix_hits`` and ``cows``.

Not ported yet (ROADMAP.md), and refused when asked for: tensor
parallelism (``tp``), disaggregated prefill/decode (``prefill_only``/
``kv_import``), the telemetry bus, the watchdog, per-page CRC
validation, and ``snapshot``/``restore``/``recover``/``adopt``/
``adopt_prefilled``/``export_request``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.serving.kv_cache import PagedKVCache, PrefixIndex
from apex_tpu_torch.serving.model import (PagedDecoder, ServingModelConfig,
                                          init_params, params_to)
from apex_tpu_torch.serving.scheduler import (FINISHED, WAITING,
                                              ContinuousBatchingScheduler,
                                              QueueFullError, Request)
from apex_tpu_torch.serving.spec import (NgramProposer, SpecConfig,
                                         commit_tokens)

#: JAX engine options that have no port yet, with the value that means
#: "off"; any other value is refused.
_UNPORTED_OPTIONS = {"telemetry": None, "watchdog": None,
                     "validate_pages": False, "tp": 1,
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
    shed queued requests before their deadline expires.  ``kv_quant``
    (None, ``"int8"`` or ``"fp8"``) quantizes the KV pool.  ``spec`` (a
    :class:`SpecConfig`) turns on speculative decoding and/or chunked
    prefill; ``prefix_sharing`` (needs ``spec.chunk_size``) shares
    prompt prefixes through a :class:`PrefixIndex` of at most
    ``prefix_entries`` entries.

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
                 kv_quant: Optional[str] = None,
                 spec: Optional[SpecConfig] = None,
                 prefix_sharing: bool = False,
                 prefix_entries: int = 8,
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
        self.spec = spec
        self.spec_k = spec.k if spec is not None else 0
        self.chunk_size = spec.chunk_size if spec is not None else None
        self.proposer = None
        if self.spec_k > 0:
            self.proposer = (spec.proposer if spec.proposer is not None
                             else NgramProposer())
        self.prefix_entries = int(prefix_entries)
        # the decode step's row count: the verify step's when speculating
        # (module docstring), so a row rounds alike in either step
        self.decode_rows = max_batch * (self.spec_k + 1)
        if max_pages_per_request is None:
            # a chunked engine serves requests wider than the prefill
            # row, so its table reaches max_position (within the pool)
            cap = (cfg.max_position if self.chunk_size is not None
                   else self.prefill_budget)
            max_pages_per_request = min(-(-cap // page_size),
                                        max(1, num_pages - 1))
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_pages=num_pages,
            page_size=page_size, num_heads=cfg.num_heads,
            head_dim=cfg.head_dim,
            max_pages_per_request=max_pages_per_request,
            dtype=cfg.dtype, device=self.device, quantize=kv_quant)
        self.kv_quant = kv_quant
        self.prefix_index = (
            PrefixIndex(self.cache, max_entries=self.prefix_entries)
            if prefix_sharing else None)
        self.sched = ContinuousBatchingScheduler(
            self.cache, max_batch=max_batch,
            prefill_budget=self.prefill_budget,
            max_position=cfg.max_position,
            max_queue=max_queue, preempt_cap=preempt_cap,
            chunk_size=self.chunk_size, prefix_index=self.prefix_index)
        self.decoder = PagedDecoder(cfg)
        self.max_batch = max_batch
        self.clock = clock if clock is not None else time.monotonic
        self.shed_min_service_s = float(shed_min_service_s)
        self.reject_unservable = bool(reject_unservable)
        self.rejected: List[Request] = []
        self._next_rid = 0
        self.steps = 0
        # the step counts (each a device step of its kind), the
        # speculative tokens and the sharing events
        self.prefills = 0
        self.decode_steps = 0
        self.verify_steps = 0
        self.chunk_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self.prefix_hits = 0

    @property
    def cows(self) -> int:
        """Copy-on-writes made at admission."""
        return self.sched.cows

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

    def _decode(self, dev: torch.Tensor) -> torch.Tensor:
        """The decode step on the pool from one int32 operand row:
        tokens [b] | positions [b] | kv_len [b] | page_table [b, p_max]
        (with a quantized pool's scale planes), ``b = decode_rows``."""
        b, p_max = self.decode_rows, self.cache.max_pages_per_request
        return self.decoder.decode(
            self.params, self.cache.k, self.cache.v, dev[:b], dev[b:2 * b],
            dev[3 * b:].view(b, p_max), dev[2 * b:3 * b],
            k_scale=self.cache.k_scale, v_scale=self.cache.v_scale)

    def _extend_host(self, b: int, q: int):
        """The host operand row of an extend step (verify or chunk), all
        int32 and zero: tokens [b, q] | positions [b, q] | write pages
        [b, q] | write offsets [b, q] | kv_len [b] | page_table
        [b, p_max]; returns the row and a view of each part."""
        p_max = self.cache.max_pages_per_request
        n = b * q
        host = np.zeros(4 * n + b + b * p_max, np.int32)
        parts = [host[i * n:(i + 1) * n].reshape(b, q) for i in range(4)]
        parts += [host[4 * n:4 * n + b], host[4 * n + b:].reshape(b, p_max)]
        return host, parts

    def _extend(self, dev: torch.Tensor, b: int, q: int,
                last_only: bool = False) -> torch.Tensor:
        """The extend step on the pool from its operand row on the
        device (:meth:`_extend_host`'s layout)."""
        p_max = self.cache.max_pages_per_request
        n = b * q
        tok, pos, wp, wo = (dev[i * n:(i + 1) * n].view(b, q)
                            for i in range(4))
        return self.decoder.extend(
            self.params, self.cache.k, self.cache.v, tok, pos, wp, wo,
            dev[4 * n + b:].view(b, p_max), dev[4 * n:4 * n + b],
            last_only=last_only, k_scale=self.cache.k_scale,
            v_scale=self.cache.v_scale)

    @torch.no_grad()
    def warmup(self) -> float:
        """Run one prefill row, one admission scatter and one decode step
        (and, with the modes on, one verify step, one chunk step and one
        copy-on-write page copy) into the scratch page before any request
        arrives, so the first request pays for no kernel build, library
        load or cuBLAS set-up; returns the seconds spent.  No reader ever
        sees what the warm-up writes."""
        t0 = time.perf_counter()
        S, b = self.prefill_budget, self.max_batch
        z = self._to_device(np.zeros((1, S), np.int32))
        _, k, v = self.decoder.prefill(self.params, z, z, z, 0)
        zs = z[0]
        self.cache.write_tokens(k[:, 0], v[:, 0], zs, zs)
        p_max, rows = self.cache.max_pages_per_request, self.decode_rows
        host = np.zeros(3 * rows + rows * p_max, np.int32)
        host[2 * rows:3 * rows] = 1   # kv_len 1: each idle row sees its slot
        self._decode(self._to_device(host))
        if self.spec_k:
            # idle rows: kv_len == q_len, every column in scratch page 0
            qw = self.spec_k + 1
            host, parts = self._extend_host(b, qw)
            parts[4][:] = qw
            self._extend(self._to_device(host), b, qw)
        if self.chunk_size is not None:
            host, parts = self._extend_host(1, self.chunk_size)
            parts[4][:] = self.chunk_size
            self._extend(self._to_device(host), 1, self.chunk_size,
                         last_only=True)
        if self.prefix_index is not None:
            self.cache.warm_copy()
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
        self.prefills += 1
        req.kv_len = C
        self._register_prefix(ctx, req.pages)
        req.generated.append(int(logits[0, 0].argmax()))
        if req.first_token_t is None:
            req.first_token_t = self.clock()

    def _register_prefix(self, ctx: Sequence[int],
                         pages: List[int]) -> None:
        """Register the page-aligned prefix of a freshly prefilled
        context in the prefix index.  Aligned, so no registered page is
        one its owner still writes (every later write lands at positions
        ``>= len(ctx)``)."""
        if self.prefix_index is None:
            return
        ps = self.cache.page_size
        aligned = (len(ctx) // ps) * ps
        if aligned >= ps:
            self.prefix_index.register(ctx[:aligned],
                                       pages[:aligned // ps])

    def _check_private(self, pages, what: str) -> None:
        """Write-path guard: a step writing a page with refcount > 1
        would corrupt another reader's prefix.  By construction (aligned
        registration, copy-on-write at admission) it never fires."""
        if self.prefix_index is None:
            return
        for p in pages:
            if self.cache.is_shared(int(p)):
                raise RuntimeError(
                    f"{what} would write shared page {int(p)} "
                    "(refcount > 1) — copy-on-write missing")

    @torch.no_grad()
    def _decode_batch(self, rows: List[Request]) -> None:
        """One decode step for ``rows`` (<= max_batch), idle-padded to
        the fixed width ``decode_rows``."""
        b = self.decode_rows
        ps = self.cache.page_size
        p_max = self.cache.max_pages_per_request
        # tokens [b] | positions [b] | kv_len [b] | page_table [b, p_max]
        host = np.zeros(3 * b + b * p_max, np.int32)
        host[2 * b:3 * b] = 1
        for i, req in enumerate(rows):
            host[i] = req.generated[-1]
            host[b + i] = req.seq_len - 1
            host[2 * b + i] = req.seq_len
        self._check_private([r.pages[(r.seq_len - 1) // ps] for r in rows],
                            "decode append")
        host[3 * b:] = self.cache.page_table([r.pages for r in rows],
                                             rows=b).ravel()
        next_tok = self._decode(self._to_device(host)).argmax(-1).cpu().numpy()
        self.decode_steps += 1
        for i, req in enumerate(rows):
            req.kv_len = req.seq_len
            req.generated.append(int(next_tok[i]))

    @torch.no_grad()
    def _verify_batch(self, rows: List[Request],
                      drafts: Dict[int, List[int]]) -> None:
        """One speculative decode step: every row's last committed token
        and draft scored in ONE extend step (``q_len = k + 1``), each
        row's longest endorsed prefix plus the bonus token committed, the
        rest rolled back.

        Rows are FRONT-padded, so a row with a ``j``-token draft fills the
        last ``j + 1`` query rows and ``kv_len = seq_len + j`` keeps the
        causal alignment exact; a draft-less row is a decode step at the
        verify shape.  Rollback is accounting: ``kv_len`` advances over
        the committed draft rows only (K/V past it is never read, and is
        overwritten when the sequence grows back), and the pages grown
        for rejected rows go back to the pool (``free_tail``)."""
        b, qw = self.max_batch, self.spec_k + 1
        ps = self.cache.page_size
        host, (tokens, positions, wpages, woffs, kv_len,
               table) = self._extend_host(b, qw)
        kv_len[:] = qw                 # idle rows: kv_len == q_len
        row_draft: List[List[int]] = []
        written: List[int] = []
        for i, req in enumerate(rows):
            d = drafts.get(req.rid, [])
            row_draft.append(d)
            S, j = req.seq_len, len(d)
            pad = qw - (j + 1)
            pos = np.arange(S - 1, S + j)
            tokens[i, pad:] = [req.generated[-1]] + d
            positions[i, pad:] = pos
            pg = np.asarray(req.pages, np.int32)[pos // ps]
            wpages[i, pad:] = pg
            woffs[i, pad:] = pos % ps
            kv_len[i] = S + j
            written.extend(int(p) for p in pg)
        self._check_private(written, "verify append")
        table[:] = self.cache.page_table([r.pages for r in rows], rows=b)
        logits = self._extend(self._to_device(host), b, qw)
        next_tok = logits.argmax(-1).cpu().numpy()
        self.verify_steps += 1
        drafted = accepted = 0
        for i, req in enumerate(rows):
            d = row_draft[i]
            S, j = req.seq_len, len(d)
            out, n_draft_kv, a = commit_tokens(
                d, next_tok[i, qw - (j + 1):].tolist(), eos_id=req.eos_id,
                remaining=req.max_new_tokens - len(req.generated))
            req.generated.extend(out)
            req.kv_len = S + n_draft_kv
            # the next step's growth takes back, lowest first, the same
            # pages the committed tokens need
            self.cache.free_tail(
                req.pages, self.cache.pages_needed(max(req.seq_len,
                                                       req.kv_len)))
            drafted += j
            accepted += a
            self.spec_committed += len(out)
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        if self.proposer is not None:
            self.proposer.observe(drafted, accepted)

    @torch.no_grad()
    def _chunk_step(self, req: Request, start: int, n: int) -> None:
        """Advance one chunked prefill by ``n <= chunk_size`` tokens:
        K/V for context positions ``[start, start + n)`` computed against
        the pages earlier chunks (or a shared prefix) filled, through the
        fixed ``[1, chunk_size]`` extend step, front-padded.  The last
        chunk's last row gives the request's first token; earlier chunks
        read nothing back."""
        cs, ps = self.chunk_size, self.cache.page_size
        ctx = req.context
        need = self.cache.pages_needed(start + n)
        if len(req.pages) < need:
            raise RuntimeError(
                f"request {req.rid}: chunk [{start}, {start + n}) found "
                f"{len(req.pages)} reserved pages, needs {need} — pages "
                "must be reserved at admission")
        host, (tokens, positions, wpages, woffs, kv_len,
               table) = self._extend_host(1, cs)
        pad = cs - n
        pos = np.arange(start, start + n)
        tokens[0, pad:] = ctx[start:start + n]
        positions[0, pad:] = pos
        pg = np.asarray(req.pages, np.int32)[pos // ps]
        wpages[0, pad:] = pg
        woffs[0, pad:] = pos % ps
        kv_len[0] = start + n
        self._check_private(pg, "chunk scatter")
        table[:] = self.cache.page_table([req.pages], rows=1)
        logits = self._extend(self._to_device(host), 1, cs, last_only=True)
        self.chunk_steps += 1
        req.kv_len = start + n
        req.prefill_pos = start + n
        if req.prefill_pos >= len(ctx):
            # prefill complete: the request decodes from the next step
            req.prefill_pos = None
            self._register_prefix(ctx, req.pages)
            req.generated.append(int(logits[0, 0].argmax()))
            if req.first_token_t is None:
                req.first_token_t = self.clock()

    # -- the engine step ---------------------------------------------------

    def _retire(self, now: float) -> List[Request]:
        done = self.sched.retire_finished(now)
        if self.proposer is not None:
            for req in done:
                self.proposer.release(req.rid)
        return done

    def _expire(self, now: float) -> bool:
        """Deadline enforcement for this step boundary: shed queued
        requests that can no longer meet their SLO, time out running
        ones whose deadline passed (both release their proposer state)."""
        shed, timed_out = self.sched.expire_deadlines(
            now, min_service_s=self.shed_min_service_s)
        if self.proposer is not None:
            for req in shed + timed_out:
                self.proposer.release(req.rid)
        return bool(shed or timed_out)

    def _propose_drafts(self) -> Dict[int, List[int]]:
        """Each decode-ready row's draft, clamped so a commit can never
        pass ``max_new_tokens`` (nor, by the submit check, write past
        ``max_position``).  An empty draft means a plain decode row."""
        drafts: Dict[int, List[int]] = {}
        for req in self.sched.running:
            if req.prefill_pos is not None:
                continue   # mid-chunk: nothing to decode yet
            k_eff = min(self.spec_k,
                        req.max_new_tokens - len(req.generated) - 1)
            if k_eff <= 0:
                continue
            d = self.proposer.propose(req.rid, req.context, k_eff)
            if d:
                drafts[req.rid] = [int(t) for t in d[:k_eff]]
        return drafts

    def step(self) -> bool:
        """One engine iteration: expire deadlines -> retire -> admit,
        prefill and chunks -> retire -> drafts, grow/preempt -> decode or
        verify.  Returns True if any work was done."""
        now = self.clock()
        progress = self._expire(now)
        progress = bool(self._retire(now)) or progress
        if self.chunk_size is not None:
            chunk_plan, admitted = self.sched.schedule_prefill()
        else:
            chunk_plan, admitted = [], self.sched.admit()
        for req in admitted:
            req.admit_t = now
            self.prefix_hits += req.prefix_hit
            if req.prefill_pos is None:
                self._prefill_request(req)
            progress = True
        for req, start, n in chunk_plan:
            self._chunk_step(req, start, n)
            progress = True
        # a request whose budget was a single token is done at prefill
        progress = bool(self._retire(now)) or progress
        evicted: List[Request] = []
        drafts: Dict[int, List[int]] = {}
        if self.sched.running:
            if self.proposer is not None:
                drafts = self._propose_drafts()
            # growth covers each draft's K/V too; a row preempted while
            # growing drops out of this step, its draft unused
            evicted = self.sched.ensure_decode_capacity(
                extra={rid: len(d) for rid, d in drafts.items()} or None)
        rows = [r for r in self.sched.running if r.prefill_pos is None]
        if rows:
            if any(r.rid in drafts for r in rows):
                self._verify_batch(rows, drafts)
            else:
                self._decode_batch(rows)
            progress = True
        elif evicted or chunk_plan:
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
