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

**Telemetry.**  With ``telemetry=`` (a
:class:`~apex_tpu_torch.telemetry.TelemetryBus`) every lifecycle edge is
an event of the JAX package's schema, at the JAX engine's points and with
its fields — ``request_admit``, ``request_retire`` (TTFT/TPOT, and
``deadline_hit`` when the request had a deadline), ``decode_step``,
``request_reject``, ``request_timeout``, ``serving_recovery``,
``device_loss``, ``serving_stall`` — plus the ``span`` events of each
request's trace (``queue_wait``, ``admit``, ``prefill_chunk``,
``decode_wait``, ``decode_steps``, ``stream_emit``, ``kv_export``).
Events are host-side dicts: they read nothing from the device.  The
engine also keeps plain counters: ``prefills`` (whole-row),
``decode_steps`` (every decode boundary, decode or verify, as the JAX
engine counts them), ``verify_steps`` (the verify boundaries among
them), ``chunk_steps``, ``spec_drafted``/``spec_accepted``/
``spec_committed`` tokens, ``prefix_hits``, ``cows`` and ``recoveries``.

**Failure semantics.**  :meth:`ServingEngine.snapshot`/
:meth:`~ServingEngine.restore` capture the host-side serving state (queue
order and each request's tokens, the JAX engine's JSON key for key; KV
pages excluded — re-prefill rebuilds them), :meth:`~ServingEngine.adopt`
merges such records into a busy engine, and a
:class:`~apex_tpu_torch.resilience.chaos.DeviceLossError` or
:class:`~apex_tpu_torch.serving.kv_cache.PagePoolCorruption` raised
inside a step makes :meth:`run`/:meth:`serve` call
:meth:`~ServingEngine.recover` (a fresh pool, the live requests back at
the front of the queue; at most ``max_recoveries`` times).  Any other
error — a CUDA error, a kernel wrapper's refusal — propagates: a sticky
CUDA error leaves the context unusable, and no failure is hidden behind a
re-prefill.  ``validate_pages=True`` checks every page a step reads
against its CRC (``PagedKVCache(crc_pages=True)``); ``watchdog=`` arms a
:class:`~apex_tpu_torch.resilience.elastic.Watchdog` around every step.

**Disaggregated prefill and decode.**  A ``prefill_only`` engine admits
and prefills but never decodes; :meth:`~ServingEngine.export_request`
ships a prefilled request as a record and its pages' bytes
(:meth:`~apex_tpu_torch.serving.kv_cache.PagedKVCache.export_page_bytes`),
and a ``kv_import`` engine's :meth:`~ServingEngine.adopt_prefilled`
verifies the bytes, lands them verbatim and decodes on.

Not ported yet (ROADMAP.md), and refused when asked for: tensor
parallelism (``tp``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.resilience.chaos import DeviceLossError
from apex_tpu_torch.serving.kv_cache import (PagedKVCache, PagePoolCorruption,
                                             PagePoolExhausted, PrefixIndex,
                                             verify_page_payload)
from apex_tpu_torch.serving.model import (PagedDecoder, ServingModelConfig,
                                          init_params, params_to)
from apex_tpu_torch.serving.scheduler import (FINISHED, RUNNING, WAITING,
                                              ContinuousBatchingScheduler,
                                              QueueFullError, Request)
from apex_tpu_torch.serving.spec import (NgramProposer, SpecConfig,
                                         commit_tokens)

#: JAX engine options that have no port yet, with the value that means
#: "off"; any other value is refused.
_UNPORTED_OPTIONS = {"tp": 1}


class AdmissionRefused(RuntimeError):
    """A shipped-prefill admission (:meth:`ServingEngine.adopt_prefilled`)
    was refused for CAPACITY — no decode batch slot or no pool pages.
    Retryable, like :class:`~apex_tpu_torch.serving.kv_cache.
    PagePoolExhausted`: the sender backs off and retries.  Validation
    failures (geometry, rid collision, CRC) raise ``ValueError``
    instead."""


# -- the fault hook ----------------------------------------------------------
# The chaos tier installs an injector here to raise DeviceLossError, sleep
# or corrupt a page at a named engine event ("decode" before each decode
# or verify launch, with the decode-boundary count; "prefill" before each
# prefill or chunk launch, with the rid).  Production never sets it; the
# slot costs one None check a step.

_FAULT_HOOK: Optional[Callable[[str, int], None]] = None


def set_fault_hook(hook: Optional[Callable[[str, int], None]]):
    """Install (or clear) the serving fault hook; returns the previous
    hook so context-manager injectors can chain and restore it."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = hook
    return prev


def _fault_point(event: str, info: int) -> None:
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(event, info)


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

    ``telemetry`` is an optional :class:`~apex_tpu_torch.telemetry.
    TelemetryBus`; ``watchdog`` an optional :class:`~apex_tpu_torch.
    resilience.elastic.Watchdog` armed around every step;
    ``validate_pages`` turns on per-page CRC read-back validation in the
    pool; ``recover_on_fault`` lets :meth:`serve`/:meth:`run` absorb a
    ``DeviceLossError``/``PagePoolCorruption`` raised inside a step via
    :meth:`recover` (at most ``max_recoveries`` times, then the fault
    re-raises).  ``prefill_only`` makes an engine that admits and
    prefills but never decodes (its requests leave by
    :meth:`export_request`); ``kv_import`` warms the page import that
    :meth:`adopt_prefilled` lands shipped pages through.

    ``device=None`` means the card; without one the constructor raises
    instead of falling back.  ``device="cpu"`` runs the plain PyTorch
    versions of the kernels.  ``params`` (as :func:`init_params` makes
    them) are moved to ``device``; ``None`` draws them from ``seed``."""

    def __init__(self, cfg: ServingModelConfig, params=None, *,
                 num_pages: int, page_size: int = 64,
                 max_batch: int = 8,
                 max_pages_per_request: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 telemetry=None,
                 clock: Optional[Callable[[], float]] = None,
                 seed: int = 0,
                 max_queue: Optional[int] = None,
                 preempt_cap: Optional[int] = 4,
                 shed_min_service_s: float = 0.0,
                 watchdog=None,
                 validate_pages: bool = False,
                 recover_on_fault: bool = True,
                 max_recoveries: int = 3,
                 reject_unservable: bool = False,
                 spec: Optional[SpecConfig] = None,
                 kv_quant: Optional[str] = None,
                 prefix_sharing: bool = False,
                 prefix_entries: int = 8,
                 prefill_only: bool = False,
                 kv_import: bool = False,
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
            dtype=cfg.dtype, device=self.device, crc_pages=validate_pages,
            quantize=kv_quant)
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
        self.telemetry = telemetry
        self.clock = clock if clock is not None else time.monotonic
        self.shed_min_service_s = float(shed_min_service_s)
        self.watchdog = watchdog
        self.recover_on_fault = recover_on_fault
        self.max_recoveries = int(max_recoveries)
        self.reject_unservable = bool(reject_unservable)
        # disaggregation roles: a prefill_only engine never decodes, its
        # requests leave by export_request; kv_import warms the import of
        # shipped pages.  Both off is the colocated engine.
        self.prefill_only = bool(prefill_only)
        self.kv_import = bool(kv_import)
        self.recoveries = 0
        self.rejected: List[Request] = []
        self._next_rid = 0
        self.steps = 0
        # decode_steps counts every decode boundary (decode or verify
        # step), as the JAX engine does; the others count device steps of
        # their kind, the speculative tokens and the sharing events
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
        (``finish_reason == "rejected"``) and a ``request_reject`` event
        is emitted."""
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
        ``ValueError`` (caller bug) unless ``reject_unservable`` (then it
        finishes as ``rejected`` with ``reason="unservable"``); a full
        queue finishes it as ``rejected`` with ``reason="queue_full"``."""
        try:
            self.sched.submit(req)
        except QueueFullError:
            self._reject(req, "queue_full")
        except ValueError:
            if not self.reject_unservable:
                raise
            self._reject(req, "unservable")
        return req

    def _reject(self, req: Request, reason: str) -> None:
        req.state = FINISHED
        req.finish_t = self.clock()
        req.finish_reason = "rejected"
        self.rejected.append(req)
        self._emit("request_reject", rid=req.rid, reason=reason,
                   queue_depth=len(self.sched.waiting))

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
        copy-on-write page copy; with ``kv_import`` one page import, with
        ``prefill_only`` one page export) into the scratch page before any
        request arrives, so the first request pays for no kernel build,
        library load or cuBLAS set-up; returns the seconds spent.  No
        reader ever sees what the warm-up writes."""
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
        if self.kv_import:
            self.cache.warm_import()
        if self.prefill_only:
            self.cache.warm_export()
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
        _fault_point("prefill", req.rid)
        prefill_t0 = self.clock()
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
            # colocated: the token is streamable the instant it is
            # sampled (a shipped request's stream_t is its adoption)
            req.stream_t = req.first_token_t
        # a whole-row prefill is one prefill_chunk span over the context
        life = self._life(req)
        self._emit("span", rid=req.rid,
                   span_id=f"{req.rid}:prefill_chunk:{life}:0",
                   parent_id=f"{req.rid}:admit:{life}",
                   kind="prefill_chunk", t_start=prefill_t0,
                   t_end=self.clock())

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
        _fault_point("decode", self.decode_steps)
        # opt-in read-back validation: the pages this step attends over
        # must still match their recorded CRCs
        self.cache.verify_pages([req.pages for req in rows])
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
        written = [r.pages[(r.seq_len - 1) // ps] for r in rows]
        self._check_private(written, "decode append")
        host[3 * b:] = self.cache.page_table([r.pages for r in rows],
                                             rows=b).ravel()
        next_tok = self._decode(self._to_device(host)).argmax(-1).cpu().numpy()
        self.cache.refresh_page_crcs(written)
        for i, req in enumerate(rows):
            req.kv_len = req.seq_len
            req.generated.append(int(next_tok[i]))

    @torch.no_grad()
    def _verify_batch(self, rows: List[Request],
                      drafts: Dict[int, List[int]]) -> Tuple[int, int, int]:
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
        for rejected rows go back to the pool (``free_tail``).  Returns
        ``(drafted, accepted, committed)`` token counts for the
        ``decode_step`` event."""
        _fault_point("decode", self.decode_steps)
        self.cache.verify_pages([req.pages for req in rows])
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
        self.cache.refresh_page_crcs(written)
        self.verify_steps += 1
        drafted = accepted = committed = 0
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
            committed += len(out)
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_committed += committed
        if self.proposer is not None:
            self.proposer.observe(drafted, accepted)
        return drafted, accepted, committed

    @torch.no_grad()
    def _chunk_step(self, req: Request, start: int, n: int) -> None:
        """Advance one chunked prefill by ``n <= chunk_size`` tokens:
        K/V for context positions ``[start, start + n)`` computed against
        the pages earlier chunks (or a shared prefix) filled, through the
        fixed ``[1, chunk_size]`` extend step, front-padded.  The last
        chunk's last row gives the request's first token; earlier chunks
        read nothing back."""
        _fault_point("prefill", req.rid)
        t0 = self.clock()
        # this chunk attends over the pages earlier chunks filled: a
        # corrupted one must raise here, before the last chunk samples
        # the first token from it (pages not yet filled have no CRC)
        self.cache.verify_pages([req.pages])
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
        self.cache.refresh_page_crcs(int(p) for p in pg)
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
                req.stream_t = req.first_token_t
        life = self._life(req)
        self._emit("span", rid=req.rid,
                   span_id=f"{req.rid}:prefill_chunk:{life}:{start}",
                   parent_id=f"{req.rid}:admit:{life}",
                   kind="prefill_chunk", t_start=t0, t_end=self.clock())

    # -- the engine step ---------------------------------------------------

    def _emit(self, type_: str, **payload) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(type_, step=self.steps, **payload)

    @staticmethod
    def _life(req: Request) -> str:
        """The admission-life discriminator shared by every span of one
        (re)admission: ``preemptions`` alone is not unique across a
        re-admission, ``admit_t`` on the engine clock makes it so."""
        return f"{req.preemptions}:{req.admit_t:.6f}"

    def _retire(self, now: float) -> List[Request]:
        done = self.sched.retire_finished(now)
        for req in done:
            if self.proposer is not None:
                self.proposer.release(req.rid)
            n = len(req.generated)
            ev = dict(rid=req.rid, reason=req.finish_reason,
                      new_tokens=n, preemptions=req.preemptions)
            # TTFT runs to stream_t, when the first token became
            # streamable: a shipped request's ship wall lands in TTFT,
            # not in TPOT (colocated, stream_t == first_token_t)
            stream_t = (req.stream_t if req.stream_t is not None
                        else req.first_token_t)
            if req.first_token_t is not None:
                ev["ttft_ms"] = round((stream_t - req.arrival_t) * 1e3, 3)
                if req.ship_s > 0.0:
                    ev["ship_ms"] = round(req.ship_s * 1e3, 3)
                if n > 1 and req.finish_t is not None:
                    ev["tpot_ms"] = round(
                        (req.finish_t - stream_t) / (n - 1) * 1e3, 3)
            if req.deadline_t is not None and req.finish_t is not None:
                # a real bool, present only when a deadline existed
                ev["deadline_hit"] = bool(req.finish_t <= req.deadline_t)
            self._emit("request_retire", **ev)
            self._emit_retire_spans(req, stream_t, now)
        return done

    def _emit_retire_spans(self, req: Request, stream_t, now: float
                           ) -> None:
        """The decode-side tail of the request's trace, emitted once at
        retirement from host-side state: ``decode_wait`` (prefill done ->
        streamable), ``decode_steps`` (stream -> finish) and the
        ``stream_emit`` point span the TTFT decomposition ends at."""
        if self.telemetry is None or stream_t is None \
                or req.admit_t is None:
            return
        life = self._life(req)
        dw = f"{req.rid}:decode_wait:{life}"
        self._emit("span", rid=req.rid, span_id=dw,
                   parent_id=f"{req.rid}:admit:{life}",
                   kind="decode_wait", t_start=req.first_token_t,
                   t_end=stream_t)
        self._emit("span", rid=req.rid,
                   span_id=f"{req.rid}:decode_steps:{life}",
                   parent_id=dw, kind="decode_steps",
                   t_start=stream_t, t_end=now)
        self._emit("span", rid=req.rid,
                   span_id=f"{req.rid}:stream_emit:{life}",
                   parent_id=dw, kind="stream_emit",
                   t_start=stream_t, t_end=stream_t)

    def _expire(self, now: float) -> bool:
        """Deadline enforcement for this step boundary: shed queued
        requests that can no longer meet their SLO, time out running
        ones whose deadline passed (both release their proposer state);
        each is a ``request_timeout`` event saying where it was."""
        shed, timed_out = self.sched.expire_deadlines(
            now, min_service_s=self.shed_min_service_s)
        if self.proposer is not None:
            for req in shed + timed_out:
                self.proposer.release(req.rid)
        for req in shed:
            self._emit("request_timeout", rid=req.rid, where="queued",
                       overshoot_ms=round((now - req.deadline_t) * 1e3, 3))
        for req in timed_out:
            self._emit("request_timeout", rid=req.rid, where="running",
                       overshoot_ms=round((now - req.deadline_t) * 1e3, 3))
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
        verify.  Returns True if any work was done.  With a ``watchdog``
        the whole step runs under an armed deadline."""
        if self.watchdog is None:
            return self._step_body()
        with self.watchdog.step(self.steps):
            return self._step_body()

    def _step_body(self) -> bool:
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
            ctx_tokens = req.seq_len
            if req.prefill_pos is None:
                self._prefill_request(req)
            ev = dict(rid=req.rid, context_tokens=ctx_tokens,
                      pages=len(req.pages), preemptions=req.preemptions)
            if req.prefill_pos is not None:
                ev["chunked"] = True
            if self.prefix_index is not None:
                # on EVERY admission while sharing is on, hit or miss
                ev["prefix_hit"] = bool(req.prefix_hit)
            self._emit("request_admit", **ev)
            # every (re)admission opens a new life: queue_wait is a root
            # (arrival -> admission), admit its child (the admission and
            # a whole-row prefill; chunks have prefill_chunk spans)
            life = self._life(req)
            qid = f"{req.rid}:queue_wait:{life}"
            self._emit("span", rid=req.rid, span_id=qid,
                       kind="queue_wait", t_start=req.arrival_t, t_end=now)
            self._emit("span", rid=req.rid,
                       span_id=f"{req.rid}:admit:{life}",
                       parent_id=qid, kind="admit", t_start=now,
                       t_end=self.clock())
            progress = True
        for req, start, n in chunk_plan:
            self._chunk_step(req, start, n)
            progress = True
        # a request whose budget was a single token is done at prefill
        progress = bool(self._retire(now)) or progress
        evicted: List[Request] = []
        drafts: Dict[int, List[int]] = {}
        if self.sched.running and not self.prefill_only:
            if self.proposer is not None:
                drafts = self._propose_drafts()
            # growth covers each draft's K/V too; a row preempted while
            # growing drops out of this step, its draft unused
            evicted = self.sched.ensure_decode_capacity(
                extra={rid: len(d) for rid, d in drafts.items()} or None)
        # a prefill_only engine never decodes: finished prefills hold
        # their first token until export_request ships them
        rows = ([] if self.prefill_only else
                [r for r in self.sched.running if r.prefill_pos is None])
        if rows:
            t0 = self.clock()
            fields: Dict[str, Any] = {}
            if any(r.rid in drafts for r in rows):
                drafted, accepted, committed = self._verify_batch(rows,
                                                                  drafts)
                new_tokens = committed
                fields = {"spec_verify": True, "spec_drafted": drafted,
                          "spec_accepted": accepted}
            else:
                self._decode_batch(rows)
                new_tokens = len(rows)
            if self.prefix_index is not None:
                fields["pool_shared_pages"] = self.cache.pages_shared
            self.decode_steps += 1
            self._emit("decode_step", batch=len(rows),
                       new_tokens=new_tokens,
                       pool_used=self.cache.pages_used,
                       pool_pages=self.cache.num_pages - 1,
                       evicted=[r.rid for r in evicted],
                       step_ms=round((self.clock() - t0) * 1e3, 3),
                       **fields)
            progress = True
        elif evicted or chunk_plan:
            progress = True
        self.steps += 1
        if isinstance(self.clock, SimClock):
            self.clock.advance()
        return progress

    # -- serving state: snapshot, restore, adopt ---------------------------

    @staticmethod
    def _record(req: Request, was_running: bool) -> Dict[str, Any]:
        return {
            "rid": req.rid,
            "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id,
            "arrival_t": req.arrival_t,
            "deadline_s": req.deadline_s,
            "generated": list(req.generated),
            "preemptions": req.preemptions,
            "admit_t": req.admit_t,
            "first_token_t": req.first_token_t,
            "was_running": was_running,
        }

    @staticmethod
    def _from_record(r: Dict[str, Any]) -> Request:
        req = Request(
            rid=int(r["rid"]), prompt=list(r["prompt"]),
            max_new_tokens=int(r["max_new_tokens"]),
            eos_id=r["eos_id"], arrival_t=float(r["arrival_t"]),
            deadline_s=r["deadline_s"])
        req.generated = list(r["generated"])
        req.preemptions = int(r["preemptions"])
        req.admit_t = r["admit_t"]
        req.first_token_t = r["first_token_t"]
        return req

    def snapshot(self) -> Dict[str, Any]:
        """Serializable capture of the HOST-side serving state: queue
        order (running first, in admission order, then waiting) plus each
        live request's token state and counters — the JAX engine's JSON,
        key for key (``"format": 1``), so a snapshot of either engine
        restores into the other.  KV pages are excluded: re-prefill from
        the kept tokens rebuilds them."""
        return {
            "format": 1,
            "next_rid": self._next_rid,
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "requests": ([self._record(r, True) for r in self.sched.running]
                         + [self._record(r, False)
                            for r in self.sched.waiting]),
        }

    def restore(self, snap: Dict[str, Any]) -> List[Request]:
        """Rebuild serving state from a :meth:`snapshot` into THIS idle
        engine.  Every snapshotted request — running or waiting at
        capture — enters the waiting queue in snapshot order with no
        pages; the previously running ones are re-admitted first and
        re-prefilled, so the streams continue as the uninterrupted run's.
        Refusals (a busy engine, an unknown format, a request this
        engine's geometry cannot serve, more live requests than
        ``max_queue``) leave the engine untouched.  Returns the restored
        request handles."""
        if self.sched.running or self.sched.waiting:
            raise RuntimeError(
                "restore into a busy engine — serving state would be "
                "interleaved; restore only into a fresh engine")
        if snap.get("format") != 1:
            raise ValueError(
                f"unknown serving snapshot format {snap.get('format')!r}")
        restored = [self._from_record(r) for r in snap["requests"]]
        # validate before mutating anything, so a refusal is atomic
        live = [req for req in restored if not req.done]
        for req in live:
            self.sched.check_servable(req)
        if self.sched.max_queue is not None and \
                len(live) > self.sched.max_queue:
            raise ValueError(
                f"snapshot holds {len(live)} live requests > "
                f"max_queue {self.sched.max_queue}")
        for req in restored:
            if req.done:
                # captured between its last decode and its retirement:
                # re-admitting would overshoot max_new_tokens
                self._finish_restored(req)
            else:
                req.state = WAITING
                self.sched.waiting.append(req)
        self._next_rid = max(self._next_rid, int(snap["next_rid"]))
        self.steps = int(snap["steps"])
        self.decode_steps = int(snap["decode_steps"])
        return restored

    def adopt(self, records: Sequence[Dict[str, Any]]) -> List[Request]:
        """Admit snapshot-format request records into THIS possibly busy
        engine (the migration path; :meth:`restore` refuses a busy
        target).  Validation is atomic: every record must be servable by
        this engine's geometry, must not collide with a live rid, and the
        batch must fit the remaining ``max_queue`` headroom — all checked
        before any state changes.  Live records enter the waiting queue
        pageless (re-prefill rebuilds their KV); done ones retire at
        once.  Returns this engine's new request handles."""
        adopted = [self._from_record(r) for r in records]
        live = [req for req in adopted if not req.done]
        live_rids = ({q.rid for q in self.sched.running}
                     | {q.rid for q in self.sched.waiting})
        for req in live:
            self.sched.check_servable(req)
            if req.rid in live_rids:
                raise ValueError(
                    f"adopt: rid {req.rid} collides with a live "
                    "request — migration requires a fleet-global rid "
                    "namespace")
        if self.sched.max_queue is not None and \
                len(self.sched.waiting) + len(live) > self.sched.max_queue:
            raise ValueError(
                f"adopt: {len(live)} live records exceed queue "
                f"headroom ({len(self.sched.waiting)}/"
                f"{self.sched.max_queue} waiting)")
        for req in adopted:
            self._next_rid = max(self._next_rid, req.rid + 1)
            if req.done:
                self._finish_restored(req)
            else:
                req.state = WAITING
                self.sched.waiting.append(req)
        return adopted

    # -- disaggregated prefill and decode ----------------------------------

    def export_request(self, rid: int):
        """Detach a freshly prefilled request for shipping (the prefill
        side): serialize its KV pages
        (:meth:`~apex_tpu_torch.serving.kv_cache.PagedKVCache.
        export_page_bytes`, a CRC a page), capture its snapshot-format
        record (first token included in ``generated``), then release its
        pages here.  Returns ``(record, pages_payload, kv_len)``.

        The request must be RUNNING with its prefill complete and hold
        its first token.  Here it finishes as ``"shipped"`` (not counted
        in ``sched.finished``: it retires on the decode engine)."""
        req = next((r for r in self.sched.running if r.rid == rid), None)
        if req is None:
            raise ValueError(f"export_request: rid {rid} is not running")
        if req.prefill_pos is not None or not req.generated:
            raise ValueError(
                f"export_request: rid {rid} has not finished prefill")
        t0 = self.clock()
        pages_payload = [self.cache.export_page_bytes(p) for p in req.pages]
        # the export span opens the ship segment of the TTFT
        # decomposition; export_t/export_span ride the record so the
        # decode side can account the ship wall
        life = self._life(req)
        export_span = f"{req.rid}:kv_export:{life}"
        self._emit("span", rid=req.rid, span_id=export_span,
                   parent_id=f"{req.rid}:admit:{life}",
                   kind="kv_export", t_start=t0, t_end=self.clock())
        record = dict(self._record(req, True), export_t=t0,
                      export_span=export_span)
        kv_len = req.kv_len
        self.sched.running.remove(req)
        self.cache.free(req.pages)
        req.pages = []
        req.kv_len = 0
        req.state = FINISHED
        req.finish_reason = "shipped"
        if self.proposer is not None:
            self.proposer.release(req.rid)
        return record, pages_payload, kv_len

    def adopt_prefilled(self, record: Dict[str, Any],
                        pages_payload: Sequence[Dict[str, Any]],
                        kv_len: int) -> Request:
        """Admit one SHIPPED prefill straight into the decode batch (the
        decode side): verify each page payload on the host, allocate
        pages, land the bytes verbatim, and enter RUNNING with the
        source's token state — decode proceeds as if this engine had
        prefilled locally.

        Validation is atomic — geometry, rid collision, page count and
        every page's CRC checked before any state changes (a corrupted
        page is never adopted).  Capacity refusals (no decode batch slot,
        no pool pages) raise :class:`AdmissionRefused`, leaving the
        engine untouched."""
        kv_len = int(kv_len)
        req = self._from_record(record)
        self.sched.check_servable(req)
        live_rids = ({q.rid for q in self.sched.running}
                     | {q.rid for q in self.sched.waiting})
        if req.rid in live_rids:
            raise ValueError(
                f"adopt_prefilled: rid {req.rid} collides with a live "
                "request — shipping requires a fleet-global rid "
                "namespace")
        need = self.cache.pages_needed(kv_len)
        if len(pages_payload) != need:
            raise ValueError(
                f"adopt_prefilled: rid {req.rid} shipped "
                f"{len(pages_payload)} pages for kv_len {kv_len} "
                f"(expected {need})")
        for i, data in enumerate(pages_payload):
            if not verify_page_payload(data):
                raise ValueError(
                    f"adopt_prefilled: rid {req.rid} page {i} failed "
                    "CRC verification — corrupted in flight, refusing "
                    "to adopt")
        if len(self.sched.running) >= self.max_batch:
            raise AdmissionRefused(
                f"adopt_prefilled: decode batch full "
                f"({len(self.sched.running)}/{self.max_batch})")
        try:
            pages = self.cache.allocate(need, req.rid)
        except PagePoolExhausted as e:
            raise AdmissionRefused(str(e)) from e
        for page, data in zip(pages, pages_payload):
            self.cache.import_page_bytes(page, data)
        req.pages = pages
        req.kv_len = kv_len
        req.state = RUNNING
        self.sched.running.append(req)
        self._next_rid = max(self._next_rid, req.rid + 1)
        # the first token was sampled at export but is streamable only
        # now that its KV landed: adoption is stream_t, and the
        # export -> adopt wall is the request's ship time
        now = self.clock()
        req.stream_t = now
        export_t = record.get("export_t")
        if export_t is not None:
            req.ship_s = max(0.0, now - float(export_t))
        self._emit("request_admit", rid=req.rid,
                   context_tokens=kv_len, pages=len(pages),
                   preemptions=req.preemptions)
        return req

    # -- recovery ----------------------------------------------------------

    def _finish_restored(self, req: Request) -> None:
        """Retire a request that was already done when the fault hit (its
        last decode ran, its retirement had not).  The retire event
        carries no timing: the faulted run took those with it."""
        req.state = FINISHED
        req.finish_reason = (
            "eos" if req.eos_id is not None and req.generated
            and req.generated[-1] == req.eos_id else "length")
        self.sched.finished.append(req)
        if self.proposer is not None:
            self.proposer.release(req.rid)
        self._emit("request_retire", rid=req.rid, reason=req.finish_reason,
                   new_tokens=len(req.generated),
                   preemptions=req.preemptions)

    def recover(self, cause: str) -> None:
        """In-process recovery after a device loss or a page corruption:
        drop the pool (its content is garbage or gone), build a fresh one
        with the same geometry, quantization and CRC setting, and put
        every live request back on the waiting queue — running ones
        first, in admission order, tokens kept.  Re-admission re-prefills
        them, so the streams continue as an uninterrupted run's.  The
        prefix index starts empty (it pointed into the dropped pool) and
        the scheduler keeps its chunk size.  The caller's
        :class:`Request` handles stay live."""
        running = list(self.sched.running)
        waiting = list(self.sched.waiting)
        old = self.cache
        self.cache = None      # the dropped pool's memory goes first
        geometry = dict(num_layers=self.cfg.num_layers,
                        num_pages=old.num_pages, page_size=old.page_size,
                        num_heads=self.cfg.num_heads,
                        head_dim=self.cfg.head_dim,
                        max_pages_per_request=old.max_pages_per_request,
                        dtype=self.cfg.dtype, device=self.device,
                        crc_pages=old.crc_pages, quantize=self.kv_quant)
        del old
        self.cache = PagedKVCache(**geometry)
        if self.prefix_index is not None:
            self.prefix_index = PrefixIndex(
                self.cache, max_entries=self.prefix_entries)
        sched = ContinuousBatchingScheduler(
            self.cache, max_batch=self.max_batch,
            prefill_budget=self.prefill_budget,
            max_position=self.cfg.max_position,
            max_queue=self.sched.max_queue,
            preempt_cap=self.sched.preempt_cap,
            chunk_size=self.chunk_size,
            prefix_index=self.prefix_index)
        sched.finished = self.sched.finished   # history survives
        sched.cows = self.sched.cows
        self.sched = sched
        for req in running:
            req.pages = []
            req.kv_len = 0
            # a mid-chunk request starts its chunked prefill over
            req.prefill_pos = None
            if req.done:
                self._finish_restored(req)
            else:
                req.state = WAITING
                sched.waiting.append(req)
        sched.waiting.extend(waiting)
        self.recoveries += 1
        self._emit("serving_recovery", cause=cause, pool_rebuilt=True,
                   running_restored=len(running),
                   waiting_restored=len(waiting))

    def _handle_fault(self, exc: BaseException) -> None:
        """Absorb a recoverable fault via :meth:`recover`, or re-raise
        when recovery is off or its budget spent — a spent budget first
        dumps the flight recorder's ring (when the bus writes a file)."""
        if not self.recover_on_fault or \
                self.recoveries >= self.max_recoveries:
            if self.recover_on_fault and self.telemetry is not None:
                from apex_tpu_torch.telemetry.tracing import \
                    maybe_dump_flight_record

                maybe_dump_flight_record(
                    self.telemetry,
                    f"recovery_exhausted:{type(exc).__name__}",
                    step=self.steps)
            raise exc
        device_ids = getattr(exc, "device_ids", None)
        if device_ids is not None:
            self._emit("device_loss", device_ids=list(device_ids))
        cause = ("device_loss" if device_ids is not None
                 else "page_corruption")
        self.recover(cause=cause)

    # -- run and serve -----------------------------------------------------

    def _guarded_step(self) -> None:
        """One step with the recovery net: a device loss or a CRC-caught
        page corruption rebuilds and continues.  Nothing else is caught —
        a CUDA error or a kernel's refusal reaches the caller."""
        try:
            self.step()
        except (DeviceLossError, PagePoolCorruption) as e:
            self._handle_fault(e)

    def run(self, max_steps: int = 100_000, *,
            raise_on_stall: bool = True) -> List[Request]:
        """Step until every queued request has finished; returns the
        finished list (scheduler order).  Exhausting ``max_steps`` with
        live requests is a stall: a ``serving_stall`` event is emitted,
        then the engine raises, or returns the partial list under
        ``raise_on_stall=False``."""
        for _ in range(max_steps):
            if self.sched.idle:
                break
            self._guarded_step()
        else:
            self._emit("serving_stall", waiting=len(self.sched.waiting),
                       running=len(self.sched.running), budget=max_steps)
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
                self._guarded_step()
            elif i < len(pending):
                gap = pending[i].arrival_t - now
                if isinstance(self.clock, SimClock):
                    self.clock.advance()
                elif gap > 0:
                    time.sleep(min(gap, 0.05))
            else:
                break
        else:
            self._emit("serving_stall", waiting=len(self.sched.waiting),
                       running=len(self.sched.running), budget=max_steps)
            if raise_on_stall:
                raise RuntimeError(
                    f"trace did not drain in {max_steps} steps")
        self._retire(self.clock())
        return self.sched.finished
