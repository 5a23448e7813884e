"""Paged KV cache: a preallocated device page pool + host-side page
accounting (port of the JAX package's ``apex_tpu/serving/kv_cache.py``).

* ``k``/``v``: ``[num_layers, num_pages, page_size, num_heads,
  head_dim]`` device tensors, allocated ONCE.  A request's cache is a
  *page list*; pages need not be contiguous, so the pool never
  fragments and "grow by one token" is at most "append one page id".
* Page 0 is the reserved **scratch page**: it is never allocated, page
  tables pad their rows with it, and prefill padding positions scatter
  into it.  Readers never see its content (the decode attention masks
  every column past ``kv_len``), so duplicate pad writes landing in it
  are harmless.
* Host-side accounting (free list, per-page owner, per-page refcount) is
  plain Python; allocation is LOWEST-INDEX-FIRST, so every run of the
  scheduler is reproducible.
* A **quantized pool** (``quantize="int8"``/``"fp8"``): the pool holds
  narrow codes (``torch.int8`` / ``torch.float8_e4m3fn``) plus
  per-(page, slot, head) fp32 scales ``k_scale``/``v_scale``
  ``[num_layers, num_pages, page_size, num_heads]``; tokens are
  quantized on write (:func:`quantize_tokens`) and dequantized on read in
  ``flash_decode``.

Unlike the JAX package, whose arrays are immutable (``.at[].set``
returns a new pool and the cache re-binds it), the pool here is updated
IN PLACE (``index_put_`` in :meth:`PagedKVCache.write_tokens` and in the
decode step's append): one admission or decode step never copies the
pool.  An fp8 pool is written through a uint8 view of the same bytes
(``ops.attention.code_bytes``), since not every build scatters float8
tensors.

**Prefix sharing.**  A page may have several readers (refcount > 1):
live requests and the :class:`PrefixIndex`, which keeps a finished
prefill's page-aligned prefix warm for later requests with the same
prompt head.  A shared page's content is immutable; a writer first takes
a private copy (:meth:`PagedKVCache.cow`, a plain page copy of K, V and
a quantized pool's scale planes).

Not ported yet (ROADMAP.md): per-page CRC validation, page export/import
and defrag.
"""

from __future__ import annotations

import bisect
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.attention import code_bytes


#: qmax per quantization mode: int8 symmetric [-127, 127] (the -128 code is
#: unused so the grid is symmetric), fp8 e4m3 saturates at 448
_QUANT_QMAX = {"int8": 127.0, "fp8": 448.0}


def quant_pool_dtype(mode: str) -> torch.dtype:
    """Dtype of the quantized pool's code tensors."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantize mode {mode!r} "
                     f"(expected one of {sorted(_QUANT_QMAX)})")


def quantize_tokens(x: torch.Tensor, qdtype: torch.dtype, qmax: float):
    """``x`` [..., H, D] -> (codes [..., H, D] ``qdtype``, scale [..., H]
    fp32), the JAX package's ``quantize_tokens`` bit for bit.

    The scale is a pure per-(token, head) function of that token's own
    values: absmax over D divided by ``qmax``, with absmax 0 mapped to
    scale 1 so zero rows stay exactly zero.  So quantizing a token on its
    decode append and on a bulk prefill write give the same bytes.  The
    divisor is a tensor, not a Python number: PyTorch's CUDA division by
    a scalar multiplies by its rounded reciprocal, which would move some
    scales by an ulp on the card against the CPU and JAX."""
    xf = x.float()
    absmax = xf.abs().amax(-1)
    scale = torch.where(absmax == 0.0, 1.0,
                        absmax / torch.full_like(absmax, qmax))
    codes = xf / scale[..., None]
    if qdtype == torch.int8:
        codes = codes.round().clamp(-qmax, qmax)
    return codes.to(qdtype), scale


class PagePoolExhausted(RuntimeError):
    """No free pages left — the scheduler's cue to preempt, never an
    OOM: the pool size is fixed at construction and allocation failure
    is an ordinary, recoverable scheduling event."""


class PagePoolCorruption(RuntimeError):
    """A pool page's content no longer matches its recorded checksum.
    Raised by the per-page validation the JAX package has; kept here so
    callers can name it, though the validation itself is not ported yet."""


class PagedKVCache:
    """Fixed-size paged KV pool shared by all in-flight requests.

    ``max_pages_per_request`` fixes the page-table width ``p_max`` —
    every decode step sees a ``[batch, p_max]`` table.  ``device=None``
    means the card.  ``dtype`` is the compute dtype of the tokens fed to
    :meth:`write_tokens`; ``quantize`` (None, ``"int8"`` or ``"fp8"``)
    stores them as codes plus fp32 scales."""

    def __init__(self, *, num_layers: int, num_pages: int, page_size: int,
                 num_heads: int, head_dim: int, max_pages_per_request: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 quantize: Optional[str] = None):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved scratch page)")
        if max_pages_per_request > num_pages - 1:
            raise ValueError(
                f"max_pages_per_request {max_pages_per_request} exceeds "
                f"the {num_pages - 1} allocatable pages")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.max_pages_per_request = max_pages_per_request
        self.dtype = dtype
        self.quantize = quantize
        pool_dtype = quant_pool_dtype(quantize) if quantize else dtype
        self.device = resolve_device(device)
        shape = (num_layers, num_pages, page_size, num_heads, head_dim)
        self.k = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self.qmax = _QUANT_QMAX[quantize] if quantize else None
        self.k_scale = self.v_scale = None
        if quantize:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        # sorted free list, lowest-first allocation: deterministic
        self._free: List[int] = list(range(1, num_pages))
        self._owner: Dict[int, int] = {}
        # every allocated page has one entry: allocate -> 1, share -> +1,
        # free -> -1, back on the free list only at zero
        self._ref: Dict[int, int] = {}

    # -- accounting ------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages referenced by more than one reader (live requests and/or
        the prefix index)."""
        return sum(1 for r in self._ref.values() if r > 1)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)  # ceil

    def allocate(self, n: int, owner: int) -> List[int]:
        """Take ``n`` free pages for ``owner`` (a request id) at
        refcount 1; raises :class:`PagePoolExhausted` — with the pool
        untouched — when fewer than ``n`` are free."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({self.pages_used}/{self.num_pages - 1} in use)")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._owner[p] = owner
            self._ref[p] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reader to each page: its content is immutable until
        the refcount drops back to 1 (writers :meth:`cow` first).  Raises
        on pages that are not currently allocated (sharing a free page
        would resurrect it)."""
        for p in pages:
            if p == 0 or p not in self._ref:
                raise ValueError(f"share of unallocated page {p}")
        for p in pages:
            self._ref[p] += 1

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def is_shared(self, page: int) -> bool:
        return self._ref.get(page, 0) > 1

    def owner_of(self, page: int) -> Optional[int]:
        return self._owner.get(page)

    def cow(self, page: int, owner: int) -> int:
        """Copy-on-write: give ``owner`` a private copy of the shared
        ``page`` and drop its reference to the original; returns the new
        page id, for the caller to swap into its page list before it
        writes.  K, V and a quantized pool's scale planes are copied on
        the device, in place.  Raises on an unshared page (a private page
        needs no copy) and :class:`PagePoolExhausted` when no page is
        free."""
        if self._ref.get(page, 0) < 2:
            raise ValueError(f"cow on unshared page {page} "
                             f"(refcount {self._ref.get(page, 0)})")
        [new] = self.allocate(1, owner)
        self._copy_page(page, new)
        self._ref[page] -= 1
        return new

    def _copy_page(self, src: int, dst: int) -> None:
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                code_bytes(t)[:, dst] = code_bytes(t)[:, src]

    def warm_copy(self) -> None:
        """Run the copy-on-write page copy once, scratch page 0 onto
        itself (its content unchanged, and no reader sees it), so the
        first shared-prefix admission meets no first-use cost."""
        self._copy_page(0, 0)

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the pool only
        when its refcount reaches zero.  The freed page's content is left
        in place — readers mask by ``kv_len``, so stale values are
        unreachable."""
        for p in pages:
            if p == 0 or p not in self._ref:
                raise ValueError(f"double free / scratch free: page {p}")
            self._ref[p] -= 1
            if self._ref[p] > 0:
                continue
            del self._ref[p]
            self._owner.pop(p, None)
            bisect.insort(self._free, p)

    def free_tail(self, pages: List[int], keep: int) -> None:
        """Free ``pages[keep:]`` IN PLACE (the rollback of a rejected
        speculative draft); a ``keep`` at or past the list length is a
        no-op.  Forbidden on shared pages: a rollback only ever covers a
        request's private tail."""
        if keep < 0:
            raise ValueError(f"free_tail keep={keep} must be >= 0")
        tail = pages[keep:]
        shared = [p for p in tail if self.is_shared(p)]
        if shared:
            raise ValueError(
                f"free_tail would roll back shared page(s) {shared} — "
                "rollback is only defined on a request's private tail")
        if tail:
            self.free(tail)
            del pages[keep:]

    # -- device-facing views ---------------------------------------------

    def page_table(self, page_lists: Sequence[Sequence[int]],
                   rows: Optional[int] = None) -> np.ndarray:
        """``[rows, max_pages_per_request]`` int32 HOST table, each row a
        request's page list in cache order, padded with the scratch page
        0.  (Host-side so the engine can ship it to the device together
        with the step's other small operands in one copy.)"""
        rows = len(page_lists) if rows is None else rows
        t = np.zeros((rows, self.max_pages_per_request), np.int32)
        for i, pages in enumerate(page_lists):
            if len(pages) > self.max_pages_per_request:
                raise ValueError(
                    f"page list of {len(pages)} exceeds "
                    f"max_pages_per_request={self.max_pages_per_request}")
            t[i, :len(pages)] = pages
        return t

    def write_tokens(self, k_new: torch.Tensor, v_new: torch.Tensor,
                     pages: torch.Tensor, offsets: torch.Tensor) -> None:
        """Scatter per-token K/V into the pool, in place (the prefill
        fill path).  ``k_new``/``v_new``: ``[num_layers, T, num_heads,
        head_dim]``; token t lands in ``(pages[t], offsets[t])`` (int
        tensors on the pool's device).  Padding positions point at the
        scratch page 0.  A quantized pool quantizes on write: codes and
        per-(slot, head) scales are scattered together."""
        if self.quantize:
            kq, ks = quantize_tokens(k_new, self.k.dtype, self.qmax)
            vq, vs = quantize_tokens(v_new, self.v.dtype, self.qmax)
            self.k_scale[:, pages, offsets] = ks
            self.v_scale[:, pages, offsets] = vs
            k_new, v_new = kq, vq
        code_bytes(self.k)[:, pages, offsets] = code_bytes(k_new)
        code_bytes(self.v)[:, pages, offsets] = code_bytes(v_new)


class PrefixIndex:
    """Prompt-prefix registry behind page sharing.

    Maps a prefilled context (a token tuple) to the pages holding its
    K/V, taking its OWN reference on every page (:meth:`PagedKVCache.
    share`), so an entry outlives the request that built it.  Admission
    asks :meth:`lookup` for the longest registered prefix of a new
    context; on a hit the covered tokens are not prefilled again.  The
    coverage is capped at ``len(context) - 1`` tokens, so every request
    still computes its last prompt token (whose logits give the first
    token).  At most ``max_entries`` entries; eviction is oldest-first
    and drops only the index's reference: a page a live request reads
    stays allocated."""

    def __init__(self, cache: PagedKVCache, *, max_entries: int = 8):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.cache = cache
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[Tuple[int, ...], List[int]]" = \
            OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[Tuple[int, ...]]:
        return list(self._entries)

    def register(self, tokens: Sequence[int],
                 pages: Sequence[int]) -> bool:
        """Register a finished prefill's context and its pages (the
        request keeps its own references; the index adds one).  Contexts
        shorter than a page and known keys are not registered; ``pages``
        must be exactly the context's footprint."""
        key = tuple(int(t) for t in tokens)
        if len(key) < self.cache.page_size or key in self._entries:
            return False
        if len(pages) != self.cache.pages_needed(len(key)):
            raise ValueError(
                f"register: {len(pages)} pages for a {len(key)}-token "
                f"context (expected {self.cache.pages_needed(len(key))})")
        self.cache.share(pages)
        self._entries[key] = list(pages)
        while len(self._entries) > self.max_entries:
            self.evict_one()
        return True

    def lookup(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """The longest usable shared prefix of ``tokens``: ``(m, pages)``,
        the first ``m`` tokens covered by the entry's first
        ``ceil(m / page_size)`` pages, or ``(0, [])``.  ``m`` is at most
        ``len(tokens) - 1`` and at least a page.  When ``m`` ends
        mid-page the last shared page also holds the entry's tokens past
        ``m``: readers mask by their own ``kv_len``, and the new reader
        copies the page before its first write there."""
        ctx = tuple(int(t) for t in tokens)
        best_m, best_pages = 0, []
        for key, pages in self._entries.items():
            lim = min(len(key), len(ctx) - 1)
            m = 0
            while m < lim and key[m] == ctx[m]:
                m += 1
            if m >= self.cache.page_size and m > best_m:
                best_m = m
                best_pages = pages[:self.cache.pages_needed(m)]
        return best_m, list(best_pages)

    def evict_one(self) -> int:
        """Drop the oldest entry and the index's references; returns how
        many pages went back to the free list."""
        if not self._entries:
            return 0
        _, pages = self._entries.popitem(last=False)
        before = self.cache.pages_free
        self.cache.free(pages)
        return self.cache.pages_free - before

    def clear(self) -> int:
        """Evict every entry; returns the pages returned to the pool."""
        freed = 0
        while self._entries:
            freed += self.evict_one()
        return freed
