"""Paged KV cache: a preallocated device page pool + host-side page
accounting (port of the JAX package's ``apex_tpu/serving/kv_cache.py``,
unquantized pool).

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

Unlike the JAX package, whose arrays are immutable (``.at[].set``
returns a new pool and the cache re-binds it), the pool here is updated
IN PLACE (``index_put_`` in :meth:`PagedKVCache.write_tokens` and in the
decode step's append): one admission or decode step never copies the
pool.

Not ported yet (ROADMAP.md): the int8/fp8 quantized pool, copy-on-write
and the prefix index, per-page CRC validation, page export/import and
defrag.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device


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
    means the card."""

    def __init__(self, *, num_layers: int, num_pages: int, page_size: int,
                 num_heads: int, head_dim: int, max_pages_per_request: int,
                 dtype: torch.dtype = torch.float32, device=None):
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
        self.device = resolve_device(device)
        shape = (num_layers, num_pages, page_size, num_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
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
        """Add one reader to each page.  Raises on pages that are not
        currently allocated (sharing a free page would resurrect it)."""
        for p in pages:
            if p == 0 or p not in self._ref:
                raise ValueError(f"share of unallocated page {p}")
        for p in pages:
            self._ref[p] += 1

    def is_shared(self, page: int) -> bool:
        return self._ref.get(page, 0) > 1

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
        scratch page 0."""
        self.k[:, pages, offsets] = k_new
        self.v[:, pages, offsets] = v_new
