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

**Page integrity** (``crc_pages=True``, opt-in): every write the host
makes records a crc32 of each touched page's bytes (K, and V; a
quantized pool's scale planes included), and :meth:`PagedKVCache.
verify_pages` reads the pages back and raises :class:`PagePoolCorruption`
on a mismatch.  A digest reads its pages back to the host (the read waits
for the write before it on the stream), so it costs a device-to-host copy
of every touched page a step: a debugging and chaos knob.

**Page shipping**: :meth:`PagedKVCache.export_page_bytes` serializes a
page as the JAX package does — the C-order bytes of ``pool[:, page]``
(bf16 and fp8 through an integer view of the same width), a quantized
pool's fp32 scale planes as their own keys, base64 text and a crc32 a
plane — so a payload exported by either package verifies
(:func:`verify_page_payload`) and lands (:meth:`PagedKVCache.
import_page_bytes`) in the other, byte for byte.
:meth:`PagedKVCache.defrag` compacts the live pages to the lowest ids.

**Under tensor parallelism** (``tp_group``, a group of ``tp`` ranks) each
rank's pool holds its slice of the heads, ``num_heads`` of them, the
rank's ``tp_rank``-th block of the model's ``num_heads * tp``.  Page
accounting is the same on every rank (the ranks make the same calls).  A
shipped page is the whole page on the wire: :meth:`PagedKVCache.
export_page_bytes` gathers the ranks' slices along the head axis (one
collective a page) and stamps the whole page's CRCs, and
:meth:`PagedKVCache.import_page_bytes` lands each rank's slice of a whole
payload, so engines at any two tensor-parallel sizes ship to each other.
The per-page CRCs that ``crc_pages`` keeps cover the rank's own slice:
they never leave the rank.
"""

from __future__ import annotations

import base64
import bisect
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.attention import code_bytes
from apex_tpu_torch.parallel import comm


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


def verify_page_payload(data: Dict[str, int]) -> bool:
    """Host-side CRC check of one shipped-page payload — pure
    base64/zlib, no device work, so a receiver rejects a page corrupted
    in flight BEFORE touching its pool.  The digest recipe is
    :meth:`PagedKVCache._page_digest`'s (K bytes plus — quantized,
    inferred from the scale keys — the K scale bytes), so a payload that
    verifies here lands with a CRC the importing pool's read-back
    validation agrees with.  The JAX package's function, byte for
    byte."""
    kb = base64.b64decode(data["k"])
    vb = base64.b64decode(data["v"])
    if "k_scale" in data:
        kb += base64.b64decode(data["k_scale"])
        vb += base64.b64decode(data["v_scale"])
    return (zlib.crc32(kb) == data["crc_k"]
            and zlib.crc32(vb) == data["crc_v"])


def _planes_bytes(planes: Sequence[torch.Tensor]) -> List[bytes]:
    """The C-order bytes of each of ``planes`` (slices of the pool arrays,
    any dtype), read back in ONE device-to-host copy."""
    flat = [p.contiguous().view(torch.uint8).reshape(-1) for p in planes]
    host = torch.cat(flat).cpu().numpy().tobytes()
    out, at = [], 0
    for f in flat:
        out.append(host[at:at + f.numel()])
        at += f.numel()
    return out


class PagePoolExhausted(RuntimeError):
    """No free pages left — the scheduler's cue to preempt, never an
    OOM: the pool size is fixed at construction and allocation failure
    is an ordinary, recoverable scheduling event."""


class PagePoolCorruption(RuntimeError):
    """A pool page's content no longer matches its recorded CRC32 — an
    HBM bit flip / DMA fault stand-in, raised by
    :meth:`PagedKVCache.verify_pages`.  Recoverable by construction: page
    content is always rebuildable from host-side tokens by re-prefill, so
    the engine treats it like a device loss (rebuild the pool, restore
    the live requests) rather than an abort."""


class PagedKVCache:
    """Fixed-size paged KV pool shared by all in-flight requests.

    ``max_pages_per_request`` fixes the page-table width ``p_max`` —
    every decode step sees a ``[batch, p_max]`` table.  ``device=None``
    means the card.  ``dtype`` is the compute dtype of the tokens fed to
    :meth:`write_tokens`; ``quantize`` (None, ``"int8"`` or ``"fp8"``)
    stores them as codes plus fp32 scales.  ``crc_pages`` turns on the
    per-page CRC read-back validation; ``tp_group`` makes the pool one
    rank's head slice (module docstring)."""

    def __init__(self, *, num_layers: int, num_pages: int, page_size: int,
                 num_heads: int, head_dim: int, max_pages_per_request: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 crc_pages: bool = False, quantize: Optional[str] = None,
                 tp_group=None):
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
        self.tp_group = tp_group
        self.tp = comm.group_size(tp_group)
        self.tp_rank = comm.group_rank(tp_group)
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
        # opt-in per-page CRCs: page -> (crc of K, crc of V), recorded at
        # each host-visible write, checked by verify_pages
        self.crc_pages = bool(crc_pages)
        self._crc: Dict[int, Tuple[int, int]] = {}

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
        # content moved verbatim, so the copy inherits the digest
        if page in self._crc:
            self._crc[new] = self._crc[page]
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
            self._crc.pop(p, None)
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
        per-(slot, head) scales are scattered together.  With
        ``crc_pages`` the touched pages' CRCs are recorded anew."""
        if self.quantize:
            kq, ks = quantize_tokens(k_new, self.k.dtype, self.qmax)
            vq, vs = quantize_tokens(v_new, self.v.dtype, self.qmax)
            self.k_scale[:, pages, offsets] = ks
            self.v_scale[:, pages, offsets] = vs
            k_new, v_new = kq, vq
        code_bytes(self.k)[:, pages, offsets] = code_bytes(k_new)
        code_bytes(self.v)[:, pages, offsets] = code_bytes(v_new)
        if self.crc_pages:
            self.refresh_page_crcs(pages.cpu().tolist())

    # -- page shipping ---------------------------------------------------

    def _planes(self, page: int) -> List[torch.Tensor]:
        """Page ``page``'s slices of the pool arrays, in digest order:
        K, V, and (quantized) the K and V scale planes."""
        return [t[:, page] for t in (self.k, self.v, self.k_scale,
                                     self.v_scale) if t is not None]

    def _whole_planes_bytes(self, page: int) -> List[bytes]:
        """The C-order bytes of page ``page``'s planes across every head
        of the model: the rank's own planes at one rank, else the ranks'
        head slices gathered in rank order (one collective; every rank
        gets the same bytes)."""
        planes = self._planes(page)
        if self.tp == 1:
            return _planes_bytes(planes)
        # each plane as [L, ps, heads, bytes of a head's entry], head axis
        # first, all planes side by side in one [heads, bytes] buffer
        raw = [(p if p.dim() == 4 else p.unsqueeze(-1)).contiguous()
               .view(torch.uint8) for p in planes]
        mine = torch.cat([r.movedim(2, 0).reshape(self.num_heads, -1)
                          for r in raw], dim=1)
        whole = comm.all_gather_tiled(mine, self.tp_group).cpu()
        out, at = [], 0
        for r in raw:
            n = r.shape[0] * r.shape[1] * r.shape[3]   # bytes a head
            part = whole[:, at:at + n].reshape(-1, r.shape[0], r.shape[1],
                                               r.shape[3])
            out.append(part.permute(1, 2, 0, 3).contiguous().numpy()
                       .tobytes())
            at += n
        return out

    def export_page_bytes(self, page: int) -> Dict[str, int]:
        """Serialize one page for shipping: the C-order K/V page slices
        (quantized: the narrow codes, plus the fp32 scale planes as
        separate keys) as base64 text, with per-page CRCs stamped at
        export using the :meth:`_page_digest` recipe — the receiver
        verifies them host-side (:func:`verify_page_payload`) before its
        pool ever sees the bytes, and records them as the imported page's
        read-back digest.  Under tensor parallelism the payload is the
        whole page's (module docstring), the same on every rank."""
        planes = self._whole_planes_bytes(page)
        kb, vb = planes[0], planes[1]
        out = {"k": base64.b64encode(kb).decode("ascii"),
               "v": base64.b64encode(vb).decode("ascii")}
        if self.quantize:
            ksb, vsb = planes[2], planes[3]
            out["k_scale"] = base64.b64encode(ksb).decode("ascii")
            out["v_scale"] = base64.b64encode(vsb).decode("ascii")
            kb += ksb
            vb += vsb
        out["crc_k"] = zlib.crc32(kb)
        out["crc_v"] = zlib.crc32(vb)
        return out

    def import_page_bytes(self, page: int, data: Dict[str, int]) -> None:
        """Land one shipped payload in (already allocated) ``page``,
        verbatim and in place: the pool bytes after import are the source
        pool's bytes — quantized codes and scale planes included — so
        decode over an imported page is decode over a locally prefilled
        one.  Callers verify the payload first
        (:func:`verify_page_payload`); this method trusts it and records
        the shipped CRCs as the page's read-back digest.  Under tensor
        parallelism each rank lands its head slice of the whole payload
        and records its slice's CRCs."""
        keys = ("k", "v", "k_scale", "v_scale")
        mine = []
        for key, t in zip(keys, (self.k, self.v, self.k_scale,
                                 self.v_scale)):
            if t is None:
                continue
            dst = t[:, page]
            dst = (dst if dst.dim() == 4 else dst.unsqueeze(-1)) \
                .view(torch.uint8)
            src = np.frombuffer(bytearray(base64.b64decode(data[key])),
                                np.uint8)
            if self.tp > 1:
                # [L, ps, all heads, bytes a head] -> the rank's heads
                h0 = self.tp_rank * self.num_heads
                src = src.reshape(dst.shape[0], dst.shape[1], -1,
                                  dst.shape[3])[:, :, h0:h0 + self.num_heads]
            src = np.ascontiguousarray(src)
            mine.append(src.tobytes())
            dst.copy_(torch.from_numpy(src).reshape(dst.shape))
        if self.crc_pages:
            # shipped bytes land verbatim, so the export digest IS the
            # imported page's digest (under tp: the digest of the slice
            # landed here) — no device read-back needed
            if self.tp == 1:
                self._crc[page] = (data["crc_k"], data["crc_v"])
            else:
                kb, vb = mine[0], mine[1]
                if self.quantize:
                    kb += mine[2]
                    vb += mine[3]
                self._crc[page] = (zlib.crc32(kb), zlib.crc32(vb))

    def warm_import(self) -> None:
        """Move an all-zero page through :meth:`import_page_bytes`'s
        write path into scratch page 0 (a content no-op no reader ever
        sees), so a decode engine's first inbound shipment meets no
        first-use cost.  The JAX package warms its import executable
        here; ``ServingEngine.warmup`` calls both at the same point."""
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                zero = torch.zeros(t[:, 0].shape, dtype=torch.uint8
                                   if t.dtype == torch.float8_e4m3fn
                                   else t.dtype, device=self.device)
                code_bytes(t)[:, 0] = zero

    def warm_export(self) -> None:
        """Read scratch page 0 out through :meth:`export_page_bytes` once
        and discard the payload, so a prefill engine's first outbound
        shipment meets no first-use cost (the export twin of
        :meth:`warm_import`)."""
        self.export_page_bytes(0)

    # -- per-page CRC validation (opt-in) --------------------------------

    def _page_digests(self, pages: Sequence[int]) -> List[Tuple[int, int]]:
        """crc32 of each page's K and V bytes across all layers
        (quantized: codes AND scale planes — a flipped scale bit must not
        read back clean), the pages read back in one copy."""
        if not pages:
            return []
        idx = torch.tensor(list(pages), dtype=torch.long, device=self.device)
        planes = _planes_bytes([code_bytes(t)[:, idx].transpose(0, 1)
                                for t in (self.k, self.v, self.k_scale,
                                          self.v_scale) if t is not None])
        n = len(pages)
        per = [[b[i * len(b) // n:(i + 1) * len(b) // n] for i in range(n)]
               for b in planes]
        out = []
        for i in range(n):
            kb, vb = per[0][i], per[1][i]
            if self.quantize:
                kb += per[2][i]
                vb += per[3][i]
            out.append((zlib.crc32(kb), zlib.crc32(vb)))
        return out

    def _page_digest(self, page: int) -> Tuple[int, int]:
        """crc32 of page ``page``'s K and V bytes (the JAX package's
        recipe: K, then — quantized — the K scale plane; V likewise)."""
        return self._page_digests([page])[0]

    def refresh_page_crcs(self, pages: Sequence[int]) -> None:
        """Re-record CRCs after a host-visible write (the admission
        scatter, a decode or extend step's append).  The read-back waits
        for the write on the stream.  No-op unless ``crc_pages``."""
        if not self.crc_pages:
            return
        todo = sorted({int(p) for p in pages} - {0})
        for p, crc in zip(todo, self._page_digests(todo)):
            self._crc[p] = crc

    def verify_pages(self, page_lists: Sequence[Sequence[int]]) -> None:
        """Read-back validation: recompute each live page's digest and
        compare against the recorded CRC; raises
        :class:`PagePoolCorruption` naming the lowest damaged page.
        Pages with no recorded CRC (never written through a CRC-tracking
        path) are skipped — absence of a record is not corruption."""
        if not self.crc_pages:
            return
        todo = [p for p in sorted({int(p) for lst in page_lists
                                   for p in lst} - {0})
                if p in self._crc]
        for p, crc in zip(todo, self._page_digests(todo)):
            if crc != self._crc[p]:
                raise PagePoolCorruption(
                    f"page {p} failed CRC read-back "
                    f"(owner rid {self._owner.get(p)})")

    # -- defrag ----------------------------------------------------------

    def defrag(self, page_lists: Sequence[List[int]]) -> Dict[int, int]:
        """Compact live pages to the lowest pool indices.

        ``page_lists`` are the page lists of every live request, IN
        PLACE — they are rewritten to the new ids.  Returns the old→new
        mapping.  Content moves by one device gather per pool array
        (quantized: the scale planes gather with the codes), written back
        into the pool in place; refcounts, owners and digests move with
        the ids.

        FORBIDDEN while any page is shared: one physical page then
        appears in several page lists (and in the prefix index, which
        this method never sees), so neither the overlap check nor the
        dense renumbering holds.  Callers drain sharing first or skip the
        compaction."""
        shared = sorted(p for p, r in self._ref.items() if r > 1)
        if shared:
            raise ValueError(
                f"defrag forbidden while page(s) {shared} are shared "
                "(refcount > 1) — evict the prefix index / let readers "
                "retire first")
        live: List[int] = []
        for pages in page_lists:
            live.extend(pages)
        if len(set(live)) != len(live):
            raise ValueError("page lists overlap — pool corruption")
        mapping = {old: new for new, old in enumerate(live, start=1)}
        src = np.arange(self.num_pages)
        for old, new in mapping.items():
            src[new] = old
        # pages outside the live prefix keep whatever content the gather
        # assigns them — they are free, nothing reads them
        idx = torch.from_numpy(src).to(self.device)
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                code_bytes(t).copy_(code_bytes(t)[:, idx])
        self._owner = {mapping[p]: o for p, o in self._owner.items()
                       if p in mapping}
        self._ref = {mapping[p]: r for p, r in self._ref.items()
                     if p in mapping}
        # content moves verbatim with the ids, so digests remap too
        self._crc = {mapping[p]: c for p, c in self._crc.items()
                     if p in mapping}
        self._free = list(range(len(live) + 1, self.num_pages))
        for pages in page_lists:
            pages[:] = [mapping[p] for p in pages]
        return mapping


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
