"""GPT-style decoder with a paged KV cache — the serving engine's model
half (port of the JAX package's ``apex_tpu/serving/model.py``).

Three entry points serve the phases of continuous batching:

* :meth:`PagedDecoder.prefill` — the ADMISSION path: a fixed-width
  packed token row with segment ids (0 = padding, real segments 1..n)
  through causal flash attention (``csrc/flash_fwd.cu`` on the card).
  It returns per-layer K/V for every packed position; the engine
  scatters them into the request's pages.
* :meth:`PagedDecoder.decode` — the STEADY-STATE path: one token per
  running request; append the token's K/V into its current page, then
  attend over the request's page list (``csrc/flash_decode_sm90.cu`` on
  the card at head dim 128, ``csrc/flash_decode.cu`` for an fp32 pool).
  The batch width is fixed at the engine's ``max_batch``, idle rows
  pointed at the scratch page.  Over a quantized pool (int8 / fp8 codes
  with fp32 scale planes) the new token's K/V are quantized before they
  are appended.
* :meth:`PagedDecoder.extend` — SEVERAL tokens per row: the speculative
  verify step (the last committed token and its draft, ``q_len = k + 1``)
  and the chunked prefill (``q_len = chunk_size``, one row).  Each layer
  writes the window's K/V into the pool, then ``flash_decode`` at that
  ``q_len`` reads it (``csrc/flash_decode_sm90.cu`` on the card).

Per-row independence is a hard contract: every op in ``decode`` is
row-wise (embedding lookup, layer norm, per-row matmuls, paged attention
over the row's own page list), which is what makes batched continuous
decoding produce bit-identical tokens to one-request-at-a-time decoding
at the same batch width.

**Tensor parallelism.**  With ``tp_group`` (a ``torch.distributed`` group
of ``tp`` ranks) the three methods run as one rank's part of the model,
Megatron-style: the rank holds its head slice of ``wqkv`` (columns, in
the shard-major order :func:`shard_params_tp` makes) and of ``w1``
(columns), the matching rows of ``wo`` and ``w2``, and the embeddings and
LayerNorms whole (:func:`tp_rank_params`).  The head count is read off
the rank's own ``wqkv`` block, the pool holds the rank's heads, and each
block's partial residual (attention, then MLP) is summed over the group
by one ``comm.all_reduce``: two a layer, where the JAX package's
``shard_map`` body has its ``lax.psum``.  Every rank ends a step with the
same summed hidden state and so the same logits.

Parameters are a plain dict of tensors (:func:`init_params`) with tied
embeddings, weights kept in the JAX package's ``[in, out]`` layout so
``x @ W`` needs no transpose and JAX weights load unchanged
(:func:`~apex_tpu_torch.serving.convert.params_from_jax`).  The GEMMs are
``torch.matmul``, as the JAX package leaves them to XLA.

"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops import flash_attention, flash_decode
from apex_tpu_torch.ops.attention import code_bytes
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.serving.kv_cache import quantize_tokens


@dataclasses.dataclass(frozen=True)
class ServingModelConfig:
    """Decoder geometry.  ``max_position`` bounds the learned position
    table — admission must reject requests that could outgrow it."""

    vocab_size: int = 256
    hidden_size: int = 64
    num_heads: int = 4
    num_layers: int = 2
    max_position: int = 512
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must divide by num_heads")
        return self.hidden_size // self.num_heads


def quant_qmax(dtype: torch.dtype) -> float:
    """qmax for a quantized pool's code dtype (int8 -> 127, fp8 e4m3 ->
    448): the model reads the grid off the pool it is handed."""
    return 127.0 if dtype == torch.int8 else 448.0


def init_params(cfg: ServingModelConfig, seed: int = 0, device=None) -> Dict:
    """Deterministic parameters (scaled-normal init, tied LM head =
    embedding transpose), drawn from a ``torch.Generator`` on ``device``
    seeded with ``seed`` (``device=None`` means the card).  The values
    depend on the device's generator: a CPU and a CUDA draw differ."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, r, dt = cfg.hidden_size, cfg.mlp_ratio, cfg.dtype

    def norm(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) / math.sqrt(fan_in)).to(dt)

    def ln():
        return {"g": torch.ones(h, dtype=dt, device=device),
                "b": torch.zeros(h, dtype=dt, device=device)}

    params = {"embed": norm((cfg.vocab_size, h), h),
              "pos": norm((cfg.max_position, h), h),
              "ln_f": ln(), "layers": []}
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": ln(),
            "wqkv": norm((h, 3 * h), h),
            "wo": norm((h, h), h),
            "ln2": ln(),
            "w1": norm((h, r * h), h),
            "w2": norm((r * h, h), r * h),
        })
    return params


def shard_params_tp(params, tp: int):
    """Reorder each layer's fused ``wqkv`` ``[h, 3h]`` into shard-major
    column blocks ``[q_0|k_0|v_0 | q_1|k_1|v_1 | ...]``, so that rank
    ``j``'s ``j``-th column block holds exactly its head slice of all
    three projections and ``chunk(3, dim=-1)`` splits it as at one rank
    (the JAX package's ``shard_params_tp``, bit for bit: a column
    permutation).  Returns a new tree sharing every other leaf; ``tp=1``
    returns ``params`` as it is."""
    if tp == 1:
        return params
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        w = layer["wqkv"]
        h = w.shape[0]
        if h % tp:
            raise ValueError(f"hidden_size {h} not divisible by tp={tp}")
        wq, wk, wv = w.chunk(3, dim=1)
        n = h // tp
        blocks = []
        for j in range(tp):
            blocks += [t[:, j * n:(j + 1) * n] for t in (wq, wk, wv)]
        out["layers"].append(dict(layer, wqkv=torch.cat(blocks, dim=1)))
    return out


def tp_rank_params(params, tp: int, rank: int):
    """Rank ``rank``'s part of a :func:`shard_params_tp` tree at ``tp``
    ranks (the JAX engine's ``_param_specs``): the ``rank``-th column
    block of ``wqkv`` and ``w1``, the ``rank``-th row block of ``wo`` and
    ``w2`` (each a contiguous copy), the embeddings, positions and
    LayerNorms as they are."""
    if tp == 1:
        return params

    def block(w, dim):
        n = w.shape[dim] // tp
        return w.narrow(dim, rank * n, n).contiguous()

    out = dict(params)
    out["layers"] = [dict(layer, wqkv=block(layer["wqkv"], 1),
                          w1=block(layer["w1"], 1), wo=block(layer["wo"], 0),
                          w2=block(layer["w2"], 0))
                     for layer in params["layers"]]
    return out


def params_to(params, device):
    """The same parameter tree with every tensor on ``device`` (tensors
    already there are returned as they are, not copied)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def _ln(x, p):
    # the JAX package's formula in the working dtype (F.layer_norm would
    # compute its statistics in fp32)
    m = x.mean(-1, keepdim=True)
    var = (x - m).square().mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


def _mlp(x, layer):
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    return F.gelu(x @ layer["w1"], approximate="tanh") @ layer["w2"]


def _sum_rows(part: torch.Tensor, group, live: Optional[int]):
    """``part`` ``[b, s, h]`` summed over ``group``: every row, or with
    ``live`` the first ``live`` rows alone (in place; the rest keep this
    rank's partial)."""
    if live is None or live >= part.shape[1] or comm.group_size(group) == 1:
        return comm.all_reduce(part, group)
    part[:, :live] = comm.all_reduce(part[:, :live], group)
    return part


class PagedDecoder:
    """The decoder model over the cache layout the engine owns (the
    engine holds params and pool; this class is functions of them)."""

    def __init__(self, cfg: ServingModelConfig):
        self.cfg = cfg

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """[b, s, H*hd] view -> [b, H, s, hd] view (no copy); ``H`` is read
        off the width, so a rank's slice of ``H / tp`` heads views as
        such."""
        b, s = t.shape[:2]
        hd = self.cfg.head_dim
        return t.view(b, s, t.shape[-1] // hd, hd).transpose(1, 2)

    # -- admission: packed varlen prefill --------------------------------

    def prefill(self, params, tokens: torch.Tensor, seg: torch.Tensor,
                positions: torch.Tensor,
                last_index: Optional[int] = None, *, tp_group=None,
                live: Optional[int] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """tokens/seg/positions ``[1, S]`` int (one packed row; seg 0 =
        padding, real segments 1..n; positions restart per segment).
        Returns (logits, k, v ``[L, 1, S, H, D]``) — K/V for every packed
        position, for the engine to scatter into pages.

        ``last_index``: compute logits ``[1, 1, vocab]`` for that single
        position only (admission needs one next-token distribution);
        ``None`` returns the full ``[1, S, vocab]`` logits.

        ``tp_group``: run as one rank of that group (module docstring);
        the returned K/V are the rank's head slice.  ``live``: the row's
        first ``live`` positions are its real ones and the rest padding
        (segment 0, which no real position attends to); the ranks then
        sum only the real positions' partials, and the padding rows carry
        this rank's partial alone (their K/V and logits are never read).
        The real rows' values are the same either way."""
        x = params["embed"][tokens] + params["pos"][positions]
        b, s = tokens.shape
        hd = self.cfg.head_dim
        ks, vs = [], []
        for layer in params["layers"]:
            qkv = _ln(x, layer["ln1"]) @ layer["wqkv"]
            q, k, v = qkv.chunk(3, dim=-1)
            ctx = flash_attention(self._heads(q), self._heads(k),
                                  self._heads(v), causal=True,
                                  segment_ids=seg)
            x = x + _sum_rows(
                ctx.transpose(1, 2).reshape(b, s, -1) @ layer["wo"],
                tp_group, live)
            x = x + _sum_rows(_mlp(_ln(x, layer["ln2"]), layer), tp_group,
                              live)
            ks.append(k.view(b, s, -1, hd))
            vs.append(v.view(b, s, -1, hd))
        x = _ln(x, params["ln_f"])
        if last_index is not None:
            x = x[:, last_index:last_index + 1]
        logits = x @ params["embed"].T
        return logits, torch.stack(ks), torch.stack(vs)

    # -- steady state: paged decode --------------------------------------

    def decode(self, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
               tokens: torch.Tensor, positions: torch.Tensor,
               page_table: torch.Tensor, kv_len: torch.Tensor, *,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None,
               tp_group=None) -> torch.Tensor:
        """One decode step for a fixed-width batch; returns logits
        ``[b, vocab]``.

        ``tokens``/``positions`` ``[b]``: each row's newest token and its
        0-based sequence position; ``kv_len = positions + 1`` (the count
        includes the query token, whose K/V this step appends).
        ``page_table`` ``[b, p_max]`` int32.  Idle rows carry position 0
        / kv_len 1 / an all-scratch page row; their writes land in
        scratch page 0 and their outputs are discarded by the engine.

        ``k_pool``/``v_pool`` ``[L, n_pages, page_size, H, D]`` are
        updated IN PLACE (each layer's new K/V is written before that
        layer's attention reads the pool) — the JAX package returns new
        pools instead.  With ``k_scale``/``v_scale`` (a quantized pool's
        ``[L, n_pages, page_size, H]`` fp32 scale planes) the new K/V are
        quantized on write, their scales written in place beside the
        codes, and ``flash_decode`` dequantizes on read.  ``tp_group``:
        as in :meth:`prefill` (the pools hold the rank's heads)."""
        page_size = k_pool.shape[2]
        b = tokens.shape[0]
        hd = self.cfg.head_dim
        quantized = k_scale is not None
        qmax = quant_qmax(k_pool.dtype) if quantized else None
        x = params["embed"][tokens] + params["pos"][positions]  # [b, h]
        rows = torch.arange(b, device=tokens.device)
        at = (page_table[rows, positions // page_size],
              positions % page_size)
        for li, layer in enumerate(params["layers"]):
            qkv = _ln(x, layer["ln1"]) @ layer["wqkv"]
            width = qkv.shape[-1] // 3        # the rank's heads x hd
            q = qkv[:, None, :width]          # [b, 1, width]
            kv = qkv[:, width:].view(b, 2, -1, hd)  # K, V
            if quantized:
                # one pass for K and V: the scale is a per-(token, head)
                # function, so this is quantize_tokens of each alone
                kv, s = quantize_tokens(kv, k_pool.dtype, qmax)
                k_scale[li].index_put_(at, s[:, 0])
                v_scale[li].index_put_(at, s[:, 1])
            code_bytes(k_pool[li]).index_put_(at, code_bytes(kv[:, 0]))
            code_bytes(v_pool[li]).index_put_(at, code_bytes(kv[:, 1]))
            ctx = flash_decode(
                self._heads(q), k_pool[li], v_pool[li], page_table, kv_len,
                k_scale=k_scale[li] if quantized else None,
                v_scale=v_scale[li] if quantized else None)
            x = x + comm.all_reduce(
                ctx.transpose(1, 2).reshape(b, -1) @ layer["wo"], tp_group)
            x = x + comm.all_reduce(_mlp(_ln(x, layer["ln2"]), layer),
                                    tp_group)
        return _ln(x, params["ln_f"]) @ params["embed"].T

    # -- draft-verify / chunked prefill: several tokens a row -------------

    def extend(self, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
               tokens: torch.Tensor, positions: torch.Tensor,
               write_pages: torch.Tensor, write_offsets: torch.Tensor,
               page_table: torch.Tensor, kv_len: torch.Tensor, *,
               last_only: bool = False,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None,
               tp_group=None) -> torch.Tensor:
        """Append ``q`` tokens a row to the paged cache and score them in
        one ``flash_decode`` call a layer; returns logits ``[b, q, vocab]``
        (``[b, 1, vocab]`` with ``last_only``).

        ``tokens``/``positions`` ``[b, q]``: each row's newest tokens,
        FRONT-padded (the valid tokens are the last ones, since row i of
        the window sees columns ``[0, kv_len - q + i]``).
        ``write_pages``/``write_offsets`` ``[b, q]``: where each token's
        K/V goes; pad rows point at scratch page 0.  ``kv_len`` ``[b]``:
        valid tokens including the window's real ones; it may be smaller
        than ``q`` (rows whose window is empty get exact zeros from the
        attention, and the engine discards them); idle rows pass
        ``kv_len = q``.  ``page_table`` ``[b, p_max]``.

        ``last_only``: only the last row through the LM head (the chunk
        step, which wants one next-token distribution).  The pools (and
        a quantized pool's ``k_scale``/``v_scale``) are updated IN PLACE,
        each layer's K/V written before that layer's attention reads
        them, quantized on write as in :meth:`decode`.  ``tp_group``: as
        in :meth:`prefill`."""
        b, q = tokens.shape
        hd = self.cfg.head_dim
        quantized = k_scale is not None
        qmax = quant_qmax(k_pool.dtype) if quantized else None
        x = params["embed"][tokens] + params["pos"][positions]  # [b, q, h]
        at = (write_pages, write_offsets)
        for li, layer in enumerate(params["layers"]):
            qkv = _ln(x, layer["ln1"]) @ layer["wqkv"]
            width = qkv.shape[-1] // 3        # the rank's heads x hd
            kv = qkv[..., width:].view(b, q, 2, -1, hd)       # K, V
            if quantized:
                kv, s = quantize_tokens(kv, k_pool.dtype, qmax)
                k_scale[li].index_put_(at, s[:, :, 0])
                v_scale[li].index_put_(at, s[:, :, 1])
            code_bytes(k_pool[li]).index_put_(at, code_bytes(kv[:, :, 0]))
            code_bytes(v_pool[li]).index_put_(at, code_bytes(kv[:, :, 1]))
            ctx = flash_decode(
                self._heads(qkv[..., :width]), k_pool[li], v_pool[li],
                page_table, kv_len,
                k_scale=k_scale[li] if quantized else None,
                v_scale=v_scale[li] if quantized else None)
            x = x + comm.all_reduce(
                ctx.transpose(1, 2).reshape(b, q, -1) @ layer["wo"],
                tp_group)
            x = x + comm.all_reduce(_mlp(_ln(x, layer["ln2"]), layer),
                                    tp_group)
        x = _ln(x, params["ln_f"])
        if last_only:
            x = x[:, -1:]
        return x @ params["embed"].T
