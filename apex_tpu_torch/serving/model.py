"""GPT-style decoder with a paged KV cache — the serving engine's model
half (port of the JAX package's ``apex_tpu/serving/model.py``).

Two entry points mirror the two phases of continuous batching:

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

Per-row independence is a hard contract: every op in ``decode`` is
row-wise (embedding lookup, layer norm, per-row matmuls, paged attention
over the row's own page list), which is what makes batched continuous
decoding produce bit-identical tokens to one-request-at-a-time decoding
at the same batch width.

Parameters are a plain dict of tensors (:func:`init_params`) with tied
embeddings, weights kept in the JAX package's ``[in, out]`` layout so
``x @ W`` needs no transpose and JAX weights load unchanged
(:func:`~apex_tpu_torch.serving.convert.params_from_jax`).  The GEMMs are
``torch.matmul``, as the JAX package leaves them to XLA.

Not ported yet (ROADMAP.md): ``extend`` (speculative verify and chunked
prefill) and tensor parallelism.
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


class PagedDecoder:
    """The decoder model over the cache layout the engine owns (the
    engine holds params and pool; this class is functions of them)."""

    def __init__(self, cfg: ServingModelConfig):
        self.cfg = cfg

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """[b, s, H*hd] view -> [b, H, s, hd] view (no copy)."""
        b, s = t.shape[:2]
        return t.view(b, s, self.cfg.num_heads,
                      self.cfg.head_dim).transpose(1, 2)

    # -- admission: packed varlen prefill --------------------------------

    def prefill(self, params, tokens: torch.Tensor, seg: torch.Tensor,
                positions: torch.Tensor,
                last_index: Optional[int] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """tokens/seg/positions ``[1, S]`` int (one packed row; seg 0 =
        padding, real segments 1..n; positions restart per segment).
        Returns (logits, k, v ``[L, 1, S, H, D]``) — K/V for every packed
        position, for the engine to scatter into pages.

        ``last_index``: compute logits ``[1, 1, vocab]`` for that single
        position only (admission needs one next-token distribution);
        ``None`` returns the full ``[1, S, vocab]`` logits."""
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
            x = x + ctx.transpose(1, 2).reshape(b, s, -1) @ layer["wo"]
            x = x + _mlp(_ln(x, layer["ln2"]), layer)
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
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        codes, and ``flash_decode`` dequantizes on read."""
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
            q = qkv[:, None, :self.cfg.hidden_size]   # [b, 1, h]
            kv = qkv[:, self.cfg.hidden_size:].view(b, 2, -1, hd)  # K, V
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
            x = x + ctx.transpose(1, 2).reshape(b, -1) @ layer["wo"]
            x = x + _mlp(_ln(x, layer["ln2"]), layer)
        return _ln(x, params["ln_f"]) @ params["embed"].T
