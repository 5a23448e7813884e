"""Standalone Megatron GPT: the training path's model.

PyTorch port of the JAX package's
``apex_tpu/transformer/testing/standalone_gpt.py`` (pre-LN GPT-2): word +
learned position embedding, N x (LN -> self-attention -> residual -> LN
-> GELU MLP -> residual), final LN, logits through the tied word
embedding, per-token loss.  Layers are an ``nn.ModuleList``, not a scan;
parameter names are the JAX tree's paths (``transformer.layers.<i>...``
for the JAX leading layer axis), see :mod:`.convert`.

What runs where: the LayerNorms are ``ops.layer_norm`` (``csrc/
layer_norm.cu`` on the card), attention is ``ops.flash_attention_qkv``
straight from the QKV projection (``csrc/flash_qkv_fwd.cu`` /
``flash_qkv_bwd.cu``), the GEMMs are fp32-accumulated library products.
With labels, a bf16 model takes the fused LM-head cross-entropy and an
fp32 model the plain vocab-parallel one (the JAX package's choice).

Remat (``cfg.remat``) checkpoints each layer with
``torch.utils.checkpoint`` (non-reentrant).  Policy ``"attn_res"`` keeps
the attention kernel's outputs (ctx, lse) through a selective checkpoint,
so the recompute re-runs the LayerNorms and GEMMs but never the attention
forward, as the JAX policy ``save_only_these_names("flash_attn_out",
"flash_attn_lse")`` does; ``"full"`` recomputes everything.  Dropout
seeds are integers fixed by (step seed, layer, site) and each site
re-creates its generator, so the recompute redraws the same masks.

Not ported (raise ``NotImplementedError``): tensor parallelism above 1,
the non-flash attention path, the MoE MLP, remat policies other than
``attn_res`` and ``full``, attention masks, fp16 on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.attention import FLASH_QKV_FWD_OP, flash_attention_qkv
from apex_tpu_torch.ops.fused_layer_norm import FusedLayerNorm
from apex_tpu_torch.ops.fused_linear_xent import fused_linear_cross_entropy
from apex_tpu_torch.ops._gemm import linear_f32
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    normal_init, vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint, dropout, fold_in, model_parallel_dropout_seed)

REMAT_POLICIES = ("attn_res", "full")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Network-size args (the JAX ``GPTConfig`` without its TPU tiling
    knobs ``flash_block_q``/``flash_block_k`` and its MoE knobs
    ``moe_capacity_factor``/``moe_aux_loss_coeff``; ``num_experts`` stays
    so that a MoE config is refused, not silently run dense)."""

    num_layers: int = 2
    hidden_size: int = 64
    num_attention_heads: int = 4
    vocab_size: int = 128
    max_position_embeddings: int = 64
    ffn_hidden_size: Optional[int] = None
    layernorm_epsilon: float = 1e-5
    init_method_std: float = 0.02
    fp16: bool = False
    bf16: bool = False
    tp_size: int = 1
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    use_flash_attention: bool = False
    remat: bool = False
    remat_policy: str = "full"
    num_experts: int = 0

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.bf16:
            return torch.bfloat16
        if self.fp16:
            return torch.float16
        return torch.float32

    @property
    def kv_channels(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _refuse_unported(cfg: GPTConfig, device: torch.device) -> None:
    unported = []
    if cfg.tp_size != 1:
        unported.append(f"tp_size={cfg.tp_size}")
    if not cfg.use_flash_attention:
        unported.append("use_flash_attention=False (the fused-softmax path)")
    if cfg.num_experts > 0:
        unported.append(f"num_experts={cfg.num_experts} (the MoE MLP)")
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        unported.append(f"remat_policy={cfg.remat_policy!r}")
    if cfg.fp16 and device.type == "cuda":
        unported.append("fp16 on the card (the kernels take fp32 or bf16)")
    if unported:
        raise NotImplementedError(
            "not ported to apex_tpu_torch (ROADMAP.md): " + ", ".join(unported))


def _attn_res_policy(ctx, op, *args, **kwargs):
    """Save the attention kernel's outputs, recompute everything else."""
    if op == FLASH_QKV_FWD_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _attn_res_context():
    return create_selective_checkpoint_contexts(_attn_res_policy)


class ParallelAttention(nn.Module):
    """Causal self-attention through the packed-QKV flash op (reference
    standalone_gpt.py:283)."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        init = normal_init(cfg.init_method_std)
        self.qkv = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, init_method=init,
            tp_size=cfg.tp_size, device=device, generator=generator)
        self.proj = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, init_method=init,
            tp_size=cfg.tp_size, device=device, generator=generator)
        self.np_local = cfg.num_attention_heads // cfg.tp_size

    def forward(self, h: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        qkv = self.qkv(h)  # [b, s, 3 * hidden], per head q | k | v
        drop = {}
        if dropout_seed is not None and self.cfg.attention_dropout > 0:
            # the probs are head-sharded over TP: per-rank stream
            drop = dict(dropout_rate=self.cfg.attention_dropout,
                        dropout_seed=model_parallel_dropout_seed(
                            dropout_seed) & 0xFFFFFFFF)
        ctx = flash_attention_qkv(qkv, self.np_local, causal=True, **drop)
        return self.proj(ctx.to(h.dtype))


class ParallelMLP(nn.Module):
    """h -> 4h -> h with tanh GELU (``jax.nn.gelu(approximate=True)``)."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        init = normal_init(cfg.init_method_std)
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, init_method=init, tp_size=cfg.tp_size,
            device=device, generator=generator)
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn, cfg.hidden_size, init_method=init, tp_size=cfg.tp_size,
            device=device, generator=generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        inter = F.gelu(self.dense_h_to_4h(h), approximate="tanh")
        return self.dense_4h_to_h(inter)


def embedding_dropout(h: torch.Tensor, cfg: GPTConfig,
                      dropout_seed: Optional[int]) -> torch.Tensor:
    """Hidden dropout on the embedding output (replicated stream)."""
    if dropout_seed is None or cfg.hidden_dropout <= 0.0:
        return h
    return dropout(h, cfg.hidden_dropout, fold_in(dropout_seed, 0x0E0B))


def _hidden_dropout(x: torch.Tensor, cfg: GPTConfig,
                    seed: Optional[int]) -> torch.Tensor:
    """Post-RowParallel dropout: the activation is TP-replicated, so the
    base (replicated) seed is the right stream."""
    if seed is None or cfg.hidden_dropout <= 0.0:
        return x
    return dropout(x, cfg.hidden_dropout, seed)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block (reference standalone_gpt.py:575)."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        eps = cfg.layernorm_epsilon
        self.input_layernorm = FusedLayerNorm(h, eps, device=device)
        self.attention = ParallelAttention(cfg, device=device,
                                           generator=generator)
        self.post_attention_layernorm = FusedLayerNorm(h, eps, device=device)
        self.mlp = ParallelMLP(cfg, device=device, generator=generator)

    def forward(self, h: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        s_attn = s_h1 = s_h2 = None
        if dropout_seed is not None:
            s_attn, s_h1, s_h2 = (fold_in(dropout_seed, i) for i in range(3))
        attn = self.attention(self.input_layernorm(h), s_attn)
        h = h + _hidden_dropout(attn, self.cfg, s_h1)
        out = self.mlp(self.post_attention_layernorm(h))
        return h + _hidden_dropout(out, self.cfg, s_h2)


class ParallelTransformer(nn.Module):
    """The layer stack, one module per layer, each checkpointed under
    ``cfg.remat``."""

    def __init__(self, cfg: GPTConfig, num_layers: Optional[int] = None, *,
                 device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        n = cfg.num_layers if num_layers is None else num_layers
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(cfg, device=device, generator=generator)
            for _ in range(n))

    def forward(self, h: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        remat = self.cfg.remat and torch.is_grad_enabled()
        context_fn = (_attn_res_context
                      if self.cfg.remat_policy == "attn_res" else None)
        for i, layer in enumerate(self.layers):
            seed = None if dropout_seed is None else fold_in(dropout_seed, i)
            if remat:
                h = checkpoint(layer, h, seed, context_fn=context_fn)
            else:
                h = layer(h, seed)
        return h


class GPTModel(nn.Module):
    """Embeddings + transformer + tied LM head (reference
    standalone_gpt.py:1426).  Built on ``device`` (``None``: the card,
    raising without one; ``"cpu"`` runs the plain versions of the
    kernels), weights drawn from ``seed`` with a generator on that
    device, fp32 masters."""

    def __init__(self, cfg: GPTConfig, num_layers: Optional[int] = None, *,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        _refuse_unported(cfg, dev)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init = normal_init(cfg.init_method_std)
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, init_method=init,
            tp_size=cfg.tp_size, device=dev, generator=gen)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=dev,
            _weight=init((cfg.max_position_embeddings, cfg.hidden_size),
                         gen, dev))
        self.transformer = ParallelTransformer(cfg, num_layers, device=dev,
                                               generator=gen)
        self.final_layernorm = FusedLayerNorm(
            cfg.hidden_size, cfg.layernorm_epsilon, device=dev)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.embedding(tokens)
        pos = self.position_embeddings.weight[:tokens.shape[1]]
        return (h + pos[None]).to(self.cfg.compute_dtype)

    def head_logits_local(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits [b, s, vocab] through the tied embedding."""
        return linear_f32(self.final_layernorm(h), self.embedding.weight)

    def forward(self, tokens: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """With ``labels``, per-token losses [b, s] (fp32); otherwise fp32
        logits.  ``dropout_seed`` (an int) switches the config's attention
        and hidden dropout on (training mode)."""
        if attention_mask is not None:
            raise NotImplementedError(
                "attention masks are not ported: the GPT path is causal "
                "self-attention without padding (ROADMAP.md)")
        h = embedding_dropout(self.embed(tokens), self.cfg, dropout_seed)
        h = self.transformer(h, dropout_seed)
        if labels is None:
            return self.head_logits_local(h)
        if self.cfg.compute_dtype != torch.float32:
            # half-precision single-shard head: projection and loss fused,
            # only bf16 logits + fp32 lse kept for the backward
            hn = self.final_layernorm(h)
            b, s, hid = hn.shape
            return fused_linear_cross_entropy(
                hn.reshape(b * s, hid), self.embedding.weight,
                labels.reshape(b * s)).reshape(b, s)
        return vocab_parallel_cross_entropy(self.head_logits_local(h), labels)


__all__ = ["GPTConfig", "GPTModel", "ParallelAttention", "ParallelMLP",
           "ParallelTransformerLayer", "ParallelTransformer",
           "embedding_dropout", "REMAT_POLICIES"]
