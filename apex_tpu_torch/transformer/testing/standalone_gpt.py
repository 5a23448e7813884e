"""Standalone Megatron GPT: the training path's model.

PyTorch port of the JAX package's
``apex_tpu/transformer/testing/standalone_gpt.py`` (pre-LN GPT-2): word +
learned position embedding, N x (LN -> self-attention -> residual -> LN
-> GELU MLP -> residual), final LN, logits through the tied word
embedding, per-token loss.  Layers are an ``nn.ModuleList``, not a scan;
parameter names are the JAX tree's paths (``transformer.layers.<i>...``
for the JAX leading layer axis), see :mod:`.convert`.

What runs where: the LayerNorms are ``ops.layer_norm`` (``csrc/
layer_norm_sm90.cu`` or ``layer_norm.cu`` on the card).  Attention has the
JAX model's two paths.  With ``use_flash_attention`` and no mask or a
key-padding mask it is ``ops.flash_attention_qkv`` straight from the QKV
projection (the packed kernels of ``csrc/flash_qkv_*.cu``), a key-padding
mask [b, 1, 1, s] (True = masked key) and packing ids folded into the
kernels' segment ids as the JAX ``ParallelAttention.apply`` folds them.
Otherwise (``use_flash_attention=False``, the JAX default, or any other
boolean mask) the scores are materialised: ``q k^T`` accumulated in fp32,
scaled by 1/sqrt(hn) in fp32, cast to the model dtype, then
``ops.FusedScaleMaskSoftmax`` (causal for GPT, padding for BERT; packing
ids become a boolean cross-segment mask), dropout on the probabilities
from the per-TP-rank stream, and ``probs v`` accumulated in fp32: the JAX
path's two products, which it leaves to XLA as the port leaves them to
the library.  The GEMMs are fp32-accumulated library products.  The body
is shared with BERT (:mod:`.standalone_bert`):
``ParallelAttention(causal=False)``.
With labels, a bf16 model at tp = 1 takes the fused LM-head
cross-entropy and every other model the plain vocab-parallel one (the
JAX package's choice).

Remat (``cfg.remat``) checkpoints each layer with
``torch.utils.checkpoint`` (non-reentrant); ``remat_policy`` picks what a
selective checkpoint keeps, with the JAX policies' meaning:
``"full"`` keeps nothing (everything is recomputed); ``"dots"`` keeps the
output of every product (the parallel linear layers' ops and the
attention products: ``dots_saveable``); ``"attn_res"`` keeps the
attention kernel's outputs (ctx, lse), so the recompute never re-runs K3;
``"attn_res_mlp"`` keeps those and the pre-GELU h->4h output (the layer
named ``mlp_4h``); ``"attn_out"`` keeps the attention block's output (the
projection named ``attn_out``), and the attention kernel still re-runs to
rebuild its own residuals.  Where JAX names a tensor with
``checkpoint_name``, the port saves the op of the layer of that name
(:data:`~apex_tpu_torch.transformer.tensor_parallel.layers.
PARALLEL_LINEAR_OP`).  Unlike ``jax.checkpoint``, the recompute re-runs
every op that is not saved, even one whose output nothing needs.  An
unknown policy raises ``ValueError``, as in JAX.  Dropout seeds are
integers fixed by (step seed, layer, site) and each site re-creates its
generator, so the recompute redraws the same masks.

Tensor parallelism (``cfg.tp_size`` above 1, in each rank of a
registered tensor group of that size, :mod:`apex_tpu_torch.transformer.
parallel_state`) follows the JAX model: each rank holds heads / tp heads
(the QKV projection's rows sliced as the JAX ``shard_master`` slices
them, whole heads of the packed q | k | v layout), the projections are
column- then row-parallel, the word embedding and the tied head are
vocab-parallel, and the loss is the vocab-parallel cross entropy over
fp32 sharded logits (the fused LM-head cross entropy is the tp = 1 head
only, as in JAX).  Attention-probability dropout draws from the per-rank
stream (``model_parallel_dropout_seed(seed, tp_rank)``), hidden dropout
from the replicated one, so every rank holds the same hidden state.
Every rank draws the whole master weights from ``seed`` and keeps its
shard, so tp ranks start from the tp = 1 model.

Mixture-of-Experts (``cfg.num_experts > 0``, the JAX model's): every
layer's MLP is a :class:`~apex_tpu_torch.transformer.moe.SwitchMLP` over
the layer's tokens (``[b, s, h]`` flattened), its experts replicated
across tp as JAX's ``shard_master`` leaves them (shard them over an
expert group with ``SwitchMLP`` directly); each layer returns its
load-balancing loss beside its output, the stack sums them (through the
checkpoint under every remat policy: the MoE names no value, so only
``"full"`` and ``"dots"`` treat it as they treat any op) and
:meth:`GPTModel.forward` adds ``moe_aux_loss_coeff · aux`` to every
token's loss.  fp16 (``cfg.fp16``, amp's half) runs on the card through
the fp16 instances of the packed-attention and LayerNorm kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.attention import FLASH_QKV_FWD_OP, flash_attention_qkv
from apex_tpu_torch.ops.fused_layer_norm import FusedLayerNorm
from apex_tpu_torch.ops.fused_linear_xent import fused_linear_cross_entropy
from apex_tpu_torch.ops._gemm import bmm_f32, linear_f32
from apex_tpu_torch.ops.fused_softmax import (AttnMaskType,
                                              FusedScaleMaskSoftmax)
from apex_tpu_torch.transformer.moe import MoEConfig, SwitchMLP
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    normal_init, vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    PARALLEL_LINEAR_OP)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint, dropout, fold_in, model_parallel_dropout_seed)

REMAT_POLICIES = ("full", "dots", "attn_res", "attn_res_mlp", "attn_out")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Network-size args (the JAX ``GPTConfig`` without its TPU tiling
    knobs ``flash_block_q``/``flash_block_k``).  ``num_experts > 0``
    replaces every layer's MLP with a Switch-routed expert MLP of
    ``moe_capacity_factor``, whose load-balancing loss, times
    ``moe_aux_loss_coeff``, is folded into every token's loss."""

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
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coeff: float = 1e-2

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
    if cfg.num_attention_heads % cfg.tp_size:
        raise ValueError(f"{cfg.num_attention_heads} heads do not divide "
                         f"over tp_size={cfg.tp_size}")
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        # a misspelled policy must not silently degrade to full recompute
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; "
            "expected full|dots|attn_res|attn_res_mlp|attn_out")


#: the products ``"dots"`` keeps besides the parallel linear layers: the
#: attention's two batched products on the materialised-scores path
_DOT_OPS = (torch.ops.aten.mm, torch.ops.aten.bmm)


def _keeps(policy: str, op, args) -> bool:
    """Whether remat ``policy`` keeps the output of ``op`` called with
    ``args`` (a parallel linear layer's name is its op's last argument)."""
    name = args[-1] if op == PARALLEL_LINEAR_OP else None
    if policy == "dots":
        return (op == PARALLEL_LINEAR_OP
                or getattr(op, "overloadpacket", None) in _DOT_OPS)
    if policy == "attn_res":
        return op == FLASH_QKV_FWD_OP
    if policy == "attn_res_mlp":
        return op == FLASH_QKV_FWD_OP or name == "mlp_4h"
    return policy == "attn_out" and name == "attn_out"


def _policy(policy, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if _keeps(policy, op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context_fn(policy: str):
    """The ``context_fn`` of a layer checkpoint under ``policy`` (None for
    ``"full"``: a plain checkpoint)."""
    if policy == "full":
        return None
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_policy, policy))


def is_key_padding(attention_mask: torch.Tensor) -> bool:
    """A [b, 1, 1, s] mask: hides keys only (True = masked key)."""
    return attention_mask.ndim == 4 and attention_mask.shape[1:3] == (1, 1)


def softmax_mask(attention_mask: Optional[torch.Tensor],
                 segment_ids: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
    """The fused-softmax path's boolean mask (True = masked): the caller's
    mask, or'ed with the cross-segment mask of packing ids [b, s]
    ([b, 1, s, s]), as the JAX ``ParallelAttention.apply`` builds it."""
    mask = None if attention_mask is None else attention_mask.bool()
    if segment_ids is not None:
        cross = segment_ids[:, None, :, None] != segment_ids[:, None, None, :]
        mask = cross if mask is None else cross | mask
    return mask


def attention_segments(attention_mask: Optional[torch.Tensor],
                       segment_ids: Optional[torch.Tensor]):
    """The packed kernels' segment ids for a key-padding mask and packing
    ids, as the JAX ``ParallelAttention.apply`` folds them: packing ids
    alone as they are; a mask alone as (ones, keep), so pad keys are
    hidden from every query and pad queries still see the real keys;
    both as (ids, ids with pad keys at -1), a bucket no real segment
    uses.  Any other mask raises ``ValueError``: it takes the
    fused-softmax path (:func:`softmax_mask`)."""
    if attention_mask is None:
        return segment_ids
    if not is_key_padding(attention_mask):
        raise ValueError(
            f"attention mask of shape {tuple(attention_mask.shape)}: only a "
            "key-padding mask [b, 1, 1, s] folds into segment ids (any other "
            "mask takes the fused-softmax path)")
    pad = attention_mask[:, 0, 0, :].bool()
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        return seg, torch.where(pad, -1, seg)
    keep = (~pad).to(torch.int32)
    return torch.ones_like(keep), keep


class ParallelAttention(nn.Module):
    """Self-attention (reference standalone_gpt.py:283): the packed-QKV
    flash op, or the materialised scores through the fused softmax;
    causal for GPT, bidirectional for BERT (``causal``, the counterpart of
    the JAX module's ``softmax.attn_mask_type``)."""

    def __init__(self, cfg: GPTConfig, *, causal: bool = True, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        init = normal_init(cfg.init_method_std)
        self.qkv = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, gather_output=False,
            init_method=init, tp_size=cfg.tp_size, device=device,
            generator=generator, name="qkv")
        # named for remat_policy="attn_out": the attention block's output
        self.proj = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, input_is_parallel=True,
            init_method=init, tp_size=cfg.tp_size, device=device,
            generator=generator, name="attn_out")
        self.softmax = FusedScaleMaskSoftmax(
            input_in_fp16=cfg.fp16, input_in_bf16=cfg.bf16,
            attn_mask_type=(AttnMaskType.causal if causal
                            else AttnMaskType.padding),
            scaled_masked_softmax_fusion=True, softmax_in_fp32=True,
            scale=None)
        self.np_local = cfg.num_attention_heads // cfg.tp_size

    def forward(self, h: torch.Tensor, dropout_seed: Optional[int] = None,
                segment_ids=None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The flash op when the config asks for it and no
        ``attention_mask`` is given (``segment_ids``: the packed kernels'
        ids, None, one int [b, s] tensor or a (seg_q, seg_k) pair, as
        :func:`attention_segments` folds them); otherwise the fused-softmax
        path under the boolean ``attention_mask`` (True = masked;
        :func:`softmax_mask` folds packing ids into it)."""
        cfg = self.cfg
        qkv = self.qkv(h)  # [b, s, 3 * hidden / tp], per head q | k | v
        drop = (dropout_seed is not None and cfg.attention_dropout > 0)
        if drop:
            # the probs are head-sharded over TP: per-rank stream
            drop_seed = model_parallel_dropout_seed(dropout_seed,
                                                    self.qkv.tp_rank)
        if cfg.use_flash_attention and attention_mask is None:
            kw = {}
            if drop:
                kw = dict(dropout_rate=cfg.attention_dropout,
                          dropout_seed=drop_seed & 0xFFFFFFFF)
            ctx = flash_attention_qkv(qkv, self.np_local, causal=self.causal,
                                      segment_ids=segment_ids, **kw)
            return self.proj(ctx.to(h.dtype))
        b, s, _ = h.shape
        n, hn = self.np_local, cfg.kv_channels
        q, k, v = qkv.view(b, s, n, 3 * hn).split(hn, dim=-1)
        # scores [b, n, s, s]: 1/sqrt(hn) in fp32, as the JAX norm factor
        scale = float(np.float32(1.0) / np.sqrt(np.float32(hn)))
        scores = bmm_f32(q.transpose(1, 2).reshape(b * n, s, hn),
                         k.permute(0, 2, 3, 1).reshape(b * n, hn, s))
        scores = (scores * scale).to(h.dtype).view(b, n, s, s)
        probs = self.softmax(scores, attention_mask)
        if drop:
            probs = dropout(probs, cfg.attention_dropout, drop_seed)
        ctx = bmm_f32(probs.reshape(b * n, s, s),
                      v.transpose(1, 2).reshape(b * n, s, hn))
        ctx = ctx.view(b, n, s, hn).transpose(1, 2).reshape(b, s, n * hn)
        return self.proj(ctx.to(h.dtype))


class ParallelMLP(nn.Module):
    """h -> 4h -> h with tanh GELU (``jax.nn.gelu(approximate=True)``)."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        init = normal_init(cfg.init_method_std)
        # named for remat_policy="attn_res_mlp": the pre-GELU h->4h output
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, gather_output=False, init_method=init,
            tp_size=cfg.tp_size, device=device, generator=generator,
            name="mlp_4h")
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn, cfg.hidden_size, input_is_parallel=True,
            init_method=init, tp_size=cfg.tp_size, device=device,
            generator=generator, name="mlp_out")

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
    """Pre-LN block (reference standalone_gpt.py:575); with
    ``cfg.num_experts > 0`` the MLP is a Switch-routed expert MLP."""

    def __init__(self, cfg: GPTConfig, *, causal: bool = True, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        eps = cfg.layernorm_epsilon
        self.input_layernorm = FusedLayerNorm(h, eps, device=device)
        self.attention = ParallelAttention(cfg, causal=causal, device=device,
                                           generator=generator)
        self.post_attention_layernorm = FusedLayerNorm(h, eps, device=device)
        if cfg.num_experts > 0:
            # experts replicated across tp (JAX's shard_master leaves the
            # MoE MLP whole)
            self.mlp = SwitchMLP(MoEConfig(
                hidden_size=h, ffn_hidden_size=cfg.ffn,
                num_experts=cfg.num_experts,
                capacity_factor=cfg.moe_capacity_factor,
                init_method_std=cfg.init_method_std), device=device,
                generator=generator)
        else:
            self.mlp = ParallelMLP(cfg, device=device, generator=generator)

    def forward(self, h: torch.Tensor, dropout_seed: Optional[int] = None,
                segment_ids=None,
                attention_mask: Optional[torch.Tensor] = None):
        """``(h, aux)``: the block's output and the MoE load-balancing loss
        (``0.0`` for the dense MLP).  ``segment_ids``, ``attention_mask``:
        as :meth:`ParallelAttention.forward` takes them."""
        s_attn = s_h1 = s_h2 = None
        if dropout_seed is not None:
            s_attn, s_h1, s_h2 = (fold_in(dropout_seed, i) for i in range(3))
        attn = self.attention(self.input_layernorm(h), s_attn, segment_ids,
                              attention_mask)
        h = h + _hidden_dropout(attn, self.cfg, s_h1)
        ln2 = self.post_attention_layernorm(h)
        if self.cfg.num_experts > 0:
            b, s, hid = ln2.shape
            out, aux = self.mlp(ln2.reshape(b * s, hid))
            out = out.reshape(b, s, hid).to(h.dtype)
        else:
            out, aux = self.mlp(ln2), 0.0
        return h + _hidden_dropout(out, self.cfg, s_h2), aux


class ParallelTransformer(nn.Module):
    """The layer stack, one module per layer, each checkpointed under
    ``cfg.remat``."""

    def __init__(self, cfg: GPTConfig, num_layers: Optional[int] = None, *,
                 causal: bool = True, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        n = cfg.num_layers if num_layers is None else num_layers
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(cfg, causal=causal, device=device,
                                     generator=generator)
            for _ in range(n))

    def forward(self, h: torch.Tensor, dropout_seed: Optional[int] = None,
                attention_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None):
        """``(h, aux)``: the stack's output and the sum of its layers' MoE
        load-balancing losses (``0.0`` for dense MLPs).
        ``attention_mask`` (boolean, True = masked) and ``segment_ids``
        (packing ids [b, s]), folded once for every layer: into the packed
        kernels' segment ids (:func:`attention_segments`) on the flash
        path, which takes no mask or a key-padding mask; into one boolean
        mask (:func:`softmax_mask`) on the fused-softmax path, which takes
        every other case."""
        if self.cfg.use_flash_attention and (
                attention_mask is None or is_key_padding(attention_mask)):
            seg, mask = attention_segments(attention_mask, segment_ids), None
        else:
            seg, mask = None, softmax_mask(attention_mask, segment_ids)
        remat = self.cfg.remat and torch.is_grad_enabled()
        context_fn = remat_context_fn(self.cfg.remat_policy)
        aux_sum = 0.0
        for i, layer in enumerate(self.layers):
            seed = None if dropout_seed is None else fold_in(dropout_seed, i)
            if remat:
                h, aux = checkpoint(layer, h, seed, seg, mask,
                                    context_fn=context_fn)
            else:
                h, aux = layer(h, seed, seg, mask)
            aux_sum = aux_sum + aux
        return h, aux_sum


class GPTModel(nn.Module):
    """Embeddings + transformer + tied LM head (reference
    standalone_gpt.py:1426).  Built on ``device`` (``None``: the card,
    raising without one; ``"cpu"`` runs the plain versions of the
    kernels), weights drawn from ``seed`` with a generator on that
    device, fp32 masters.

    ``pre_process`` / ``post_process`` (the JAX model's flags) build a
    pipeline stage: without ``pre_process`` no word or position
    embedding; without ``post_process`` no final LayerNorm and no head.
    A stage with the head but not the embedding (the last of a pipeline)
    keeps its own copy of the word embedding for the head, drawn first
    from ``seed`` as the first stage draws its embedding, so the two
    start equal; nothing ties them in training (the JAX model's untied
    stage).  A stage runs through :func:`make_gpt_stage_fns`;
    :meth:`forward` takes the whole model."""

    def __init__(self, cfg: GPTConfig, num_layers: Optional[int] = None, *,
                 device=None, seed: int = 0, pre_process: bool = True,
                 post_process: bool = True):
        super().__init__()
        dev = resolve_device(device)
        _refuse_unported(cfg, dev)
        self.cfg = cfg
        self.pre_process = pre_process
        self.post_process = post_process
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init = normal_init(cfg.init_method_std)
        if pre_process or post_process:
            self.embedding = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, init_method=init,
                tp_size=cfg.tp_size, device=dev, generator=gen)
        if pre_process:
            self.position_embeddings = nn.Embedding(
                cfg.max_position_embeddings, cfg.hidden_size, device=dev,
                _weight=init((cfg.max_position_embeddings, cfg.hidden_size),
                             gen, dev))
        self.transformer = ParallelTransformer(cfg, num_layers, device=dev,
                                               generator=gen)
        if post_process:
            self.final_layernorm = FusedLayerNorm(
                cfg.hidden_size, cfg.layernorm_epsilon, device=dev)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.embedding(tokens)
        pos = self.position_embeddings.weight[:tokens.shape[1]]
        return (h + pos[None]).to(self.cfg.compute_dtype)

    def head_logits_local(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits [b, s, vocab / tp] through this rank's shard of the
        tied embedding (the final LayerNorm's output enters the copy
        region: its gradient is summed over the tp ranks)."""
        hn = copy_to_tensor_model_parallel_region(
            self.final_layernorm(h), self.embedding.tp_group)
        return linear_f32(hn, self.embedding.weight)

    def forward(self, tokens: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """With ``labels``, per-token losses [b, s] (fp32); otherwise fp32
        logits.  ``dropout_seed`` (an int) switches the config's attention
        and hidden dropout on (training mode).  ``attention_mask``: a
        boolean mask broadcastable to [b, heads, s, s] (True = masked),
        applied on top of the causal mask; on the flash path a key-padding
        mask [b, 1, 1, s] stays on the packed kernels and any other mask
        takes the fused-softmax path, as in the JAX model."""
        if not (self.pre_process and self.post_process):
            raise ValueError("a pipeline stage (pre_process or post_process "
                             "False) runs through make_gpt_stage_fns")
        h = embedding_dropout(self.embed(tokens), self.cfg, dropout_seed)
        h, aux = self.transformer(h, dropout_seed, attention_mask)
        if labels is None:
            return self.head_logits_local(h)
        if self.cfg.tp_size == 1 and self.cfg.compute_dtype != torch.float32:
            # half-precision single-shard head: projection and loss fused,
            # only bf16 logits + fp32 lse kept for the backward
            hn = self.final_layernorm(h)
            b, s, hid = hn.shape
            losses = fused_linear_cross_entropy(
                hn.reshape(b * s, hid), self.embedding.weight,
                labels.reshape(b * s)).reshape(b, s)
        else:
            losses = vocab_parallel_cross_entropy(
                self.head_logits_local(h), labels, self.embedding.tp_group)
        if self.cfg.num_experts > 0:
            # the load-balancing term per token, so that mean(losses) is
            # the mean cross entropy + coeff x aux (the JAX model's rule)
            losses = losses + (self.cfg.moe_aux_loss_coeff * aux
                               ).to(losses.dtype)
        return losses


def gpt_model_provider(cfg: GPTConfig, pre_process: bool = True,
                       post_process: bool = True, *,
                       num_layers: Optional[int] = None, device=None,
                       seed: int = 0) -> GPTModel:
    """Reference gpt_model_provider (standalone_gpt.py:1502);
    ``num_layers`` sizes a pipeline chunk."""
    return GPTModel(cfg, num_layers, device=device, seed=seed,
                    pre_process=pre_process, post_process=post_process)


# -- pipeline adaptation -----------------------------------------------------

def make_gpt_stage_fns(cfg: GPTConfig, n_stages: int):
    """``(stage_fn, loss_fn)`` of a GPT split into ``n_stages`` pipeline
    stages (virtual stages with interleaving), for the schedules of
    :mod:`apex_tpu_torch.transformer.pipeline_parallel` (the JAX
    package's ``make_gpt_stage_fns``).  Each stage is a :class:`GPTModel`
    of ``cfg.num_layers / n_stages`` layers (``build_model`` with
    :func:`gpt_model_provider`, or ``convert.stage_state_dict`` for
    weights); microbatches are dicts of ``"tokens"`` and ``"labels"``.

    ``stage_fn(stage, h_in, mb[, k])``: the first stage embeds word and
    position, every other takes ``h_in`` in the compute dtype; then the
    stage's layers, **without dropout** whatever the config's rates (the
    JAX stage passes no dropout key, so its stages are deterministic).
    ``loss_fn(stage, h, mb)``: the last stage's mean vocab-parallel cross
    entropy over fp32 logits through its final LayerNorm and its own copy
    of the word embedding (not the fused bf16 head of
    :meth:`GPTModel.forward` at tp = 1).  A MoE config warns, as JAX's
    does: a stage's output is one hidden tensor, so the load-balancing
    loss is dropped at every stage boundary."""
    if cfg.num_layers % n_stages != 0:
        raise ValueError("num_layers must divide evenly into stages")
    if cfg.num_experts:
        warnings.warn(
            "MoE under pipeline parallelism drops the load-balancing aux "
            "loss (stage outputs are a single hidden tensor) — routing "
            "can silently collapse. Use MoE with TP/DP, or thread a "
            "custom stage contract that carries the aux loss.",
            stacklevel=2)

    def stage_fn(stage, h_in, mb, k=0):
        if stage.pre_process:
            h = stage.embed(mb["tokens"])
        else:
            h = h_in.to(cfg.compute_dtype)
        h, _aux = stage.transformer(h)    # aux dropped, as in JAX
        return h

    def loss_fn(stage, h_out, mb):
        return vocab_parallel_cross_entropy(
            stage.head_logits_local(h_out), mb["labels"],
            stage.embedding.tp_group).mean()

    return stage_fn, loss_fn


__all__ = ["GPTConfig", "GPTModel", "gpt_model_provider",
           "make_gpt_stage_fns", "ParallelAttention", "ParallelMLP",
           "ParallelTransformerLayer", "ParallelTransformer",
           "attention_segments", "embedding_dropout", "is_key_padding",
           "remat_context_fn", "softmax_mask", "REMAT_POLICIES"]
