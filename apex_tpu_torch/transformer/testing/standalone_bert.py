"""Standalone Megatron BERT: the masked-language-model training path.

PyTorch port of the JAX package's
``apex_tpu/transformer/testing/standalone_bert.py``.  It shares the
transformer body with :mod:`.standalone_gpt`, bidirectional
(``causal=False``), with BERT's own parts: token-type embeddings, learned
positions that may be given per token (varlen packing restarts them at
each segment), a tanh pooler over the first token with the binary (NSP)
head, and the MLM head (dense, tanh GELU, LayerNorm, the tied word
embedding, a vocab-length bias) before the per-token cross entropy.  The
body has no final LayerNorm.

Attention takes padding as the JAX model does: ``attention_mask`` [b, s]
(1 = real token) becomes a key-padding mask, and with ``segment_ids``
(packing ids, pad tail in its own bucket) both fold into the packed
kernels' segment ids (:func:`.standalone_gpt.attention_segments`), so a
bf16 BERT-large step runs ``csrc/flash_qkv_*_sm90.cu`` at head dim 64,
not causal.

Dtypes are the JAX package's: the body computes in the config's dtype;
the MLM head multiplies the body's output by fp32 master weights, which
in JAX promotes the whole head to fp32 (dense, GELU, LayerNorm and the
logits), so here it runs in fp32 too, and the loss is the plain
vocab-parallel cross entropy over fp32 logits (not the GPT path's fused
bf16 head).  Parameter names are the JAX tree's paths (see :mod:`.convert`).

At ``cfg.tp_size`` above 1 the body and the word embedding are
tensor-parallel as in the GPT (:mod:`.standalone_gpt`), the MLM head's
vocab-length bias is sharded with the vocab (rank r keeps [r n, (r + 1)
n), as the JAX ``shard_master`` shards it), its logits are this rank's
vocab shard and the loss is the vocab-parallel cross entropy; the
pooler, the binary head and the head's dense layer and LayerNorm are
replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.fused_layer_norm import FusedLayerNorm
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding, copy_to_tensor_model_parallel_region,
    normal_init, set_tensor_model_parallel_attributes,
    vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTConfig, ParallelTransformer, _refuse_unported, embedding_dropout)


@dataclasses.dataclass(frozen=True)
class BertConfig(GPTConfig):
    """BERT reuses the network-size config, plus token types and the NSP
    head."""

    num_tokentypes: int = 2
    add_binary_head: bool = True


class _Dense(nn.Module):
    """An fp32 weight [out, in] drawn by ``init`` and a zero bias, applied
    as x W^T + b (the JAX head's ``h @ w.T + b``)."""

    def __init__(self, size: int, init, generator, device):
        super().__init__()
        self.weight = nn.Parameter(init((size, size), generator, device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(x, self.weight, self.bias)


class BertLMHead(nn.Module):
    """dense -> tanh GELU -> LayerNorm, then the tied projection plus a
    vocab-length bias; fp32 throughout (reference BertLmHead)."""

    def __init__(self, cfg: BertConfig, init, generator, device,
                 tp_group=None):
        super().__init__()
        h = cfg.hidden_size
        self.tp_group = tp_group
        self.dense = _Dense(h, init, generator, device)
        self.layernorm = FusedLayerNorm(h, cfg.layernorm_epsilon,
                                        device=device)
        self.bias = nn.Parameter(torch.zeros(
            cfg.vocab_size // cfg.tp_size, device=device))
        set_tensor_model_parallel_attributes(self.bias, True, 0)

    def forward(self, h: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        h = self.dense(h.float())
        h = torch.nn.functional.gelu(h, approximate="tanh")
        h = copy_to_tensor_model_parallel_region(self.layernorm(h),
                                                 self.tp_group)
        return torch.nn.functional.linear(h, word, self.bias)


class BertModel(nn.Module):
    """Embeddings + bidirectional transformer + pooler, binary head and
    MLM head (reference standalone_bert.py:101).  Built on ``device``
    (``None``: the card, raising without one; ``"cpu"`` runs the plain
    versions of the kernels), weights drawn from ``seed`` with a generator
    on that device, fp32 masters."""

    def __init__(self, cfg: BertConfig, num_layers: Optional[int] = None, *,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        _refuse_unported(cfg, dev)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init = normal_init(cfg.init_method_std)
        h = cfg.hidden_size
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, h, init_method=init, tp_size=cfg.tp_size,
            device=dev, generator=gen)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, h, device=dev,
            _weight=init((cfg.max_position_embeddings, h), gen, dev))
        if cfg.num_tokentypes > 0:
            self.tokentype_embeddings = nn.Embedding(
                cfg.num_tokentypes, h, device=dev,
                _weight=init((cfg.num_tokentypes, h), gen, dev))
        self.transformer = ParallelTransformer(cfg, num_layers, causal=False,
                                               device=dev, generator=gen)
        self.lm_head = BertLMHead(cfg, init, gen, dev,
                                  self.embedding.tp_group)
        if cfg.add_binary_head:
            self.pooler = _Dense(h, init, gen, dev)
            self.binary_head = nn.Linear(h, 2, device=dev)
            nn.init.zeros_(self.binary_head.weight)
            nn.init.zeros_(self.binary_head.bias)

    def embed(self, tokens: torch.Tensor,
              tokentype_ids: Optional[torch.Tensor] = None,
              position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.embedding(tokens)
        pos = self.position_embeddings.weight
        if position_ids is None:
            h = h + pos[:tokens.shape[1]][None]
        else:
            # varlen packing: positions restart at each segment, so every
            # packed sequence sees the position embeddings it would padded
            h = h + pos[position_ids.long()]
        if tokentype_ids is not None and self.cfg.num_tokentypes > 0:
            h = h + self.tokentype_embeddings.weight[tokentype_ids.long()]
        return h.to(self.cfg.compute_dtype)

    def forward(self, tokens: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                tokentype_ids: Optional[torch.Tensor] = None,
                lm_labels: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None,
                segment_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(lm_losses_or_logits, binary_logits)``: with ``lm_labels``
        per-token losses [b, s], otherwise fp32 logits [b, s, vocab];
        ``binary_logits`` [b, 2] with the binary head, else None.
        ``attention_mask`` [b, s]: 1 = real token.  ``segment_ids`` [b,
        s]: packing ids; pass ``position_ids`` restarting at each segment.
        ``dropout_seed`` (an int) switches the config's dropout on."""
        h = self.embed(tokens, tokentype_ids, position_ids)
        h = embedding_dropout(h, self.cfg, dropout_seed)
        am = None
        if attention_mask is not None:   # [b, s] -> [b, 1, 1, s], True = pad
            am = ~attention_mask[:, None, None, :].bool()
        h, _aux = self.transformer(h, dropout_seed, am, segment_ids)
        binary_logits = None
        if self.cfg.add_binary_head:
            pooled = torch.tanh(self.pooler(h[:, 0].float()))
            binary_logits = self.binary_head(pooled)
        logits = self.lm_head(h, self.embedding.weight)
        if lm_labels is None:
            return logits, binary_logits
        return (vocab_parallel_cross_entropy(logits, lm_labels,
                                             self.embedding.tp_group),
                binary_logits)


def bert_model_provider(cfg: BertConfig, *, device=None,
                        seed: int = 0) -> BertModel:
    """Reference bert_model_provider (standalone_bert.py:215)."""
    return BertModel(cfg, device=device, seed=seed)


__all__ = ["BertConfig", "BertLMHead", "BertModel", "bert_model_provider"]
