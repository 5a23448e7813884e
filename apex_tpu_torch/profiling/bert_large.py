"""The BERT-large MLM workload: ``bench.py``'s BERT-large path, ported.

PyTorch port of the pieces of ``bench.py`` that build and drive its
BERT-large flagship (the workload class the reference FMHA exists for:
sequences of at most 512 tokens, head dim 64, varlen packing):

* :func:`bert_lengths` (``bench.py::bert_lengths``, 615): the
  deterministic length distribution;
* :func:`bert_pack_rows` (``_bert_pack_rows``, 1506): first-fit-decreasing
  packing of sequences into rows;
* :func:`bert_batches` (``_bert_batches``, 1524): the same real tokens as
  padded rows with a key-padding mask and as packed rows with segment
  ids (pad tail in its own bucket), positions restarting per segment and
  a real-token loss mask;
* :func:`bert_analytic_flops` (630): the step's model flops;
* :func:`bert_large_config`, :func:`bert_setup` and :func:`train_step`:
  the model and step of ``_bert_setup`` (1580): 24 layers, hidden 1024, 16
  heads of 64, vocab 30592, sequence 512, bf16, flash attention, remat
  ``attn_res``, no token types, no binary head, ``FusedAdam(lr=1e-4)``,
  the loss ``sum(losses * loss_mask) / sum(loss_mask)``.

The data is numpy from the bench's seeds (7 for the lengths, 11 for the
tokens), so padded and packed see the identical workload.  The model's
weights are drawn from a torch seed (not JAX's); the entry points build
on the card unless asked for the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.testing.standalone_bert import (BertConfig,
                                                                BertModel)

BERT_L, BERT_H, BERT_HEADS, BERT_V, BERT_SEQ = 24, 1024, 16, 30592, 512
BERT_SEQS = 16      # sequences in the workload (bench.py's BENCH_BERT_SEQS)
BERT_LR = 1e-4

Batch = Dict[str, torch.Tensor]


def bert_lengths(n: int, seq: int = BERT_SEQ, seed: int = 7) -> np.ndarray:
    """``n`` sequence lengths: ~25 % at the full window, the rest uniform
    in [seq/8, seq) rounded down to 8, at least 8 (the bimodal shape of
    Wikipedia-style MLM data; mean about 0.67 seq)."""
    rng = np.random.RandomState(seed)
    lens = np.where(rng.rand(n) < 0.25, seq,
                    (rng.randint(seq // 8, seq, size=n) // 8) * 8)
    return np.maximum(lens, 8).astype(np.int64)


def bert_pack_rows(lens, seq: int = BERT_SEQ) -> List[List[int]]:
    """Greedy first-fit-decreasing packing of sequence indices into rows
    of capacity ``seq``; deterministic."""
    order = sorted(range(len(lens)), key=lambda i: -int(lens[i]))
    rows: List[List[int]] = []
    space: List[int] = []
    for i in order:
        n = int(lens[i])
        for r, free in enumerate(space):
            if free >= n:
                rows[r].append(i)
                space[r] -= n
                break
        else:
            rows.append([i])
            space.append(seq - n)
    return rows


def bert_batches(n_seq: int = BERT_SEQS, seq: int = BERT_SEQ,
                 vocab: int = BERT_V, *, device=None
                 ) -> Tuple[Batch, Batch, int, int]:
    """The same deterministic MLM workload in both layouts: ``(padded,
    packed, n_real_tokens, seq_sq_sum)``.

    ``padded``: one row per sequence, ``tokens``, ``labels``,
    ``loss_mask`` and ``attention_mask`` (1 = real token).  ``packed``:
    the sequences first-fit into rows of ``seq`` (:func:`bert_pack_rows`),
    ``tokens``, ``labels``, ``loss_mask``, ``segment_ids`` (0, 1, ... a
    row, the pad tail its own bucket) and ``position_ids`` (restarting per
    segment).  int32 tensors on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    lens = bert_lengths(n_seq, seq)
    rng = np.random.RandomState(11)
    seqs = [rng.randint(1, vocab, size=int(n)) for n in lens]
    labs = [rng.randint(0, vocab, size=int(n)) for n in lens]

    def tensors(**arrays):
        return {k: torch.from_numpy(a).to(dev) for k, a in arrays.items()}

    tok, lab, msk = (np.zeros((n_seq, seq), np.int32) for _ in range(3))
    for i, (t, lb) in enumerate(zip(seqs, labs)):
        tok[i, :len(t)], lab[i, :len(t)], msk[i, :len(t)] = t, lb, 1
    padded = tensors(tokens=tok, labels=lab, loss_mask=msk,
                     attention_mask=msk)

    rows = bert_pack_rows(lens, seq)
    tok, lab, msk, segs, pos = (np.zeros((len(rows), seq), np.int32)
                                for _ in range(5))
    for r, idxs in enumerate(rows):
        at = 0
        for j, i in enumerate(idxs):
            n = len(seqs[i])
            tok[r, at:at + n], lab[r, at:at + n] = seqs[i], labs[i]
            msk[r, at:at + n] = 1
            segs[r, at:at + n] = j
            pos[r, at:at + n] = np.arange(n)
            at += n
        segs[r, at:] = len(idxs)    # the pad tail: a segment of its own
    packed = tensors(tokens=tok, labels=lab, loss_mask=msk, segment_ids=segs,
                     position_ids=pos)
    n_real = int(sum(len(t) for t in seqs))
    seq_sq = int(sum(len(t) ** 2 for t in seqs))
    return padded, packed, n_real, seq_sq


def bert_analytic_flops(n_tokens: int, seq_sq_sum: int, L: int = BERT_L,
                        H: int = BERT_H, V: int = BERT_V) -> int:
    """Model flops of one MLM step (forward and backward, matrix products
    only) over ``n_tokens`` real tokens whose sequence lengths square-sum
    to ``seq_sq_sum``: body GEMMs 12 H^2 a token a layer, bidirectional
    attention 4 H s_i^2 a layer, MLM head dense H^2 and tied projection H
    V a token; no recompute."""
    body = 2 * 12 * H * H * L * n_tokens
    attn = 4 * H * L * seq_sq_sum
    head = 2 * n_tokens * (H * H + H * V)
    return 3 * (body + attn + head)


def bert_large_config(**overrides) -> BertConfig:
    """BERT-large as ``bench.py::_bert_setup`` builds it; ``overrides``
    replace fields (a cut depth, fp32, another remat policy)."""
    kw = dict(num_layers=BERT_L, hidden_size=BERT_H,
              num_attention_heads=BERT_HEADS, vocab_size=BERT_V,
              max_position_embeddings=BERT_SEQ, tp_size=1, bf16=True,
              use_flash_attention=True, remat=True, remat_policy="attn_res",
              num_tokentypes=0, add_binary_head=False)
    kw.update(overrides)
    return BertConfig(**kw)


def bert_setup(cfg: Optional[BertConfig] = None, *, device=None,
               seed: int = 0) -> Tuple[BertModel, FusedAdam]:
    """The model (``cfg``, by default :func:`bert_large_config`) on
    ``device`` (``None``: the card) with weights from ``seed``, and its
    ``FusedAdam(lr=1e-4)``."""
    model = BertModel(cfg or bert_large_config(), device=device, seed=seed)
    return model, FusedAdam(model.parameters(), lr=BERT_LR)


def bert_losses(model: BertModel, batch: Batch,
                with_packing: bool) -> torch.Tensor:
    """Per-token MLM losses [rows, seq] of one batch: the padded layout
    through its key-padding mask, the packed one (``with_packing``)
    through its segment and position ids."""
    losses, _ = model(
        batch["tokens"], attention_mask=batch.get("attention_mask"),
        lm_labels=batch["labels"],
        segment_ids=batch.get("segment_ids") if with_packing else None,
        position_ids=batch.get("position_ids") if with_packing else None)
    return losses


def bert_loss(model: BertModel, batch: Batch,
              with_packing: bool) -> torch.Tensor:
    """The step's loss: the mean of the per-token losses over the real
    tokens, ``sum(losses * loss_mask) / sum(loss_mask)``."""
    m = batch["loss_mask"].float()
    return (bert_losses(model, batch, with_packing) * m).sum() / m.sum()


def train_step(model: BertModel, opt: FusedAdam, batch: Batch,
               with_packing: bool) -> torch.Tensor:
    """One MLM training step (forward, backward, ``FusedAdam``); returns
    the loss, detached."""
    loss = bert_loss(model, batch, with_packing)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


__all__ = ["BERT_H", "BERT_HEADS", "BERT_L", "BERT_LR", "BERT_SEQ",
           "BERT_SEQS", "BERT_V", "bert_analytic_flops", "bert_batches",
           "bert_large_config", "bert_lengths", "bert_loss", "bert_losses",
           "bert_pack_rows", "bert_setup", "train_step"]
