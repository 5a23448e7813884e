#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Drives the port only (it imports neither ``jax`` nor ``apex_tpu``).
It covers the six ported paths: the serving engine (phases 4-5, its
speculative, chunked and prefix-sharing modes in phases 4 and 15, and its
state, page integrity and telemetry in phase 16), the GPT
training step of ``pretrain_gpt`` (phases 6-7; under amp, O0 and O2 in
bf16 and fp16 with the fused optimizers, in phase 17; on real token
shards through a checkpoint, a preemption and a resume in phase 18), the contrib multi-head
attention training path (phases 8-9), GPT training on the flat
superblock with ``FlatFusedAdam`` (phases 10-11), the kernel
microbenches with their HBM roof and attention dot floor (phase 12) and
BERT-large training, padded and packed (phases 13-14).
Phases, each of which fails the run (non-zero exit) on error:

1. device — a CUDA card is required; its name and power limit are read
   from ``nvidia-smi``;
2. build — ``apex_tpu_torch/csrc/*.cu`` are compiled with ``nvcc`` (in
   parallel, one process per source); the tensor-core sources of K3/K4
   (``flash_qkv_*_sm90.cu``), K2 (``flash_bwd_sm90.cu``), K1
   (``flash_fwd_sm90.cu``) and K10 (``attention_dots_sm90.cu``) must show
   no spill or stack in ``ptxas -v``'s report and hold ``HGMMA`` (wgmma)
   and ``UTMALDG`` (TMA loads) in their SASS (ptxas's performance
   advisories, such as serialized wgmma, are printed); K6/K7's
   ``layer_norm_sm90.cu``, whose rows and dgamma/dbeta sums live in
   registers, must show no spill or stack either, nor K5's
   ``flash_decode_sm90.cu``, whose SASS must hold 16-byte global loads
   (``LDG.E.128``); K3/K4's head-dim-64 instances (BERT-large) and their
   fp16 instances (amp's half) at head dims 128 and 64 must all be built,
   four of each kernel at each, each with ``HGMMA`` and ``UTMALDG`` in
   its own SASS;
3. kernels — each kernel against its plain PyTorch version on the card,
   at its main path's shapes (bf16; the training kernels with and without
   dropout) and in fp32, with the tolerance stated; then timed (operands
   cold in L2) beside its plain version, one PyTorch library call
   computing the same function, and its bound.  K5 (paged decode) routes
   by pool: the bf16, int8 and fp8 pools at head dim 128 to
   ``flash_decode_sm90.cu`` (one entry point a pool), the fp32 pool to
   ``flash_decode.cu``; each pool is held to the plain version at q_len
   1, 5 (windows shorter than q_len: exact zeros), 20 and 128 (the chunk
   width; rows of the ragged batch with kv_len < 128 see nothing) over
   ragged lengths (the fp32 pool at q_len 1 and 5), each case naming the
   entry point that ran, ``flash_decode_sm90.cu``'s run twice (bitwise),
   then timed cold at the ragged batch, 8 x 300 and 8 x 1024 (16 pages a
   request), and, where the serving modes run it, at the verify step's
   [8, 16, 5, 128] (kv_len 192-448) and the chunk step's [1, 16, 128,
   128] (kv_len 256 and 384), beside its plain version and a page gather
   + SDPA with the causal offset mask, its bound counting only the
   columns each query row sees; ``flash_decode.cu`` is also called
   directly on the bf16 pool at q_len 1, 5 and 20 and at each decode
   shape, held to the plain
   version there and timed cold and in turns beside
   ``flash_decode_sm90.cu``; the card's ``quantize_tokens`` must give the CPU's codes
   and scales bit for bit.  K3/K4 route by dtype:
   bf16 to the tensor-core kernels, held to their plain versions causal
   and not, with segment ids, and at a ragged s = 1000, run twice
   (bitwise), with K4's tiles walked against :func:`flash_bwd_tiles` at
   its own tiles; fp32 to the scalar kernels; fp16 to the tensor-core
   kernels' own instances, held to the fp16 bar (2^-10 x max|ref|) causal
   with and without dropout, with segment ids at a ragged s = 1000 and at
   the padded BERT-large batch, run twice (bitwise) with their tiles
   walked, and timed beside SDPA at fp16.  The scalar kernels' bf16
   instances are timed against the tensor-core ones, cold and in turns
   (``timed_pair``).  Each case names the instance that ran: head dim 128
   (GPT) or 64 (BERT-large), one entry point each.  At head dim 64, not
   causal, at BERT-large's batches (``profiling.bert_large``: 16
   sequences padded to 512, packed into 13 rows): key padding folded as
   (ones, keep), the packing ids (pad tail in its own bucket), both
   folded, a ragged s = 500, dropout, causal with segment ids, and fp32
   on the scalar route; K4's tiles walked against :func:`flash_bwd_tiles`
   with distinct ``seg_q`` and ``seg_k``; timed cold at the padded and
   the packed batch beside the plain versions and SDPA with the ids as a
   boolean mask.  The generic attention kernels (K1 and K2, whose bf16
   routes at head dims 64 and 128 are the tensor-core
   ``flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu`` and whose fp32 and
   head dim 8 routes are the scalar ``flash_fwd.cu`` and
   ``flash_bwd.cu``; each case names the kernel that ran) are checked at
   the prefill's shape and at the
   multi-head attention path's three shapes, with each feature alone and
   combined at head dims 8, 64 and 128 in both dtypes, causal with sq <
   sk and sq > sk, an all-padded batch row (exact zeros) in both dtypes,
   an additive mask that hides every key of a batch row at a ragged key
   length, causal with a -300 mask hiding every key of a batch row (the
   tensor-core K1's FMA-chain path for mask-dominated rows), a
   zero-stride mask against the same mask materialised, K1 and
   K2 run twice (bitwise: the prefill, the encoder and the decoder's mask
   shapes), the tiles each walks against the plain statement of its skip
   rule at its route's tiles (:func:`flash_fwd_tiles`,
   :func:`flash_bwd_tiles`), and ``flash_attention_varlen`` on a
   BERT-large-shaped packed batch; K1's (at the prefill and encoder
   shapes) and K2's (encoder) scalar bf16 instances are timed against
   the tensor-core ones, cold and in turns.  K6/K7 (LayerNorm) route by
   width: fp32 and bf16 at 1024, 2048 and 4096 columns to
   ``layer_norm_sm90.cu``, other widths to ``layer_norm.cu``; each case
   names the kernels that ran and is held to the plain versions (y, mean,
   invvar, dx, dweight, dbias) at the GPT-1.3B shape in bf16 and fp32,
   the MHA decoder's rows, a ragged row count, no weight or bias, fp32 at
   4096 with ragged rows and bf16 at 1536 (the old route), the new route's
   cases run twice (bitwise); the two routes are timed against each
   other at the GPT-1.3B shape, cold and in turns; fp16 takes each
   route's own instances (the GPT-1.3B shape, ragged rows, no weight, and
   1536 on ``layer_norm.cu``), timed the same way beside ``F.layer_norm``
   at fp16.  K8 (``flat_adam``) runs
   over the GPT-1.3B superblock (its init weights) and must give its plain version's bits for p, m and v over 3
   steps in four variants (AdamW decay 0.01, L2 decay 0.05, decay 0, no
   bias correction); a ``plan_buckets`` walk and a hand-built 3-span walk
   must give the single launch's bits; a step must run under
   ``set_sync_debug_mode("error")``; padding of a ragged superblock stays
   exactly 0; it is timed beside ``torch._fused_adamw_``;
4. toy engine — the same weights served at toy width in fp32 on the card
   (kernels) and on the CPU (plain versions) give identical greedy
   streams, the attention on the scalar K1 (its fp32 route); then with the
   modes on (``SpecConfig(k=4, chunk_size=16)``, ``prefix_sharing=True``)
   over a 16-token shared prompt, contexts above and below the chunk and
   a repeated 24-token prompt whose hit ends mid-page (a copy-on-write):
   the card's streams equal the CPU's and the plain engine's, every mode
   ran, and the attention took the scalar K1 and K5 alone;
5. full-width engine — GPT-1.3B width (hidden 2048, 16 heads of 128, 24
   layers, vocab 51200, bf16, page 64, batch 8), on the bf16 pool and on
   the quantized ones (``kv_quant="int8"``, ``"fp8"``): ``warmup()`` then
   ``serve()`` of a seeded Poisson trace; every request finishes, the
   pool drains, the kernels' launch counts match the main path's
   prefills (the tensor-core K1) and decode steps (the pool's
   ``flash_decode_sm90`` entry point, ``flash_decode.cu`` never)
   exactly, the kernel path's prefill (bf16) and full-batch decode
   logits agree with the plain path's, and batched == sequential == a
   re-run at equal ``max_batch``, bitwise (the quantized streams are not
   held to the bf16 ones); a full-batch decode step's host-enqueue and
   device-done times and its device time by part under
   ``torch.profiler`` are reported beside the serve metrics;
6. toy training — ``pretrain_gpt.main`` at fp32, 2 layers, hidden 256,
   from the same weights and batches on the card (kernels) and on the CPU
   (plain versions): per-step losses and final weights agree, and the
   fp32 attention ran the scalar K3/K4 (their fp32 route);
7. full-width training — ``pretrain_gpt.main`` with the GPT-1.3B flags
   (24 layers, hidden 2048, 16 heads of 128, seq 2048, batch 4, bf16,
   default dropouts, clip and decay, remat ``attn_res``): 10 finite
   steps, step 1's loss near ln(vocab) + 0.41 (the init's logit variance
   0.02^2 x 2048, halved), exact launch counts of the four
   training kernels (K3/K4 the tensor-core ones, K6/K7
   ``layer_norm_sm90.cu``'s; the scalar K3/K4 and ``layer_norm.cu``
   never);
   then on a fixed batch the loss falls over 5 steps,
   one dropout-free step through the kernels agrees with the same step
   through the plain versions, and one step run twice from the same state
   gives bitwise-equal loss and weights; step time, tokens/s, model
   TFLOP/s, peak memory and a step's host-enqueue vs device-done time are
   reported, and one step's device time by kind, with the kernels no kind
   names split by the ATen op that launched them (also in phases 9 and
   11);
8. toy multi-head attention — the encoder-decoder stack of
   ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` at toy width (4 heads
   of 8), fp32, five ``FusedAdam`` steps from the same weights on the card
   and on the CPU: losses and final weights agree, the weights moved, and
   K1 and K2 ran their scalar routes (fp32);
9. full-width multi-head attention — the same stack at Transformer-big
   width (d_model 1024, 16 heads of 64, 6 encoder and 6 decoder layers,
   dropout 0.1, bias, pre-norm), 32 sentence pairs padded to 256 / 192,
   bf16 with fp32 masters, MSE against a fixed target, ``FusedAdam``:
   exact launch counts (K1 = K2 = K6 = K7 = 18 a step, K1 and K2 the
   tensor-core kernels and the scalar ones never, K6 and K7
   ``layer_norm_sm90.cu``'s and ``layer_norm.cu``'s never), the loss falls
   over 5 steps, a dropout-free step through the kernels agrees with the
   plain path (loss, grad norm, worst leaf) at the seeded initial weights
   and again at the weights six training steps leave, a step run twice
   is bitwise equal; step time, tokens/s,
   peak memory and a step's device time by part are reported;
10. toy flat training — phase 6's toy GPT on the superblock
    (``SuperblockTrainer``: weights and grads are views of two flat fp32
    buffers, the step is ``FlatFusedAdam``), five steps from the same
    weights and batches on the card (K8) and on the CPU (plain): losses
    and final weights within phase 6's bars, and the weights moved;
11. full-width flat training — phase 7's GPT-1.3B on the superblock: five
    finite steps on a fixed batch with a falling loss, exact launch counts
    (K3/K4/K6/K7 as in phase 7, K8 once a step), every weight and grad
    still a view of the flat buffers; from one shared state a step run
    twice is bitwise equal, the ``plan_buckets`` walk gives the single
    launch's bits, and the tree ``FusedAdam`` step agrees within
    ``FLAT_TREE_TOL``; step time, tokens/s, peak memory and the
    optimizer's device time (K8 + clip) are reported beside phase 7's.

12. roofs and floors — K9 (``hbm_copy``) bit for bit against its plain
    version at the HBM roof's 16384 x 8192 fp32 and at a ragged bf16
    length, and a misaligned destination refused; K10
    (``attention_dots``, its route ``attention_dots_sm90.cu``) within
    ``tolerance`` of its plain version and bitwise across two runs at
    bench.py's (128, 1024, 64, blocks 512), GPT-1.3B's (64, 2048, 128,
    blocks 64) and Transformer-big's encoder (512, 256, 64, blocks 64)
    shapes, and at q tails (s = 192 and 320, blocks 64) and unequal
    blocks ((64, 128), (128, 64)) at head dims 64 and 128, the 64 x 64
    sub-tiles each block multiplied equal to its walk
    (:func:`roofs.dots_walk`) and to the rule's pairs / 4096; the route
    before it, ``attention_dots.cu`` (``mma.sync``, called through its
    ``Kernel``), within ``tolerance`` at the three shapes and its ``HMMA``
    count in the SASS (``cuobjdump``), which must not be 0; K1/K2 and
    K6/K7 against their plain versions at the microbenches' shapes.  Then
    the main path, the port of bench.py's kernel-microbench path:
    ``hbm_roof``, ``matmul_roof``,
    ``attention_kernel`` at bench.py's two shapes (the first with the dot
    floor) and ``layer_norm_kernel``, each printed with the card, with
    exact launch counts (``attention_dots_sm90`` only, ``attention_dots``
    never); then K9 and K10 timed cold beside their plain versions,
    ``copy_`` and two dense ``torch.bmm``, K10's two routes also in turns
    (``timed_pair``) at the three shapes; last, every kernel row read
    against what the card demonstrably reaches (the HBM roof, or the dot
    floor at its shape; attention rows also at ``matmul_roof``'s rate).
13. toy BERT — ``BertModel`` at fp32, 2 layers, 2 heads of 64, padded
    and packed (``profiling.bert_large.bert_batches`` at 8 sequences of
    at most 128 tokens), three ``FusedAdam`` steps from the same weights
    on the card and on the CPU: losses and final weights agree, the
    attention ran the scalar K3/K4's head-dim-64 instance (the fp32
    route) and nothing else of K3/K4, and the packed per-token losses
    equal the padded ones on the real tokens within 2e-5;
14. full-width BERT-large — ``profiling.bert_large`` (bench.py's
    ``_bert_setup``: 24 layers, hidden 1024, 16 heads of 64, vocab 30592,
    seq 512, bf16, remat ``attn_res``, ``FusedAdam(lr=1e-4)``), padded (16
    rows and a key-padding mask) and packed (13 rows, segment and
    position ids): five steps on a fixed batch each, finite and falling,
    step 1 near ln(30592) + 0.02^2 x 1024 / 2, exact launch counts a step
    (the tensor-core K3/K4's head-dim-64 instances only, K6/K7
    ``layer_norm_sm90.cu``'s, the MLM head's fp32 LayerNorm included);
    one step through the kernels against the plain versions within its
    bars, the same step with a planted fault (one head's dK dropped, the
    segment ids dropped) outside them, and one step run twice (bitwise),
    in each layout; step ms, real tokens/s, model
    TFLOP/s (``bert_analytic_flops``), ``bert_varlen_vs_padded_speedup``,
    peak memory, a step's host enqueue vs device done time and its device
    time by kind under ``torch.profiler``.
15. serving modes at full width — phase 5's model with bench.py's modes
    (``SpecConfig(k=4, proposer=NgramProposer(), chunk_size=128)``,
    ``prefix_sharing=True``, 7 pages a request, 85 pages) over
    ``trace(0, 16)`` behind bench.py's 128-token system prompt, plus a
    256-token prompt and its repeat (a hit ending mid-page):
    ``warmup()`` then ``serve()``; every request finishes, the pool
    drains once the prefix index is cleared, the run shows chunk steps, a
    prefix hit, a copy-on-write and an accepted draft, and the launch
    counts are exact (``flash_decode_sm90`` once a layer for each decode,
    verify and chunk step and the warm-up's three, ``flash_fwd_sm90`` for
    each whole-row prefill and the warm-up, nothing else); a full-batch
    verify step's and a chunk step's logits through K5 within
    ``logits_close``'s bar of the plain path's, and the verify step's
    within it of five sequential decode steps over the same tokens on a
    copy of the pool (bitwise on an H100: a speculative engine's decode
    step runs at the verify step's 40 rows); three more runs whose
    proposers replay the streams (drafts accepted), shift them (drafts
    rejected) or never draft, each giving the same streams; batched ==
    sequential == a re-run on six of the requests (where one at a time
    the repeat hits the index and copies a page); the streams against a
    ``spec=None`` engine's (the share equal, each divergence's first
    token and the plain engine's top-2 logit margin there, which must be
    at most twice the larger of two gaps held under ``logits_close``'s
    bar: a prompt's first token through chunks against one whole-row
    prefill, and the decode step at 40 rows against 8); TTFT,
    TPOT, tokens/s, acceptance, committed tokens a verify step, prefix
    hit rate, pool peak, peak memory and a verify and a chunk step's
    device time by part, beside phase 5's bf16 numbers.  Then the split
    of ROADMAP queue C's C1: a plain engine that decodes at the modes
    engine's 40 rows (a never-drafting proposer, no chunks) against the
    plain engine at 8 rows and against the modes engine (recorded, bf16);
    and the three engines again in fp32 at hidden 512, 4 layers, 4 heads
    of 128 on the scalar routes, where the modes engine's streams must
    equal the plain engine's (the contract the JAX package pins at fp32).
16. serving state, page integrity and telemetry — on the fp32 toy (card):
    recovery from a ``ServingDeviceLoss`` and from a ``CorruptLivePage``
    caught by ``validate_pages``, and a snapshot restored into a fresh
    engine, each bitwise equal to the uninterrupted run, and a
    ``Watchdog`` escalating on a ``SlowDecode``; at GPT-1.3B width in
    bf16 (phase 5's engine on a ``SimClock``): ``trace(0, 16)`` served
    with a ``TelemetryBus`` and without gives the same streams and launch
    counts, every event valid, 16 valid traces whose TTFT parts sum to
    the retire event's TTFT; a device loss at decode boundary 12 and a
    corrupt page on a short trace recovered with exact K1/K5 counts
    (prefills + re-prefills + warm-up, decode steps + warm-up), the bf16
    streams against the uninterrupted ones recorded with each
    divergence's margin, ``validate_pages``'s ms and bytes a step and the
    recovery's wall; a snapshot through JSON restored into a fresh engine
    (a restore into the busy one refused); ``defrag`` after every step,
    bitwise; four requests prefilled on a ``prefill_only`` engine,
    exported, verified and adopted by a ``kv_import`` engine on the bf16
    and int8 pools, bitwise equal to the colocated engine, K1 only on the
    prefill side and K5 only on the decode side, a flipped byte refused
    with the engine unchanged, export and import ms a page.
17. GPT training under amp — a toy GPT (2 layers, hidden 128, 2 heads of
    64, so K3/K4 take their head-dim-64 instances) trained four steps on
    one batch by ``AmpTrainer`` (``amp.initialize``, ``master_params``,
    ``cast_model``, ``scaled_value_and_grad``, ``step_if_finite``,
    ``copy_masters``, ``scaler.update``) at O0 fp32, O2 bf16 and O2 fp16
    with ``FusedAdam``, ``FusedLAMB`` and ``FusedSGD``, on the card and
    on the CPU from the same weights: losses within ``AMP_TOY_TOL``, the
    finite flags and loss scales equal, the dtype's instances launched
    exactly, the loss falling; and an fp16 run from a loss scale of 2^40
    whose skipped steps and scales equal the CPU's.  Then GPT-1.3B
    (``gpt1p3b_config``: 24 layers, hidden 2048, 16 heads of 128, batch 4
    x 2048, remat ``attn_res``) under O2 with dynamic loss scaling from
    2^16: 10 steps each with fp16 ``FusedLAMB``, fp16 ``FusedAdam`` and
    bf16 ``FusedAdam``, every step under
    ``torch.cuda.set_sync_debug_mode("error")``; each step's loss, scale
    and skipped count, step p50, tokens/s, peak memory, host enqueue vs
    device done, exact launch counts of the dtype's K3/K4/K6/K7 (a
    skipped step launches too), the losses of the steps not skipped
    falling; an inf planted in one gradient at step 6 of the FusedLAMB
    run is skipped with every parameter, master, moment and the step
    count bitwise unchanged, the scale halved and ``skipped`` up by one;
    one fp16 step's device time by kind under ``torch.profiler``; one
    fp16 step through the kernels within ``AMP_PLAIN_*`` of the same step
    through the plain versions, and with head 0's dK dropped in K4
    outside them.
18. GPT-1.3B training: checkpoint, preempt, resume — phase 7's flags
    with ``--data-dir`` over four checksummed shards of seeded tokens
    (``write_checksummed_records``, 24 records of 2049 ids) written into
    a temp dir (its free bytes printed first; the dir is removed at the
    end, pass or fail): run A trains 6 steps uninterrupted; run B adds
    ``--save``, ``--save-interval 2``, ``--telemetry-dir`` and
    ``--watchdog-timeout 120`` and a ``SimulatedPreemption`` (a real
    SIGTERM) after step 3, so an async save at 2 and a blocking save at
    3, then a clean exit; run C loads step 3 (``--load``) and runs to 6; run D
    loads after ``corrupt_arrays`` flipped a byte of step 3's
    arrays, must warn ``CheckpointFallbackWarning`` and resume from step
    2.  B's losses and state to step 3, C's from step 4 and D's from step
    3 equal A's bit for bit (each loss, and a digest of every parameter
    and both Adam moments, taken on the card, after steps 3 and 6); both
    checkpoints hold the iterator's ``data_state``; B's stream validates
    and holds the two ``ckpt_save`` events with ``wall_ms``, the
    accountant's ``ckpt_fence`` pause and the SIGTERM's postmortem; K3,
    K4, K6 and K7 launch phase 7's counts a step times the 16 steps of
    the four runs, exactly.  Each save's seconds and GB (the async one's
    time to return against its time to commit, with its fence, snapshot,
    CRC32 and write split), each restore's seconds and GB and run A's
    step time against run B's are printed beside the card.

The last three lines of standard output are the kernels' JSON record,
the ``nvidia-smi`` name/power line, and ``{"ok": true, "device": ...}``.
A failure prints ``chip_smoke: FAILED in phase N (<name>): <type>:
<message>`` and the traceback on standard error, and the run exits 1.
fp32 matrix products run in full fp32 (``allow_tf32`` off).
"""

from __future__ import annotations

import base64
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from apex_tpu_torch import kernels  # noqa: E402
from apex_tpu_torch.contrib.multihead_attn import (  # noqa: E402
    EncdecMultiheadAttn, SelfMultiheadAttn)
from apex_tpu_torch.examples.gpt import pretrain_gpt  # noqa: E402
from apex_tpu_torch.multi_tensor import (BucketPlan, flatten,  # noqa: E402
                                         multi_tensor_l2norm, plan_buckets,
                                         unflatten)
from apex_tpu_torch.ops import attention as att  # noqa: E402
from apex_tpu_torch.ops import fused_layer_norm as ln  # noqa: E402
from apex_tpu_torch.optimizers import (FlatAdamState,  # noqa: E402
                                       FlatFusedAdam, FusedAdam)
from apex_tpu_torch.optimizers import flat as flat_opt  # noqa: E402
from apex_tpu_torch.profiling import (bert_large, microbench,  # noqa: E402
                                      roofs, timing)
from apex_tpu_torch.profiling.bert_large import bert_lengths  # noqa: E402
from apex_tpu_torch.profiling.roofs import (HBM_BYTES_PER_S,  # noqa: E402
                                            PEAK_FLOPS, bound)
from apex_tpu_torch.profiling.timing import cold_ms  # noqa: E402
from apex_tpu_torch import amp  # noqa: E402
from apex_tpu_torch.optimizers import FusedLAMB, FusedSGD  # noqa: E402
from apex_tpu_torch.transformer.testing import (  # noqa: E402
    BertModel, GPTConfig, GPTModel, gpt1p3b_config, gpt_param_count)
from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: E402
    attention_segments)
from apex_tpu_torch import checkpoint as ckpt  # noqa: E402
from apex_tpu_torch import resilience  # noqa: E402
from apex_tpu_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from apex_tpu_torch.data import write_checksummed_records  # noqa: E402
from apex_tpu_torch.resilience import CheckpointFallbackWarning  # noqa: E402
from apex_tpu_torch.resilience.chaos import (  # noqa: E402
    SimulatedPreemption, corrupt_arrays)
from apex_tpu_torch.resilience import (CorruptLivePage,  # noqa: E402
                                       ServingDeviceLoss, SlowDecode,
                                       Watchdog)
from apex_tpu_torch.serving import model as model_mod  # noqa: E402
from apex_tpu_torch.serving import (NgramProposer,  # noqa: E402
                                    PagedKVCache, PagePoolCorruption,
                                    ServingEngine, ServingModelConfig,
                                    SimClock, SpecConfig, init_params,
                                    poisson_trace, quant_pool_dtype,
                                    quantize_tokens, verify_page_payload)
from apex_tpu_torch.telemetry import (TTFT_SUM_TOLERANCE_MS,  # noqa: E402
                                      MemorySink, TelemetryBus, build_traces,
                                      format_summary, load_jsonl,
                                      summarize_events, ttft_decomposition,
                                      validate_event, validate_events,
                                      validate_trace)

BF16_TOL = 2.0 ** -7    # x max|ref|: one bf16 ulp at the output's scale
# x max|ref|: the same rule at fp16's spacing (10 fraction bits to bf16's
# 7), one fp16 ulp at the output's scale; the fp16 instances of K3/K4/K6/K7
# round where their bf16 ones do, so their gaps to the plain versions are
# the bf16 gaps scaled by the spacing
FP16_TOL = 2.0 ** -10
FP32_TOL = 1e-5         # x max(1, max|ref|)

# the serving main path's geometry (GPT-1.3B width, bench.py's serving cell)
FULL = dict(vocab_size=51200, hidden_size=2048, num_heads=16, num_layers=24,
            max_position=1024)
PAGE, BATCH, PAGES_PER_REQ = 64, 8, 5
NUM_PAGES = 1 + BATCH * PAGES_PER_REQ * 3 // 2
# the serving modes' settings and pool (phase 15), bench.py's: draft width
# 4, chunks of 128, its 128-token system prompt ahead of every prompt, and
# ceil((128 + 256 + 64) / 64) = 7 pages a request, 1 + 8 x 7 x 3 // 2 = 85
SPEC_K, CHUNK = 4, 128
SYSTEM_PROMPT = [1 + (7 * i) % (FULL["vocab_size"] - 1)
                 for i in range(2 * PAGE)]
MODES_PAGES_PER_REQ = -(-(len(SYSTEM_PROMPT) + 256 + 64) // PAGE)
MODES_NUM_PAGES = 1 + BATCH * MODES_PAGES_PER_REQ * 3 // 2


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(text: str) -> list:
    """(function, registers, stack-frame bytes, spill-store bytes) of each
    kernel instance, from ``ptxas -v``'s output."""
    out, fn, stack, spill = [], None, 0, 0
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip()
        elif "bytes spill stores" in line:
            stack = int(line.split("bytes stack frame")[0].split()[-1])
            spill = int(line.split("bytes spill stores")[0].split()[-1])
        elif "Used " in line and " registers" in line and fn:
            out.append((fn, int(line.split("Used ")[1].split()[0]), stack,
                        spill))
            fn, stack, spill = None, 0, 0
    return out


def demangle(name: str) -> str:
    """``flash_decode_kernel<float, 128>`` from its mangled name."""
    try:
        full = subprocess.run(["c++filt", name], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return name
    found = re.search(r"\w+<[^()]*>", full)
    return found.group(0) if found else full.strip()


def tolerance(ref: torch.Tensor) -> float:
    scale = ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        return BF16_TOL * scale
    if ref.dtype == torch.float16:
        return FP16_TOL * scale
    return FP32_TOL * max(1.0, scale)


def check(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    err = (got.float() - ref.float()).abs().max().item()
    tol = tolerance(ref)
    ok = math.isfinite(err) and err <= tol
    log(f"  {name}: max_abs_diff {err:.3e}  tol {tol:.3e}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol:.3e})")
    return err


# -- phase 3: the kernels against their plain versions ---------------------


def seg_row(s: int, lengths) -> torch.Tensor:
    """One packed row: segments 1..n of the given lengths, 0 = padding."""
    seg = torch.zeros(s, dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[at:at + n] = i + 1
        at += n
    return seg


def prefill_operands(gen, dtype, lengths, b=1, h=16, s=1024, d=128):
    """q/k/v as the prefill hands them in: strided [b, h, s, d] views of
    one fused [b, s, 3*h*d] projection."""
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.view(b, s, h, d).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    return q, k, v, seg_row(s, lengths)[None].cuda()


def launched(fn):
    """(``fn()``, the symbols of the kernels it launched)."""
    before = {k.symbol: k.launches for k in kernels.KERNELS}
    out = fn()
    return out, [k.symbol for k in kernels.KERNELS
                 if k.launches != before[k.symbol]]


def flash_fwd_case(gen, name, dtype, lengths):
    """K1 at the prefill's shape through ``flash_attention_fwd`` against
    its plain version, naming the kernel that ran (bf16 at head dim 128:
    ``flash_fwd_sm90``; fp32: the scalar ``flash_fwd``); on the tensor
    cores also run again (bitwise) counting its tiles walked, against
    :func:`flash_fwd_tiles`."""
    q, k, v, seg = prefill_operands(gen, dtype, lengths)
    b, h, s, d = q.shape
    (o, lse), ran = launched(lambda: att.flash_attention_fwd(
        q, k, v, causal=True, segment_ids=seg))
    ro, rlse = att._blockwise_fwd(
        q.reshape(b * h, s, d), k.reshape(b * h, s, d),
        v.reshape(b * h, s, d), 1 / math.sqrt(d), True, None, seg, seg)
    torch.cuda.synchronize()
    err = check(f"{ran[0]} {name} o", o, ro.view(b, h, s, d))
    lerr = (lse - rlse).abs().max().item()
    log(f"  {ran[0]} {name} lse: max_abs_diff {lerr:.3e}  tol 1e-4  "
        f"{'ok' if lerr <= 1e-4 else 'FAIL'}")
    if not lerr <= 1e-4:
        raise AssertionError(f"{ran[0]} {name}: lse disagrees ({lerr:.3e})")
    if att._fwd_on_tensor_cores(q):
        visits = fwd_visits(q)
        again = att._flash_fwd_cuda(q, k, v, None, seg, seg, 1 / math.sqrt(d),
                                    True, 0.0, 0, visits=visits)
        check_bitwise(f"{ran[0]} {name} run twice", (o, lse), again)
        check_fwd_visits(f"{ran[0]} {name}", visits, seg, seg, s, s, True,
                         b * h)
    return err, (q, k, v, seg)


def scalar_fwd(fn):
    """``fn`` with K1 routed to its scalar kernel (``flash_fwd.cu``, the
    bf16 route before ``flash_fwd_sm90.cu``)."""
    def old():
        with mock.patch.object(att, "_fwd_on_tensor_cores", lambda t: False):
            return fn()
    return old


def time_flash_fwd(dtype, q, k, v, seg) -> tuple:
    """K1 at the prefill's shape (the tensor-core kernel, through
    ``flash_attention_fwd``) timed cold beside its plain version, SDPA
    and its bound; the scalar kernel it replaced on bf16 timed cold too,
    and the two in turns (a, b, b, a) in this one call
    (``timing.timed_pair``).  Returns (tensor-core row, scalar row)."""
    b, h, s, d = q.shape
    scale = 1 / math.sqrt(d)
    new = lambda: att.flash_attention_fwd(  # noqa: E731
        q, k, v, causal=True, segment_ids=seg)
    old = scalar_fwd(new)
    ms = cold_ms(new)
    old_ms = cold_ms(old, 10)
    pair = timing.timed_pair(old, new, (), ())
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    plain_ms = cold_ms(lambda: att._blockwise_fwd(qf, kf, vf, scale, True,
                                                  None, seg, seg))
    sid = seg[0]
    visible = (sid[:, None] == sid[None, :]) & torch.ones(
        s, s, dtype=torch.bool, device="cuda").tril()
    lib_ms = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=visible[None, None]))
    item = q.element_size()
    # q, k, v read once; o written once; lse out; the two seg-id rows in
    nbytes = 4 * b * h * s * d * item + b * h * s * 4 + 2 * s * 4
    flops = 4 * d * b * h * int(visible.sum().item())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    bq, bk = att.flash_fwd_tiles_of(q)
    walk = flash_fwd_tiles(seg, seg, s, s, True, bq, bk)
    n_tiles = int((walk[..., 1] - walk[..., 0]).sum())
    log(f"  flash_fwd_sm90 timing [{b},{h},{s},{d}] {dtype}: kernel "
        f"{ms:.4f} ms (scalar flash_fwd {old_ms:.4f}: {old_ms / ms:.2f}x), "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); {bq}x{bk} tiles walked per head "
        f"{n_tiles}")
    log(f"  in turns (timed_pair, warm): scalar {pair[0]:.4f} ms vs "
        f"tensor-core {pair[1]:.4f} ms ({pair[0] / pair[1]:.2f}x)")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, warm_pair_ms=pair[1])
    return row, {**row, "ms": old_ms, "warm_pair_ms": pair[0]}


# the decode step's pools, each with the flash_decode_sm90.cu entry point
# it runs: the default bf16 pool and the quantized ones (kv_quant)
DECODE_POOLS = (("bf16", None, "flash_decode_sm90"),
                ("int8", "int8", "flash_decode_sm90_int8"),
                ("fp8", "fp8", "flash_decode_sm90_fp8"))
# K5's timed shapes (name, kv lengths, pages a request): the ragged batch,
# a full batch mid-trace, and a full batch at FULL's max_position
DECODE_RAGGED = [1, 2, 63, 64, 65, 200, 320, 3]
DECODE_SHAPES = (("ragged", DECODE_RAGGED, PAGES_PER_REQ),
                 ("8x300", [300] * BATCH, PAGES_PER_REQ),
                 ("8x1024", [1024] * BATCH, FULL["max_position"] // PAGE))


def decode_operands(gen, dtype, q_len, lengths, b=BATCH, h=16, d=128,
                    page_size=PAGE, p_max=PAGES_PER_REQ, quant=None):
    """(q, k_pages, v_pages, table, kv_len, k_scale, v_scale) as the decode
    step hands them in: q a view of a fused qkv projection, a pool of
    random K/V in ``dtype`` or, with ``quant``, quantized by the port's
    ``quantize_tokens`` (codes and fp32 scales; the scales are None for an
    unquantized pool), a shuffled page table."""
    n_pages = 1 + b * p_max
    kp = torch.randn(n_pages, page_size, h, d, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn(n_pages, page_size, h, d, generator=gen,
                     device="cuda").to(dtype)
    ks = vs = None
    if quant:
        codes = quant_pool_dtype(quant)
        kp, ks = quantize_tokens(kp, codes, model_mod.quant_qmax(codes))
        vp, vs = quantize_tokens(vp, codes, model_mod.quant_qmax(codes))
    # shuffled, non-contiguous page ids: the indirection is under test
    free = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).tolist()
    table = torch.zeros(b, p_max, dtype=torch.int32)
    for i, n in enumerate(lengths):
        for p in range(-(-n // page_size)):
            table[i, p] = free.pop()
    qkv = torch.randn(b, q_len, 3 * h * d, generator=gen,
                      device="cuda").to(dtype)
    q = qkv[..., :h * d].view(b, q_len, h, d).transpose(1, 2)
    kv_len = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.cuda(), kv_len, ks, vs


def decode_plain(q, kp, vp, table, kv_len, ks, vs):
    return att._paged_attention(q, kp, vp, table, kv_len,
                                1 / math.sqrt(q.shape[-1]), ks, vs)


def flash_decode_case(gen, name, dtype, q_len, lengths, quant=None,
                      scalar=False):
    """K5 through ``flash_decode`` (with ``scalar``, ``flash_decode.cu``
    called directly, as on a bf16 pool before ``flash_decode_sm90.cu``)
    against its plain version, naming the entry point that ran;
    ``flash_decode_sm90.cu``'s run again (bitwise).  Returns (max error,
    operands, the entry point)."""
    ops = decode_operands(gen, dtype, q_len, lengths, quant=quant)
    q, kp, vp, table, kv_len, ks, vs = ops

    def run():
        if scalar:
            return att._flash_decode_cuda(q, kp, vp, table, kv_len,
                                          1 / math.sqrt(q.shape[-1]))
        return att.flash_decode(q, kp, vp, table, kv_len, k_scale=ks,
                                v_scale=vs)

    o, ran = launched(run)
    ro = decode_plain(*ops)
    torch.cuda.synchronize()
    err = check(f"{ran[0]} {name}", o, ro)
    for i, n in enumerate(lengths):
        for r in range(q_len):
            if n - q_len + r < 0 and not bool((o[i, :, r] == 0).all()):
                raise AssertionError(
                    f"{ran[0]} {name}: row {r} of request {i} "
                    f"(kv_len {n} < q_len {q_len}) is not exact zeros")
    if ran[0] != "flash_decode":
        check_bitwise(f"{ran[0]} {name} run twice", (o,), (run(),))
    return err, ops, ran[0]


def time_flash_decode(name, ops) -> dict:
    """K5 at one shape, cold: the kernel ``flash_decode`` runs for this
    pool, its plain version, a page gather + SDPA with the causal offset
    mask (the codes dequantized to q's dtype first) and the bound: the
    live pages' rows (codes and scales) read once, q in, o out, the table
    and lengths in, and the products over the columns each query row
    sees.  On a bf16 pool ``flash_decode.cu``, the route before
    ``flash_decode_sm90.cu``, is held to the plain version on the same
    operands and timed cold too, and the two in turns
    (``timing.timed_pair``)."""
    q, kp, vp, table, kv_len, ks, vs = ops
    b, h, q_len, d = q.shape
    page_size, p_max = kp.shape[1], table.shape[1]

    def new():
        return att.flash_decode(q, kp, vp, table, kv_len, k_scale=ks,
                                v_scale=vs)

    ms = cold_ms(new, 50)
    plain_ms = cold_ms(lambda: decode_plain(*ops), 50)
    cols = torch.arange(p_max * page_size, device="cuda")
    rows = torch.arange(q_len, device="cuda")[:, None]
    visible = cols <= (kv_len.long() - q_len)[:, None, None, None] + rows

    def library():
        idx = table.long()
        kc, vc = att._gather_pages(kp, idx), att._gather_pages(vp, idx)
        if ks is not None:
            kc = (kc.float() * ks[idx][..., None]).to(q.dtype)
            vc = (vc.float() * vs[idx][..., None]).to(q.dtype)
        kc = kc.reshape(b, -1, h, d).transpose(1, 2)
        vc = vc.reshape(b, -1, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=visible)

    lib_ms = cold_ms(library, 50)
    reach = p_max * page_size
    live_cols = sum(min(int(n), reach) for n in kv_len.tolist())
    seen = sum(max(0, min(int(n) - q_len + r + 1, reach))
               for n in kv_len.tolist() for r in range(q_len))
    nbytes = (2 * live_cols * h * d * kp.element_size()
              + 2 * b * h * q_len * d * q.element_size()
              + table.numel() * 4 + b * 4)
    flops = 4 * d * h * seen
    op_dtype = q.dtype
    if ks is not None:
        # the scales, and the dequantizing products, in fp32
        nbytes += 2 * live_cols * h * 4
        flops += 2 * d * h * live_cols
        op_dtype = torch.float32
    bound_ms, bound_by = bound(nbytes, flops, op_dtype)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    old = ""
    if ks is None:
        scale = 1 / math.sqrt(d)

        def scalar():
            return att._flash_decode_cuda(q, kp, vp, table, kv_len, scale)

        old_err = check(f"flash_decode on the {name} operands", scalar(),
                        decode_plain(*ops))
        pair = timing.timed_pair(scalar, new, (), ())
        row.update(old_ms=cold_ms(scalar, 50), old_warm_pair_ms=pair[0],
                   warm_pair_ms=pair[1], old_max_abs_err=old_err)
        old = (f"; flash_decode.cu {row['old_ms']:.4f} ms cold; in turns, "
               f"warm: flash_decode.cu {pair[0]:.4f} vs {pair[1]:.4f} ms")
    log(f"  {name} timing [{b},{h},{q_len},{d}] {kp.dtype} kv_len "
        f"{kv_len.tolist()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"gather+sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}): {bound_ms / ms:.1%} of it" + old)
    return row


# K5's checked q_len: the decode step's, windows shorter than q_len (the
# verify step's q_len, k + 1 = 5), two of flash_decode.cu's 16-row tiles,
# and the chunk step's width (rows of the ragged batch see nothing)
DECODE_Q_LENS = ((1, ""), (5, " (kv_len < q_len rows)"),
                 (20, " (two 16-row tiles)"),
                 (128, " (the chunk width; kv_len < q_len rows)"))
# K5 where the serving modes run it (phase 15's geometry, 7 pages a
# request): the full-batch verify step (q_len k + 1 = 5, a 4-token draft
# a row, kv_len 192-448) and the chunk step ([1, 16, 128, 128] at kv_len
# 256 and 384: its second and third chunk)
DECODE_MODE_SHAPES = (
    ("verify", 5, [192, 224, 256, 288, 320, 352, 384, 448]),
    ("chunk", 128, [256]),
    ("chunk_kv384", 128, [384]))


def phase_decode_kernels(gen) -> dict:
    """K5 on each pool: held to its plain version at :data:`DECODE_Q_LENS`
    over the ragged lengths, then timed at :data:`DECODE_SHAPES`;
    ``flash_decode.cu``, the fp32 pool's route, held to it on the fp32
    pool at q_len 1 and 5 and, called directly, on the bf16 pool at q_len
    1, 5 and 20, then timed on bf16 as the kernel ``flash_decode_sm90.cu``
    replaced there; ``flash_decode_sm90.cu`` held and timed at
    :data:`DECODE_MODE_SHAPES` (the record's ``flash_decode_sm90_verify``
    and ``_chunk`` rows); the card's
    ``quantize_tokens`` against the CPU's."""
    bf16 = torch.bfloat16
    out = {}
    for pool, quant, name in DECODE_POOLS:
        cases = [flash_decode_case(gen, f"{pool} pool q_len={q_len}{what}",
                                   bf16, q_len, DECODE_RAGGED, quant)
                 for q_len, what in DECODE_Q_LENS]
        if any(ran != name for _, _, ran in cases):
            raise AssertionError(f"the {pool} pool did not run {name}")
        shapes = {shape: time_flash_decode(
            f"{name} {shape}", cases[0][1] if shape == "ragged" else
            decode_operands(gen, bf16, 1, lengths, p_max=p_max, quant=quant))
            for shape, lengths, p_max in DECODE_SHAPES}
        out[name] = dict(shapes["ragged"], max_abs_err=max(
            e for e, _, _ in cases), shapes=shapes)
    scalar = [flash_decode_case(gen, f"fp32 pool q_len={q_len}{what}",
                                torch.float32, q_len, DECODE_RAGGED)
              for q_len, what in DECODE_Q_LENS[:2]]
    scalar += [flash_decode_case(gen, f"bf16 pool q_len={q_len}{what}",
                                 bf16, q_len, DECODE_RAGGED, scalar=True)
               for q_len, what in DECODE_Q_LENS[:3]]
    if any(ran != "flash_decode" for _, _, ran in scalar):
        raise AssertionError("the fp32 pool or the direct call did not run "
                             "flash_decode")
    # the record's numbers from the bf16 run that is timed
    sm90 = out["flash_decode_sm90"]
    new = {k: v for k, v in sm90.items() if not k.startswith("old_")}
    out["flash_decode"] = dict(
        new, ms=sm90["old_ms"], max_abs_err=sm90["old_max_abs_err"],
        warm_pair_ms=sm90["old_warm_pair_ms"],
        cases_max_abs_err=max(e for e, _, _ in scalar),
        shapes={k: dict(v, ms=v["old_ms"], max_abs_err=v["old_max_abs_err"])
                for k, v in sm90["shapes"].items()})
    modes = {use: decode_mode_timing(gen, use, q_len, lengths)
             for use, q_len, lengths in DECODE_MODE_SHAPES}
    out["flash_decode_sm90_verify"] = modes["verify"]
    out["flash_decode_sm90_chunk"] = dict(modes["chunk"],
                                          at_kv_len_384=modes["chunk_kv384"])
    quantize_card_vs_cpu(gen)
    return out


def decode_mode_timing(gen, use, q_len, lengths) -> dict:
    """``flash_decode_sm90.cu`` at one of :data:`DECODE_MODE_SHAPES`: held
    to its plain version, then timed (``time_flash_decode``).  Each query
    row walks its own K/V in its own blocks, so at the chunk's 128 rows
    the pages are read 128 times over: far from the bound, which counts
    them once.  ``flash_decode.cu``, whose blocks take 16 query rows,
    is timed beside it on the same operands."""
    ops = decode_operands(gen, torch.bfloat16, q_len, lengths,
                          b=len(lengths), p_max=MODES_PAGES_PER_REQ)
    q, kp, vp, table, kv_len, _, _ = ops
    o, ran = launched(lambda: att.flash_decode(q, kp, vp, table, kv_len))
    if ran != ["flash_decode_sm90"]:
        raise AssertionError(f"K5 at the {use} shape ran {ran}")
    err = check(f"flash_decode_sm90 {use} [{len(lengths)},16,{q_len},128] "
                f"kv_len {lengths}", o, decode_plain(*ops))
    row = time_flash_decode(f"flash_decode_sm90 {use}", ops)
    return dict(row, max_abs_err=err, q_len=q_len, kv_len=lengths)


def quantize_card_vs_cpu(gen, tokens=4096) -> None:
    """``quantize_tokens`` on the card against the CPU, bit for bit, codes
    and scales, on one seeded [tokens, 16, 128] input over six decades."""
    x = torch.randn(tokens, 16, 128, generator=gen, device="cuda") * 10.0 ** (
        torch.rand(tokens, 16, 1, generator=gen, device="cuda") * 6 - 3)
    for mode in ("int8", "fp8"):
        codes = quant_pool_dtype(mode)
        qmax = model_mod.quant_qmax(codes)
        c, sc = quantize_tokens(x, codes, qmax)
        cc, csc = quantize_tokens(x.cpu(), codes, qmax)
        same = (torch.equal(c.view(torch.uint8).cpu(), cc.view(torch.uint8))
                and torch.equal(sc.cpu().view(torch.int32),
                                csc.view(torch.int32)))
        log(f"  quantize_tokens {mode} [{tokens}, 16, 128], card vs CPU: "
            f"bitwise equal {same}")
        if not same:
            raise AssertionError(f"quantize_tokens {mode}: the card's codes "
                                 "or scales differ from the CPU's")


# the training main path's attention and LayerNorm shapes (GPT-1.3B,
# pretrain_gpt at micro-batch 4, seq 2048)
TRAIN = dict(b=4, s=2048, heads=16, d=128, hidden=2048)
ATT_DROPOUT = 0.1            # arguments.py's default, on the main path
# absolute, fp32 log-sum-exp near 8; raised elementwise to one fp32
# spacing at |ref| where that is larger (rows an additive mask hides
# whole, lse near -1e4, spacing 2^-10): scripts/lse_masked_rows.py, 150
# draws a head dim on an NVIDIA H100 80GB HBM3 at 700 W, read every miss
# of 1e-4 there as exactly one spacing (flash_fwd_sm90 9 rows at d 64, 8
# at d 128; the scalar flash_fwd 6 and 6)
LSE_TOL = 1e-4
RATE_SEED = 1234


def fp32_spacing(t: torch.Tensor) -> torch.Tensor:
    """The gap from |t| to the next float32 above it, elementwise."""
    a = t.float().abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def check_lse(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    gap = (got - ref).abs()
    tol = torch.clamp(fp32_spacing(ref), min=LSE_TOL)
    err, worst = gap.max().item(), (gap / tol).max().item()
    ok = worst <= 1.0
    log(f"  {name}: max_abs_diff {err:.3e}  tol max({LSE_TOL:.0e}, one fp32 "
        f"spacing at |ref|): worst gap {worst:.3f} of its bar  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees ({err:.3e}, {worst:.3f} "
                             "of its bar)")


def qkv_operands(gen, dtype, b=TRAIN["b"], s=TRAIN["s"], d=TRAIN["d"],
                 h=TRAIN["heads"]):
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    dctx = torch.randn(b, s, h * d, generator=gen, device="cuda").to(dtype)
    return qkv, dctx


def seg_pair(seg):
    """(seg_q, seg_k) of the packed kernels' ``segment_ids``: None, one id
    tensor for both sides, or a pair (the key-padding fold)."""
    return seg if isinstance(seg, tuple) else (seg, seg)


def sm90_visits_want(seg, b, s, causal, h=TRAIN["heads"]):
    """The tiles ``flash_qkv_bwd_sm90.cu`` walks, from the plain statement
    of its skip rule (:func:`flash_bwd_tiles` at its two passes' tiles,
    ``att.QKV_SM90_BWD_TILES``), in the layout of its ``visits``: the dk/dv
    pass's blocks, then the dq pass's, each [b*h, n_blocks] flattened.
    ``seg``: None, one id tensor for both sides, or a (seg_q, seg_k)
    pair."""
    seg_q, seg_k = seg_pair(seg)
    (bq2, bk2), (bq3, bk3) = (att.QKV_SM90_BWD_TILES[k] for k in ("dkdv",
                                                                   "dq"))
    kv = flash_bwd_tiles(seg_q, seg_k, s, s, causal, bq2, bk2)[0]
    q = flash_bwd_tiles(seg_q, seg_k, s, s, causal, bq3, bk3)[1]
    per = [(r[..., 1] - r[..., 0]) for r in (kv, q)]
    return torch.cat([w.repeat_interleave(b * h // w.shape[0], 0).flatten()
                      for w in per])


def flash_qkv_case(gen, name, dtype, rate, b=TRAIN["b"], s=TRAIN["s"],
                   seg=None, causal=True, d=TRAIN["d"], h=TRAIN["heads"]):
    """K3 and K4 against their plain versions, naming the instances that
    ran (the route's, at head dim ``d``); for bf16 (the tensor-core
    kernels) also K4's tiles walked against the plain statement of its
    skip rule and K3 and K4 run twice (bitwise).  ``seg``: None, one id
    tensor or a (seg_q, seg_k) pair.  Returns (K3 error, K4 error,
    operands)."""
    qkv, dctx = qkv_operands(gen, dtype, b, s, d, h)
    args = (*seg_pair(seg), h, d ** -0.5, causal, rate, RATE_SEED)
    want = [k.symbol for k in att.QKV_KERNELS[att._qkv_route(dtype), d]]
    (ctx, lse), ran3 = launched(lambda: att._flash_qkv_fwd_cuda(qkv, *args))
    if ran3 != want[:1]:
        raise AssertionError(f"flash_qkv {name}: ran {ran3}, expected "
                             f"{want[:1]}")
    rctx, rlse = att._flash_qkv_fwd_plain(qkv, *args)
    torch.cuda.synchronize()
    e3 = check(f"flash_qkv_fwd {name} ctx", ctx, rctx)
    check_lse(f"flash_qkv_fwd {name} lse", lse, rlse)
    del rctx, rlse
    visits = None
    if dtype != torch.float32:      # the tensor-core instances
        tiles = sm90_visits_want(seg, b, s, causal, h)
        visits = torch.full((tiles.numel(),), -1, dtype=torch.int32,
                            device="cuda")
    dqkv, ran4 = launched(lambda: att._flash_qkv_bwd_cuda(
        qkv, dctx, ctx, lse, *args, visits=visits))
    log(f"  flash_qkv {name} [{b},{s},{h}x3x{d}]: ran {ran3 + ran4}")
    if ran4 != want[1:]:
        raise AssertionError(f"flash_qkv {name}: backward ran {ran4}, "
                             f"expected {want[1:]}")
    rdqkv = att._flash_qkv_bwd_plain(qkv, dctx, ctx, lse, *args)
    torch.cuda.synchronize()
    e4 = check(f"flash_qkv_bwd {name} dqkv", dqkv, rdqkv)
    del rdqkv
    if visits is not None:
        got = visits.cpu().long()
        n_kv = b * h * -(-s // att.QKV_SM90_BWD_TILES["dkdv"][1])
        log(f"  flash_qkv_bwd {name} tiles walked: dk/dv "
            f"{int(got[:n_kv].sum())}, dq {int(got[n_kv:].sum())}; the plain "
            f"rule's {int(tiles[:n_kv].sum())}, {int(tiles[n_kv:].sum())}: "
            f"{'ok' if torch.equal(got, tiles) else 'FAIL'}")
        if not torch.equal(got, tiles):
            raise AssertionError(f"flash_qkv_bwd {name}: tiles walked differ "
                                 "from flash_bwd_tiles")
        again = att._flash_qkv_fwd_cuda(qkv, *args)
        check_bitwise(f"flash_qkv_fwd {name} run twice", (ctx, lse), again)
        check_bitwise(f"flash_qkv_bwd {name} run twice", (dqkv,),
                      (att._flash_qkv_bwd_cuda(qkv, dctx, ctx, lse, *args),))
    torch.cuda.empty_cache()
    return e3, e4, (qkv, dctx, ctx, lse)


def scalar_qkv(qkv, dctx, ctx, lse, rate):
    """Calls of the scalar kernels' bf16 instances (``flash_qkv_fwd.cu``,
    ``flash_qkv_bwd.cu``, the bf16 route before the tensor-core kernels)
    straight through their ``Kernel`` objects: the wrappers send bf16 to
    the tensor-core kernels only.  Returns (forward, backward) callables."""
    b, s, _ = qkv.shape
    h, d = TRAIN["heads"], TRAIN["d"]
    seed, thresh, keep, inv = att._dropout_launch_args(rate, RATE_SEED)
    out, out_lse = torch.empty_like(ctx), torch.empty_like(lse)
    delta, dqkv = torch.empty_like(lse), torch.empty_like(qkv)
    code, dev = kernels.DTYPE_CODES[qkv.dtype], qkv.device.index

    def fwd():
        kernels.FLASH_QKV_FWD(
            code, d, dev, qkv.data_ptr(), out.data_ptr(), out_lse.data_ptr(),
            None, None, 1, b, h, s, d ** -0.5, 1, seed, thresh, keep,
            torch.cuda.current_stream().cuda_stream)

    def bwd():
        kernels.FLASH_QKV_BWD(
            code, d, dev, qkv.data_ptr(), dctx.data_ptr(), ctx.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), None, None, 1,
            b, h, s, d ** -0.5, 1, seed, thresh, inv,
            torch.cuda.current_stream().cuda_stream)

    return fwd, bwd


def time_flash_qkv(qkv, dctx, ctx, lse, rate) -> tuple:
    """K3 and K4 (the tensor-core kernels, through the wrappers) timed cold
    beside their plain versions, SDPA and the scalar kernels they replace
    on bf16 (cold too); then the scalar and the tensor-core kernel of each
    in turns (a, b, b, a) in this one call (``timing.timed_pair``).  The
    scalar kernels have no fp16 instance: an fp16 qkv is timed without
    them (the third element is then None)."""
    b, s, _ = qkv.shape
    h, d = TRAIN["heads"], TRAIN["d"]
    args = (None, None, h, d ** -0.5, True, rate, RATE_SEED)
    new_fwd = lambda: att._flash_qkv_fwd_cuda(qkv, *args)  # noqa: E731
    new_bwd = lambda: att._flash_qkv_bwd_cuda(  # noqa: E731
        qkv, dctx, ctx, lse, *args)
    old = qkv.dtype in kernels.DTYPE_CODES
    if old:
        old_fwd, old_bwd = scalar_qkv(qkv, dctx, ctx, lse, rate)
    fwd_ms = cold_ms(new_fwd, 10)
    fwd_old = cold_ms(old_fwd, 5, 1) if old else None
    fwd_plain = cold_ms(lambda: att._flash_qkv_fwd_plain(qkv, *args), 5, 1)
    bwd_ms = cold_ms(new_bwd, 10)
    bwd_old = cold_ms(old_bwd, 5, 1) if old else None
    bwd_plain = cold_ms(lambda: att._flash_qkv_bwd_plain(
        qkv, dctx, ctx, lse, *args), 5, 1)
    if old:
        pair_fwd = timing.timed_pair(old_fwd, new_fwd, (), ())
        pair_bwd = timing.timed_pair(old_bwd, new_bwd, (), ())
    # the library yardstick: SDPA on the same strided per-head views
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(b, s, h, 3, d).permute(3, 0, 2, 1, 4))
    fwd_lib = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=rate, is_causal=True), 10)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=rate,
                                         is_causal=True)
    dout = dctx.view(b, s, h, d).transpose(1, 2)
    bwd_lib = cold_ms(lambda: torch.autograd.grad(
        out, (q, k, v), dout, retain_graph=True), 10)
    rows = b * h * s                          # every row live
    pairs = b * h * s * (s + 1) // 2          # visible causal pairs
    fb, fby = attention_bound(qkv.dtype, d, rows, rows, True, rows, rows,
                              pairs)
    bb, bby = attention_bound(qkv.dtype, d, rows, rows, False, rows, rows,
                              pairs)
    log(f"  flash_qkv timing [{b},{s},{h}x3x{d}] {qkv.dtype} dropout {rate}:"
        f" fwd kernel {fwd_ms:.4f} ms"
        + (f" (scalar {fwd_old:.4f}: {fwd_old / fwd_ms:.2f}x)" if old else "")
        + f", plain {fwd_plain:.4f}, sdpa {fwd_lib:.4f}, bound {fb:.4f} "
        f"({fby}, {fb / fwd_ms:.1%} of it); bwd kernel {bwd_ms:.4f} ms"
        + (f" (scalar {bwd_old:.4f}: {bwd_old / bwd_ms:.2f}x)" if old else "")
        + f", plain {bwd_plain:.4f}, sdpa backward {bwd_lib:.4f}, bound "
        f"{bb:.4f} ({bby}, {bb / bwd_ms:.1%} of it)")
    fwd = dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
               bound_ms=fb, bound_by=fby, flops=4 * d * pairs)
    bwd = dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
               bound_ms=bb, bound_by=bby, flops=10 * d * pairs)
    if not old:
        return fwd, bwd, None
    log(f"  in turns (timed_pair, warm): fwd scalar {pair_fwd[0]:.4f} ms vs "
        f"tensor-core {pair_fwd[1]:.4f} ms ({pair_fwd[0] / pair_fwd[1]:.2f}x);"
        f" bwd scalar {pair_bwd[0]:.4f} vs {pair_bwd[1]:.4f} "
        f"({pair_bwd[0] / pair_bwd[1]:.2f}x)")
    scalar = ({**fwd, "ms": fwd_old, "warm_pair_ms": pair_fwd[0]},
              {**bwd, "ms": bwd_old, "warm_pair_ms": pair_bwd[0]})
    fwd["warm_pair_ms"], bwd["warm_pair_ms"] = pair_fwd[1], pair_bwd[1]
    return fwd, bwd, scalar


def layer_norm_case(gen, name, dtype, rows=TRAIN["b"] * TRAIN["s"],
                    cols=TRAIN["hidden"], affine=True):
    """K6 and K7 against their plain versions (fp32 weights, as the
    main path's masters are), naming the kernels that ran; on the
    ``layer_norm_sm90.cu`` route both run again (bitwise)."""
    x = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, cols, generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(cols, generator=gen, device="cuda")
    b = 0.1 * torch.randn(cols, generator=gen, device="cuda")
    if not affine:
        w = b = None
    (y, mean, invvar), ran6 = launched(lambda: ln._ln_fwd_cuda(x, w, b,
                                                               1e-5))
    ry, rmean, rinvvar = ln._ln_fwd_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    route = ln._ln_route(dtype, cols)
    want = [ln._ln_kernels(x)[0].symbol]
    log(f"  {name} [{rows}, {cols}]: route {route}, ran {ran6}")
    if ran6 != want:
        raise AssertionError(f"layer_norm {name}: ran {ran6}, expected "
                             f"{want}")
    e6 = check(f"{ran6[0]} {name} y", y, ry)
    check(f"{ran6[0]} {name} mean", mean, rmean)
    check(f"{ran6[0]} {name} invvar", invvar, rinvvar)
    (dx, dw, db), ran7 = launched(lambda: ln._ln_bwd_cuda(
        x, dy, mean, invvar, w, affine))
    rdx, rdw, rdb = ln._ln_bwd_plain(x, dy, mean, invvar, w, affine)
    torch.cuda.synchronize()
    if ran7 != [k.replace("fwd", "bwd") for k in want]:
        raise AssertionError(f"layer_norm {name}: backward ran {ran7}")
    e7 = check(f"{ran7[0]} {name} dx", dx, rdx)
    if affine:
        check(f"{ran7[0]} {name} dweight", dw, rdw)
        check(f"{ran7[0]} {name} dbias", db, rdb)
    elif dw is not None or db is not None:
        raise AssertionError(f"layer_norm {name}: gradients of no weight")
    if route == "sm90":
        check_bitwise(f"{ran6[0]} {name} run twice", (y, mean, invvar),
                      ln._ln_fwd_cuda(x, w, b, 1e-5))
        again = ln._ln_bwd_cuda(x, dy, mean, invvar, w, affine)
        check_bitwise(f"{ran7[0]} {name} run twice",
                      [t for t in (dx, dw, db) if t is not None],
                      [t for t in again if t is not None])
    return e6, e7, (x, dy, w, b, mean, invvar)


def ln_kernel_calls(kernel_fwd, kernel_bwd, x, dy, w, b, mean, invvar):
    """Calls of one route's two kernels straight through their ``Kernel``
    objects on preallocated outputs (the wrappers pick the route by width
    and allocate on every call): (forward, backward) callables."""
    rows, cols = x.shape
    y, dx = torch.empty_like(x), torch.empty_like(x)
    out_mean, out_inv = torch.empty_like(mean), torch.empty_like(invvar)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    part = torch.empty(ln.ln_bwd_workspace(rows, cols), device="cuda")
    code, dev = ln._KERNEL_DTYPES[x.dtype], x.device.index

    def fwd():
        kernel_fwd(code, dev, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                   y.data_ptr(), out_mean.data_ptr(), out_inv.data_ptr(),
                   rows, cols, 1e-5, torch.cuda.current_stream().cuda_stream)

    def bwd():
        kernel_bwd(code, dev, x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                   invvar.data_ptr(), w.data_ptr(), dx.data_ptr(),
                   dw.data_ptr(), db.data_ptr(), part.data_ptr(), rows, cols,
                   torch.cuda.current_stream().cuda_stream)

    return fwd, bwd


def time_layer_norm(x, dy, w, b, mean, invvar) -> tuple:
    """K6 and K7 on ``layer_norm_sm90.cu`` (through the wrappers) timed
    cold beside their plain versions, ``F.layer_norm`` and the kernels of
    ``layer_norm.cu`` they replace at this width (cold too), x's dtype's
    instances of each (fp16 has its own); then the old and the new kernel
    of each in turns (a, b, b, a) in this one call
    (``timing.timed_pair``, both straight through their ``Kernel``
    objects).  Returns (new forward, new backward, old forward, old
    backward) rows."""
    rows, cols = x.shape
    fwd_ms = cold_ms(lambda: ln._ln_fwd_cuda(x, w, b, 1e-5), 50)
    fwd_plain = cold_ms(lambda: ln._ln_fwd_plain(x, w, b, 1e-5), 20)
    bwd_ms = cold_ms(lambda: ln._ln_bwd_cuda(x, dy, mean, invvar, w, True),
                     50)
    bwd_plain = cold_ms(lambda: ln._ln_bwd_plain(x, dy, mean, invvar, w,
                                                 True), 20)
    f16 = "_F16" if x.dtype == torch.float16 else ""
    new_fwd, new_bwd = ln_kernel_calls(
        getattr(kernels, f"LAYER_NORM_FWD_SM90{f16}"),
        getattr(kernels, f"LAYER_NORM_BWD_SM90{f16}"), x, dy, w, b, mean,
        invvar)
    old_fwd, old_bwd = ln_kernel_calls(
        getattr(kernels, f"LAYER_NORM_FWD{f16}"),
        getattr(kernels, f"LAYER_NORM_BWD{f16}"), x, dy, w, b, mean, invvar)
    fwd_old, bwd_old = cold_ms(old_fwd, 50), cold_ms(old_bwd, 50)
    pair_fwd = timing.timed_pair(old_fwd, new_fwd, (), ())
    pair_bwd = timing.timed_pair(old_bwd, new_bwd, (), ())
    # the library yardstick in x's dtype throughout (F.layer_norm wants
    # one dtype), forward and its autograd backward
    xl = x.detach().requires_grad_()
    wl, bl = (t.to(x.dtype).requires_grad_() for t in (w, b))
    fwd_lib = cold_ms(lambda: F.layer_norm(xl, (cols,), wl, bl), 50)
    yl = F.layer_norm(xl, (cols,), wl, bl)
    bwd_lib = cold_ms(lambda: torch.autograd.grad(
        yl, (xl, wl, bl), dy, retain_graph=True), 50)
    item = x.element_size()
    # x in, y out, w and b in, mean and invvar out; ~7 fp32 ops an element
    fb, fby = bound(2 * rows * cols * item + 2 * cols * 4 + 2 * rows * 4,
                    7 * rows * cols, torch.float32)
    # x, dy in, dx out, w in, dw and db out, mean and invvar in
    bb, bby = bound(3 * rows * cols * item + 3 * cols * 4 + 2 * rows * 4,
                    12 * rows * cols, torch.float32)
    log(f"  layer_norm timing [{rows},{cols}] {x.dtype} (fp32 w): fwd kernel"
        f" {fwd_ms:.4f} ms (layer_norm.cu {fwd_old:.4f}: "
        f"{fwd_old / fwd_ms:.2f}x), plain {fwd_plain:.4f}, F.layer_norm "
        f"{fwd_lib:.4f}, bound {fb:.4f} ({fby}, {fb / fwd_ms:.1%} of it); "
        f"bwd kernel {bwd_ms:.4f} ms (layer_norm.cu {bwd_old:.4f}: "
        f"{bwd_old / bwd_ms:.2f}x), plain {bwd_plain:.4f}, F.layer_norm "
        f"backward {bwd_lib:.4f}, bound {bb:.4f} ({bby}, {bb / bwd_ms:.1%} "
        f"of it)")
    log(f"  in turns (timed_pair, warm): fwd layer_norm.cu {pair_fwd[0]:.4f}"
        f" ms vs layer_norm_sm90.cu {pair_fwd[1]:.4f} ms "
        f"({pair_fwd[0] / pair_fwd[1]:.2f}x); bwd {pair_bwd[0]:.4f} vs "
        f"{pair_bwd[1]:.4f} ({pair_bwd[0] / pair_bwd[1]:.2f}x)")
    fwd = dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
               bound_ms=fb, bound_by=fby, warm_pair_ms=pair_fwd[1])
    bwd = dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
               bound_ms=bb, bound_by=bby, warm_pair_ms=pair_bwd[1])
    return (fwd, bwd, {**fwd, "ms": fwd_old, "warm_pair_ms": pair_fwd[0]},
            {**bwd, "ms": bwd_old, "warm_pair_ms": pair_bwd[0]})


def phase_training_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    flash_qkv_case(gen, "bf16 causal, no dropout", bf16, 0.0)
    e3, e4, ops = flash_qkv_case(gen, f"bf16 causal, dropout {ATT_DROPOUT}",
                                 bf16, ATT_DROPOUT)
    s3, s4, _ = flash_qkv_case(gen, f"fp32 causal, dropout {ATT_DROPOUT}, "
                               "b=1", fp32, ATT_DROPOUT, b=1)
    seg = torch.stack([seg_row(512, [200, 250]), seg_row(512, [512])]).cuda()
    flash_qkv_case(gen, "bf16 causal + segment ids, dropout, b=2 s=512",
                   bf16, ATT_DROPOUT, b=2, s=512, seg=seg)
    flash_qkv_case(gen, f"bf16 non-causal, dropout {ATT_DROPOUT}, b=2 s=512",
                   bf16, ATT_DROPOUT, b=2, s=512, causal=False)
    seg = torch.stack([seg_row(1000, [300, 450]),
                       seg_row(1000, [1000])]).cuda()
    flash_qkv_case(gen, "bf16 causal + segment ids, dropout, b=2 ragged "
                   "s=1000", bf16, ATT_DROPOUT, b=2, s=1000, seg=seg)
    fwd, bwd, (sfwd, sbwd) = time_flash_qkv(*ops, ATT_DROPOUT)
    del ops
    torch.cuda.empty_cache()
    # fp16 (amp's half): the tensor-core K3/K4's own instances, on a
    # generator of their own (the bf16 and fp32 cases draw as before)
    f16, gh = torch.float16, torch.Generator(device="cuda").manual_seed(17)
    flash_qkv_case(gh, "fp16 causal, no dropout", f16, 0.0)
    h3, h4, hops = flash_qkv_case(gh, f"fp16 causal, dropout {ATT_DROPOUT}",
                                  f16, ATT_DROPOUT)
    seg = torch.stack([seg_row(1000, [300, 450]),
                       seg_row(1000, [1000])]).cuda()
    flash_qkv_case(gh, "fp16 causal + segment ids, dropout, b=2 ragged "
                   "s=1000", f16, ATT_DROPOUT, b=2, s=1000, seg=seg)
    hfwd, hbwd, _ = time_flash_qkv(*hops, ATT_DROPOUT)
    del hops
    torch.cuda.empty_cache()
    e6, e7, lops = layer_norm_case(gen, "bf16 x", bf16)
    layer_norm_case(gen, "fp32 x", fp32)
    layer_norm_case(gen, "bf16 x, the MHA decoder's rows", bf16,
                    rows=MHA["batch"] * MHA["tgt"], cols=MHA["hidden"])
    layer_norm_case(gen, "bf16 x, ragged rows", bf16, rows=8191)
    layer_norm_case(gen, "bf16 x, no weight or bias", bf16, rows=37,
                    affine=False)
    layer_norm_case(gen, "fp32 x at 4096, ragged rows", fp32, rows=1001,
                    cols=4096)
    # a width outside SM90_WIDTHS: layer_norm.cu's route
    o6, o7, _ = layer_norm_case(gen, "bf16 x at 1536", bf16, rows=4096,
                                cols=1536)
    lfwd, lbwd, ofwd, obwd = time_layer_norm(*lops)
    del lops
    h6, h7, hlops = layer_norm_case(gh, "fp16 x", f16)
    layer_norm_case(gh, "fp16 x, ragged rows", f16, rows=8191)
    layer_norm_case(gh, "fp16 x, no weight or bias", f16, rows=37,
                    affine=False)
    p6, p7, _ = layer_norm_case(gh, "fp16 x at 1536", f16, rows=4096,
                                cols=1536)
    hlfwd, hlbwd, hofwd, hobwd = time_layer_norm(*hlops)
    del hlops
    hfwd["max_abs_err"], hbwd["max_abs_err"] = h3, h4
    hlfwd["max_abs_err"], hlbwd["max_abs_err"] = h6, h7
    hofwd["max_abs_err"], hobwd["max_abs_err"] = p6, p7  # their route
    fwd["max_abs_err"], bwd["max_abs_err"] = e3, e4
    sfwd["max_abs_err"], sbwd["max_abs_err"] = s3, s4  # their fp32 route
    lfwd["max_abs_err"], lbwd["max_abs_err"] = e6, e7
    ofwd["max_abs_err"], obwd["max_abs_err"] = o6, o7  # their route
    return {"flash_qkv_fwd_sm90": fwd, "flash_qkv_bwd_sm90": bwd,
            "flash_qkv_fwd": sfwd, "flash_qkv_bwd": sbwd,
            "layer_norm_fwd_sm90": lfwd, "layer_norm_bwd_sm90": lbwd,
            "layer_norm_fwd": ofwd, "layer_norm_bwd": obwd,
            "flash_qkv_fwd_sm90_f16": hfwd, "flash_qkv_bwd_sm90_f16": hbwd,
            "layer_norm_fwd_sm90_f16": hlfwd,
            "layer_norm_bwd_sm90_f16": hlbwd,
            "layer_norm_fwd_f16": hofwd, "layer_norm_bwd_f16": hobwd}


# -- phase 3, slice 12: K3/K4 at BERT-large's shape (head dim 64, not
# causal, key padding and packing ids folded into segment ids) -------------

BERT_D = bert_large.BERT_H // bert_large.BERT_HEADS     # 64


def bert_attention_ids(batch, layout):
    """The packed kernels' segment ids of one BERT-large batch as the
    model folds them (``standalone_gpt.attention_segments``): ``padded``
    its key-padding mask, ``packed`` its packing ids, ``folded`` the
    packed rows with their padding mask too."""
    if layout == "packed":
        return batch["segment_ids"]
    pad = ~batch["loss_mask" if layout == "folded"
                 else "attention_mask"][:, None, None, :].bool()
    return attention_segments(
        pad, batch["segment_ids"] if layout == "folded" else None)


def time_bert_qkv(qkv, dctx, ctx, lse, seg, what) -> tuple:
    """K3 and K4 (through the wrappers: the route of qkv's dtype at head
    dim 64) timed cold at a BERT-large batch beside their plain versions
    and SDPA with the same ids as a boolean mask (the library call for the
    same function), with the bound of this batch's visible pairs."""
    b, s, _ = qkv.shape
    h, d = bert_large.BERT_HEADS, BERT_D
    seg_q, seg_k = seg_pair(seg)
    args = (seg_q, seg_k, h, d ** -0.5, False, 0.0, RATE_SEED)
    fwd_ms = cold_ms(lambda: att._flash_qkv_fwd_cuda(qkv, *args), 10)
    fwd_plain = cold_ms(lambda: att._flash_qkv_fwd_plain(qkv, *args), 5, 1)
    bwd_ms = cold_ms(lambda: att._flash_qkv_bwd_cuda(
        qkv, dctx, ctx, lse, *args), 10)
    bwd_plain = cold_ms(lambda: att._flash_qkv_bwd_plain(
        qkv, dctx, ctx, lse, *args), 5, 1)
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(b, s, h, 3, d).permute(3, 0, 2, 1, 4))
    mask = (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    fwd_lib = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 10)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    dout = dctx.view(b, s, h, d).transpose(1, 2)
    bwd_lib = cold_ms(lambda: torch.autograd.grad(
        out, (q, k, v), dout, retain_graph=True), 10)
    pairs, live_q, live_k = live_counts(seg_q, seg_k, h)
    ids = seg_q.untyped_storage().nbytes() + seg_k.untyped_storage().nbytes()
    rows = b * h * s
    fb, fby = attention_bound(qkv.dtype, d, rows, rows, True, live_q, live_k,
                              pairs, ids)
    bb, bby = attention_bound(qkv.dtype, d, rows, rows, False, live_q,
                              live_k, pairs, ids)
    log(f"  flash_qkv d 64 timing, {what} [{b},{s},{h}x3x{d}] {qkv.dtype}, "
        f"{pairs} visible pairs, {live_k} of {rows} key rows seen: fwd "
        f"kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f}, sdpa (boolean "
        f"mask) {fwd_lib:.4f}, bound {fb:.4f} ({fby}, {fb / fwd_ms:.1%} of "
        f"it); bwd kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f}, sdpa "
        f"backward {bwd_lib:.4f}, bound {bb:.4f} ({bby}, {bb / bwd_ms:.1%} "
        f"of it)")
    fwd = dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
               bound_ms=fb, bound_by=fby, flops=4 * d * pairs)
    bwd = dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
               bound_ms=bb, bound_by=bby, flops=10 * d * pairs)
    return fwd, bwd


def phase_bert_kernels() -> dict:
    """K3/K4's head-dim-64 instances against their plain versions at
    BERT-large's batches (bench.py's workload: 16 sequences padded to 512,
    and packed into 13 rows), not causal, through the three foldings of
    key padding and packing ids; a ragged s = 500; the dropout and the
    causal instances; fp32 on the scalar route; then timed."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16, fp32 = torch.bfloat16, torch.float32
    padded, packed, _, _ = bert_large.bert_batches()
    kw = dict(d=BERT_D, h=bert_large.BERT_HEADS, causal=False)
    segs, errs, ops = {}, {}, {}
    for layout, batch in (("padded", padded), ("packed", packed),
                          ("folded", packed)):
        segs[layout] = bert_attention_ids(batch, layout)
        e3, e4, ops[layout] = flash_qkv_case(
            gen, f"bf16 BERT-large {layout}", bf16, 0.0,
            b=batch["tokens"].shape[0], s=bert_large.BERT_SEQ,
            seg=segs[layout], **kw)
        errs[layout] = (e3, e4)
        if layout == "folded":
            del ops[layout]
    lens = torch.tensor([500, 437, 256, 64], device="cuda")
    flash_qkv_case(gen, "bf16 key padding, ragged s=500", bf16, 0.0, b=4,
                   s=500, seg=segments_of(key_padding(lens, 500), 500), **kw)
    pad4 = {k: v[:4] for k, v in padded.items()}
    flash_qkv_case(gen, f"bf16 key padding, dropout {ATT_DROPOUT}", bf16,
                   ATT_DROPOUT, b=4, s=bert_large.BERT_SEQ,
                   seg=bert_attention_ids(pad4, "padded"), **kw)
    seg = torch.stack([seg_row(512, [200, 250]), seg_row(512, [512])]).cuda()
    flash_qkv_case(gen, "bf16 causal + segment ids, dropout, b=2 s=512",
                   bf16, ATT_DROPOUT, b=2, s=512, seg=seg, d=BERT_D,
                   h=bert_large.BERT_HEADS)
    s3, s4, sops = flash_qkv_case(gen, "fp32 BERT-large padded", fp32, 0.0,
                                  b=padded["tokens"].shape[0],
                                  s=bert_large.BERT_SEQ,
                                  seg=segs["padded"], **kw)
    # fp16 (amp's half) at head dim 64: its own instances, on a generator
    # of their own
    gh = torch.Generator(device="cuda").manual_seed(18)
    h3, h4, hops = flash_qkv_case(gh, "fp16 BERT-large padded",
                                  torch.float16, 0.0,
                                  b=padded["tokens"].shape[0],
                                  s=bert_large.BERT_SEQ, seg=segs["padded"],
                                  **kw)
    flash_qkv_case(gh, f"fp16 key padding, dropout {ATT_DROPOUT}",
                   torch.float16, ATT_DROPOUT, b=4, s=bert_large.BERT_SEQ,
                   seg=bert_attention_ids(pad4, "padded"), **kw)
    fwd, bwd = time_bert_qkv(*ops["padded"], segs["padded"], "padded")
    pfwd, pbwd = time_bert_qkv(*ops["packed"], segs["packed"], "packed")
    sfwd, sbwd = time_bert_qkv(*sops, segs["padded"], "padded")
    hfwd, hbwd = time_bert_qkv(*hops, segs["padded"], "padded")
    hfwd["max_abs_err"], hbwd["max_abs_err"] = h3, h4
    del ops, sops, hops
    torch.cuda.empty_cache()
    fwd["max_abs_err"], bwd["max_abs_err"] = errs["padded"]
    pfwd["max_abs_err"], pbwd["max_abs_err"] = errs["packed"]
    fwd["at_packed"], bwd["at_packed"] = pfwd, pbwd
    fwd["max_abs_err_folded"], bwd["max_abs_err_folded"] = errs["folded"]
    sfwd["max_abs_err"], sbwd["max_abs_err"] = s3, s4
    return {"flash_qkv_fwd_sm90_d64": fwd, "flash_qkv_bwd_sm90_d64": bwd,
            "flash_qkv_fwd_d64": sfwd, "flash_qkv_bwd_d64": sbwd,
            "flash_qkv_fwd_sm90_d64_f16": hfwd,
            "flash_qkv_bwd_sm90_d64_f16": hbwd}


# -- phase 3, slice 3: the generic attention kernels K1 (mask, dropout,
# d = 64) and K2 ------------------------------------------------------------

# the multi-head attention main path (phase 9): Transformer-big, the "big"
# row of Table 3 of Vaswani et al. 2017 (d_model 1024, 16 heads of 64)
MHA = dict(hidden=1024, heads=16, layers=6, batch=32, src=256, tgt=192,
           dropout=0.1)
MASK_FILL = -10000.0         # the modules' fill for a boolean mask


def mha_lengths(seed, b, lo, hi):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        lo, hi + 1, size=b)).cuda()


def mha_operands(gen, dtype, sq, sk, b, d, h=16):
    """q, k, v as the attention modules hand them to the kernels: strided
    [b, h, s, d] views of a [s, b, 3*h*d] projection (sq == sk) or of
    [sq, b, h*d] and [sk, b, 2*h*d] ones; do in the [s, b, h, d] order
    autograd hands it back."""
    def heads(t, s):
        return t.view(s, b, h, d).permute(1, 2, 0, 3)

    if sq == sk:
        qkv = torch.randn(sq, b, 3 * h * d, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (heads(t, sq) for t in qkv.split(h * d, -1))
    else:
        q = heads(torch.randn(sq, b, h * d, generator=gen,
                              device="cuda").to(dtype), sq)
        kv = torch.randn(sk, b, 2 * h * d, generator=gen,
                         device="cuda").to(dtype)
        k, v = (heads(t, sk) for t in kv.split(h * d, -1))
    do = heads(torch.randn(sq, b, h * d, generator=gen,
                           device="cuda").to(dtype), sq)
    return q, k, v, do


def key_padding(lengths, sk):
    """[b, sk] bool, True = padded (the modules' key_padding_mask)."""
    return torch.arange(sk, device="cuda")[None] >= lengths[:, None]


def segments_of(pad, sq):
    """The modules' segment route: all-ones query ids, key ids 1 = real."""
    keep = (~pad).to(torch.int32)
    return torch.ones(pad.shape[0], sq, dtype=torch.int32,
                      device="cuda"), keep


def causal_fill(sq, sk):
    """[1, 1, sq, sk] additive causal mask, as the decoder's bool
    attn_mask becomes on the module's mask_bias route."""
    tri = torch.ones(sq, sk, dtype=torch.bool, device="cuda").triu(
        1 + sk - sq)
    return torch.where(tri, MASK_FILL, 0.0)[None, None]


def check_bitwise(name, a, b):
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"  {name}: bitwise equal {same}")
    if not same:
        raise AssertionError(f"{name}: not bitwise equal")


def flash_fwd_tiles(seg_q, seg_k, sq, sk, causal, block_q=128,
                    block_k=128):
    """The key tiles each q-tile block of a flash forward walks, as
    [rows, n_qb, 2] [lo, hi) ranges: the segment rule
    (``_segment_block_bounds``' first output), cut at the tile of the
    last key the block's last query sees under the causal mask.  The
    backward's dq pass walks the same rule (:func:`flash_bwd_tiles`).
    ``csrc/flash_fwd_sm90.cu`` walks 128 x 128; its ``visits`` are held
    against this in phase 3, and this against the JAX package's rule in
    the tests."""
    return flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, block_q, block_k)[1]


def fwd_visits(q):
    """A ``visits`` tensor for the tensor-core K1 on operands like ``q``."""
    return torch.full((att.flash_fwd_visits_len(q),), -1, dtype=torch.int32,
                      device="cuda")


def check_fwd_visits(name, visits, seg_q, seg_k, sq, sk, causal, bh):
    """The tensor-core K1's tiles walked, per block, against
    :func:`flash_fwd_tiles` at its tiles."""
    bq, bk = att.FLASH_FWD_SM90_TILES
    want = flash_fwd_tiles(seg_q, seg_k, sq, sk, causal, bq, bk)
    want = want[..., 1] - want[..., 0]
    want = want.repeat_interleave(bh // want.shape[0], 0).flatten()
    got = visits.cpu().long()
    ok = torch.equal(got, want)
    log(f"  {name} tiles walked ({bq} x {bk}): {int(got.sum())} of "
        f"{bh * -(-sq // bq) * -(-sk // bk)}; the plain rule's "
        f"{int(want.sum())}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: tiles walked differ from "
                             "flash_fwd_tiles")


def flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, block_q=64,
                    block_k=64):
    """The tiles a three-pass flash backward walks, as [lo, hi) ranges:
    ([rows, n_kb, 2] q-tiles of each k-tile's dk/dv block, [rows, n_qb, 2]
    k-tiles of each q-tile's dq block), rows being the segment-id rows
    (one without segments); an empty range has lo == hi.  The dk/dv pass
    takes the transposed segment rule (``_segment_block_bounds``' second
    output) and, under the causal mask, starts at the tile of row k0 - (sk
    - sq), the first row that sees its first column; the dq pass takes the
    forward's rule and stops at the causal limit.  Tiles of ``block_q``
    rows and ``block_k`` columns (64 and 64: ``csrc/flash_bwd_kernel.cuh``,
    K2's scalar route; ``csrc/flash_bwd_sm90.cu``, K2's tensor-core route,
    and ``csrc/flash_qkv_bwd_sm90.cu``, K4, walk 32 x 128 in their dk/dv
    pass and 128 x 64 in their dq pass); a ragged last tile counts its
    valid ids only.  The kernels' own counts (``visits``) are held against this in
    phase 3, and this against the JAX package's rule in the tests."""
    n_qb, n_kb = -(-sq // block_q), -(-sk // block_k)
    if seg_q is None:
        q_lo, q_hi = torch.zeros(1, n_kb, dtype=torch.int64), torch.full(
            (1, n_kb), n_qb)
        k_lo, k_hi = torch.zeros(1, n_qb, dtype=torch.int64), torch.full(
            (1, n_qb), n_kb)
    else:
        def pad(ids, n, block):  # repeat the last id: min and max stay
            ids = ids.to(torch.int64).cpu()
            return torch.cat([ids, ids[:, -1:].expand(-1, n * block
                                                      - ids.shape[1])], 1)

        lohi_q, lohi_k = att._segment_block_bounds(
            pad(seg_q, n_qb, block_q), pad(seg_k, n_kb, block_k), block_q,
            block_k)
        k_lo, k_hi = lohi_q[..., 0].long(), lohi_q[..., 1].long()
        q_lo, q_hi = lohi_k[..., 0].long(), lohi_k[..., 1].long()
    if causal:
        first = torch.arange(n_kb) * block_k - (sk - sq)
        q_lo = torch.maximum(q_lo, torch.where(
            first <= 0, 0, (first // block_q).clamp(max=n_qb)))
        q0 = torch.arange(n_qb) * block_q
        last = q0 + (sq - q0).clamp(max=block_q) - 1 + (sk - sq)
        k_hi = torch.minimum(k_hi, torch.where(last >= 0,
                                               last // block_k + 1, 0))
    return (torch.stack([q_lo, torch.maximum(q_hi, q_lo)], -1),
            torch.stack([k_lo, torch.maximum(k_hi, k_lo)], -1))


def generic_case(gen, name, dtype, sq, sk, *, b, d, h=16, causal=False,
                 mask=None, seg=None, rate=0.0, repeat=False):
    """K1 and K2 against their plain versions on the same inputs (K2 gets
    K1's o and lse), and the tiles each walked against the plain
    statement of its skip rule (bf16 at head dims 64 and 128 runs
    ``flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu``, held to
    :func:`flash_fwd_tiles` and :func:`flash_bwd_tiles` at their tiles;
    the rest the scalar ``flash_fwd.cu`` and ``flash_bwd.cu``, K2 held to
    its rule at its tiles; the launch counts name the kernel that ran).
    ``repeat`` runs both again (bitwise).  Returns (K1 error, K2 error,
    operands)."""
    q, k, v, do = mha_operands(gen, dtype, sq, sk, b, d, h)
    seg_q, seg_k = seg if seg is not None else (None, None)
    args = (mask, seg_q, seg_k, d ** -0.5, causal, rate, RATE_SEED)
    tensor_cores = att._fwd_on_tensor_cores(q)
    visits = fwd_visits(q) if tensor_cores else None
    (o, lse), ran = launched(lambda: att._flash_fwd_cuda(q, k, v, *args,
                                                         visits=visits))
    ro, rlse = att._flash_fwd_plain(q, k, v, *args)
    torch.cuda.synchronize()
    e1 = check(f"{ran[0]} {name} o", o, ro)
    check_lse(f"{ran[0]} {name} lse", lse, rlse)
    if tensor_cores:
        check_fwd_visits(f"{ran[0]} {name}", visits, seg_q, seg_k, sq, sk,
                         causal, b * h)
    if repeat:
        check_bitwise(f"{ran[0]} {name} run twice", (o, lse),
                      att._flash_fwd_cuda(q, k, v, *args))
    tiles = att.flash_bwd_tiles_of(q)
    (bq2, bk2), (bq3, bk3) = tiles["dkdv"], tiles["dq"]
    n_kb = -(-sk // bk2)
    visits = torch.full((att.flash_bwd_visits_len(q, sk),), -1,
                        dtype=torch.int32, device="cuda")
    grads, ran = launched(lambda: att._flash_bwd_cuda(q, k, v, o, lse, do,
                                                      *args, visits=visits))
    ref = att._flash_bwd_plain(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    e2 = max(check(f"{ran[0]} {name} {n}", g, r)
             for n, g, r in zip(("dq", "dk", "dv"), grads, ref))
    want_kv = flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, bq2, bk2)[0]
    want_q = flash_bwd_tiles(seg_q, seg_k, sq, sk, causal, bq3, bk3)[1]
    want_kv, want_q = (r[..., 1] - r[..., 0] for r in (want_kv, want_q))
    rows = want_kv.shape[0]
    want = torch.cat([want_kv.repeat_interleave(b * h // rows, 0).flatten(),
                      want_q.repeat_interleave(b * h // rows, 0).flatten()])
    got = visits.cpu().long()
    full = b * h * (n_kb * -(-sq // bq2) + -(-sq // bq3) * -(-sk // bk3))
    log(f"  {ran[0]} {name} tiles walked ({bq2} x {bk2}, {bq3} x {bk3}): "
        f"{int(got.sum())} of {full} (dk/dv {int(got[:b * h * n_kb].sum())}"
        f", dq {int(got[b * h * n_kb:].sum())}); the plain rule's "
        f"{int(want.sum())}: {'ok' if torch.equal(got, want) else 'FAIL'}")
    if not torch.equal(got, want):
        raise AssertionError(f"{ran[0]} {name}: tiles walked differ from "
                             "flash_bwd_tiles")
    if repeat:
        again = att._flash_bwd_cuda(q, k, v, o, lse, do, *args)
        check_bitwise(f"{ran[0]} {name} run twice", grads, again)
    del ro, rlse, ref
    return e1, e2, (q, k, v, do, o, lse, args)


def phase_generic_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, fp32 = torch.bfloat16, torch.float32
    B, S, T = MHA["batch"], MHA["src"], MHA["tgt"]
    src_pad = key_padding(mha_lengths(5, B, 32, S), S)
    tgt_pad = key_padding(mha_lengths(6, B, 32, T), T)
    # the main path's three attention calls, at their shapes
    e1, e2, enc = generic_case(
        gen, "encoder self [32,16,256,64] bf16 key-padding segments", bf16,
        S, S, b=B, d=64, seg=segments_of(src_pad, S), repeat=True)
    dec_mask = (torch.where(tgt_pad, MASK_FILL, 0.0)[:, None, None, :]
                + causal_fill(T, T))                    # [b, 1, sq, sk]
    _, _, dec = generic_case(
        gen, "decoder self [32,16,192,64] bf16 pad + causal mask", bf16, T,
        T, b=B, d=64, mask=dec_mask, repeat=True)
    generic_case(gen, "cross [32,16,192x256,64] bf16 segments", bf16, T, S,
                 b=B, d=64, seg=segments_of(src_pad, T))
    # the mask read through its strides equals the mask materialised
    q, k, v, do, o, lse, args = dec
    full = dec_mask.expand(B, 16, T, T).contiguous()
    o_full, lse_full = att._flash_fwd_cuda(q, k, v, full, *args[1:])
    check_bitwise("flash_fwd zero-stride [b,1,sq,sk] mask vs materialised "
                  "[b,h,sq,sk]", (o, lse), (o_full, lse_full))
    check_bitwise("flash_bwd zero-stride mask vs materialised",
                  att._flash_bwd_cuda(q, k, v, o, lse, do, *args),
                  att._flash_bwd_cuda(q, k, v, o, lse, do, full, *args[1:]))
    del full, o_full, lse_full
    pad8 = src_pad[:8]
    generic_case(gen, "key padding [8,1,1,256] + attn mask [1,1,256,256], "
                 "zero strides", bf16, S, S, b=8, d=64,
                 mask=torch.where(pad8, MASK_FILL, 0.0)[:, None, None, :]
                 + causal_fill(S, S))
    e1_fp32, e2_fp32, _ = generic_case(
        gen, "full [b,h,sq,sk] random mask, fp32", fp32, 128, 128, b=2, d=64,
        mask=torch.randn(2, 16, 128, 128, generator=gen, device="cuda"))
    # each feature alone and combined, at other shapes, both dtypes
    generic_case(gen, "causal sq < sk (192 x 256) bf16", bf16, 192, 256, b=4,
                 d=64, causal=True)
    generic_case(gen, "causal sq > sk (256 x 192) + segments fp32", fp32, 256,
                 192, b=4, d=64, causal=True,
                 seg=segments_of(key_padding(mha_lengths(7, 4, 1, 192), 192),
                                 256))
    generic_case(gen, f"dropout {MHA['dropout']} + segments bf16", bf16, S, S,
                 b=8, d=64, rate=MHA["dropout"],
                 seg=segments_of(src_pad[:8], S))
    lens = mha_lengths(8, 4, 1, 200)
    lens[1] = 0   # every key of batch row 1 padded: its rows see nothing
    all_padded_case(gen, fp32, lens)
    varied = segments_of(key_padding(mha_lengths(9, 4, 1, 200), 200), 200)
    for dtype in (fp32, bf16):
        for d in (8, 64, 128):
            generic_case(gen, f"combined mask + segments + causal + dropout "
                         f"d={d} {dtype}", dtype, 200, 200, b=4, d=d, h=4,
                         causal=True, mask=torch.randn(
                             4, 1, 200, 200, generator=gen, device="cuda"),
                         seg=varied, rate=MHA["dropout"], repeat=d == 64)
    # the tensor-core K2's cases the scalar one had alone (fp32 above)
    all_padded_case(gen, bf16, lens)
    generic_case(gen, "causal sq > sk (256 x 192) + segments bf16", bf16, 256,
                 192, b=4, d=64, causal=True,
                 seg=segments_of(key_padding(mha_lengths(7, 4, 1, 192), 192),
                                 256))
    # a mask that hides every key of batch row 1 at a ragged key length:
    # its lse is near MASK_FILL, and the key tile past the end must stay
    # hidden in the dq pass (exp(-lse) overflows there)
    hidden = key_padding(lens, 200)[:, None, None, :]   # row 1: all keys
    for d in (64, 128):
        generic_case(gen, f"mask hides every key of a row, sk 200, d={d} "
                     "bf16", bf16, 200, 200, b=4, d=d, h=4,
                     mask=torch.where(hidden, MASK_FILL, 0.0))
    # the causal masked instances without dropout (at d = 64 the one that
    # takes two 64-key steps a tile), with a batch row whose every key a
    # mask of -300 hides: its scores take the tensor-core K1's FMA-chain
    # path (|row max| >= 256), where fp32's spacing (3e-5) is under
    # LSE_TOL; a generator of their own keeps the later cases' data
    gen_c = torch.Generator(device="cuda").manual_seed(4)
    for d in (64, 128):
        generic_case(gen_c, f"causal + mask of -300 hiding every key of a row,"
                     f" d={d} bf16", bf16, 200, 200, b=4, d=d, h=4,
                     causal=True, mask=torch.where(hidden, -300.0, 0.0))
    varlen_case(gen)
    timing = time_generic(enc, dec, gen)
    timing["flash_fwd_sm90_mha"]["max_abs_err"] = e1
    timing["flash_fwd_mha"]["max_abs_err"] = e1_fp32  # its route: fp32, d = 8
    timing["flash_bwd_sm90"]["max_abs_err"] = e2
    timing["flash_bwd"]["max_abs_err"] = e2_fp32  # its route: fp32, d = 8
    return timing


def all_padded_case(gen, dtype, lens) -> None:
    """A batch row whose keys are all padded (segment route, b = 4, s =
    200, d = 64): its o and dq are exact zeros and its lse K1's -1e30."""
    e_pad = generic_case(gen, f"all-padded rows (segment route) {dtype}",
                         dtype, 200, 200, b=4, d=64,
                         seg=segments_of(key_padding(lens, 200), 200))[2]
    q, k, v, do, o, lse, args = e_pad
    dq = att._flash_bwd_cuda(q, k, v, o, lse, do, *args)[0]
    zero = bool((o[1] == 0).all()) and bool((dq[1] == 0).all()) and bool(
        (lse.view(4, 16, 200)[1] == -1e30).all())
    log(f"  all-padded batch row, {dtype}: o, dq exactly 0 and lse -1e30: "
        f"{zero}")
    if not zero:
        raise AssertionError("all-padded rows are not exact zeros")


def varlen_case(gen) -> None:
    """flash_attention_varlen forward and backward on a BERT-large-shaped
    packed batch: [total, 16, 64] bf16, bench.py's 16 sequence lengths
    concatenated and padded to whole rows of 512, kernels vs plain."""
    lens = bert_lengths(16)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      device="cuda")
    total = -(-int(lens.sum()) // 512) * 512
    qkv = torch.randn(total, 3, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    dout = torch.randn(total, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16)

    def run():
        q, k, v = (t.detach().requires_grad_() for t in qkv.unbind(1))
        o = att.flash_attention_varlen(q, k, v, cu)
        return (o, *torch.autograd.grad(o, (q, k, v), dout))

    got = run()
    with plain_kernels()[0]:
        ref = run()
    torch.cuda.synchronize()
    for n, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
        check(f"flash_attention_varlen [{total},16,64] bf16 {n}", g, r)


def live_counts(seg_q, seg_k, per_row) -> tuple:
    """(visible pairs, live query rows, live key rows) of non-causal
    attention with these ids ([rows, s] each), every count times
    ``per_row`` (the heads a row of ids serves): what this run's data
    needs.  A live query sees some key; a live key is seen by some
    query."""
    pairs = seg_q[:, :, None] == seg_k[:, None, :]  # [rows, sq, sk]
    return (per_row * int(pairs.sum()), per_row * int(pairs.any(2).sum()),
            per_row * int(pairs.any(1).sum()))


def attention_bound(dtype, d, q_rows, k_rows, fwd, live_q, live_k, visible,
                    extra_bytes=0) -> tuple:
    """(bound ms, what bounds it) of one flash forward (``fwd``: K1, K3)
    or backward (K2, K4) over ``q_rows`` query and ``k_rows`` key rows of
    head dim ``d`` (counts over all batch*heads).  Bytes: the rows of q
    (and for the backward o, do and lse) that see some key, and the rows
    of k and v that some query sees, read once (``live_q``, ``live_k``; a
    hidden key is never read); o and lse (backward: dq, dk and dv)
    written once in full; ``extra_bytes`` (a mask, the ids) read once.
    Operations: 4 d (forward) or 10 d (backward) flops per ``visible``
    pair."""
    item = torch.tensor([], dtype=dtype).element_size()
    if fwd:
        nbytes = (live_q + 2 * live_k + q_rows) * d * item + q_rows * 4
        flops = 4 * d * visible
    else:
        nbytes = ((3 * live_q + 2 * live_k + q_rows + 2 * k_rows) * d * item
                  + live_q * 4)
        flops = 10 * d * visible
    return bound(nbytes + extra_bytes, flops, dtype)


def time_generic(enc, dec, gen) -> dict:
    """K1 and K2 at the main path's encoder shape (segments) and K1's
    mask, dropout and K2 at the decoder's (pad + causal mask): kernel,
    plain, SDPA with the same float mask (forward; backward through
    autograd) and the bound.  At the encoder shape K1's and K2's scalar
    bf16 instances are also timed cold, and each against its tensor-core
    kernel in turns (a, b, b, a) in this one call
    (``timing.timed_pair``)."""
    out = {}
    for name, ops in (("encoder", enc), ("decoder", dec)):
        q, k, v, do, o, lse, args = ops
        mask, seg_q, seg_k, scale = args[:4]
        B, H, sq, d = q.shape
        sk = k.shape[2]
        if seg_q is not None:   # key padding: -inf at padded keys
            fmask = torch.where(seg_k.bool(), 0.0, float("-inf"))[
                :, None, None, :].to(q.dtype)
            visible, live_q, live_k = live_counts(seg_q, seg_k,
                                                  B * H // seg_q.shape[0])
        else:
            fmask = mask.to(q.dtype)
            visible, live_q, live_k = B * H * sq * sk, B * H * sq, B * H * sk
        new_fwd = lambda: att._flash_fwd_cuda(q, k, v, *args)  # noqa: E731
        fwd_ms = cold_ms(new_fwd, 20)
        drop_ms = cold_ms(lambda: att._flash_fwd_cuda(
            q, k, v, *args[:5], MHA["dropout"], RATE_SEED), 20)
        fwd_plain = cold_ms(lambda: att._flash_fwd_plain(q, k, v, *args), 5, 1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        fwd_lib = cold_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=fmask), 20)
        new_bwd = lambda: att._flash_bwd_cuda(  # noqa: E731
            q, k, v, o, lse, do, *args)
        bwd_ms = cold_ms(new_bwd, 20)
        bwd_plain = cold_ms(lambda: att._flash_bwd_plain(
            q, k, v, o, lse, do, *args), 5, 1)
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=fmask)
        bwd_lib = cold_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), 20)
        m = 0 if mask is None else mask.untyped_storage().nbytes()
        fb, fby = attention_bound(q.dtype, d, B * H * sq, B * H * sk, True,
                                  live_q, live_k, visible, m)
        bb, bby = attention_bound(q.dtype, d, B * H * sq, B * H * sk, False,
                                  live_q, live_k, visible, m)
        log(f"  generic attention timing, {name} [{B},{H},{sq}x{sk},{d}] "
            f"{q.dtype} ({'segments' if seg_q is not None else 'mask'}): "
            f"fwd kernel (tensor cores) {fwd_ms:.4f} ms (dropout "
            f"{MHA['dropout']}: "
            f"{drop_ms:.4f}), plain {fwd_plain:.4f}, sdpa {fwd_lib:.4f}, "
            f"bound {fb:.4f} ({fby}); bwd kernel (tensor cores) "
            f"{bwd_ms:.4f} ms, plain {bwd_plain:.4f}, sdpa backward "
            f"{bwd_lib:.4f}, bound {bb:.4f} ({bby})")
        out[name] = dict(fwd=dict(ms=fwd_ms, ms_dropout=drop_ms,
                                  plain_ms=fwd_plain, library_ms=fwd_lib,
                                  bound_ms=fb, bound_by=fby,
                                  flops=4 * d * visible),
                         bwd=dict(ms=bwd_ms, plain_ms=bwd_plain,
                                  library_ms=bwd_lib, bound_ms=bb,
                                  bound_by=bby, flops=10 * d * visible))
        if name == "encoder":
            old_fwd = scalar_fwd(new_fwd)
            old_fwd_ms = cold_ms(old_fwd, 10)
            pair_fwd = timing.timed_pair(old_fwd, new_fwd, (), ())
            log(f"  K1 at the encoder shape, scalar bf16 instance (flash_fwd"
                f".cu) {old_fwd_ms:.4f} ms cold ({old_fwd_ms / fwd_ms:.2f}x "
                f"the tensor-core kernel's); in turns (timed_pair, warm): "
                f"scalar {pair_fwd[0]:.4f} ms vs tensor-core "
                f"{pair_fwd[1]:.4f} ms ({pair_fwd[0] / pair_fwd[1]:.2f}x)")
            out["scalar_fwd"] = {
                **{k: v for k, v in out[name]["fwd"].items()
                   if k != "ms_dropout"},
                "ms": old_fwd_ms, "warm_pair_ms": pair_fwd[0]}
            out[name]["fwd"]["warm_pair_ms"] = pair_fwd[1]

            def old_bwd():  # the scalar K2's bf16 instance (flash_bwd.cu)
                with mock.patch.object(att, "_bwd_on_tensor_cores",
                                       lambda t: False):
                    return att._flash_bwd_cuda(q, k, v, o, lse, do, *args)
            old_ms = cold_ms(old_bwd, 5, 1)
            pair = timing.timed_pair(old_bwd, new_bwd, (), ())
            log(f"  K2 at the encoder shape, scalar bf16 instance (flash_bwd"
                f".cu) {old_ms:.4f} ms cold ({old_ms / bwd_ms:.2f}x the "
                f"tensor-core kernel's); in turns (timed_pair, warm): scalar "
                f"{pair[0]:.4f} ms vs tensor-core {pair[1]:.4f} ms "
                f"({pair[0] / pair[1]:.2f}x)")
            out["scalar_bwd"] = {**out[name]["bwd"], "ms": old_ms,
                                 "warm_pair_ms": pair[0]}
            out[name]["bwd"]["warm_pair_ms"] = pair[1]
        del ql, kl, vl, ol
    return {"flash_fwd_sm90_mha": out["encoder"]["fwd"],
            "flash_fwd_mha": out["scalar_fwd"],
            "flash_fwd_sm90_mha_mask": out["decoder"]["fwd"],
            "flash_bwd_sm90": out["encoder"]["bwd"],
            "flash_bwd_sm90_mask": out["decoder"]["bwd"],
            "flash_bwd": out["scalar_bwd"]}


# -- phase 3, slice 4: K8, Adam over the GPT-1.3B superblock ---------------

FLAT_LR = 1.5e-4     # pretrain_gpt's default, the main path's
FLAT_STEPS = 3
FLAT_GRAD_SCALE = 3e-5   # x randn: a global norm near 1 over 1.3e9 elements
FLAT_VARIANTS = (("AdamW, decay 0.01", dict(weight_decay=0.01)),
                 ("L2, decay 0.05", dict(weight_decay=0.05,
                                         adam_w_mode=False)),
                 ("decay 0", dict(weight_decay=0.0)),
                 ("bias correction off", dict(weight_decay=0.01,
                                              bias_correction=False)))


def plain_flat_adam():
    """K8 swapped for its plain version, on the card."""
    return mock.patch.object(flat_opt, "_flat_adam_cuda",
                             flat_opt._flat_adam_plain)


def gpt_superblock():
    """The GPT-1.3B main path's superblock (its seeded init weights, the
    model's unique parameters by name) and its schema."""
    _, model, _ = pretrain_gpt.setup(FULL_TRAIN, "cuda")
    with torch.no_grad():
        return flatten(dict(model.named_parameters()), dtype=torch.float32,
                       total_multiple_of=1024)


def flat_grad(gen, n):
    return torch.randn(n, generator=gen, device="cuda").mul_(FLAT_GRAD_SCALE)


def flat_adam_walk(opt, p0, seed, plan=None):
    """FLAT_STEPS in-place steps from ``p0`` and fresh moments, gradients
    drawn from ``seed``; returns (p, state)."""
    p = p0.clone()
    state = opt.init(p)
    run = opt.jit_step(plan=plan)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(FLAT_STEPS):
        _, state = run(flat_grad(gen, p.numel()), state, p)
    return p, state


def pmv(p, state):
    return p, state.exp_avg, state.exp_avg_sq


def flat_padding_case() -> None:
    """Leaves of ragged sizes, so the superblock has gaps and a tail: after
    three steps in either decay mode every padding element of p, m and v
    is still exactly 0."""
    rng = np.random.RandomState(4)
    shapes = [(1000,), (3, 7), (5,), (64, 65), (4096 + 7,)]

    def tree():
        return {f"w{i}": torch.from_numpy(rng.randn(*s).astype(np.float32)
                                          ).cuda() for i, s in enumerate(shapes)}

    p, schema = flatten(tree(), total_multiple_of=1024)
    pad = schema.segment_ids().cuda() == schema.num_tensors
    for name, kw in FLAT_VARIANTS[:2]:
        opt = FlatFusedAdam(lr=1e-2, **kw)
        q, state = p.clone(), opt.init(p)
        for _ in range(FLAT_STEPS):
            _, state = opt.jit_step()(flatten(tree(), schema)[0], state, q)
        zero = all(bool((t[pad] == 0).all()) for t in pmv(q, state))
        tail = schema.total - schema.offsets[-1] - schema.sizes[-1]
        log(f"  flat_adam {name}: {int(pad.sum())} padding elements of "
            f"{schema.total} (tail {tail}) exactly 0 in p, m, v after "
            f"{FLAT_STEPS} steps: {zero}")
        if not zero:
            raise AssertionError("flat_adam wrote into the padding")


def phase_flat_adam() -> dict:
    """K8 at the GPT-1.3B superblock's length: bitwise against its plain
    version over FLAT_STEPS steps in every decay variant; bucketed walks
    bitwise against the single launch; no host sync in a step; padding
    stays 0; then timed beside its plain version, ``torch._fused_adamw_``
    on the same one-tensor lists, and its bound."""
    p0, schema = gpt_superblock()
    n = p0.numel()
    log(f"  superblock: {schema.num_tensors} leaves, {n} elements")
    timing, err = None, 0.0
    for name, kw in FLAT_VARIANTS:
        opt = FlatFusedAdam(lr=FLAT_LR, **kw)
        got = flat_adam_walk(opt, p0, 21)
        with plain_flat_adam():
            ref = flat_adam_walk(opt, p0, 21)
        check_bitwise(f"flat_adam [{n}] {name}, {FLAT_STEPS} steps: p, m, v "
                      "vs plain", pmv(*got), pmv(*ref))
        err = max([err] + [(a - b).abs().max().item()
                           for a, b in zip(pmv(*got), pmv(*ref))])
        del ref
        if timing is None:   # the main path's variant
            timing = flat_adam_plans(opt, p0, schema, got)
        del got
        torch.cuda.empty_cache()
    del p0
    torch.cuda.empty_cache()
    flat_padding_case()
    timing["max_abs_err"] = err   # over p, m, v in every variant
    return timing


def flat_adam_plans(opt, p0, schema, got) -> dict:
    """Bucketed walks against the single launch ``got``, the sync check,
    and the timings (``got`` is consumed)."""
    n = p0.numel()
    third = n // 3 // 1024 * 1024
    plans = (plan_buckets(schema, 1, span_align=1024),
             BucketPlan(spans=((0, third), (third, 2 * third), (2 * third, n)),
                        shard=n, world=1, bucket_bytes=None))
    for plan, what in zip(plans, ("plan_buckets(span_align=1024)",
                                  "hand-built")):
        bucketed = flat_adam_walk(opt, p0, 21, plan)
        check_bitwise(f"flat_adam {what} plan, {plan.num_buckets} spans, vs "
                      "one launch", pmv(*got), pmv(*bucketed))
        del bucketed
    p, state = got
    g = flat_grad(torch.Generator(device="cuda").manual_seed(22), n)
    run = opt.jit_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(g, state, p)
        opt.jit_step(plan=plans[0])(g, state, p)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  flat_adam step, one launch and bucketed, under "
        "set_sync_debug_mode('error'): no host sync")
    ms = cold_ms(lambda: run(g, state, p), 20)
    with plain_flat_adam():
        plain_ms = cold_ms(lambda: run(g, state, p), 5, 1)
    # the library yardstick: PyTorch's fused AdamW on the same one-tensor
    # lists (the same function, its arithmetic in another order); its
    # state_steps hold the step after the increment, as K8's c1, c2 do
    t = (state.step + 1).float()

    def library(p, m, v):
        torch._fused_adamw_([p], [g], [m], [v], [], [t], lr=opt.lr,
                            beta1=opt.beta1, beta2=opt.beta2,
                            weight_decay=opt.weight_decay, eps=opt.eps,
                            amsgrad=False, maximize=False)

    lib_ms = cold_ms(lambda: library(*pmv(p, state)), 20)
    # its gap to K8: one step of each from the same state
    twin = [x.clone() for x in pmv(p, state)]
    run(g, state, p)
    library(*twin)
    lib_diff = (p - twin[0]).abs().max().item()
    del twin
    # p, g, m, v read, p, m, v written; 16 fp32 operations an element
    bound_ms, bound_by = bound(28 * n, 16 * n, torch.float32)
    log(f"  flat_adam timing [{n}] fp32 AdamW: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch._fused_adamw_ {lib_ms:.4f} ms (max |p - "
        f"p_lib| after one step from the same state {lib_diff:.3e}), bound "
        f"{bound_ms:.4f} ms ({bound_by}); {28 * n / ms / 1e9:.3f} TB/s")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_max_abs_diff=lib_diff)


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    err_fwd, fwd_ops = flash_fwd_case(gen, "bf16 one segment C=700 + pad",
                                      bf16, [700])
    flash_fwd_case(gen, "bf16 three segments", bf16, [300, 400, 200])
    err_fwd32 = flash_fwd_case(gen, "fp32 one segment C=700 + pad", fp32,
                               [700])[0]
    fwd, sfwd = time_flash_fwd(bf16, *fwd_ops)
    fwd["max_abs_err"] = err_fwd
    sfwd["max_abs_err"] = err_fwd32   # the scalar K1's route: fp32, d = 8
    del fwd_ops
    out = {"flash_fwd_sm90": fwd, "flash_fwd": sfwd,
           **phase_decode_kernels(gen),
           **phase_training_kernels(),
           **phase_bert_kernels(),
           **phase_generic_kernels()}
    torch.cuda.empty_cache()
    out["flat_adam"] = phase_flat_adam()
    torch.cuda.empty_cache()
    return out


# -- phase 4: toy width, cuda vs cpu ---------------------------------------


def toy_modes_prompts(vocab):
    """Phase 4's modes trace: a 16-token (two-page) shared prompt ahead of
    four prompts, all past the 16-token chunk; one short prompt under it;
    and a repeat of the 24-token prompt, whose hit (capped at 23 tokens)
    ends mid-page and forces a copy-on-write."""
    rng = np.random.RandomState(13)
    system = [int(t) for t in rng.randint(0, vocab, 16)]
    prompts = [system + [int(t) for t in rng.randint(0, vocab, n)]
               for n in (3, 8, 20, 30)]
    prompts.append([int(t) for t in rng.randint(0, vocab, 6)])
    prompts.append(list(prompts[1]))
    return prompts


def phase_toy() -> dict:
    cfg = ServingModelConfig(vocab_size=64, hidden_size=32, num_heads=4,
                             num_layers=2, max_position=96)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = [[int(x) for x in np.random.RandomState(100 + i).randint(
        0, cfg.vocab_size, 5 + 3 * i)] for i in range(4)]

    def streams(device, modes=False):
        eng = ServingEngine(
            cfg, params, num_pages=64, page_size=8, max_batch=4,
            prefill_budget=cfg.max_position, clock=SimClock(),
            spec=SpecConfig(k=4, chunk_size=16) if modes else None,
            prefix_sharing=modes, device=device)
        if not modes:
            reqs = [eng.submit(p, 12) for p in prompts]
            eng.run()
            return [list(r.generated) for r in reqs]
        eng.warmup()
        reqs = []
        for p in toy_modes_prompts(cfg.vocab_size):
            reqs.append(eng.submit(p, 12))
            eng.step()           # staggered: earlier prefixes registered
        eng.run()
        eng.prefix_index.clear()
        if eng.cache.pages_used:
            raise AssertionError("toy modes engine: the pool did not drain")
        seen = dict(verify_steps=eng.verify_steps,
                    chunk_steps=eng.chunk_steps, prefills=eng.prefills,
                    accepted=eng.spec_accepted, prefix_hits=eng.prefix_hits,
                    cows=eng.cows)
        if not all(seen.values()):
            raise AssertionError(f"toy modes engine: a mode did not run "
                                 f"({seen})")
        return [list(r.generated) for r in reqs], seen

    kernels.reset_launch_counts()
    on_card = streams("cuda")
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    on_cpu = streams("cpu")
    log(f"  toy fp32 launches {launches}")
    if not (launches.get("flash_fwd") and "flash_fwd_sm90" not in launches):
        raise AssertionError("toy engine: fp32 attention did not take the "
                             "scalar K1 (the fp32 route)")
    log(f"  toy fp32 streams, cuda (kernels): {on_card}")
    log(f"  toy fp32 streams, cpu (plain):    {on_cpu}")
    if on_card != on_cpu:
        raise AssertionError("toy engine: cuda and cpu streams differ")

    # the modes (spec k=4, chunks of 16, prefix sharing) on both devices,
    # against the plain engine's streams of the same prompts
    kernels.reset_launch_counts()
    modes_card, seen = streams("cuda", modes=True)
    modes_launches = {k.symbol: k.launches for k in kernels.KERNELS
                      if k.launches}
    modes_cpu, seen_cpu = streams("cpu", modes=True)
    plain = ServingEngine(cfg, params, num_pages=64, page_size=8,
                          max_batch=4, prefill_budget=cfg.max_position,
                          clock=SimClock(), device="cuda")
    reqs = [plain.submit(p, 12) for p in toy_modes_prompts(cfg.vocab_size)]
    plain.run()
    plain_streams = [list(r.generated) for r in reqs]
    log(f"  toy fp32 modes (spec k=4, chunk 16, prefix sharing): {seen}, "
        f"launches {modes_launches}")
    log(f"  toy fp32 modes streams, cuda (kernels): {modes_card}")
    log(f"  toy fp32 modes streams, cpu (plain):    {modes_cpu}")
    log(f"  toy fp32 plain engine's streams, cuda:  {plain_streams}")
    if set(modes_launches) != {"flash_fwd", "flash_decode"}:
        raise AssertionError("toy modes engine: fp32 attention did not take "
                             "the scalar K1 and K5 alone")
    if not (modes_card == modes_cpu == plain_streams and seen == seen_cpu):
        raise AssertionError("toy modes engine: the card's, the CPU's and "
                             "the plain engine's streams differ")
    return {"launches": launches, "modes": dict(seen,
                                                launches=modes_launches)}


# -- phase 5: the full-width engine ----------------------------------------


def full_engine(params, cfg, max_batch=BATCH, kv_quant=None) -> ServingEngine:
    return ServingEngine(cfg, params, num_pages=NUM_PAGES, page_size=PAGE,
                         max_batch=max_batch,
                         max_pages_per_request=PAGES_PER_REQ,
                         prefill_budget=cfg.max_position, kv_quant=kv_quant,
                         device="cuda")


def trace(seed, n):
    # bench.py's serving trace shape at max_position 1024
    return poisson_trace(seed, n, rate=8.0, prompt_len=(64, 256),
                         max_new=(16, 64), vocab_size=FULL["vocab_size"])


def plain_attention():
    """The decoder with its two kernels swapped for their plain versions
    (the reference the kernel path's logits are held against)."""
    def fa(q, k, v, *, causal, segment_ids):
        b, h, s, d = q.shape
        o, _ = att._blockwise_fwd(q.reshape(b * h, s, d),
                                  k.reshape(b * h, s, d),
                                  v.reshape(b * h, s, d), 1 / math.sqrt(d),
                                  causal, None, segment_ids, segment_ids)
        return o.view(b, h, s, d)

    def fd(q, k_pages, v_pages, page_table, kv_len, k_scale=None,
           v_scale=None):
        return decode_plain(q, k_pages, v_pages, page_table, kv_len,
                            k_scale, v_scale)

    return mock.patch.multiple(model_mod, flash_attention=fa,
                               flash_decode=fd)


def logits_close(what, got, ref, shape, vs="kernels vs plain") -> float:
    """Kernel-path logits against the plain path's (or two other ways of
    computing the same logits, named by ``vs``).  bf16 rounds at every
    layer, so the bar is a few bf16 ulps of the logit scale (8 x 2^-8 x
    max|ref|), not one."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()) or tuple(got.shape) != shape:
        raise AssertionError(f"{what} logits: shape {tuple(got.shape)} or "
                             "non-finite values")
    err = (got - ref).abs().max().item()
    tol = 8 * 2.0 ** -8 * ref.abs().max().item()
    log(f"  {what} logits, {vs}: max_abs_diff {err:.3e}  tol "
        f"{tol:.3e}  (logit scale {ref.abs().max().item():.3f}, argmax "
        f"{got.argmax(-1).flatten().tolist()} vs "
        f"{ref.argmax(-1).flatten().tolist()})")
    if not err <= tol:
        raise AssertionError(f"{what} logits: kernel path disagrees")
    return err


@torch.no_grad()
def logits_check(eng: ServingEngine, prompt) -> float:
    """Last-position prefill logits of ``prompt``, kernel path vs plain
    path, same weights."""
    S, C = eng.prefill_budget, len(prompt)
    host = np.zeros((3, S), np.int32)
    host[0, :C], host[1, :C], host[2, :C] = prompt, 1, np.arange(C)
    dev = torch.from_numpy(host).cuda()
    got, _, _ = eng.decoder.prefill(eng.params, dev[0:1], dev[1:2],
                                    dev[2:3], C - 1)
    with plain_attention():
        ref, _, _ = eng.decoder.prefill(eng.params, dev[0:1], dev[1:2],
                                        dev[2:3], C - 1)
    return logits_close("full-width prefill", got, ref,
                        (1, 1, FULL["vocab_size"]))


def full_batch_operands(eng: ServingEngine) -> torch.Tensor:
    """The engine's decode operand row for a full batch: every row at
    kv_len 256 on its own 5 pages (the pool is drained, so the appends
    land in free pages)."""
    b, p_max = eng.max_batch, eng.cache.max_pages_per_request
    host = np.zeros(3 * b + b * p_max, np.int32)
    host[b:2 * b], host[2 * b:3 * b] = 255, 256      # positions, kv_len
    host[3 * b:] = 1 + np.arange(b * p_max)         # distinct pages
    return torch.from_numpy(host).cuda()


@torch.no_grad()
def decode_logits_check(eng: ServingEngine) -> float:
    """A full-batch decode step's logits through K5 against the same step
    through its plain version, on the same pool (each run appends its own
    token's K/V before reading)."""
    dev = full_batch_operands(eng)
    got = eng._decode(dev)
    with plain_attention():
        ref = eng._decode(dev)
    return logits_close(f"full-batch decode ({eng.kv_quant or 'bf16'} "
                        "pool)", got, ref, (BATCH, FULL["vocab_size"]))


@torch.no_grad()
def decode_step_split(eng: ServingEngine, steps: int = 20) -> dict:
    """A full-batch decode step timed two ways: until the host has
    enqueued it, and until the device has finished it.  When the two are
    close the host, not the device, sets the step time.  Medians over
    ``steps`` steps."""
    dev = full_batch_operands(eng)
    eng._decode(dev)
    torch.cuda.synchronize()
    enqueue, done = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng._decode(dev)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    split = {"decode_enqueue_ms_p50": statistics.median(enqueue),
             "decode_done_ms_p50": statistics.median(done)}
    log(f"  full-batch decode step: host enqueue "
        f"{split['decode_enqueue_ms_p50']:.3f} ms, device done "
        f"{split['decode_done_ms_p50']:.3f} ms (medians of {steps})")
    return split


# kernel-name fragments of a decode step -> its parts (step_profile)
DECODE_KINDS = (("decode_split", "K5 flash_decode_sm90"),
                ("decode_merge", "K5 flash_decode_sm90 (split merge)"),
                ("gemm", "GEMMs (cuBLAS)"), ("gemv", "GEMMs (cuBLAS)"),
                ("xmma", "GEMMs (cuBLAS)"), ("nvjet", "GEMMs (cuBLAS)"),
                ("cutlass", "GEMMs (cuBLAS)"))


@torch.no_grad()
def decode_step_profile(eng: ServingEngine) -> dict:
    """One full-batch decode step's device time by part under
    ``torch.profiler``: K5, the GEMMs, the elementwise rest (also by the
    ATen op that launched each kernel), and busy against wall (the wall
    holds the host's enqueue)."""
    dev = full_batch_operands(eng)
    eng._decode(dev)
    prof = step_profile(lambda: eng._decode(dev), DECODE_KINDS)
    k5 = sum(t for k, t in prof["by_kind_ms"].items() if k.startswith("K5"))
    log(f"  full-batch decode step under torch.profiler "
        f"({eng.kv_quant or 'bf16'} pool): busy "
        f"{prof['device_busy_ms']:.3f} of a {prof['wall_ms']:.3f} ms wall "
        f"(idle {prof['idle_share']:.1%}); K5 {k5:.3f} ms, "
        f"{k5 / prof['device_busy_ms']:.1%} of busy; by kind "
        + ", ".join(f"{k} {t:.3f}" for k, t in prof["by_kind_ms"].items()))
    log_other_ops(prof)
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                 "by_kind_ms", "top_other_ops")}


def streams_of(eng: ServingEngine, reqs, one_at_a_time=False):
    """``reqs``' prompts and budgets submitted to ``eng`` at once (or each
    run to its end before the next arrives) and run; their streams."""
    handles = []
    for r in reqs:
        handles.append(eng.submit(r.prompt, r.max_new_tokens))
        if one_at_a_time:
            eng.run()
    eng.run()
    return [h.generated for h in handles]


def stream_sets(params, cfg, kv_quant) -> dict:
    """Three requests of a seeded trace served together, again, one at a
    time at the same ``max_batch``, and (recorded only) at ``max_batch``
    1, where every GEMM has another shape."""
    def run(max_batch=BATCH, one_at_a_time=False):
        return streams_of(full_engine(params, cfg, max_batch, kv_quant),
                          trace(1, 3), one_at_a_time)

    return {"together": run(), "again": run(),
            "one_at_a_time": run(one_at_a_time=True),
            "max_batch_1": run(max_batch=1)}


def serve_measured(eng: ServingEngine, reqs, what: str):
    """``warmup()``, then ``serve()`` of ``reqs`` on the engine's clock:
    every request must finish with its whole budget and the pool drain
    (once a prefix index is cleared).  Returns the finished requests, the
    launch counts of the serve (warm-up included) and its metrics: TTFT
    and TPOT p50, tokens/s, the pool's peak occupancy and peak memory."""
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    warm_s = eng.warmup()
    peak, step = [0], eng.step

    def stepped():
        out = step()
        peak[0] = max(peak[0], eng.cache.pages_used)
        return out

    eng.step = stepped
    t0 = time.perf_counter()
    finished = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    if len(finished) != len(reqs) or any(
            r.finish_reason != "length" or len(r.generated) != r.max_new_tokens
            for r in finished):
        raise AssertionError(f"{what} serve: not every request finished")
    if eng.prefix_index is not None:
        eng.prefix_index.clear()
    if eng.cache.pages_used != 0:
        raise AssertionError(f"{what} serve: the pool did not drain "
                             f"({eng.cache.pages_used} pages used)")
    tokens = sum(len(r.generated) for r in finished)
    ttft = [(r.first_token_t - r.arrival_t) * 1e3 for r in finished]
    tpot = [(r.finish_t - r.first_token_t) / (len(r.generated) - 1) * 1e3
            for r in finished if len(r.generated) > 1]
    return finished, launches, {
        "requests": len(finished), "tokens": tokens, "wall_s": wall,
        "tok_per_s": tokens / wall, "ttft_p50_ms": statistics.median(ttft),
        "tpot_p50_ms": statistics.median(tpot), "warmup_s": warm_s,
        "preemptions": sum(r.preemptions for r in finished),
        "pool_peak": peak[0] / (eng.cache.num_pages - 1),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def serve_full(params, cfg, pool, kv_quant, decode_kernel, smi) -> dict:
    """``warmup()`` and ``serve()`` of the seeded trace on one pool, with
    exact launch counts (the tensor-core K1 and the pool's K5 entry
    point, nothing else), the kernel path's decode logits against the
    plain path's, the decode step's host/device split and device profile,
    and batched == sequential == a re-run, bitwise."""
    torch.cuda.empty_cache()
    eng = full_engine(params, cfg, kv_quant=kv_quant)
    reqs = trace(0, 16)
    finished, launches, served = serve_measured(eng, reqs, pool)
    prefills = sum(1 + r.preemptions for r in finished)
    want = {"flash_fwd_sm90": cfg.num_layers * (prefills + 1),
            decode_kernel: cfg.num_layers * (eng.decode_steps + 1)}
    log(f"  {pool} pool: launches {launches}, expected {want} ({prefills} "
        f"prefills + warmup, {eng.decode_steps} decode steps + warmup)")
    if launches != want:
        raise AssertionError("launch counts do not match the main path")
    metrics = {"pool": pool, **served, "decode_steps": eng.decode_steps,
               "prefills": prefills, "card": smi}
    log("  serve " + json.dumps(metrics))
    if kv_quant is None:
        logits_check(eng, reqs[0].prompt)
    metrics["decode_logits_err"] = decode_logits_check(eng)
    metrics.update(decode_step_split(eng))
    metrics["decode_step_profile"] = decode_step_profile(eng)
    del eng
    torch.cuda.empty_cache()

    s = stream_sets(params, cfg, kv_quant)
    same = s["together"] == s["one_at_a_time"]
    rerun = s["together"] == s["again"]
    same_b1 = s["together"] == s["max_batch_1"]
    log(f"  {pool} pool: batched == sequential at max_batch {BATCH}: "
        f"{same}; a re-run equal to itself: {rerun}; max_batch {BATCH} == "
        f"max_batch 1: {same_b1} (recorded, not required)")
    if not (same and rerun):
        raise AssertionError(f"{pool} pool: batched, sequential and re-run "
                             "streams differ")
    metrics.update(launches=launches, batched_eq_sequential=same,
                   rerun_eq=rerun, batch8_eq_batch1=same_b1)
    return metrics


def phase_full(smi: str) -> dict:
    """The full-width engine on each pool (:data:`DECODE_POOLS`); the
    quantized streams are not held equal to the bf16 ones."""
    cfg = ServingModelConfig(**FULL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    return {pool: serve_full(params, cfg, pool, quant, name, smi)
            for pool, quant, name in DECODE_POOLS}


# -- phase 15: the serving modes at full width -------------------------------


def modes_engine(params, cfg, proposer=None, spec=True, share=True,
                 k=SPEC_K, chunk=CHUNK, prefill_budget=None) -> ServingEngine:
    """Phase 15's engine: FULL's model on bench.py's modes pool, with
    ``SpecConfig(k, proposer, chunk_size=chunk)`` and prefix sharing
    (``spec=False``: the plain engine on the same pool)."""
    return ServingEngine(
        cfg, params, num_pages=MODES_NUM_PAGES, page_size=PAGE,
        max_batch=BATCH, max_pages_per_request=MODES_PAGES_PER_REQ,
        prefill_budget=prefill_budget or cfg.max_position,
        spec=(SpecConfig(k=k, proposer=proposer or (NgramProposer() if k
                                                    else None),
                         chunk_size=chunk) if spec else None),
        prefix_sharing=spec and share, device="cuda")


def rows40_engine(params, cfg, prefill_budget=None) -> ServingEngine:
    """The plain engine that decodes at the modes engine's 40 rows: a
    speculative engine whose proposer never drafts and that has no chunks
    prefills whole rows on K1 and runs every token through the decode
    step at ``decode_rows = BATCH * (SPEC_K + 1)``."""
    return modes_engine(params, cfg, proposer=ReplayProposer({}, none=True),
                        share=False, chunk=None,
                        prefill_budget=prefill_budget)


def modes_trace():
    """bench.py's shared-prompt trace: its 128-token system prompt ahead of
    every prompt of ``trace(0, 16)``; then a 256-token prompt (the longest
    prompt's head) and, a quarter second later, its exact repeat, whose hit
    (capped at 255 tokens) ends mid-page and forces a copy-on-write."""
    reqs = trace(0, 16)
    for r in reqs:
        r.prompt = SYSTEM_PROMPT + r.prompt
    head = max(reqs, key=lambda r: len(r.prompt)).prompt[:4 * PAGE]
    last = max(r.arrival_t for r in reqs)
    for i in range(2):
        reqs.append(type(reqs[0])(rid=len(reqs), prompt=list(head),
                                  max_new_tokens=32,
                                  arrival_t=last + 0.25 * (i + 1)))
    return reqs


class ReplayProposer:
    """Drafts each request's continuation in ``streams`` (prompt + tokens,
    by rid) while its history follows it: drafts the verify step accepts
    where it agrees with the run that made the streams.  With ``wrong``
    every draft token is shifted by one id: drafts it rejects.  With
    ``none`` it never drafts (every step is the decode step)."""

    def __init__(self, streams, wrong=False, none=False):
        self.streams, self.wrong, self.none = streams, wrong, none
        self.drafted = self.accepted = 0

    def propose(self, rid, context, k):
        if self.none:
            return []
        full = self.streams[rid]
        n = len(context)
        if full[:n] != list(context):
            return []
        d = full[n:n + k]
        return [(t + 1) % FULL["vocab_size"] for t in d] if self.wrong else d

    def observe(self, drafted, accepted):
        self.drafted += drafted
        self.accepted += accepted

    def release(self, rid):
        pass


def serve_modes(eng, reqs) -> dict:
    """:func:`serve_measured` of ``reqs`` on a modes engine, whose kernels
    must have run exactly the main path's launches (K1 once a layer for
    each whole-row prefill and the warm-up, K5's bf16 entry point once a
    layer for each decode, verify and chunk step and the warm-up's three,
    nothing else).  Returns the metrics and the streams by rid."""
    L = eng.cfg.num_layers
    finished, launches, served = serve_measured(eng, reqs, "modes")
    # decode_steps counts every decode boundary, decode or verify step
    steps = eng.decode_steps + eng.chunk_steps
    warm = 1 + (eng.spec_k > 0) + (eng.chunk_size is not None)
    want = {"flash_fwd_sm90": L * (eng.prefills + 1),
            "flash_decode_sm90": L * (steps + warm)}
    log(f"  launches {launches}, expected {want} ({eng.prefills} whole-row "
        f"prefills, {eng.decode_steps} decode boundaries of which "
        f"{eng.verify_steps} verify, {eng.chunk_steps} chunk steps, + the "
        f"warm-up's)")
    if launches != want:
        raise AssertionError("modes serve: launch counts do not match the "
                             "main path")
    admissions = sum(1 + r.preemptions for r in finished)
    metrics = {
        **served, "prefills": eng.prefills, "decode_steps": eng.decode_steps,
        "verify_steps": eng.verify_steps, "chunk_steps": eng.chunk_steps,
        "drafted": eng.spec_drafted, "accepted": eng.spec_accepted,
        "committed": eng.spec_committed,
        "acceptance_rate": (eng.spec_accepted / eng.spec_drafted
                            if eng.spec_drafted else 0.0),
        "committed_per_verify": (eng.spec_committed / eng.verify_steps
                                 if eng.verify_steps else 0.0),
        "prefix_hits": eng.prefix_hits, "admissions": admissions,
        "prefix_hit_rate": eng.prefix_hits / admissions, "cows": eng.cows,
        "launches": launches}
    return metrics, {r.rid: list(r.generated) for r in finished}


def verify_host(eng, seed=15) -> np.ndarray:
    """A full-batch verify step's operand row: every row's last token at
    position S - 1 and a 4-token draft, kv_len S + 4 = 4 pages (256), each
    row on its own pages of the drained pool."""
    b, qw, P = eng.max_batch, eng.spec_k + 1, eng.cache.max_pages_per_request
    S = 4 * PAGE - SPEC_K
    rng = np.random.RandomState(seed)
    host, (tok, pos, wp, wo, kvl, table) = eng._extend_host(b, qw)
    for i in range(b):
        pages = 1 + i * P + np.arange(P)
        at = np.arange(S - 1, S + qw - 1)
        tok[i], pos[i] = rng.randint(0, FULL["vocab_size"], qw), at
        wp[i], wo[i] = pages[at // PAGE], at % PAGE
        kvl[i], table[i] = S + qw - 1, pages
    return host


def chunk_host(eng, seed=16) -> np.ndarray:
    """A chunk step's operand row: the second chunk of one request,
    context positions [CHUNK, 2 CHUNK) on pages 1.., kv_len 2 CHUNK."""
    P, start = eng.cache.max_pages_per_request, CHUNK
    rng = np.random.RandomState(seed)
    host, (tok, pos, wp, wo, kvl, table) = eng._extend_host(1, CHUNK)
    pages = 1 + np.arange(P)
    at = np.arange(start, start + CHUNK)
    tok[0], pos[0] = rng.randint(0, FULL["vocab_size"], CHUNK), at
    wp[0], wo[0] = pages[at // PAGE], at % PAGE
    kvl[0], table[0] = start + CHUNK, pages
    return host


def decode_host(eng, tok, pos, table, kv_len) -> np.ndarray:
    """The engine's decode operand row (``decode_rows`` wide) with the
    given rows first and idle rows after them."""
    rows, p_max = eng.decode_rows, eng.cache.max_pages_per_request
    b = len(tok)
    host = np.zeros(3 * rows + rows * p_max, np.int32)
    host[2 * rows:3 * rows] = 1
    host[:b], host[rows:rows + b], host[2 * rows:2 * rows + b] = (
        tok, pos, kv_len)
    full = np.zeros((rows, p_max), np.int32)
    full[:b] = table
    host[3 * rows:] = full.ravel()
    return host


@torch.no_grad()
def on_pool_copy(eng, fn):
    """``fn()`` with the engine's pool swapped for a copy of it."""
    k, v = eng.cache.k, eng.cache.v
    eng.cache.k, eng.cache.v = k.clone(), v.clone()
    try:
        return fn()
    finally:
        eng.cache.k, eng.cache.v = k, v
        torch.cuda.empty_cache()


@torch.no_grad()
def modes_logits_checks(eng) -> dict:
    """Checks 5-7 on a drained pool: a full-batch verify step's logits and
    a chunk step's last-row logits through K5 against the same step
    through its plain version (each run writes its own K/V before it
    reads), and the verify step's logits against five sequential decode
    steps of the engine (``decode_rows`` wide) over the same tokens on a
    copy of the pool, all under ``logits_close``'s bar.  Then, under the
    same bar, the two gaps that part the modes engine's numbers from the
    plain engine's: a prompt's first-token logits through chunks
    against one whole-row prefill, and the decode step at ``decode_rows``
    rows against ``max_batch`` rows."""
    b, qw, V = eng.max_batch, eng.spec_k + 1, FULL["vocab_size"]
    out = {}
    host = verify_host(eng)
    dev = torch.from_numpy(host).cuda()
    got = eng._extend(dev, b, qw)
    with plain_attention():
        ref = eng._extend(dev, b, qw)
    out["verify_vs_plain"] = logits_close(
        f"full-batch verify [{b}, {qw}] at kv_len {4 * PAGE}", got, ref,
        (b, qw, V))
    cdev = torch.from_numpy(chunk_host(eng)).cuda()
    got = eng._extend(cdev, 1, CHUNK, last_only=True)
    with plain_attention():
        ref = eng._extend(cdev, 1, CHUNK, last_only=True)
    out["chunk_vs_plain"] = logits_close(
        f"chunk step [1, {CHUNK}] at kv_len {2 * CHUNK} (last row)", got,
        ref, (1, 1, V))
    # verify against sequential decode: the same tokens one at a time, on
    # a copy of the pool as it stands before the verify step writes
    n = b * qw
    tok, pos = host[:n].reshape(b, qw), host[n:2 * n].reshape(b, qw)
    table = host[4 * n + b:].reshape(b, -1)

    def sequential():
        return torch.stack([eng._decode(torch.from_numpy(decode_host(
            eng, tok[:, r], pos[:, r], table, pos[:, r] + 1)).cuda())[:b]
            for r in range(qw)], 1)

    seq = on_pool_copy(eng, sequential)
    got = eng._extend(dev, b, qw)
    out["verify_vs_decode"] = logits_close(
        "full-batch verify step", got, seq, (b, qw, V),
        vs=f"vs {qw} sequential decode steps, both through the kernels")
    out["verify_vs_decode_bitwise"] = bool(torch.equal(got, seq))
    log(f"  verify vs sequential decode: bitwise equal "
        f"{out['verify_vs_decode_bitwise']}")
    out.update(plain_engine_gaps(eng))
    return out


@torch.no_grad()
def plain_engine_gaps(eng) -> dict:
    """Where the modes engine computes what the plain engine computes
    another way: a prompt's first-token logits through three chunk steps
    (298 tokens at full width) against one whole-row prefill (K5 and
    [1, 128] GEMMs against K1 and [1, 1024]), and a full-batch decode
    step at ``decode_rows`` rows against ``max_batch`` rows (other GEMM
    kernels and reduction layouts)."""
    V, P = FULL["vocab_size"], eng.cache.max_pages_per_request
    C = 2 * CHUNK + CHUNK // 3
    ctx = np.random.RandomState(17).randint(0, V, C)
    S = eng.prefill_budget
    row = np.zeros((3, S), np.int32)
    row[0, :C], row[1, :C], row[2, :C] = ctx, 1, np.arange(C)
    rdev = torch.from_numpy(row).cuda()
    whole, _, _ = eng.decoder.prefill(eng.params, rdev[0:1], rdev[1:2],
                                      rdev[2:3], C - 1)
    pages = 1 + np.arange(P)

    def chunks():
        for start in range(0, C, CHUNK):
            m = min(CHUNK, C - start)
            host, (tk, ps, wp, wo, kvl, table) = eng._extend_host(1, CHUNK)
            at = np.arange(start, start + m)
            tk[0, CHUNK - m:], ps[0, CHUNK - m:] = ctx[at], at
            wp[0, CHUNK - m:], wo[0, CHUNK - m:] = pages[at // PAGE], at % PAGE
            kvl[0], table[0] = start + m, pages
            out = eng._extend(torch.from_numpy(host).cuda(), 1, CHUNK,
                              last_only=True)
        return out

    chunked = on_pool_copy(eng, chunks)
    first = logits_close(f"a {C}-token prompt's first token", chunked, whole,
                         (1, 1, V), vs="chunk steps vs one whole-row prefill")
    # the decode step at max_batch rows (the plain engine's) and at
    # decode_rows (this engine's), the same rows on copies of one pool
    b = eng.max_batch
    host = verify_host(eng)
    n = b * (eng.spec_k + 1)
    tok = host[:n].reshape(b, -1)[:, 0]
    pos = host[n:2 * n].reshape(b, -1)[:, 0]
    table = host[4 * n + b:].reshape(b, -1)
    wide = on_pool_copy(eng, lambda: eng._decode(torch.from_numpy(
        decode_host(eng, tok, pos, table, pos + 1)).cuda())[:b])
    kv_len = torch.from_numpy(pos + 1).cuda()
    narrow = on_pool_copy(eng, lambda: eng.decoder.decode(
        eng.params, eng.cache.k, eng.cache.v, torch.from_numpy(tok).cuda(),
        torch.from_numpy(pos).cuda(), torch.from_numpy(table).cuda(),
        kv_len))
    rows = logits_close("the full-batch decode step", wide, narrow, (b, V),
                        vs=f"at {eng.decode_rows} rows vs {b}")
    return {"chunks_vs_whole_row": first, "decode_rows_vs_max_batch": rows}


@torch.no_grad()
def extend_step_profiles(eng) -> dict:
    """One full-batch verify step and one chunk step under
    ``torch.profiler``: device time by part, busy against wall."""
    b, qw = eng.max_batch, eng.spec_k + 1
    out = {}
    for what, host, rows, q, last in (
            ("verify", verify_host(eng), b, qw, False),
            ("chunk", chunk_host(eng), 1, CHUNK, True)):
        dev = torch.from_numpy(host).cuda()
        eng._extend(dev, rows, q, last)
        prof = step_profile(lambda: eng._extend(dev, rows, q, last),
                            DECODE_KINDS)
        k5 = sum(t for k, t in prof["by_kind_ms"].items()
                 if k.startswith("K5"))
        log(f"  {what} step under torch.profiler: busy "
            f"{prof['device_busy_ms']:.3f} of a {prof['wall_ms']:.3f} ms "
            f"wall (idle {prof['idle_share']:.1%}); K5 {k5:.3f} ms, "
            f"{k5 / prof['device_busy_ms']:.1%} of busy; by kind "
            + ", ".join(f"{k} {t:.3f}" for k, t in
                        prof["by_kind_ms"].items()))
        out[what] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                          "idle_share", "by_kind_ms")}
    return out


def modes_stream_sets(params, cfg) -> dict:
    """Check 8 on six requests of the modes trace (the first four and the
    repeat pair): served together, again, and one at a time (where the
    repeat hits the index and copies a page, which together it cannot)."""
    reqs = modes_trace()
    picked = reqs[:4] + reqs[-2:]

    def run(one_at_a_time=False):
        eng = modes_engine(params, cfg)
        got = streams_of(eng, picked, one_at_a_time)
        return got, (eng.verify_steps, eng.chunk_steps, eng.prefix_hits,
                     eng.cows)

    (together, s1), (again, _), (seq, s2) = run(), run(), run(True)
    log(f"  six requests (verify, chunk steps, hits, COWs): together {s1}, "
        f"one at a time {s2}")
    return {"together": together, "again": again, "one_at_a_time": seq,
            "seen_together": s1, "seen_one_at_a_time": s2}


@torch.no_grad()
def top2_margin(eng, context) -> float:
    """The top-2 logit margin of the plain engine's next token after
    ``context`` (a whole-row prefill through the kernels)."""
    S, C = eng.prefill_budget, len(context)
    host = np.zeros((3, S), np.int32)
    host[0, :C], host[1, :C], host[2, :C] = context, 1, np.arange(C)
    dev = torch.from_numpy(host).cuda()
    logits, _, _ = eng.decoder.prefill(eng.params, dev[0:1], dev[1:2],
                                       dev[2:3], C - 1)
    top = logits[0, 0].float().topk(2).values
    return float(top[0] - top[1])


def divergences(streams, ref, prompts, eng) -> dict:
    """``streams`` against ``ref`` (by rid): the share of requests and
    tokens equal, and for each request that differs its first divergent
    token and the top-2 logit margin ``eng`` (a plain engine) had there
    after ``ref``'s context."""
    diverge = []
    for rid in sorted(streams):
        a, b = streams[rid], ref[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        diverge.append(dict(rid=rid, token=t, got=a[t], ref=b[t],
                            margin=top2_margin(eng, prompts[rid] + b[:t])))
    tok_eq = sum(x == y for rid in streams
                 for x, y in zip(streams[rid], ref[rid]))
    return dict(requests_equal=(len(streams) - len(diverge)) / len(streams),
                tokens_equal=tok_eq / sum(len(v) for v in streams.values()),
                diverged=len(diverge), divergences=diverge)


def spec_vs_plain(params, cfg, streams, reqs, prefill_budget=None) -> dict:
    """Phase 15's streams against the plain engine's (``spec=None``, no
    sharing) on the same requests, run as one batch: the share equal, and
    for each request that differs its first divergent token and the top-2
    logit margin the plain engine had there.  Then the split of queue C's
    C1: a plain engine decoding at the modes engine's 40 rows
    (:func:`rows40_engine`) against both, so what is left against the
    modes engine comes from chunked against whole-row prefill."""
    prompts = {r.rid: r.prompt for r in reqs}
    rids = [r.rid for r in reqs]
    eng = modes_engine(params, cfg, spec=False,
                       prefill_budget=prefill_budget)
    ref = dict(zip(rids, streams_of(eng, reqs)))
    rows40 = dict(zip(rids, streams_of(
        rows40_engine(params, cfg, prefill_budget), reqs)))
    out = divergences(streams, ref, prompts, eng)
    out["rows40_vs_plain"] = divergences(rows40, ref, prompts, eng)
    out["modes_vs_rows40"] = divergences(streams, rows40, prompts, eng)
    what = f"{cfg.dtype}".replace("torch.", "")
    log(f"  modes vs the plain engine ({what}): {len(streams) - out['diverged']}"
        f" of {len(streams)} requests equal, {out['tokens_equal']:.1%} of "
        f"tokens; first divergences {out['divergences']}")
    for key, name in (("rows40_vs_plain", "plain at 40 decode rows vs plain "
                       "at 8"), ("modes_vs_rows40", "modes vs plain at 40 "
                                 "decode rows (chunked vs whole-row prefill)")):
        d = out[key]
        log(f"  C1 split ({what}), {name}: {d['diverged']} of {len(streams)} "
            f"requests diverge, {d['tokens_equal']:.1%} of tokens equal; "
            f"first divergences {d['divergences']}")
    del eng
    torch.cuda.empty_cache()
    return out


# C1's fp32 reading: FULL's vocabulary and context at a width where the
# scalar fp32 routes (flash_fwd.cu, flash_decode.cu) serve the modes trace
# in seconds; a prefill row of 512 holds the trace's longest context
# (128 + 256 + 64)
FP32_MODES = dict(vocab_size=FULL["vocab_size"], hidden_size=512,
                  num_heads=4, num_layers=4,
                  max_position=FULL["max_position"])
FP32_PREFILL = 512


def c1_fp32(smi: str) -> dict:
    """Phase 15's spec-vs-plain comparison (and its 40-row split) in fp32
    at :data:`FP32_MODES`: the JAX package pins the modes' streams equal
    to the plain engine's at fp32, so a divergence here breaks that
    contract (ROADMAP.md queue C, C1)."""
    cfg = ServingModelConfig(**FP32_MODES, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    reqs = modes_trace()
    eng = modes_engine(params, cfg, prefill_budget=FP32_PREFILL)
    kernels.reset_launch_counts()
    streams = dict(zip((r.rid for r in reqs), streams_of(eng, reqs)))
    launches = launch_counts()
    serve_s = time.perf_counter() - t0
    # every context passes the chunk, so K1 may not run at all
    if not (set(launches) <= {"flash_fwd", "flash_decode"}
            and launches.get("flash_decode")):
        raise AssertionError(f"fp32 modes engine: attention did not take the "
                             f"scalar K1 and K5 alone ({launches})")
    seen = dict(verify=eng.verify_steps, chunk=eng.chunk_steps,
                hits=eng.prefix_hits)
    if not all(seen.values()):
        raise AssertionError(f"fp32 modes engine: a mode did not run {seen}")
    out = spec_vs_plain(params, cfg, streams, reqs,
                        prefill_budget=FP32_PREFILL)
    out.update(seen=seen, launches=launches, modes_serve_s=serve_s,
               wall_s=time.perf_counter() - t0, width=FP32_MODES, card=smi)
    if out["diverged"]:
        raise AssertionError("fp32: the modes engine's streams part from the "
                             "plain engine's, the contract the JAX package "
                             f"pins ({out['divergences']})")
    log(f"  C1 fp32 at hidden {FP32_MODES['hidden_size']}, "
        f"{FP32_MODES['num_layers']} layers, {FP32_MODES['num_heads']} heads "
        f"of {cfg.head_dim}, prefill row {FP32_PREFILL}: modes serve {serve_s:.1f} s, "
        f"all three engines {out['wall_s']:.1f} s; {seen}; {smi}")
    return out


def phase_modes(smi: str, serving: dict) -> dict:
    """The serving modes at GPT-1.3B width (:func:`modes_engine`,
    :func:`modes_trace`): checks 1-8 and the readings beside phase 5's
    bf16 numbers."""
    cfg = ServingModelConfig(**FULL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    reqs = modes_trace()
    eng = modes_engine(params, cfg)
    metrics, streams = serve_modes(eng, reqs)
    seen = {k: metrics[k] for k in ("chunk_steps", "prefix_hits", "cows",
                                    "verify_steps", "accepted")}
    log("  modes serve " + json.dumps(
        {k: v for k, v in metrics.items() if k != "launches"}))
    if not all(seen.values()):
        raise AssertionError(f"modes serve: a mode did not run ({seen})")
    metrics.update(modes_logits_checks(eng))
    metrics["step_profiles"] = extend_step_profiles(eng)
    del eng
    torch.cuda.empty_cache()

    # drafts that follow the served streams (accepted), that never do
    # (rejected), and none at all: speculation changes how many tokens a
    # step commits, never which, so the streams stay the served ones
    prompts = {r.rid: r.prompt for r in reqs}
    full_streams = {rid: prompts[rid] + g for rid, g in streams.items()}
    replays = {}
    for what, prop in (("replay", ReplayProposer(full_streams)),
                       ("wrong", ReplayProposer(full_streams, wrong=True)),
                       ("none", ReplayProposer({}, none=True))):
        m, got = serve_modes(modes_engine(params, cfg, proposer=prop),
                             modes_trace())
        replays[what] = dict(
            streams_equal=got == streams, verify_steps=m["verify_steps"],
            decode_steps=m["decode_steps"], drafted=m["drafted"],
            accepted=m["accepted"], committed=m["committed"])
        log(f"  {what} proposer: {replays[what]}")
        torch.cuda.empty_cache()
    if not all(r["streams_equal"] for r in replays.values()):
        raise AssertionError("the streams moved with the proposer")
    if not (replays["replay"]["accepted"] and not replays["wrong"]["accepted"]
            and not replays["none"]["verify_steps"]):
        raise AssertionError("the replaying proposer's drafts were not "
                             "accepted, a wrong draft was, or a step "
                             "without drafts verified")
    metrics["proposers"] = replays

    s = modes_stream_sets(params, cfg)
    same = s["together"] == s["one_at_a_time"]
    rerun = s["together"] == s["again"]
    log(f"  modes: batched == sequential: {same}; a re-run equal to itself: "
        f"{rerun}")
    if not (same and rerun):
        raise AssertionError("modes: batched, sequential and re-run streams "
                             "differ")
    metrics.update(batched_eq_sequential=same, rerun_eq=rerun,
                   sets_seen={k: s[k] for k in ("seen_together",
                                                "seen_one_at_a_time")})
    vs = spec_vs_plain(params, cfg, streams, reqs)
    metrics["vs_plain"] = vs
    metrics["c1_fp32"] = c1_fp32(smi)
    # equal to the plain engine's streams, or every divergence starts
    # where the plain engine's top two logits lay within twice the larger
    # gap between the two engines' ways of computing logits (each of the
    # two logits moves by at most the gap, so a flip needs a margin of at
    # most twice it; ROADMAP.md, queue C)
    gaps = (metrics["chunks_vs_whole_row"],
            metrics["decode_rows_vs_max_batch"])
    bar = 2 * max(gaps)
    wide = [d for d in vs["divergences"] if not d["margin"] <= bar]
    log(f"  modes vs plain: {len(vs['divergences'])} divergent requests, "
        f"margins {[d['margin'] for d in vs['divergences']]} against twice "
        f"the engines' larger gap, {bar:.4f} (chunks vs whole row "
        f"{gaps[0]:.4f}, decode at {BATCH * (SPEC_K + 1)} rows vs {BATCH} "
        f"{gaps[1]:.4f}); checks 5-7: verify "
        f"{metrics['verify_vs_plain']:.4f}, chunk "
        f"{metrics['chunk_vs_plain']:.4f}, verify vs decode "
        f"{metrics['verify_vs_decode']:.4f}")
    if wide:
        raise AssertionError(f"modes vs plain: divergences at margins above "
                             f"twice the engines' gap, {bar:.4f}: {wide}")
    bf16 = serving["bf16"]
    metrics["card"] = smi
    log("  beside phase 5's bf16 serve (same card, same run): " + ", ".join(
        f"{k} {metrics[k]:.4g} vs {bf16[k]:.4g}"
        for k in ("ttft_p50_ms", "tpot_p50_ms", "tok_per_s", "peak_mem_gib",
                  "pool_peak")) + f"; {smi}")
    return metrics


# -- phase 16: serving state, page integrity and telemetry -------------------

TOY_SERVE = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
                 max_position=96)
LOSS_AT = 12       # the decode boundary the full-width device loss hits
SNAP_AT = 10       # steps before the full-width snapshot
CRC_AT = 6         # the decode boundary the corrupted page is found at


def launch_counts() -> dict:
    return {k.symbol: k.launches for k in kernels.KERNELS if k.launches}


def by_rid(reqs) -> dict:
    return {r.rid: list(r.generated) for r in reqs}


def state_engine(params, cfg, **kw) -> ServingEngine:
    """Phase 5's engine on a :class:`SimClock` (a 50 ms tick): admissions
    and decode steps land at the same steps in every run, so two runs'
    launch counts compare exactly."""
    return ServingEngine(cfg, params, num_pages=NUM_PAGES, page_size=PAGE,
                         max_batch=BATCH, max_pages_per_request=PAGES_PER_REQ,
                         prefill_budget=cfg.max_position,
                         clock=SimClock(tick=0.05), device="cuda", **kw)


def want_launches(eng: ServingEngine, decode_kernel="flash_decode_sm90"):
    """The main path's launches of a plain full-width engine, warm-up
    included: K1 once a layer for each whole-row prefill (re-prefills
    too), K5's entry point once a layer for each decode step."""
    L = eng.cfg.num_layers
    return {"flash_fwd_sm90": L * (eng.prefills + 1),
            decode_kernel: L * (eng.decode_steps + 1)}


def held_streams(what, got, ref, prompts, eng, required) -> dict:
    """``got`` against ``ref`` (by rid), bitwise; ``required`` fails the
    run on a difference, otherwise each diverged request is logged with
    its first divergent token and the plain engine's top-2 margin there."""
    d = divergences(got, ref, prompts, eng)
    log(f"  {what}: {len(got) - d['diverged']} of {len(got)} requests "
        f"bitwise equal to the uninterrupted run, {d['tokens_equal']:.1%} of "
        f"tokens{'' if required else ' (recorded, not required)'}; "
        f"divergences {d['divergences']}")
    if required and d["diverged"]:
        raise AssertionError(f"{what}: streams differ from the "
                             "uninterrupted run")
    return d


def toy_state_checks() -> dict:
    """The fp32 toy on the card (the contract the JAX package pins):
    recovery from a device loss and from a CRC-caught corrupt page, and a
    snapshot restored into a fresh engine, each bitwise equal to the
    uninterrupted run; and the watchdog escalating on a wedged decode."""
    cfg = ServingModelConfig(**TOY_SERVE)
    params = init_params(cfg, seed=0, device="cuda")

    def eng_(**kw):
        return ServingEngine(cfg, params, num_pages=64, page_size=8,
                             max_batch=4, prefill_budget=96,
                             clock=SimClock(), device="cuda", **kw)

    def trace_():
        return poisson_trace(3, 6, rate=2.0, prompt_len=(4, 10),
                             max_new=(3, 8), vocab_size=64)

    ref = trace_()
    eng_().serve(ref)
    ref = by_rid(ref)
    out = {}
    tr = trace_()
    with ServingDeviceLoss(at_step=3) as dl:
        eng = eng_()
        eng.serve(tr)
    out["device_loss"] = dict(fired=dl.fired, recoveries=eng.recoveries,
                              equal=by_rid(tr) == ref)
    tr = trace_()
    eng = eng_(validate_pages=True)
    with CorruptLivePage(eng.cache, at_step=2) as cp:
        eng.serve(tr)
    out["corrupt_page"] = dict(page=cp.corrupted_page,
                               recoveries=eng.recoveries,
                               equal=by_rid(tr) == ref)
    src = eng_()
    for r in trace_():
        src.submit_request(r)
    for _ in range(4):
        src.step()
    dst = eng_()
    restored = dst.restore(json.loads(json.dumps(src.snapshot())))
    dst.run()
    out["snapshot_restore"] = dict(
        restored=len(restored),
        equal=all(r.generated == ref[r.rid] for r in restored))
    reports = []
    wd = Watchdog(timeout=1.0, on_hang=reports.append, poll_interval=0.02,
                  devices=[0])
    eng = eng_(watchdog=wd)
    eng.warmup()
    with SlowDecode(at_step=2, delay=2.5), wd:
        reqs = [eng.submit([1, 2, 3], 4), eng.submit([4, 5], 4)]
        eng.run()
    out["watchdog"] = dict(fired=wd.expired, reports=len(reports),
                           finished=all(len(r.generated) == 4 for r in reqs))
    log(f"  fp32 toy on the card: {out}")
    if not (out["device_loss"]["fired"] and out["device_loss"]["equal"]
            and out["device_loss"]["recoveries"] == 1
            and out["corrupt_page"]["page"] is not None
            and out["corrupt_page"]["recoveries"] == 1
            and out["corrupt_page"]["equal"]
            and out["snapshot_restore"]["restored"]
            and out["snapshot_restore"]["equal"]
            and out["watchdog"]["fired"] and out["watchdog"]["reports"]
            and out["watchdog"]["finished"]):
        raise AssertionError("fp32 toy: recovery, restore or the watchdog "
                             "failed its contract")
    return out


def telemetry_inert(params, cfg, smi) -> dict:
    """Phase 5's serve of ``trace(0, 16)`` with a telemetry bus and without:
    the same streams and launch counts; every event valid, one valid trace
    a request whose TTFT decomposition sums to its retire event's TTFT."""
    runs = {}
    for what in ("off", "on"):
        mem = MemorySink()
        bus = TelemetryBus(run_id="phase16", sinks=[mem]) if what == "on" \
            else None
        eng = state_engine(params, cfg, telemetry=bus)
        kernels.reset_launch_counts()
        eng.warmup()
        reqs = trace(0, 16)
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        if launches != want_launches(eng) or len(eng.sched.finished) != 16:
            raise AssertionError(f"telemetry {what}: launches {launches}, "
                                 f"expected {want_launches(eng)}")
        runs[what] = dict(streams=by_rid(reqs), launches=launches,
                          wall_s=wall, events=mem.events,
                          prompts={r.rid: r.prompt for r in reqs})
        del eng
    on, off = runs["on"], runs["off"]
    events = on["events"]
    for e in events:
        validate_event(e)
    traces = build_traces(events)
    retire = {e["rid"]: e for e in events if e["type"] == "request_retire"}
    worst = 0.0
    for rid, tr in traces.items():
        problems = validate_trace(tr)
        dec = ttft_decomposition(tr)
        parts = sum(v for k, v in dec.items()
                    if k.startswith("ttft_") and k != "ttft_ms")
        worst = max(worst, abs(parts - retire[rid]["ttft_ms"]))
        if problems:
            raise AssertionError(f"trace of request {rid}: {problems}")
    summary = summarize_events(events)
    log("  telemetry summary: " + format_summary(summary).replace(
        "\n", "\n  "))
    out = dict(streams_equal=on["streams"] == off["streams"],
               launches_equal=on["launches"] == off["launches"],
               events=len(events), traces=len(traces),
               ttft_sum_worst_ms=worst, wall_on_s=on["wall_s"],
               wall_off_s=off["wall_s"], launches=on["launches"], card=smi)
    log(f"  telemetry inert: {json.dumps(out)}")
    if not (out["streams_equal"] and out["launches_equal"]
            and len(traces) == 16 and worst <= TTFT_SUM_TOLERANCE_MS):
        raise AssertionError("telemetry changed the streams or launches, or "
                             "a trace is short of its request's TTFT")
    return dict(out, reference=off["streams"], prompts=off["prompts"])


class DigestMeter:
    """Times and counts the page digests' read-back (``verify_pages`` and
    ``refresh_page_crcs`` both read through ``_page_digests``)."""

    def __init__(self):
        self.ms, self.pages, self.calls = 0.0, 0, 0
        self.orig = PagedKVCache._page_digests

    def __call__(self, cache, pages):
        t0 = time.perf_counter()
        out = self.orig(cache, pages)
        self.ms += (time.perf_counter() - t0) * 1e3
        self.pages += len(pages)
        self.calls += 1
        return out


def page_bytes(cfg) -> int:
    """One page's K and V bytes across the layers at bf16."""
    return 2 * cfg.num_layers * PAGE * cfg.num_heads * cfg.head_dim * 2


def recovery_full(params, cfg, ref, prompts, smi) -> dict:
    """A device loss at decode boundary ``LOSS_AT`` of the telemetry run's
    serve, recovered; then a corrupted live page caught by the CRCs on a
    short trace.  Launch counts exact; the streams against the
    uninterrupted runs recorded (bf16: a re-prefill computes the tokens'
    K/V through prefill GEMMs at ``prefill_budget`` rows, not decode
    GEMMs at ``max_batch`` rows)."""
    out = {}
    mem = MemorySink()
    eng = state_engine(params, cfg, telemetry=TelemetryBus(sinks=[mem]))
    kernels.reset_launch_counts()
    eng.warmup()
    walls, steps, recover, step = [], [], eng.recover, eng.step

    def timed_recover(cause):
        t0 = time.perf_counter()
        recover(cause)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    def timed_step():
        # the first step after the recovery re-prefills what it restored
        t0 = time.perf_counter()
        out = step()
        if walls and not steps:
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.recover, eng.step = timed_recover, timed_step
    reqs = trace(0, 16)
    with ServingDeviceLoss(at_step=LOSS_AT) as dl:
        eng.serve(reqs)
    rec = [e for e in mem.events if e["type"] == "serving_recovery"]
    restored = rec[0]["running_restored"] if rec else 0
    admissions = sum(1 + r.preemptions for r in reqs)
    launches = launch_counts()
    ok = (dl.fired and eng.recoveries == 1 and launches == want_launches(eng)
          and eng.prefills == admissions + restored)
    out["device_loss"] = dict(
        at_decode_step=LOSS_AT, recoveries=eng.recoveries,
        running_restored=restored, waiting_restored=rec[0][
            "waiting_restored"] if rec else None,
        prefills=eng.prefills, admissions=admissions,
        decode_steps=eng.decode_steps, launches=launches,
        recover_ms=walls[0] if walls else None,
        reprefill_step_ms=steps[0] if steps else None,
        streams=held_streams("device loss at full width (bf16)",
                             by_rid(reqs), ref, prompts,
                             state_engine(params, cfg), required=False))
    log(f"  device loss: {json.dumps({k: v for k, v in out['device_loss'].items() if k != 'streams'})}; {smi}")
    if not ok:
        raise AssertionError("device loss: no recovery, or the launches are "
                             f"not the main path's (want {want_launches(eng)}"
                             f", K1 for {admissions} admissions + {restored} "
                             "re-prefills)")
    del eng
    torch.cuda.empty_cache()

    # CRCs on a short trace: 4 requests of at most 32 tokens
    def short():
        return poisson_trace(2, 4, rate=8.0, prompt_len=(64, 256),
                             max_new=(16, 32), vocab_size=FULL["vocab_size"])

    plain = state_engine(params, cfg)
    plain.warmup()
    ctl = short()
    t0 = time.perf_counter()
    plain.serve(ctl)
    torch.cuda.synchronize()
    plain_s, plain_steps = time.perf_counter() - t0, plain.decode_steps
    del plain
    mem = MemorySink()
    meter = DigestMeter()
    with mock.patch.object(PagedKVCache, "_page_digests",
                           lambda c, pages: meter(c, pages)):
        eng = state_engine(params, cfg, validate_pages=True,
                           telemetry=TelemetryBus(sinks=[mem]))
        kernels.reset_launch_counts()
        eng.warmup()
        reqs = short()
        raised = []
        verify = PagedKVCache.verify_pages

        def seen(cache, lists):
            try:
                verify(cache, lists)
            except PagePoolCorruption as e:
                raised.append(str(e))
                raise

        t0 = time.perf_counter()
        with mock.patch.object(PagedKVCache, "verify_pages", seen), \
                CorruptLivePage(eng.cache, at_step=CRC_AT) as cp:
            eng.serve(reqs)
        torch.cuda.synchronize()
        crc_s = time.perf_counter() - t0
    launches = launch_counts()
    rec = [e for e in mem.events if e["type"] == "serving_recovery"]
    steps = max(1, eng.decode_steps)
    out["corrupt_page"] = dict(
        page=cp.corrupted_page, raised=raised, recoveries=eng.recoveries,
        cause=rec[0]["cause"] if rec else None, launches=launches,
        digest_calls=meter.calls, digest_pages=meter.pages,
        digest_ms=meter.ms, decode_steps=eng.decode_steps,
        validate_ms_per_step=meter.ms / steps,
        validate_bytes_per_step=meter.pages * page_bytes(cfg) / steps,
        serve_s=crc_s, plain_serve_s=plain_s, plain_decode_steps=plain_steps,
        streams=held_streams("corrupt page caught and recovered (bf16)",
                             by_rid(reqs), by_rid(ctl),
                             {r.rid: r.prompt for r in reqs},
                             state_engine(params, cfg), required=False))
    log(f"  corrupt page: {json.dumps({k: v for k, v in out['corrupt_page'].items() if k != 'streams'})}; {smi}")
    if not (cp.corrupted_page is not None and raised
            and eng.recoveries == 1 and out["corrupt_page"]["cause"]
            == "page_corruption" and launches == want_launches(eng)):
        raise AssertionError("corrupt page: not caught as PagePoolCorruption "
                             "inside the engine and recovered, or the "
                             "launches are not the main path's")
    del eng
    torch.cuda.empty_cache()
    return out


def submit_all(eng, reqs):
    for r in reqs:
        eng.submit_request(r)


def restore_full(params, cfg, smi) -> dict:
    """``trace(0, 16)`` submitted at once and run (the reference); again
    with a snapshot after ``SNAP_AT`` steps, through JSON, restored into a
    fresh engine and run there (a second restore into it, busy, refuses);
    and again with every live page compacted by ``defrag`` after every
    step (bitwise required: content moves verbatim)."""
    ref_eng = state_engine(params, cfg)
    reqs = trace(0, 16)
    submit_all(ref_eng, reqs)
    ref_eng.run()
    ref, prompts = by_rid(reqs), {r.rid: r.prompt for r in reqs}
    out = {}
    src = state_engine(params, cfg)
    submit_all(src, trace(0, 16))
    for _ in range(SNAP_AT):
        src.step()
    t0 = time.perf_counter()
    text = json.dumps(src.snapshot())
    dst = state_engine(params, cfg)
    restored = dst.restore(json.loads(text))
    restore_ms = (time.perf_counter() - t0) * 1e3
    try:
        dst.restore(json.loads(text))
        busy = "accepted"
    except RuntimeError:
        busy = "refused"
    del src
    kernels.reset_launch_counts()
    dst.run()
    out["snapshot_restore"] = dict(
        after_steps=SNAP_AT, snapshot_bytes=len(text),
        restored=len(restored), snapshot_restore_ms=restore_ms,
        busy_restore=busy, launches=launch_counts(),
        streams=held_streams(
            "snapshot -> JSON -> restore (bf16)",
            {r.rid: r.generated for r in restored},
            {r.rid: ref[r.rid] for r in restored}, prompts, ref_eng,
            required=False))
    log(f"  snapshot/restore: {json.dumps({k: v for k, v in out['snapshot_restore'].items() if k != 'streams'})}; {smi}")
    if busy != "refused" or not restored:
        raise AssertionError("restore into a busy engine was not refused")
    del dst
    eng = state_engine(params, cfg)
    reqs = trace(0, 16)
    submit_all(eng, reqs)
    moved, ms = 0, []
    while not eng.sched.idle:
        eng.step()
        t0 = time.perf_counter()
        mapping = eng.cache.defrag([r.pages for r in eng.sched.running])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        moved += sum(o != n for o, n in mapping.items())
    out["defrag"] = dict(calls=len(ms), pages_moved=moved,
                         defrag_ms_p50=statistics.median(ms),
                         streams=held_streams("defrag after every step (bf16)",
                                              by_rid(reqs), ref, prompts,
                                              ref_eng, required=True))
    log(f"  defrag: {json.dumps({k: v for k, v in out['defrag'].items() if k != 'streams'})}; {smi}")
    if not moved:
        raise AssertionError("defrag moved no page: the check saw nothing")
    del eng, ref_eng
    torch.cuda.empty_cache()
    return out


def disaggregated(params, cfg, pool, quant, decode_kernel, smi) -> dict:
    """Four requests prefilled on a ``prefill_only`` engine, shipped by
    ``export_request`` (one through ``json.dumps``/``loads``), checked by
    ``verify_page_payload`` and adopted by a ``kv_import`` engine, which
    decodes them: bitwise the colocated engine's streams at the same
    ``max_batch``; K1 only on the prefill side and K5 only on the decode
    side, in exact counts; a payload with one flipped byte refused with
    the decode engine unchanged."""
    L = cfg.num_layers
    reqs = trace(1, 4)
    colocated = state_engine(params, cfg, kv_quant=quant)
    handles = [colocated.submit(r.prompt, r.max_new_tokens) for r in reqs]
    colocated.run()
    want = by_rid(handles)
    del colocated
    pre = state_engine(params, cfg, kv_quant=quant, prefill_only=True)
    dec = state_engine(params, cfg, kv_quant=quant, kv_import=True)
    pre.warmup()
    dec.warmup()
    kernels.reset_launch_counts()
    shipped, export_ms, pages_out = [], 0.0, 0
    for r in reqs:
        h = pre.submit(r.prompt, r.max_new_tokens)
        pre.step()
        if h.prefill_pos is not None or len(h.generated) != 1:
            raise AssertionError("prefill_only engine: no first token")
        t0 = time.perf_counter()
        shipped.append(pre.export_request(h.rid))
        export_ms += (time.perf_counter() - t0) * 1e3
        pages_out += len(shipped[-1][1])
    pre_launches = launch_counts()
    kernels.reset_launch_counts()
    wire = json.dumps(list(shipped[0]))
    shipped[0] = tuple(json.loads(wire))
    if not all(verify_page_payload(p) for _, pages, _ in shipped
               for p in pages):
        raise AssertionError("a shipped page failed its CRC")
    record, pages, kv_len = shipped[1]
    raw = bytearray(base64.b64decode(pages[0]["k"]))
    raw[len(raw) // 2] ^= 0x10
    bad = [dict(pages[0], k=base64.b64encode(bytes(raw)).decode("ascii"))]
    before = (len(dec.sched.running), dec.cache.pages_free)
    try:
        dec.adopt_prefilled(record, bad + pages[1:], kv_len)
        flipped = "adopted"
    except ValueError:
        flipped = "refused"
    unchanged = before == (len(dec.sched.running), dec.cache.pages_free)
    import_ms = 0.0
    adopted = []
    for record, pages, kv_len in shipped:
        t0 = time.perf_counter()
        adopted.append(dec.adopt_prefilled(record, pages, kv_len))
        torch.cuda.synchronize()
        import_ms += (time.perf_counter() - t0) * 1e3
    dec.run()
    dec_launches = launch_counts()
    got = by_rid(adopted)
    out = dict(pool=pool, requests=len(reqs), pages=pages_out,
               export_ms_per_page=export_ms / pages_out,
               import_ms_per_page=import_ms / pages_out,
               wire_bytes_one_request=len(wire),
               streams_equal=got == want, flipped_byte=flipped,
               refusal_left_engine_unchanged=unchanged,
               prefill_launches=pre_launches, decode_launches=dec_launches,
               prefills=pre.prefills, decode_steps=dec.decode_steps,
               card=smi)
    log(f"  disaggregated ({pool} pool): {json.dumps(out)}")
    want_pre = {"flash_fwd_sm90": L * pre.prefills}
    want_dec = {decode_kernel: L * dec.decode_steps}
    if not (got == want and flipped == "refused" and unchanged
            and pre_launches == want_pre and dec_launches == want_dec
            and dec.prefills == 0):
        raise AssertionError(f"disaggregated ({pool}): streams differ from "
                             "the colocated engine's, a flipped byte was "
                             "adopted, or the launches are not K1 on the "
                             f"prefill side {want_pre} and K5 on the decode "
                             f"side {want_dec}")
    del pre, dec
    torch.cuda.empty_cache()
    return out


def phase_state(smi: str) -> dict:
    """Phase 16: the serving engine's state, page integrity and telemetry
    at full width (and the contracts the JAX package pins at fp32 on the
    toy)."""
    t0 = time.perf_counter()
    out = {"toy": toy_state_checks()}
    cfg = ServingModelConfig(**FULL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    tel = telemetry_inert(params, cfg, smi)
    ref, prompts = tel.pop("reference"), tel.pop("prompts")
    out["telemetry"] = tel
    out["recovery"] = recovery_full(params, cfg, ref, prompts, smi)
    out.update(restore_full(params, cfg, smi))
    out["disaggregated"] = {
        pool: disaggregated(params, cfg, pool, quant, name, smi)
        for pool, quant, name in DECODE_POOLS[:2]}
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 16 took {out['wall_s']:.1f} s; {smi}")
    return out


# -- phase 6: toy training, cuda vs cpu -------------------------------------

TOY_TRAIN = ["--num-layers", "2", "--hidden-size", "256",
             "--num-attention-heads", "2", "--seq-length", "128",
             "--max-position-embeddings", "128", "--micro-batch-size", "2",
             "--vocab-size", "256", "--attention-dropout", "0",
             "--hidden-dropout", "0", "--train-iters", "5",
             "--log-interval", "5"]
TOY_LOSS_TOL = 1e-5     # x |loss|: fp32 throughout, sums in another order
# final weights, card vs CPU, absolute: ten times the largest gap measured
# on an H100 (9.6e-6); five Adam steps at lr 1.5e-4 move a weight by up to
# 7.5e-4, so a card path that skipped an update would fail it
TOY_WEIGHT_TOL = 1e-4


def toy_run(device, state, batches):
    losses, final = [], {}

    def record(it, loss, model):
        losses.append(float(loss))
        final.update({k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()})

    pretrain_gpt.main(TOY_TRAIN, device=device, state_dict=state,
                      batches=batches, on_step=record)
    return losses, final


def phase_toy_training() -> dict:
    args, model, _ = pretrain_gpt.setup(TOY_TRAIN, "cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    batches = [b for b, _ in zip(pretrain_gpt.synthetic_batches(args, gen),
                                 range(5))]
    kernels.reset_launch_counts()
    on_card, w_card = toy_run("cuda", state, batches)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    on_cpu, w_cpu = toy_run("cpu", state, batches)
    log(f"  toy fp32 launches over 5 steps {launches}")
    if not (launches.get("flash_qkv_fwd") and launches.get("flash_qkv_bwd")
            and "flash_qkv_fwd_sm90" not in launches
            and "flash_qkv_bwd_sm90" not in launches):
        raise AssertionError("toy training: fp32 attention did not take the "
                             "scalar kernels (the fp32 route)")
    log(f"  toy fp32 losses, cuda (kernels): {on_card}")
    log(f"  toy fp32 losses, cpu (plain):    {on_cpu}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
    w_err = max((w_card[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
    w_mean = statistics.mean((w_card[k] - w_cpu[k]).abs().mean().item()
                             for k in w_cpu)
    moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
    log(f"  toy training: loss rel diff {loss_err:.3e} (tol "
        f"{TOY_LOSS_TOL:.0e}); final weights max diff {w_err:.3e} (tol "
        f"{TOY_WEIGHT_TOL:.0e}), mean over tensors of the mean diff "
        f"{w_mean:.3e}; the largest update on the CPU {moved:.3e}")
    if not (loss_err <= TOY_LOSS_TOL and w_err <= TOY_WEIGHT_TOL
            and moved > 2 * TOY_WEIGHT_TOL):
        raise AssertionError("toy training: card and CPU disagree")
    return {"toy_loss_rel_diff": loss_err, "toy_weight_max_diff": w_err,
            "launches": launches}


# -- phase 7: full-width training (GPT-1.3B) --------------------------------

FULL_TRAIN = ["--num-layers", "24", "--hidden-size", "2048",
              "--num-attention-heads", "16", "--seq-length", "2048",
              "--max-position-embeddings", "2048", "--micro-batch-size", "4",
              "--bf16"]
STEP_LOSS_TOL = 0.3          # step 1 within this of its expected value
# kernel vs plain step: bf16 activations at 24 layers, the kernels' and
# the plain versions' fp32 sums in other orders flip a bf16 rounding now
# and then; each bar is ten times the largest gap measured on an H100
PLAIN_LOSS_TOL = 1.5e-3      # absolute, on a loss near 8-11 (read 1.5e-4)
PLAIN_NORM_TOL = 5e-4        # relative, global grad norm (read 4.9e-5)
# relative, |g - g_plain| / |g_plain| on the worst leaf (read 4.6e-3, on
# the last layer's dense_h_to_4h weight; the median leaf reads 1.3e-3)
PLAIN_LEAF_TOL = 5e-2

# kernel-name fragments -> the part of the step they belong to
STEP_KINDS = (("qkv_fwd_sm90", "K3 flash_qkv_fwd"),
              ("qkv_bwd_", "K4 flash_qkv_bwd"),   # its three passes
              # the scalar kernels (the fp32 route): none in a bf16 step
              ("flash_fwd_kernel", "K3/K4 scalar"), ("attn_bwd", "K3/K4 scalar"),
              # both routes: layer_norm_sm90.cu's ln_fwd_rows, ln_bwd_rows
              # and ln_bwd_cols, layer_norm.cu's ln_fwd_kernel, ln_bwd_*
              ("ln_fwd", "K6 layer_norm_fwd"),
              ("ln_bwd", "K7 layer_norm_bwd"),
              ("gemm", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
              ("nvjet", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"),
              ("foreach", "optimizer + clip (foreach)"),
              ("multi_tensor", "optimizer + clip (foreach)"),
              ("lpnorm", "optimizer + clip (foreach)"))


def plain_kernels():
    """A training step with its kernels swapped for their plain versions,
    on the card (the reference of the kernel-vs-plain checks)."""
    return mock.patch.multiple(
        att, _flash_qkv_fwd_cuda=att._flash_qkv_fwd_plain,
        _flash_qkv_bwd_cuda=att._flash_qkv_bwd_plain,
        _flash_fwd_cuda=att._flash_fwd_plain,
        _flash_bwd_cuda=att._flash_bwd_plain), mock.patch.multiple(
        ln, _ln_fwd_cuda=ln._ln_fwd_plain, _ln_bwd_cuda=ln._ln_bwd_plain)


OTHER_KIND = "other elementwise, copies, reductions"


def step_profile(step, parts=STEP_KINDS) -> dict:
    """Device time of one call of ``step`` by part, from a
    ``torch.profiler`` trace (CUPTI): kernel durations summed by kind and
    the ten longest kernels by name; the device's busy time is the union
    of the kernels' intervals, and its idle share is the rest of the
    step's wall time.  The kernels that ``parts`` does not name (the
    ``OTHER_KIND`` bucket) are also split by the ATen op that launched
    each (the CPU op the profiler correlates the launch with), the ten
    largest in ``top_other_ops``; what no op launched is
    ``"(no ATen op)"``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds, names, spans = {}, {}, []
    for e in prof.events():
        # kernels, copies and sets only: the GPU-side ranges of user
        # annotations (Optimizer.step#...) overlap the kernels they cover
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        kind = next((k for frag, k in parts if frag in e.name.lower()),
                    OTHER_KIND)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        n, t = names.get(e.name[:160], (0, 0.0))
        names[e.name[:160]] = (n + 1, t + ms)
    ops = {}
    for e in prof.events():     # CPU ops, each with the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in e.kernels:
            if any(frag in k.name.lower() for frag, _ in parts):
                continue
            n, t = ops.get(e.name, (0, 0.0))
            ops[e.name] = (n + 1, t + k.duration / 1e3)
    unclaimed = kinds.get(OTHER_KIND, 0.0) - sum(t for _, t in ops.values())
    if unclaimed > 1e-3:
        ops["(no ATen op)"] = (0, unclaimed)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:10]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels": [(k, n, t) for k, (n, t) in top],
            "top_other_ops": [(k, n, t) for k, (n, t) in top_ops]}


def log_other_ops(prof: dict) -> None:
    """The ``OTHER_KIND`` bucket of :func:`step_profile`, by ATen op."""
    log(f"  {OTHER_KIND} ({prof['by_kind_ms'].get(OTHER_KIND, 0.0):.2f} "
        "ms) by the ATen op that launched each kernel, the ten largest:")
    for name, n, t in prof["top_other_ops"]:
        log(f"    {t:8.2f} ms  x{n:<5d} {name}")


def loss_and_grads(model, tokens, labels):
    loss = model(tokens, labels=labels).mean()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach().item(), grads


# a GPT-1.3B bf16 step's launches (remat attn_res, L = 24 layers): the
# tensor-core K3/K4 L each, layer_norm_sm90.cu's K6 4L + 1 and K7 2L + 1,
# and not one launch of the scalar K3/K4 or of layer_norm.cu
GPT_STEP_LAUNCHES = {"flash_qkv_fwd_sm90": 24, "flash_qkv_bwd_sm90": 24,
                     "layer_norm_fwd_sm90": 4 * 24 + 1,
                     "layer_norm_bwd_sm90": 2 * 24 + 1}


def phase_full_training(smi: str) -> dict:
    L = 24
    want = GPT_STEP_LAUNCHES
    steps, losses, times = 10, [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_last = [time.perf_counter()]

    def record(it, loss, model):
        losses.append(float(loss))      # synchronises: the step is done
        now = time.perf_counter()
        times.append((now - t_last[0]) * 1e3)
        t_last[0] = now

    kernels.reset_launch_counts()
    pretrain_gpt.main(FULL_TRAIN + ["--train-iters", str(steps),
                                    "--log-interval", "5"],
                      device="cuda", on_step=record)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    per_step = {k: v / steps for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # at init the logits are h . w_emb with h the final LayerNorm's output
    # (unit variance) and w_emb ~ N(0, 0.02^2): Gaussian logits of variance
    # v = 0.02^2 x 2048, whose cross-entropy on random labels averages
    # ln(vocab) + v / 2 = 10.843 + 0.410
    expect = math.log(51200) + 0.02 ** 2 * 2048 / 2
    log(f"  losses {losses}")
    log(f"  launches over {steps} steps {launches}; per step {per_step}, "
        f"expected {want} (remat attn_res: K3 L, K4 L, K6 4L+1, K7 2L+1; "
        f"the scalar K3/K4 and layer_norm.cu never)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("full-width training: non-finite loss")
    if abs(losses[0] - expect) > STEP_LOSS_TOL:
        raise AssertionError(f"step 1 loss {losses[0]} is not within "
                             f"{STEP_LOSS_TOL} of ln(51200) + 0.02^2 x 2048 "
                             f"/ 2 = {expect:.3f}")
    if per_step != want:
        raise AssertionError("training launch counts do not match the "
                             "main path")
    step_ms = statistics.median(times[1:])
    args, model, opt = pretrain_gpt.setup(FULL_TRAIN, "cuda")
    n_params = gpt_param_count(model.cfg)
    b, s, h = 4, 2048, 2048
    tokens_per_step = b * s
    # model flops: 6 N T for the GEMMs, plus the causal attention's two
    # products (QK^T, PV) forward and backward, 6 b s^2 h L; no recompute
    flops = 6 * n_params * tokens_per_step + 6 * b * s * s * h * L
    metrics = {"train_step_ms_p50": step_ms,
               "train_tok_per_s": tokens_per_step / step_ms * 1e3,
               "model_tflops": flops / step_ms / 1e9,
               "peak_mem_gib": peak, "params": n_params,
               "step1_loss": losses[0], "launches_per_step": per_step,
               "card": smi}
    log("  train " + json.dumps(metrics))

    # fixed batch: the loss falls; then a step's enqueue vs done time
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens, labels = next(pretrain_gpt.synthetic_batches(args, gen))
    fixed = [float(pretrain_gpt.train_step(args, model, opt, tokens, labels,
                                           it)) for it in range(5)]
    log(f"  fixed-batch losses {fixed}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError("full-width training: the loss does not fall "
                             "on a fixed batch")
    enqueue, done = [], []
    for it in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pretrain_gpt.train_step(args, model, opt, tokens, labels, 5 + it)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    metrics.update(step_enqueue_ms=statistics.median(enqueue),
                   step_done_ms=statistics.median(done))
    log(f"  one step: host enqueue {metrics['step_enqueue_ms']:.1f} ms, "
        f"device done {metrics['step_done_ms']:.1f} ms (medians of 3)")
    prof = step_profile(lambda: pretrain_gpt.train_step(
        args, model, opt, tokens, labels, 8))
    metrics["step_profile"] = prof
    if prof["device_busy_ms"] > 0:
        log("  one step under torch.profiler: " + ", ".join(
            f"{k} {v:.1f} ms ({v / prof['wall_ms']:.1%})"
            for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
        for name, n, t in prof["top_kernels"]:
            log(f"    {t:8.1f} ms  x{n:<5d} {name}")
        log_other_ops(prof)
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(breakdown not measured)")

    # kernels vs plain versions, one dropout-free step from the same weights
    loss, grads = loss_and_grads(model, tokens, labels)
    patches = plain_kernels()
    with patches[0], patches[1]:
        ref_loss, ref_grads = loss_and_grads(model, tokens, labels)
    norm = multi_tensor_l2norm(list(grads.values())).item()
    ref_norm = multi_tensor_l2norm(list(ref_grads.values())).item()
    dl, dn = abs(loss - ref_loss), abs(norm - ref_norm) / ref_norm
    leaf = {n: ((grads[n] - g).norm() / g.norm()).item()
            for n, g in ref_grads.items()}
    worst = max(leaf, key=leaf.get)
    log(f"  dropout-free step, kernels vs plain: loss {loss:.6f} vs "
        f"{ref_loss:.6f} (diff {dl:.3e}, tol {PLAIN_LOSS_TOL:.1e}); grad "
        f"norm {norm:.6f} vs {ref_norm:.6f} (rel diff {dn:.3e}, tol "
        f"{PLAIN_NORM_TOL:.0e}); worst leaf {worst} |g - g_plain| / "
        f"|g_plain| {leaf[worst]:.3e} (tol {PLAIN_LEAF_TOL:.0e}), median "
        f"over {len(leaf)} leaves {statistics.median(leaf.values()):.3e}")
    if not (dl <= PLAIN_LOSS_TOL and dn <= PLAIN_NORM_TOL
            and leaf[worst] <= PLAIN_LEAF_TOL):
        raise AssertionError("full-width step: kernel path disagrees with "
                             "the plain path")
    del model, opt, grads, ref_grads
    torch.cuda.empty_cache()

    # determinism: the same step (dropout on) twice from the same state
    def one_step():
        a, m, o = pretrain_gpt.setup(FULL_TRAIN, "cuda")
        loss = pretrain_gpt.train_step(a, m, o, tokens, labels, 0)
        return float(loss), [p.detach().clone() for p in m.parameters()]

    loss1, w1 = one_step()
    torch.cuda.empty_cache()
    loss2, w2 = one_step()
    same = loss1 == loss2 and all(torch.equal(x, y) for x, y in zip(w1, w2))
    log(f"  same step twice from the same state (dropout on): losses "
        f"{loss1!r} / {loss2!r}, weights bitwise equal: {same}")
    if not same:
        raise AssertionError("full-width step is not deterministic")
    metrics.update(kernel_vs_plain_loss_diff=dl,
                   kernel_vs_plain_grad_norm_rel_diff=dn,
                   kernel_vs_plain_worst_leaf_rel_diff=leaf[worst],
                   deterministic=same,
                   launches={k: v for k, v in launches.items()})
    return metrics


# -- phases 8-9: the multi-head attention training path ---------------------


class MHAStack(torch.nn.Module):
    """An attention-only encoder-decoder of the contrib modules, stacked as
    the reference's multi-head attention perf script stacks them: ``layers``
    pre-norm self-attention layers over the source (boolean source key
    padding: the segment route), then ``layers`` decoder layers of
    self-attention (target key padding plus a boolean causal attn_mask:
    the mask_bias route) and encoder-decoder attention over the encoder's
    output (source key padding, sq != sk: the cross-length segment
    route)."""

    def __init__(self, hidden, heads, layers, dropout, device, seed=0):
        super().__init__()
        kw = dict(dropout=dropout, bias=True, include_norm_add=True,
                  device=device)
        self.enc = torch.nn.ModuleList(
            SelfMultiheadAttn(hidden, heads, seed=seed + i, **kw)
            for i in range(layers))
        self.dec_self = torch.nn.ModuleList(
            SelfMultiheadAttn(hidden, heads, seed=seed + 100 + i, **kw)
            for i in range(layers))
        self.dec_cross = torch.nn.ModuleList(
            EncdecMultiheadAttn(hidden, heads, seed=seed + 200 + i, **kw)
            for i in range(layers))

    def forward(self, src, tgt, src_pad, tgt_pad, causal, generator=None):
        x = src
        for m in self.enc:
            x = m(x, key_padding_mask=src_pad, generator=generator)
        y = tgt
        for s, c in zip(self.dec_self, self.dec_cross):
            y = s(y, key_padding_mask=tgt_pad, attn_mask=causal,
                  generator=generator)
            y = c(y, x, key_padding_mask=src_pad, generator=generator)
        return y


def mha_batch(device, dtype, hidden, b, s_src, s_tgt, lo, seed):
    """Source and target activations [s, b, hidden] (the embeddings'
    output), a fixed random regression target, key-padding masks from
    lengths uniform in [lo, s], and the decoder's causal mask."""
    rng = np.random.RandomState(seed)
    src_len = rng.randint(lo, s_src + 1, size=b)
    tgt_len = rng.randint(lo, s_tgt + 1, size=b)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device)

    src, tgt = t(s_src, b, hidden).to(dtype), t(s_tgt, b, hidden).to(dtype)
    target = t(s_tgt, b, hidden)
    src_pad = (torch.arange(s_src)[None] >= torch.from_numpy(src_len)[:, None])
    tgt_pad = (torch.arange(s_tgt)[None] >= torch.from_numpy(tgt_len)[:, None])
    causal = torch.ones(s_tgt, s_tgt, dtype=torch.bool).triu(1)
    return dict(src=src, tgt=tgt, target=target, src_pad=src_pad.to(device),
                tgt_pad=tgt_pad.to(device), causal=causal.to(device),
                real_tokens=int(src_len.sum() + tgt_len.sum()))


def mha_loss(model, batch, generator=None):
    y = model(batch["src"], batch["tgt"], batch["src_pad"], batch["tgt_pad"],
              batch["causal"], generator=generator)
    return ((y.float() - batch["target"]) ** 2).mean()


def mha_step(model, opt, batch, generator=None):
    loss = mha_loss(model, batch, generator)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


TOY_MHA = dict(hidden=32, heads=4, layers=2, batch=4, src=40, tgt=24)
TOY_MHA_LOSS_TOL = 1e-5      # x |loss|: fp32 throughout, sums in another order
# final weights card vs CPU, absolute: ten times the largest gap read on
# an H100 (1.23e-5, and 9.83e-5 on the key biases); five Adam steps at lr
# 1e-3 move a weight by up to 5e-3, so a skipped update would fail it
TOY_MHA_WEIGHT_TOL = 1.3e-4
# the key part of a packed projection bias: softmax ignores a constant
# added to a row's scores, so its exact gradient is 0 and Adam steps on
# rounding noise (up to lr a step) on either device
TOY_MHA_KEY_BIAS_TOL = 1e-3
MHA_LR = 5e-4


def key_bias_part(name: str, hidden: int):
    """The slice of the key projection's bias in a packed bias, or None."""
    if name.endswith("in_proj_bias"):
        return slice(hidden, 2 * hidden)
    if name.endswith("kv_bias"):
        return slice(0, hidden)
    return None


def phase_toy_mha() -> dict:
    """The toy-width stack (4 heads of 8), fp32, five FusedAdam steps on a
    fixed batch from the same weights on the card (kernels) and on the
    CPU (plain versions)."""
    c = TOY_MHA
    cpu = MHAStack(c["hidden"], c["heads"], c["layers"], 0.0, "cpu", seed=1)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = MHAStack(c["hidden"], c["heads"], c["layers"], 0.0, "cpu", seed=1)
    card.load_state_dict(state)
    card.cuda()

    def run(model, device):
        batch = mha_batch(device, torch.float32, c["hidden"], c["batch"],
                          c["src"], c["tgt"], 8, seed=2)
        opt = FusedAdam(model.parameters(), lr=1e-3)
        losses = [float(mha_step(model, opt, batch)) for _ in range(5)]
        return losses, {k: v.detach().cpu() for k, v in
                        model.state_dict().items()}

    kernels.reset_launch_counts()
    on_card, w_card = run(card, "cuda")
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    on_cpu, w_cpu = run(cpu, "cpu")
    log(f"  toy fp32 launches over 5 steps {launches}")
    if not (launches.get("flash_fwd") and launches.get("flash_bwd")
            and "flash_fwd_sm90" not in launches
            and "flash_bwd_sm90" not in launches):
        raise AssertionError("toy MHA training: fp32 attention did not take "
                             "the scalar K1 and K2 (the fp32 route)")
    log(f"  toy fp32 losses, cuda (kernels): {on_card}")
    log(f"  toy fp32 losses, cpu (plain):    {on_cpu}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
    diff = {k: (w_card[k] - w_cpu[k]).abs() for k in w_cpu}
    kb_err = 0.0
    for k, d in diff.items():
        part = key_bias_part(k, c["hidden"])
        if part is not None:
            kb_err = max(kb_err, d[part].max().item())
            d[part] = 0.0
    worst = max(diff, key=lambda k: diff[k].max().item())
    w_err = diff[worst].max().item()
    moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
    log(f"  toy MHA training: loss rel diff {loss_err:.3e} (tol "
        f"{TOY_MHA_LOSS_TOL:.0e}); final weights max diff {w_err:.3e} on "
        f"{worst} (tol {TOY_MHA_WEIGHT_TOL:.1e}), key biases {kb_err:.3e} "
        f"(tol {TOY_MHA_KEY_BIAS_TOL:.0e}); the largest update on the CPU "
        f"{moved:.3e}")
    if not (loss_err <= TOY_MHA_LOSS_TOL and w_err <= TOY_MHA_WEIGHT_TOL
            and kb_err <= TOY_MHA_KEY_BIAS_TOL
            and moved > 2 * TOY_MHA_KEY_BIAS_TOL):
        raise AssertionError("toy MHA training: card and CPU disagree")
    return {"toy_mha_loss_rel_diff": loss_err,
            "toy_mha_weight_max_diff": w_err,
            "toy_mha_key_bias_max_diff": kb_err, "launches": launches}


# kernel vs plain, one dropout-free full-width step: bf16 activations
# through 12 layers, so a one-ulp difference in a K1 output or a LayerNorm
# moves every later gradient a little; each bar is ten times the largest
# gap read on an H100
# relative, on the loss, held at the seeded initial weights and at the
# trained ones: scripts/mha_step_gaps.py read 11 states on the scalar K2
# (the seeded initial weights and after each of ten training steps) on an
# NVIDIA H100 80GB HBM3 at 700 W, 6.2e-8 to 4.31e-6, the largest at the
# initial weights
MHA_PLAIN_LOSS_TOL = 4.31e-5
MHA_PLAIN_NORM_TOL = 8e-4    # relative, global grad norm (read 7.3e-5)
# relative, |g - g_plain| / |g_plain| on the worst leaf (read 1.05e-2, on
# encoder layer 5's in_proj_weight; the median leaf reads 8.7e-3)
MHA_PLAIN_LEAF_TOL = 1.1e-1
MHA_KINDS = (("ln_fwd", "K6 layer_norm_fwd"),   # before K2's "_sm90"
             ("ln_bwd", "K7 layer_norm_bwd"),
             ("attn_fwd_sm90", "K1 flash_fwd_sm90"),   # before K2's "_sm90"
             ("flash_fwd_kernel", "K1 flash_fwd (scalar)"),
             # K2's three passes: attn_bwd_{delta,dkdv,dq}_sm90 on the
             # tensor cores; the scalar attn_bwd_* are the fp32 route
             ("_sm90", "K2 flash_bwd_sm90"),
             ("attn_bwd", "K2 flash_bwd (scalar)"),
             ("gemm", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
             ("nvjet", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"),
             ("foreach", "optimizer (foreach)"),
             ("multi_tensor", "optimizer (foreach)"))


def mha_grads(model, batch):
    loss = mha_loss(model, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def mha_gaps(model, batch) -> dict:
    """Kernels vs plain versions on one dropout-free step at the model's
    weights: the loss and the global grad norm of each, their relative
    gaps, and each leaf's |g - g_plain| / |g_plain| (``leaf``, by name)."""
    loss, grads = mha_grads(model, batch)
    patches = plain_kernels()
    with patches[0], patches[1]:
        ref_loss, ref_grads = mha_grads(model, batch)
    norm = multi_tensor_l2norm(list(grads.values())).item()
    ref_norm = multi_tensor_l2norm(list(ref_grads.values())).item()
    leaf = {n: ((grads[n] - g).norm() / g.norm()).item()
            for n, g in ref_grads.items()}
    return {"loss": loss, "ref_loss": ref_loss,
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "norm": norm, "ref_norm": ref_norm,
            "norm_rel": abs(norm - ref_norm) / ref_norm, "leaf": leaf}


def check_mha_vs_plain(model, batch, state: str) -> dict:
    """:func:`mha_gaps` at one state of the weights, held to the three
    bars; returns the three gaps."""
    g = mha_gaps(model, batch)
    leaf, dl, dn = g["leaf"], g["loss_rel"], g["norm_rel"]
    worst = max(leaf, key=leaf.get)
    log(f"  dropout-free step at the {state}, kernels vs plain: loss "
        f"{g['loss']:.6f} vs {g['ref_loss']:.6f} (rel diff {dl:.3e}, tol "
        f"{MHA_PLAIN_LOSS_TOL:.2e}); grad norm {g['norm']:.6f} vs "
        f"{g['ref_norm']:.6f} (rel diff {dn:.3e}, tol "
        f"{MHA_PLAIN_NORM_TOL:.1e}); worst leaf {worst} |g - g_plain| / "
        f"|g_plain| {leaf[worst]:.3e} (tol {MHA_PLAIN_LEAF_TOL:.1e}), median "
        f"over {len(leaf)} leaves {statistics.median(leaf.values()):.3e}")
    if not (dl <= MHA_PLAIN_LOSS_TOL and dn <= MHA_PLAIN_NORM_TOL
            and leaf[worst] <= MHA_PLAIN_LEAF_TOL):
        raise AssertionError(f"MHA step at the {state}: kernel path "
                             "disagrees with the plain path")
    return {"loss_rel_diff": dl, "grad_norm_rel_diff": dn,
            "worst_leaf_rel_diff": leaf[worst]}


def phase_mha(smi: str) -> dict:
    c = MHA
    L, steps = c["layers"], 5
    per_step = {"flash_fwd_sm90": 3 * L, "flash_bwd_sm90": 3 * L,
                "layer_norm_fwd_sm90": 3 * L, "layer_norm_bwd_sm90": 3 * L}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = mha_batch("cuda", torch.bfloat16, c["hidden"], c["batch"],
                      c["src"], c["tgt"], 32, seed=3)
    model = MHAStack(c["hidden"], c["heads"], L, c["dropout"], "cuda")
    # kernels vs plain at the seeded initial weights, which no backward
    # kernel has moved yet; the trained state is held after the steps
    initial = check_mha_vs_plain(model, batch, "seeded initial weights")
    opt = FusedAdam(model.parameters(), lr=MHA_LR)
    gen = torch.Generator(device="cuda")
    losses, times = [], []
    kernels.reset_launch_counts()
    for it in range(steps):
        gen.manual_seed(1000 + it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(mha_step(model, opt, batch, gen)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    want = {k: v * steps for k, v in per_step.items()}
    log(f"  fixed-batch losses {losses}")
    log(f"  launches over {steps} steps {launches}, expected {want} (per "
        f"step K1 = K2 = K6 = K7 = {3 * L}: {L} encoder, {L} decoder self, "
        f"{L} cross; K1 and K2 the tensor-core kernels, the scalar ones "
        f"never; K6 and K7 layer_norm_sm90.cu's, layer_norm.cu's never)")
    if launches != want:
        raise AssertionError("MHA launch counts do not match the main path")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError("MHA stack: the loss is not finite or does not "
                             "fall on a fixed batch")
    step_ms = statistics.median(times[1:])
    padded = c["batch"] * (c["src"] + c["tgt"])
    metrics = {"mha_step_ms_p50": step_ms,
               "mha_tok_per_s": padded / step_ms * 1e3,
               "mha_real_tok_per_s": batch["real_tokens"] / step_ms * 1e3,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "params": sum(p.numel() for p in model.parameters()),
               "card": smi}
    log("  mha " + json.dumps(metrics))
    prof = step_profile(lambda: mha_step(model, opt, batch, gen), MHA_KINDS)
    metrics["step_profile"] = prof
    if prof["device_busy_ms"] > 0:
        log("  one step under torch.profiler: " + ", ".join(
            f"{k} {v:.2f} ms ({v / prof['wall_ms']:.1%})"
            for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms, idle {prof['idle_share']:.1%}")
        for name, n, t in prof["top_kernels"]:
            log(f"    {t:8.2f} ms  x{n:<5d} {name}")
        log_other_ops(prof)
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(breakdown not measured)")

    # kernels vs plain at the weights the six training steps above left
    trained = check_mha_vs_plain(model, batch, "weights after six steps")
    del model, opt
    torch.cuda.empty_cache()

    # determinism: the same step (dropout on) twice from the same state
    def one_step():
        m = MHAStack(c["hidden"], c["heads"], L, c["dropout"], "cuda")
        o = FusedAdam(m.parameters(), lr=MHA_LR)
        g = torch.Generator(device="cuda").manual_seed(1000)
        loss = float(mha_step(m, o, batch, g))
        return loss, [p.detach().clone() for p in m.parameters()]

    loss1, w1 = one_step()
    loss2, w2 = one_step()
    same = loss1 == loss2 and all(torch.equal(x, y) for x, y in zip(w1, w2))
    log(f"  same step twice from the same state (dropout on): losses "
        f"{loss1!r} / {loss2!r}, weights bitwise equal: {same}")
    if not same:
        raise AssertionError("MHA step is not deterministic")
    metrics.update(launches=launches, kernel_vs_plain_initial=initial,
                   kernel_vs_plain_trained=trained, deterministic=same)
    return metrics


# -- phases 10-11: GPT training on the flat superblock (K8) -----------------


class SuperblockTrainer:
    """GPT training with the model's weights in one fp32 superblock: the
    PyTorch form of the JAX package's flatten -> ``FlatFusedAdam.step``
    -> unflatten.  The model's unique parameters (the tied embedding
    once), packed by name with ``total_multiple_of=1024``, are rebound to
    their ``unflatten`` views, so the weights ARE the superblock, and each
    ``.grad`` is a view of one flat grad buffer of the same layout.  A
    step zeroes that buffer (dropping the grads would cut the views), runs
    ``pretrain_gpt.forward_backward``, whose clip scales the grad views
    and so the flat buffer, then the in-place ``FlatFusedAdam`` step: K8,
    one launch."""

    def __init__(self, args, model):
        params = dict(model.named_parameters())
        with torch.no_grad():
            self.flat_p, self.schema = flatten(
                params, dtype=torch.float32, total_multiple_of=1024)
        self.flat_g = torch.zeros_like(self.flat_p)
        weights = unflatten(self.flat_p, self.schema)
        grads = unflatten(self.flat_g, self.schema)
        for name, p in params.items():
            p.data = weights[name]
            p.grad = grads[name]
        self.args, self.model = args, model
        self.opt = FlatFusedAdam(lr=args.lr,
                                 betas=(args.adam_beta1, args.adam_beta2),
                                 eps=args.adam_eps,
                                 weight_decay=args.weight_decay)
        self.state = self.opt.init(self.flat_p)
        self.run = self.opt.jit_step()

    def step(self, tokens, labels, it: int):
        self.flat_g.zero_()
        loss = pretrain_gpt.forward_backward(self.args, self.model, tokens,
                                             labels, it)
        _, self.state = self.run(self.flat_g, self.state, self.flat_p)
        return loss


def flat_toy_run(device, state, batches):
    args, model, _ = pretrain_gpt.setup(TOY_TRAIN, device)
    model.load_state_dict(state)
    trainer = SuperblockTrainer(args, model)
    losses = [float(trainer.step(*(t.to(device) for t in b), it))
              for it, b in enumerate(batches)]
    return losses, {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}


def phase_flat_toy() -> dict:
    """Phase 6's toy GPT (fp32) trained on the superblock from the same
    weights and batches on the card (kernels, K8) and on the CPU (plain
    versions), held to phase 6's bars."""
    args, model, _ = pretrain_gpt.setup(TOY_TRAIN, "cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    batches = [b for b, _ in zip(pretrain_gpt.synthetic_batches(args, gen),
                                 range(5))]
    kernels.FLAT_ADAM.launches = 0
    on_card, w_card = flat_toy_run("cuda", state, batches)
    k8 = kernels.FLAT_ADAM.launches
    on_cpu, w_cpu = flat_toy_run("cpu", state, batches)
    log(f"  toy fp32 flat losses, cuda (kernels, {k8} K8 launches): {on_card}")
    log(f"  toy fp32 flat losses, cpu (plain):                 {on_cpu}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
    w_err = max((w_card[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
    moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
    log(f"  toy flat training: loss rel diff {loss_err:.3e} (tol "
        f"{TOY_LOSS_TOL:.0e}); final weights max diff {w_err:.3e} (tol "
        f"{TOY_WEIGHT_TOL:.0e}); the largest update on the CPU {moved:.3e}")
    if not (k8 == len(batches) and loss_err <= TOY_LOSS_TOL
            and w_err <= TOY_WEIGHT_TOL and moved > 2 * TOY_WEIGHT_TOL):
        raise AssertionError("toy flat training: card and CPU disagree")
    return {"toy_flat_loss_rel_diff": loss_err,
            "toy_flat_weight_max_diff": w_err}


# the superblock step against the tree FusedAdam step from one state and
# one gradient: the same fp32 Adam in another order of operations (and c1,
# c2 from the host there); absolute.  Read on an H100: 1.19e-7, one fp32
# ulp at 1.0 (the LayerNorm gains); ten times that is looser than 1e-6,
# so the bar stays 1e-6.  One step moves a weight by up to ~1.5e-4
FLAT_TREE_TOL = 1e-6
FLAT_KINDS = (("flat_adam", "K8 flat_adam"),) + tuple(
    (frag, "clip (foreach)" if kind.startswith("optimizer") else kind)
    for frag, kind in STEP_KINDS)


def optimizer_ms(prof, kinds) -> float:
    return sum(prof["by_kind_ms"].get(k, 0.0) for k in kinds)


def phase_flat_training(smi: str, train: dict) -> dict:
    L, steps = 24, 5
    per_step = {"flash_qkv_fwd_sm90": L, "flash_qkv_bwd_sm90": L,
                "layer_norm_fwd_sm90": 4 * L + 1,
                "layer_norm_bwd_sm90": 2 * L + 1, "flat_adam": 1}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args, model, _ = pretrain_gpt.setup(FULL_TRAIN, "cuda")
    tr = SuperblockTrainer(args, model)
    if tr.schema.total != -(-gpt_param_count(model.cfg) // 1024) * 1024:
        raise AssertionError("superblock length is not phase 3's")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens, labels = next(pretrain_gpt.synthetic_batches(args, gen))
    losses, times = [], []
    kernels.reset_launch_counts()
    for it in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(tr.step(tokens, labels, it)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: v * steps for k, v in per_step.items()}
    log(f"  superblock: {tr.schema.num_tensors} leaves, {tr.schema.total} "
        f"elements; fixed-batch losses {losses}")
    log(f"  launches over {steps} steps {launches}, expected {want} (K8 one "
        "launch a step; layer_norm.cu never)")
    if launches != want:
        raise AssertionError("flat training launch counts do not match the "
                             "main path")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError("flat training: the loss is not finite or does "
                             "not fall on a fixed batch")
    lo_p, lo_g = tr.flat_p.data_ptr(), tr.flat_g.data_ptr()
    nbytes = tr.flat_p.numel() * 4
    alias = all(lo_p <= p.data_ptr() < lo_p + nbytes
                and lo_g <= p.grad.data_ptr() < lo_g + nbytes
                for p in model.parameters())
    log(f"  after backward every weight and .grad is a view of the "
        f"superblock / flat grad buffer: {alias}")
    if not alias:
        raise AssertionError("a parameter or its grad left the superblock")
    step_ms = statistics.median(times[1:])
    tokens_per_step = args.global_batch_size * args.seq_length
    prof = step_profile(lambda: tr.step(tokens, labels, steps), FLAT_KINDS)
    opt_ms = optimizer_ms(prof, ("K8 flat_adam", "clip (foreach)"))
    tree_ms = optimizer_ms(train["step_profile"],
                           ("optimizer + clip (foreach)",))
    metrics = {"flat_step_ms_p50": step_ms,
               "flat_tok_per_s": tokens_per_step / step_ms * 1e3,
               "peak_mem_gib": peak, "superblock_elements": tr.schema.total,
               "optimizer_clip_device_ms": opt_ms,
               "tree_optimizer_clip_device_ms": tree_ms,
               "tree_step_ms_p50": train["train_step_ms_p50"],
               "tree_peak_mem_gib": train["peak_mem_gib"],
               "step_profile": prof, "card": smi}
    log(f"  flat step {step_ms:.1f} ms ({metrics['flat_tok_per_s']:,.0f} "
        f"tok/s), peak {peak:.2f} GiB; phase 7 (tree FusedAdam, this run): "
        f"{train['train_step_ms_p50']:.1f} ms, peak "
        f"{train['peak_mem_gib']:.2f} GiB")
    log("  one flat step under torch.profiler: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in prof["by_kind_ms"].items())
        + f"; wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
    log(f"  optimizer + clip device time: K8 + clip {opt_ms:.2f} ms; phase 7's"
        f" FusedAdam + clip {tree_ms:.2f} ms")
    for name, n, t in prof["top_kernels"]:
        log(f"    {t:8.1f} ms  x{n:<5d} {name}")
    log_other_ops(prof)
    metrics.update(flat_checks(tr, steps + 1))
    metrics["launches"] = launches
    return metrics


def flat_checks(tr: SuperblockTrainer, it: int) -> dict:
    """From one shared state S: a whole step run twice is bitwise equal;
    the bucketed plan gives the single launch's bits; and the tree
    ``FusedAdam`` step over the same weights, moments and gradient agrees
    within FLAT_TREE_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens, labels = next(pretrain_gpt.synthetic_batches(tr.args, gen))
    saved = [x.clone() for x in pmv(tr.flat_p, tr.state)]
    step0 = tr.state.step.clone()

    def restore():
        for dst, src in zip(pmv(tr.flat_p, tr.state), saved):
            dst.copy_(src)
        tr.state = tr.state._replace(step=step0.clone())

    loss1 = float(tr.step(tokens, labels, it))
    # the bucketed walk from S with the same (clipped) gradient
    plan = plan_buckets(tr.schema, 1, span_align=1024)
    bucketed = [x.clone() for x in saved]
    before = kernels.FLAT_ADAM.launches
    tr.opt.jit_step(plan=plan)(tr.flat_g, FlatAdamState(step0.clone(),
                                                        *bucketed[1:]),
                               bucketed[0])
    spans = kernels.FLAT_ADAM.launches - before
    check_bitwise(f"flat step, plan_buckets ({plan.num_buckets} spans, "
                  f"{spans} launches) vs one launch: p, m, v",
                  pmv(tr.flat_p, tr.state), bucketed)
    if spans != plan.num_buckets:
        raise AssertionError("the bucketed walk's launches are not its spans")
    restore()
    loss2 = float(tr.step(tokens, labels, it))
    same = loss1 == loss2 and all(torch.equal(a, b) for a, b in zip(
        pmv(tr.flat_p, tr.state), bucketed))
    log(f"  same flat step twice from the same state (dropout on): losses "
        f"{loss1!r} / {loss2!r}, p, m, v bitwise equal: {same}")
    if not same:
        raise AssertionError("the flat step is not deterministic")
    del bucketed
    torch.cuda.empty_cache()
    # the tree FusedAdam over views of S, with the flat step's gradient
    p_s, m_s, v_s = saved
    leaves = [torch.nn.Parameter(w) for w in unflatten(p_s, tr.schema).values()]
    tree = FusedAdam(leaves, lr=tr.opt.lr, betas=(tr.opt.beta1, tr.opt.beta2),
                     eps=tr.opt.eps, weight_decay=tr.opt.weight_decay)
    t0 = int(step0)
    for leaf, g, m, v in zip(leaves, *(unflatten(x, tr.schema).values()
                                       for x in (tr.flat_g, m_s, v_s))):
        leaf.grad = g
        tree.state[leaf] = {"step": t0, "exp_avg": m, "exp_avg_sq": v}
    moved = (p_s - tr.flat_p).abs().max().item()
    tree.step()
    gap = (p_s - tr.flat_p).abs().max().item()
    log(f"  one step, superblock (K8) vs tree FusedAdam from the same state: "
        f"max |dw| {gap:.3e} (tol {FLAT_TREE_TOL:.0e}); the step moved a "
        f"weight by up to {moved:.3e}")
    if not (gap <= FLAT_TREE_TOL and moved > 10 * FLAT_TREE_TOL):
        raise AssertionError("the superblock step disagrees with FusedAdam")
    return {"flat_vs_tree_max_abs_dw": gap, "flat_deterministic": same,
            "flat_bucketed_spans": plan.num_buckets}


# -- phases 13-14: BERT-large training, padded and packed -------------------

# the toy: fp32, 2 layers, 2 heads of 64 (BERT-large's head dim), so that
# its attention runs the scalar K3/K4's d = 64 instance (the fp32 route)
TOY_BERT = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
                vocab_size=512, max_position_embeddings=128, bf16=False)
TOY_BERT_SEQS, TOY_BERT_SEQ, TOY_BERT_STEPS = 8, 128, 3
TOY_BERT_LR = 1e-3
# final weights, card vs CPU, absolute: fp32 sums in another order, which
# Adam turns into steps of a sizeable fraction of lr where a gradient is
# near zero; the CPU test of the same toy against JAX reads 5.8e-5 after
# three steps at this lr and holds 6e-4 (tests/test_torch_bert.py).  Three
# steps move a weight by up to 3e-3, so a skipped update fails it.
TOY_BERT_WEIGHT_TOL = 6e-4
# packed == padded on the real tokens (tests/L0/test_megatron_models.py's
# bar: rtol and atol 2e-5)
PACKED_TOL = 2e-5
LAYOUTS = (("padded", False), ("packed", True))


def toy_bert_run(device, state, batch, with_packing):
    """TOY_BERT_STEPS FusedAdam steps of the toy from ``state`` on
    ``device``: (losses, final weights on the CPU)."""
    model = BertModel(bert_large.bert_large_config(**TOY_BERT),
                      device=device)
    model.load_state_dict(state)
    opt = FusedAdam(model.parameters(), lr=TOY_BERT_LR)
    batch = {k: v.to(device) for k, v in batch.items()}
    losses = [float(bert_large.train_step(model, opt, batch, with_packing))
              for _ in range(TOY_BERT_STEPS)]
    return losses, {k: v.detach().cpu() for k, v in
                    model.state_dict().items()}


def real_token_losses(losses, lens, rows=None):
    """The per-token losses of the real tokens, sequence by sequence in
    the workload's order: padded rows one a sequence, or packed rows
    (``rows``: :func:`bert_large.bert_pack_rows`)."""
    if rows is None:
        return torch.cat([losses[i, :int(n)] for i, n in enumerate(lens)])
    parts = {}
    for r, idxs in enumerate(rows):
        at = 0
        for i in idxs:
            parts[i] = losses[r, at:at + int(lens[i])]
            at += int(lens[i])
    return torch.cat([parts[i] for i in range(len(lens))])


def packed_vs_padded(model, padded, packed, lens, seq) -> float:
    """Max gap of the packed per-token losses from the padded ones on the
    real tokens, checked against PACKED_TOL (rtol and atol)."""
    with torch.no_grad():
        l_pad = bert_large.bert_losses(model, padded, False)
        l_pack = bert_large.bert_losses(model, packed, True)
    got = real_token_losses(l_pack, lens, bert_large.bert_pack_rows(lens, seq))
    want = real_token_losses(l_pad, lens)
    gap = (got - want).abs()
    worst = (gap / (PACKED_TOL + PACKED_TOL * want.abs())).max().item()
    log(f"  packed vs padded per-token losses on {want.numel()} real tokens:"
        f" max diff {gap.max().item():.3e} (rtol = atol = {PACKED_TOL:.0e}:"
        f" worst {worst:.3f} of its bar)")
    if not worst <= 1.0:
        raise AssertionError("packed losses differ from the padded ones")
    return gap.max().item()


def phase_toy_bert() -> dict:
    cfg = bert_large.bert_large_config(**TOY_BERT)
    state = {k: v.clone() for k, v in
             BertModel(cfg, device="cpu").state_dict().items()}
    padded, packed, _, _ = bert_large.bert_batches(
        TOY_BERT_SEQS, TOY_BERT_SEQ, TOY_BERT["vocab_size"], device="cpu")
    L = TOY_BERT["num_layers"] * TOY_BERT_STEPS
    want = {"flash_qkv_fwd_d64": L, "flash_qkv_bwd_d64": L}
    out = {}
    for layout, packing in LAYOUTS:
        batch = padded if layout == "padded" else packed
        kernels.reset_launch_counts()
        on_card, w_card = toy_bert_run("cuda", state, batch, packing)
        launches = {k.symbol: k.launches for k in kernels.KERNELS
                    if k.launches}
        on_cpu, w_cpu = toy_bert_run("cpu", state, batch, packing)
        att_ran = {k: v for k, v in launches.items() if "qkv" in k}
        log(f"  toy BERT {layout}, fp32 launches over {TOY_BERT_STEPS} "
            f"steps {launches}")
        if att_ran != want:
            raise AssertionError(f"toy BERT {layout}: attention ran "
                                 f"{att_ran}, expected {want} (the scalar "
                                 "d = 64 instance, the fp32 route)")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
        w_err = max((w_card[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
        moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
        log(f"  toy BERT {layout}: losses cuda {on_card}, cpu {on_cpu}; "
            f"loss rel diff {loss_err:.3e} (tol {TOY_LOSS_TOL:.0e}); final "
            f"weights max diff {w_err:.3e} (tol {TOY_BERT_WEIGHT_TOL:.0e}); "
            f"the largest update on the CPU {moved:.3e}")
        if not (loss_err <= TOY_LOSS_TOL and w_err <= TOY_BERT_WEIGHT_TOL
                and moved > 2 * TOY_BERT_WEIGHT_TOL):
            raise AssertionError(f"toy BERT {layout}: card and CPU disagree")
        out[layout] = {"loss_rel_diff": loss_err, "weight_max_diff": w_err,
                       "launches": launches}
    model = BertModel(cfg, device="cuda")
    model.load_state_dict(state)
    out["packed_vs_padded_max_diff"] = packed_vs_padded(
        model, *({k: v.cuda() for k, v in b.items()}
                 for b in (padded, packed)),
        bert_large.bert_lengths(TOY_BERT_SEQS, TOY_BERT_SEQ), TOY_BERT_SEQ)
    return out


BERT_STEPS = 5
# kernel vs plain step, from the seeded weights (the step is bitwise
# deterministic, so the readings repeat): the loss at ten times its
# reading, the worst leaf at phase 7's bar, the grad norm at twice its
# reading; each planted fault of BERT_FAULTS must miss one.  Any change of
# bf16 rounding in the 24-layer body moves the step's gradients by ~2 % a
# leaf (median) at these weights: the plain versions as much as the
# kernels, each ~2 % from the same step in fp32, the fp32 MLM head's
# leaves too (NVIDIA H100 80GB HBM3, 700 W)
BERT_PLAIN_LOSS_TOL = 5e-4       # absolute, on a loss near 10.5 (read 5.05e-5)
BERT_PLAIN_NORM_TOL = 1.5e-3     # relative, global grad norm (read 7.39e-4)
BERT_PLAIN_LEAF_TOL = 5e-2       # relative, the worst leaf (read 2.30e-2)
# the kernel step's median leaf gap from the same step in an fp32 model,
# over the plain step's (read 0.981 padded, 0.960 packed); a kernel that
# added an error of its own throughout would raise it
BERT_FP32_RATIO_TOL = 1.25
# the step's parts: the fp32 GEMMs of the MLM head (TF32 off) apart from
# the body's bf16 ones
BERT_KINDS = STEP_KINDS[:6] + (
    ("sgemm", "GEMMs fp32 (MLM head)"),
    ("f32f32_f32f32", "GEMMs fp32 (MLM head)"),
    ("_sss_", "GEMMs fp32 (MLM head)")) + STEP_KINDS[6:]


def bert_loss_and_grads(model, batch, packing):
    loss = bert_large.bert_loss(model, batch, packing)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach().item(), grads


def leaf_gaps(grads, ref) -> dict:
    """|g - g_ref| / |g_ref| of every gradient leaf."""
    return {n: ((grads[n] - g).norm() / g.norm()).item()
            for n, g in ref.items()}


def drop_head_dk(d=BERT_D):
    """A planted K4 fault, the checks' control: head 0's dK zeroed in
    every layer's backward (head dim ``d``)."""
    real = att._flash_qkv_bwd_cuda

    def faulty(qkv, *args, **kw):
        dqkv = real(qkv, *args, **kw)
        b, s, _ = qkv.shape
        dqkv.view(b, s, -1, 3, d)[:, :, 0, 1] = 0  # head, (q k v), d
        return dqkv
    return mock.patch.object(att, "_flash_qkv_bwd_cuda", faulty)


def ignore_ids():
    """A planted K3/K4 fault, the checks' control: the kernels drop their
    segment ids, so every query sees every key of its row (the pads, the
    other packed sequences)."""
    fwd, bwd = att._flash_qkv_fwd_cuda, att._flash_qkv_bwd_cuda
    return mock.patch.multiple(
        att, _flash_qkv_fwd_cuda=lambda qkv, sq, sk, *a: fwd(
            qkv, None, None, *a),
        _flash_qkv_bwd_cuda=lambda qkv, dctx, ctx, lse, sq, sk, *a: bwd(
            qkv, dctx, ctx, lse, None, None, *a))


BERT_FAULTS = (("head 0's dK dropped", drop_head_dk),
               ("segment ids dropped", ignore_ids))


def step_gaps(run, ref, fp32_leaf_ref) -> dict:
    """One step ``run`` (loss, grads) against the plain step ``ref``: the
    loss gap, the global grad norm's relative gap, the worst leaf's
    relative gap; and its median leaf gap from the fp32 step over the
    plain step's (``fp32_leaf_ref``: (fp32 grads, the plain step's median
    leaf gap from them)).  ``failed`` names the bars it misses."""
    (loss, grads), (ref_loss, ref_grads) = run, ref
    grads32, plain32 = fp32_leaf_ref
    norm = multi_tensor_l2norm(list(grads.values())).item()
    ref_norm = multi_tensor_l2norm(list(ref_grads.values())).item()
    leaf = leaf_gaps(grads, ref_grads)
    worst = max(leaf, key=leaf.get)
    out = {"loss_diff": abs(loss - ref_loss),
           "grad_norm_rel_diff": abs(norm - ref_norm) / ref_norm,
           "worst_leaf": worst, "worst_leaf_rel_diff": leaf[worst],
           "median_leaf_rel_diff": statistics.median(leaf.values()),
           "fp32_gap_ratio": statistics.median(
               leaf_gaps(grads, grads32).values()) / plain32}
    out["failed"] = [name for name, key, tol in (
        ("loss", "loss_diff", BERT_PLAIN_LOSS_TOL),
        ("grad norm", "grad_norm_rel_diff", BERT_PLAIN_NORM_TOL),
        ("worst leaf", "worst_leaf_rel_diff", BERT_PLAIN_LEAF_TOL),
        ("fp32 ratio", "fp32_gap_ratio", BERT_FP32_RATIO_TOL))
        if not out[key] <= tol]
    return out


def log_gaps(what, g) -> None:
    log(f"  {what}: loss diff {g['loss_diff']:.3e} (tol "
        f"{BERT_PLAIN_LOSS_TOL:.1e}); grad norm rel diff "
        f"{g['grad_norm_rel_diff']:.3e} (tol {BERT_PLAIN_NORM_TOL:.1e}); "
        f"worst leaf {g['worst_leaf']} {g['worst_leaf_rel_diff']:.3e} (tol "
        f"{BERT_PLAIN_LEAF_TOL:.0e}), median leaf "
        f"{g['median_leaf_rel_diff']:.3e}; median leaf gap from the fp32 "
        f"step over the plain step's {g['fp32_gap_ratio']:.3f} (tol "
        f"{BERT_FP32_RATIO_TOL}); bars missed: {g['failed'] or 'none'}")


def bert_step_gaps(model, model32, batch, packing) -> dict:
    """One step's loss and gradients through the kernels, and through the
    kernels with each planted fault of ``BERT_FAULTS``, against the same
    step through the plain versions, from the same weights
    (:func:`step_gaps`; ``model32``: an fp32 model the weights are loaded
    into)."""
    patches = plain_kernels()
    with patches[0], patches[1]:
        ref = bert_loss_and_grads(model, batch, packing)
    model32.load_state_dict(model.state_dict())
    grads32 = bert_loss_and_grads(model32, batch, packing)[1]
    fp32_ref = (grads32, statistics.median(leaf_gaps(ref[1],
                                                     grads32).values()))
    out = {"kernels": step_gaps(bert_loss_and_grads(model, batch, packing),
                                ref, fp32_ref)}
    for name, fault in BERT_FAULTS:
        with fault():
            out[name] = step_gaps(bert_loss_and_grads(model, batch, packing),
                                  ref, fp32_ref)
    return out


def bert_vs_plain(model, model32, batch, packing, layout) -> dict:
    """The kernel step within every bar against the plain step; each
    planted fault outside one at least, so the bars can see a kernel
    fault."""
    gaps = bert_step_gaps(model, model32, batch, packing)
    for what, g in gaps.items():
        log_gaps(f"{layout} step, {what} vs plain", g)
    if gaps["kernels"]["failed"]:
        raise AssertionError(f"BERT-large {layout} step: kernel path "
                             "disagrees with the plain path")
    caught = [what for what, _ in BERT_FAULTS if gaps[what]["failed"]]
    if len(caught) != len(BERT_FAULTS):
        raise AssertionError(f"BERT-large {layout} step: a planted fault "
                             "passes the kernel-vs-plain bars")
    return gaps


def bert_train(layout, batch, packing, expect, want) -> dict:
    """BERT_STEPS steps on one fixed batch from the seeded weights: exact
    launch counts, finite and falling losses, step 1 near ``expect``; the
    step time, peak memory, a step's host enqueue vs device done time and
    its device time by kind."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt = bert_large.bert_setup()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(BERT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(bert_large.train_step(model, opt, batch,
                                                  packing)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    per_step = {k: v / BERT_STEPS for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {layout}: losses {losses}")
    log(f"  {layout}: launches over {BERT_STEPS} steps {launches}; per step "
        f"{per_step}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"BERT-large {layout}: non-finite loss")
    if abs(losses[0] - expect) > STEP_LOSS_TOL:
        raise AssertionError(f"BERT-large {layout}: step 1 loss {losses[0]} "
                             f"is not within {STEP_LOSS_TOL} of {expect:.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"BERT-large {layout}: the loss does not fall "
                             "on a fixed batch")
    if per_step != want:
        raise AssertionError(f"BERT-large {layout}: launch counts do not "
                             "match the main path")
    enqueue, done = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bert_large.train_step(model, opt, batch, packing)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    prof = step_profile(lambda: bert_large.train_step(model, opt, batch,
                                                      packing), BERT_KINDS)
    out = {"step_ms_p50": statistics.median(times[1:]), "losses": losses,
           "peak_mem_gib": peak, "launches": launches,
           "launches_per_step": per_step,
           "step_enqueue_ms": statistics.median(enqueue),
           "step_done_ms": statistics.median(done), "step_profile": prof}
    log(f"  {layout}: step {out['step_ms_p50']:.1f} ms (median of steps "
        f"2-{BERT_STEPS}), peak {peak:.2f} GiB; one step: host enqueue "
        f"{out['step_enqueue_ms']:.1f} ms, device done "
        f"{out['step_done_ms']:.1f} ms (medians of 3)")
    if prof["device_busy_ms"] > 0:
        log(f"  {layout} step under torch.profiler: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
        for name, n, t in prof["top_kernels"]:
            log(f"    {t:8.2f} ms  x{n:<5d} {name}")
        log_other_ops(prof)
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(breakdown not measured)")
    return out


def phase_bert_large(smi: str) -> dict:
    L, H, V = bert_large.BERT_L, bert_large.BERT_H, bert_large.BERT_V
    # bf16: the tensor-core K3/K4 at head dim 64 (not the d = 128 instance
    # nor the scalar route) and layer_norm_sm90.cu's K6/K7, the MLM head's
    # fp32 LayerNorm included: remat attn_res runs K3 once a layer, K4
    # once, K6 twice a layer forward and twice in the recompute plus the
    # head's, K7 twice a layer plus the head's
    want = {"flash_qkv_fwd_sm90_d64": L, "flash_qkv_bwd_sm90_d64": L,
            "layer_norm_fwd_sm90": 4 * L + 1,
            "layer_norm_bwd_sm90": 2 * L + 1}
    padded, packed, n_real, seq_sq = bert_large.bert_batches()
    batches = {"padded": padded, "packed": packed}
    # at init the MLM head's LayerNorm gives each token unit variance over
    # H = 1024, the tied embedding is N(0, 0.02^2): Gaussian logits of
    # variance v = 0.02^2 x 1024, whose cross entropy on random labels
    # averages ln(vocab) + v / 2 = 10.329 + 0.205
    expect = math.log(V) + 0.02 ** 2 * H / 2
    flops = bert_large.bert_analytic_flops(n_real, seq_sq)
    out = {"rows": {k: int(b["tokens"].shape[0]) for k, b in
                    batches.items()},
           "real_tokens": n_real, "seq_sq_sum": seq_sq,
           "model_flops": flops, "card": smi}
    for layout, packing in LAYOUTS:
        run = bert_train(layout, batches[layout], packing, expect, want)
        run["tok_per_s"] = n_real / run["step_ms_p50"] * 1e3
        run["model_tflops"] = flops / run["step_ms_p50"] / 1e9
        out[layout] = run
    out["bert_varlen_vs_padded_speedup"] = (out["padded"]["step_ms_p50"]
                                            / out["packed"]["step_ms_p50"])
    log("  bert " + json.dumps({
        "padded_ms": out["padded"]["step_ms_p50"],
        "packed_ms": out["packed"]["step_ms_p50"],
        "real_tok_per_s": {k: out[k]["tok_per_s"] for k in batches},
        "model_tflops": {k: out[k]["model_tflops"] for k in batches},
        "bert_varlen_vs_padded_speedup":
            out["bert_varlen_vs_padded_speedup"],
        "peak_mem_gib": {k: out[k]["peak_mem_gib"] for k in batches},
        "real_tokens": n_real, "model_flops": flops, "card": smi}))
    torch.cuda.empty_cache()

    # kernels (and the planted faults) vs plain versions, one step from
    # the seeded weights
    model, _ = bert_large.bert_setup()
    model32 = BertModel(bert_large.bert_large_config(bf16=False))
    for layout, packing in LAYOUTS:
        out[layout]["vs_plain"] = bert_vs_plain(model, model32,
                                                batches[layout], packing,
                                                layout)
    del model, model32
    torch.cuda.empty_cache()

    # determinism: the same step twice from the same state
    for layout, packing in LAYOUTS:
        def one_step():
            m, o = bert_large.bert_setup()
            loss = bert_large.train_step(m, o, batches[layout], packing)
            return float(loss), [p.detach().clone() for p in m.parameters()]

        loss1, w1 = one_step()
        torch.cuda.empty_cache()
        loss2, w2 = one_step()
        same = loss1 == loss2 and all(torch.equal(x, y)
                                      for x, y in zip(w1, w2))
        del w1, w2
        torch.cuda.empty_cache()
        log(f"  {layout}: the same step twice from the same state: losses "
            f"{loss1!r} / {loss2!r}, weights bitwise equal: {same}")
        if not same:
            raise AssertionError(f"BERT-large {layout} step is not "
                                 "deterministic")
        out[layout]["deterministic"] = same
    return out


# -- phase 12: the bench's roofs and floor (K9, K10) and the kernel
# microbenches ---------------------------------------------------------------

# K10 at three shapes (bh, s, d, block_q, block_k): bench.py's microbench;
# K3/K4's GPT-1.3B attention at the port's key tile of 64
# (csrc/flash_tile.cuh); K1/K2's Transformer-big encoder
DOT_SHAPES = (
    ("bench", (128, 1024, 64, 512, 512)),
    ("GPT-1.3B (K3/K4)", (TRAIN["b"] * TRAIN["heads"], TRAIN["s"],
                          TRAIN["d"], 64, 64)),
    ("Transformer-big encoder (K1/K2)", (MHA["batch"] * MHA["heads"],
                                        MHA["src"],
                                        MHA["hidden"] // MHA["heads"], 64,
                                        64)),
)
# K10's new route at the edges of its walk, each at head dims 64 and 128
# (q tiles of 128 and 192 rows): q tails (s = 192: half the last 128-row
# tile past s, none of a 192-row one; s = 320: the last warpgroup of
# either tile past s), and blocks that differ (warpgroups of a tile
# keeping one prefix, or prefixes 128 keys apart; at s = 512 a 192-row
# tile's last warpgroup also past s)
DOT_EDGE_SHAPES = tuple(
    (f"{what} d {d}", (8, s, d, bq, bk))
    for d in roofs.DOTS_HEAD_DIMS
    for what, s, bq, bk in (("q tail s 192", 192, 64, 64),
                            ("q tail s 320", 320, 64, 64),
                            ("bq < bk", 512, 64, 128),
                            ("bq > bk", 512, 128, 64)))
# the physical ceilings a demonstrated rate must stay under (a timer that
# lost a launch would read above them)
ROOF_SLACK = 1.05


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


def hbm_copy_checks(gen) -> tuple:
    """K9 bit for bit against its plain version: the roof's 16384 x 8192
    fp32 buffer; a ragged bf16 length (2^20 + 3 elements: a 6-byte tail).
    A destination 2 bytes off 16-byte alignment is refused before any
    launch.  Returns (max |kernel - plain|, the roof's buffer)."""
    x = torch.randn(16384, 8192, generator=gen, device="cuda")
    got = roofs.hbm_copy(x)
    ref = roofs._hbm_copy_plain(x, None)
    torch.cuda.synchronize()
    check_bitwise("hbm_copy [16384, 8192] fp32 vs plain", (bits(got),),
                  (bits(ref),))
    err = (got - ref).abs().max().item()
    del got, ref
    r = torch.randn(2 ** 20 + 3, generator=gen, device="cuda").to(
        torch.bfloat16)
    check_bitwise("hbm_copy [2^20 + 3] bf16 (byte tail) vs plain",
                  (bits(roofs.hbm_copy(r)),),
                  (bits(roofs._hbm_copy_plain(r, None)),))
    out = torch.zeros(r.numel() + 1, dtype=r.dtype, device="cuda")[1:]
    launches = kernels.HBM_COPY.launches
    try:
        roofs.hbm_copy(r, out)
    except ValueError as e:
        log(f"  hbm_copy into a destination 2 bytes off alignment: refused "
            f"({e})")
    else:
        raise AssertionError("hbm_copy took a misaligned destination")
    if kernels.HBM_COPY.launches != launches:
        raise AssertionError("hbm_copy launched on a misaligned destination")
    return err, x


def old_dots(q, k, v, bq, bk) -> torch.Tensor:
    """K10's route before ``attention_dots_sm90.cu``: ``attention_dots.cu``
    (``mma.sync``) called through its ``Kernel`` object, as the wrapper
    called it."""
    bh, s, d = q.shape
    o = torch.empty_like(q)
    kernels.ATTENTION_DOTS(q.device.index, q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), o.data_ptr(), bh, s, d, bq, bk,
                           torch.cuda.current_stream().cuda_stream)
    return o


def check_dots_visits(name, visits, bh, s, d, bq, bk) -> None:
    """The 64 x 64 sub-tiles each block of ``attention_dots_sm90.cu``
    multiplied, against its walk as :func:`roofs.dots_walk` states it, and
    their sum against the pairs the skip rule keeps."""
    want = torch.tensor([sum(map(len, wgs))
                         for wgs in roofs.dots_walk(s, bq, bk, d)],
                        dtype=torch.int32)
    got = visits.view(bh, -1).cpu()
    pairs = roofs.dots_pairs(s, bq, bk)
    ok = (bool((got == want).all())
          and bool((got.sum(1) * 4096 == pairs).all()))
    log(f"  {name}: sub-tiles {int(got[0].sum())} a batch-head, the rule's "
        f"pairs / 4096 = {pairs // 4096}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the sub-tiles multiplied "
                             f"{got[0].tolist()} are not the walk's "
                             f"{want.tolist()}")


def dots_case(gen, what, shape, old=True) -> tuple:
    """K10's kernel (``attention_dots_sm90.cu``, through the wrapper)
    against its plain version within ``tolerance`` (bf16), its sub-tiles
    against the walk, and run twice, bitwise; with ``old``, the route before
    it (``attention_dots.cu``) against the plain version too.  Returns
    (error of the new route, of the old one or None, the operands)."""
    bh, s, d, bq, bk = shape
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    visits = torch.full((roofs.dots_visits_len(bh, s, d),), -1,
                        dtype=torch.int32, device="cuda")
    o = roofs._attention_dots_cuda(q, k, v, bq, bk, visits=visits)
    ref = roofs._attention_dots_plain(q, k, v, bq, bk)
    torch.cuda.synchronize()
    name = f"attention_dots_sm90 {what} [{bh}, {s}, {d}] blocks ({bq}, {bk})"
    err = check(name, o, ref)
    check_dots_visits(name, visits, bh, s, d, bq, bk)
    check_bitwise(f"{name} run twice", (o,),
                  (roofs.attention_dots(q, k, v, bq, bk),))
    err_old = None
    if old:
        err_old = check(f"attention_dots.cu {what} (the route before)",
                        old_dots(q, k, v, bq, bk), ref)
    del ref
    return err, err_old, (q, k, v)


def sass_count(source: str, opcode: str) -> int:
    """Lines of one instruction (``HMMA``: ``mma.sync`` on the tensor cores,
    ``HGMMA``: ``wgmma``, ``UTMALDG``: a TMA load; a regular expression,
    matched as a word) in the SASS of a built source's library, from
    ``cuobjdump -sass``."""
    tool = kernels._build.cuda_tool("cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(kernels._build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    return sum(re.search(rf"\b{opcode}\b", line) is not None
               for line in sass.splitlines())


def sass_functions(source: str) -> dict:
    """The SASS of a built source's library split by kernel instance:
    {demangled name: its SASS text} (``cuobjdump -sass``)."""
    tool = kernels._build.cuda_tool("cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(kernels._build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = demangle(line.split("Function :")[1].strip())
            out[name] = ""
        elif name is not None:
            out[name] += line + "\n"
    return out


#: the kernels of each packed tensor-core source with the tensor-core
#: products (K4's delta pass has none), each built causal and not, with
#: dropout and without, at every (head dim, 16-bit type) of
#: QKV_INSTANCE_TYPES
D64_INSTANCES = {"flash_qkv_fwd_sm90.cu": ("qkv_fwd_sm90",),
                 "flash_qkv_bwd_sm90.cu": ("qkv_bwd_dkdv_sm90",
                                           "qkv_bwd_dq_sm90")}
#: (head dim, template type, label): BERT-large's head dim 64 in bf16, and
#: amp's fp16 at head dims 128 (GPT) and 64
QKV_INSTANCE_TYPES = ((64, "__nv_bfloat16", "d64"), (128, "__half", "f16"),
                      (64, "__half", "d64_f16"))


def is_instance(name: str, kernel: str, d: int, type_: str) -> bool:
    """``name`` (demangled, or mangled where c++filt is missing) is an
    instance of ``kernel`` at head dim ``d`` and 16-bit type ``type_``
    (the template's last argument)."""
    if name.startswith(f"{kernel}<{d},"):
        return name.rstrip().endswith(f"{type_}>")
    return (f"{len(kernel)}{kernel}ILi{d}E" in name
            and f"{len(type_)}{type_}" in name)


def typed_instance_checks(src: str, report: list) -> dict:
    """The head-dim-64 bf16 instances and the fp16 instances of a packed
    tensor-core source: all four of each kernel built at each
    :data:`QKV_INSTANCE_TYPES` entry (causal and not, dropout and not),
    and each one's own SASS holding wgmma (``HGMMA``) and TMA loads
    (``UTMALDG``); their spills are held by the source-wide check."""
    sass = sass_functions(src)
    out = {}
    for d, type_, label in QKV_INSTANCE_TYPES:
        out[label] = {}
        for kernel in D64_INSTANCES[src]:
            regs = [r for fn, r, _, _ in report
                    if is_instance(demangle(fn), kernel, d, type_)]
            ops = {n: {op: sum(re.search(rf"\b{op}\b", line) is not None
                               for line in text.splitlines())
                       for op in ("HGMMA", "UTMALDG")}
                   for n, text in sass.items()
                   if is_instance(n, kernel, d, type_)}
            log(f"    {kernel} at head dim {d}, {type_}: {len(regs)} "
                f"instances, registers {min(regs or [0])}..{max(regs or [0])}"
                "; SASS " + "; ".join(
                    f"{n} HGMMA {c['HGMMA']} UTMALDG {c['UTMALDG']}"
                    for n, c in sorted(ops.items())))
            if len(regs) != 4 or len(ops) != 4:
                raise AssertionError(
                    f"{src}: {kernel} has {len(regs)} instances at head dim "
                    f"{d}, {type_} in ptxas's report and {len(ops)} in the "
                    "SASS, expected 4")
            if not all(c["HGMMA"] and c["UTMALDG"] for c in ops.values()):
                raise AssertionError(f"{src}: an instance of {kernel} at "
                                     f"head dim {d}, {type_} lacks HGMMA or "
                                     f"UTMALDG ({ops})")
            out[label][kernel] = dict(instances=len(regs),
                                      max_registers=max(regs), sass=ops)
    return out


SM90_SOURCES = ("flash_qkv_fwd_sm90.cu", "flash_qkv_bwd_sm90.cu",
                "flash_bwd_sm90.cu", "flash_fwd_sm90.cu",
                "attention_dots_sm90.cu")
#: the sources held to no spill and no stack: the tensor-core ones, K6/K7's,
#: whose rows and dgamma/dbeta sums live in registers, and K5's, whose
#: lanes hold q, a tile's K/V vectors and their partial sums in registers
SPILL_FREE_SOURCES = SM90_SOURCES + ("layer_norm_sm90.cu",
                                     "flash_decode_sm90.cu")
#: the instructions each source's SASS must hold: wgmma (HGMMA) and TMA
#: loads (UTMALDG) in the tensor-core sources; 16-byte global loads of the
#: pool's K/V rows in K5's
#: (as a name and the pattern ``sass_count`` searches for)
SASS_WANT = {**{src: {"HGMMA": "HGMMA", "UTMALDG": "UTMALDG"}
                for src in SM90_SOURCES},
             "flash_decode_sm90.cu": {"LDG.E.128": r"LDG\.E(?:\.\w+)*\.128"}}


def sm90_build_checks() -> dict:
    """The tensor-core sources (K3/K4's, K2's and K1's bf16 routes, K10's),
    ``layer_norm_sm90.cu`` (K6/K7) and ``flash_decode_sm90.cu`` (K5) as
    built: every instance free of spills and stack in ``ptxas -v``'s
    report, and each source's SASS holding the instructions of
    :data:`SASS_WANT`."""
    out = {}
    for src in SPILL_FREE_SOURCES:
        text = kernels.build_log.get(src)
        if text is None:  # built by an earlier run: ask ptxas again
            out_so = kernels._build.BUILD_DIR / f"{src}.report.so"
            text = subprocess.run(
                [kernels._build.cuda_tool(), *kernels._build.NVCC_FLAGS,
                 "-o", str(out_so), str(kernels._build.CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                check=True).stdout
            out_so.unlink()
        report = ptxas_report(text)
        spills = [(demangle(fn), stack, spill)
                  for fn, _, stack, spill in report if stack or spill]
        regs = [r for _, r, _, _ in report] or [0]
        counts = {op: sass_count(src, rx)
                  for op, rx in SASS_WANT.get(src, {}).items()}
        log(f"  {src}: {len(report)} instances, registers {min(regs)}.."
            f"{max(regs)}, spills or stack in {len(spills)}"
            + "".join(f"; SASS {n} {op}" for op, n in counts.items()))
        for line in text.splitlines():   # e.g. wgmma serialized by ptxas
            if "Performance Loss" in line:
                log(f"    {line.strip()}")
        if spills or not report:
            raise AssertionError(f"{src}: ptxas reports spills {spills}")
        if not all(counts.values()):
            raise AssertionError(f"{src}: its SASS lacks an instruction of "
                                 f"{list(counts)} ({counts})")
        out[src] = dict(counts, instances=len(report), max_registers=max(regs))
        if src in D64_INSTANCES:
            out[src].update(typed_instance_checks(src, report))
    return out


def time_hbm_copy(x) -> dict:
    y = torch.empty_like(x)
    ms = cold_ms(lambda: roofs.hbm_copy(x, y))
    plain_ms = cold_ms(lambda: roofs._hbm_copy_plain(x, None))
    lib_ms = cold_ms(lambda: y.copy_(x))    # a device-to-device memcpy
    nbytes = roofs.copy_bytes(x)
    bound_ms, bound_by = bound(nbytes, 0, torch.float32)
    log(f"  hbm_copy timing {list(x.shape)} fp32: kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e9:.3f} TB/s), plain (clone) {plain_ms:.4f}, "
        f"copy_ {lib_ms:.4f} ({nbytes / lib_ms / 1e9:.3f} TB/s), bound "
        f"{bound_ms:.4f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def time_dots(what, shape, q, k, v) -> dict:
    """K10 timed cold beside its plain version, its bound from the executed
    pairs, and cuBLAS's reading: two ``torch.bmm`` over the DENSE pair
    (more work than the kernel's: no tile is skipped, no scale); the route
    before it (``attention_dots.cu``) cold, and the two in turns
    (``timing.timed_pair``, warm)."""
    bh, s, d, bq, bk = shape
    ms = cold_ms(lambda: roofs.attention_dots(q, k, v, bq, bk))
    old_ms = cold_ms(lambda: old_dots(q, k, v, bq, bk))
    pair = timing.timed_pair(old_dots, roofs.attention_dots,
                             (q, k, v, bq, bk), (q, k, v, bq, bk))
    plain_ms = cold_ms(lambda: roofs._attention_dots_plain(q, k, v, bq, bk),
                       5, 1)
    lib_ms = cold_ms(lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v))
    pairs = bh * roofs.dots_pairs(s, bq, bk)
    executed = 4 * d * pairs
    bound_ms, bound_by = bound(4 * q.numel() * q.element_size(), executed)
    dense = 4 * bh * s * s * d
    log(f"  attention_dots timing {what} [{bh}, {s}, {d}] blocks ({bq}, "
        f"{bk}): kernel {ms:.4f} ms ({executed / ms / 1e9:.1f} TFLOP/s "
        f"executed, {roofs.dots_flops(bh, s, d) / ms / 1e9:.1f} under the "
        f"JAX count; {pairs / (bh * s * s):.4f} of the dense pairs; "
        f"{bound_ms / ms:.1%} of its bound), plain "
        f"{plain_ms:.4f}, two dense torch.bmm {lib_ms:.4f} "
        f"({dense / lib_ms / 1e9:.1f} TFLOP/s, {dense / executed:.2f}x the "
        f"work), bound {bound_ms:.4f} ({bound_by}); attention_dots.cu (the "
        f"route before) {old_ms:.4f} ({executed / old_ms / 1e9:.1f} TFLOP/s "
        f"executed); in turns (timed_pair, warm): attention_dots.cu "
        f"{pair[0]:.4f} vs attention_dots_sm90.cu {pair[1]:.4f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, executed_flops=executed,
                old_ms=old_ms, pair_old_ms=pair[0], pair_ms=pair[1],
                library_note="two torch.bmm over the dense pair, "
                             f"{dense / executed:.2f}x the kernel's work")


def phase_roofs(smi: str) -> dict:
    """K9 and K10 against their plain versions (K10's new route also at the
    edges of its walk, its sub-tiles against the walk; the route before it
    at the three shapes), the tensor-core instructions of K10's route
    before, K1/K2 and K6/K7 against theirs at the microbenches' shapes;
    then the main path, bench.py's kernel-microbench path, with exact
    launch counts; then the kernel rows, timed cold, K10's two routes also
    in turns."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    err9, x = hbm_copy_checks(gen)
    cases = {what: dots_case(gen, what, shape) for what, shape in DOT_SHAPES}
    for what, shape in DOT_EDGE_SHAPES:
        dots_case(gen, what, shape, old=False)
    hmma = sass_count("attention_dots.cu", "HMMA")
    log(f"  attention_dots.cu (the route before) SASS: {hmma} HMMA "
        f"(mma.sync) instructions")
    if hmma == 0:
        raise AssertionError("attention_dots.cu runs no tensor-core "
                             "instruction")
    # the microbenches' kernels at shapes they have not run at elsewhere
    for bh, s, d in ((128, 1024, 64), (16, 4096, 128)):
        generic_case(gen, f"microbench causal [{bh}, 1, {s}, {d}] bf16", bf16,
                     s, s, b=bh, d=d, h=1, causal=True)
        torch.cuda.empty_cache()
    layer_norm_case(gen, "bf16 x [16384, 4096] (the LN microbench's)", bf16,
                    rows=microbench.LN_ROWS, cols=microbench.LN_COLS)
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    hbm = roofs.hbm_roof()
    mm = roofs.matmul_roof()
    att_s1024 = microbench.attention_kernel(128, 1024, 64, 512, 512,
                                            measure_floor=True)
    att_s4096 = microbench.attention_kernel(16, 4096, 128, 512, 512)
    lnk = microbench.layer_norm_kernel()
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    for att_k in (att_s1024, att_s4096):   # as bench.py::main adds them
        att_k.update(fwd_frac_of_roof=att_k["fwd_tflops"] / mm,
                     fwdbwd_frac_of_roof=att_k["fwdbwd_tflops"] / mm)
    calls = timing.WARM + timing.STEPS
    pingpongs = 2 * (timing.WARM + timing.ROOF_STEPS)  # two roofs, two copies
    want = {"hbm_copy": 2 * pingpongs, "attention_dots_sm90": calls,
            "flash_fwd_sm90": 2 * 3 * calls, "flash_bwd_sm90": 2 * calls,
            "layer_norm_fwd_sm90": 4 * calls, "layer_norm_bwd_sm90": 2 * calls}
    log(f"  hbm_roof {hbm:.1f} GB/s  [{smi}]")
    log(f"  matmul_roof {mm:.1f} TFLOP/s  [{smi}]")
    log(f"  attention_kernel(128, 1024, 64, 512, 512, measure_floor=True) "
        f"{json.dumps(att_s1024)}  [{smi}]")
    log(f"  attention_kernel(16, 4096, 128, 512, 512) "
        f"{json.dumps(att_s4096)}  [{smi}]")
    log(f"  layer_norm_kernel() {json.dumps(lnk)}  [{smi}]")
    log(f"  launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError("the microbench path's launch counts do not "
                             "match its calls")
    results = [hbm, mm, *att_s1024.values(), *att_s4096.values(),
               *lnk.values()]
    sane = (all(math.isfinite(r) and r > 0 for r in results)
            and hbm <= ROOF_SLACK * HBM_BYTES_PER_S / 1e9
            and lnk["adjacent_hbm_gb_s"] <= ROOF_SLACK * HBM_BYTES_PER_S / 1e9
            and mm <= ROOF_SLACK * PEAK_FLOPS[bf16] / 1e12
            and att_s1024["dot_floor_executed_tflops"]
            <= ROOF_SLACK * PEAK_FLOPS[bf16] / 1e12)
    if not sane:
        raise AssertionError("a roof, floor or rate is not finite and "
                             "positive, or exceeds the card's data sheet")

    rows = {"hbm_copy": time_hbm_copy(x)}
    del x
    torch.cuda.empty_cache()
    for what, shape in DOT_SHAPES:
        err, err_old, ops = cases.pop(what)
        rows[what] = time_dots(what, shape, *ops)
        rows[what].update(max_abs_err=err, old_max_abs_err=err_old)
        del ops
        torch.cuda.empty_cache()
    rows["hbm_copy"]["max_abs_err"] = err9
    # the route before, launched only to be compared: its timed calls
    launches["attention_dots (comparison)"] = kernels.ATTENTION_DOTS.launches
    return {"rows": rows, "launches": launches, "hbm_roof_gb_s": hbm,
            "matmul_roof_tflops": mm, "flash_attention_s1024": att_s1024,
            "flash_attention_s4096": att_s4096, "layer_norm": lnk,
            "hmma": hmma, "card": smi}


# the attention rows at one of K10's shapes (DOT_SHAPES: the same bh, s
# and d)
FLOOR_OF = {"flash_qkv_fwd_sm90": "GPT-1.3B (K3/K4)",
            "flash_qkv_bwd_sm90": "GPT-1.3B (K3/K4)",
            "flash_qkv_fwd": "GPT-1.3B (K3/K4)",
            "flash_qkv_bwd": "GPT-1.3B (K3/K4)",
            "flash_qkv_fwd_sm90_f16": "GPT-1.3B (K3/K4)",
            "flash_qkv_bwd_sm90_f16": "GPT-1.3B (K3/K4)",
            "flash_fwd_sm90_mha": "Transformer-big encoder (K1/K2)",
            "flash_fwd_mha": "Transformer-big encoder (K1/K2)",
            "flash_bwd_sm90": "Transformer-big encoder (K1/K2)",
            "flash_bwd": "Transformer-big encoder (K1/K2)"}


def demonstrated(timings: dict, probes: dict) -> dict:
    """Each kernel row's least time as demonstrated on this card in this
    run, beside its data-sheet bound: for an attention row at a K10 shape,
    the row's own flops (its visible pairs, 4 d each forward, 10 d
    backward) at the rate K10 reached on the pairs it executed there, and
    the same flops at ``matmul_roof``'s rate (cuBLAS, 8192^3 bf16); for
    any other row bound by bytes, its bytes over the HBM roof
    (``hbm_roof``, K9).  A row bound by operations at no K10 shape gets
    none.  K10 runs on ``wgmma`` fed by TMA, as K1-K4 do, without their
    softmax, so an attention row should not outrun its floor; a share
    above 100 % says the floor is still stale at that shape (logged, not
    hidden), and the matmul roof is the bar there."""
    roof = probes["hbm_roof_gb_s"] * 1e9
    mm_flops = probes["matmul_roof_tflops"] * 1e12
    out = {}
    for name, t in {**timings, "hbm_copy": probes["rows"]["hbm_copy"]}.items():
        extra = {}
        if name in FLOOR_OF:
            k10 = probes["rows"][FLOOR_OF[name]]
            work = t["flops"] / k10["executed_flops"]
            ms = work * k10["ms"]
            by = (f"dot floor x {work:.4f}, its flops over K10's executed "
                  f"({FLOOR_OF[name]})")
            mm_ms = t["flops"] / mm_flops * 1e3
            extra = dict(matmul_roof_ms=mm_ms,
                         share_of_matmul_roof=mm_ms / t["ms"])
        elif t["bound_by"] == "bytes":
            ms = t["bound_ms"] * HBM_BYTES_PER_S / roof
            by = "bytes at hbm_roof"
        else:
            continue
        out[name] = dict(demonstrated_ms=ms, demonstrated_by=by,
                         share_of_demonstrated=ms / t["ms"], **extra)
        log(f"  {name}: {t['ms']:.4f} ms; demonstrated least time "
            f"{ms:.4f} ms ({by}): {ms / t['ms']:.1%} of it; data-sheet "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}): "
            f"{t['bound_ms'] / t['ms']:.1%}")
        if extra:
            log(f"    its flops at matmul_roof ({mm_flops / 1e12:.1f} "
                f"TFLOP/s): {extra['matmul_roof_ms']:.4f} ms, "
                f"{extra['share_of_matmul_roof']:.1%} of it")
        if extra and ms > t["ms"]:
            log(f"    over 100 % of K10's floor: the wgmma floor is still "
                f"stale for {name} at this shape (the kernel outruns the "
                f"two products alone), not a limit")
    return out


# -- phase 17: GPT training under amp (O0, O2 in bf16 and fp16, dynamic
# loss scaling): the toy card vs CPU, then GPT-1.3B on the card ------------


def make_optimizer(name: str, params, lr: float):
    """The JAX harness's optimizers (``tests/L1/common/harness.py``):
    FusedAdam with weight decay 1e-4, FusedLAMB with its default 0.01,
    FusedSGD with momentum 0.9."""
    if name == "adam":
        return FusedAdam(params, lr=lr, weight_decay=1e-4)
    if name == "lamb":
        return FusedLAMB(params, lr=lr, weight_decay=0.01)
    return FusedSGD(params, lr=lr, momentum=0.9)


class AmpTrainer:
    """A GPT trained under amp as a user composes it (the JAX harness's
    ``run_trajectory`` recipe in the port's idiom): ``amp.initialize``;
    fp32 masters taken, then the model cast in place (O2: half but the
    LayerNorms); ``scaled_value_and_grad`` over the model's parameters;
    the optimizer's ``step_if_finite`` on the masters; ``copy_masters``
    back into the half parameters; ``scaler.update``.  Nothing in
    :meth:`step` reads the device on the host."""

    def __init__(self, cfg, level, half, opt_name, lr, device, seed=0,
                 state=None, scaler=None):
        self.amp = amp.initialize(level, half_dtype=half)
        self.scaler = scaler or self.amp.scaler
        self.model = GPTModel(cfg, device=device, seed=seed)
        if state is not None:
            self.model.load_state_dict(state)
        self.masters = self.amp.master_params(self.model)
        self.amp.cast_model(self.model)
        self.params = list(self.model.parameters())
        self.opt = make_optimizer(opt_name, self.masters, lr)
        self.ss = self.scaler.init(device)
        model = self.model   # not self: no reference cycle keeps a trainer
        self.grad_fn = amp.scaled_value_and_grad(
            lambda t, l: model(t, labels=l).mean(), self.scaler, self.params)

    def step(self, tokens, labels):
        """One step; returns (loss, finite), device tensors."""
        loss, grads, finite = self.grad_fn(self.ss, tokens, labels)
        self.opt.step_if_finite(finite, grads)
        del grads
        amp.copy_masters(self.params, self.masters)
        self.ss = self.scaler.update(self.ss, finite)
        return loss, finite

    def written(self) -> list:
        """(name, tensor) of every tensor a step writes: the half
        parameters, the fp32 masters, the optimizer's moments and its
        step count."""
        out = [(f"param {n}", p) for n, p in self.model.named_parameters()]
        names = [n for n, _ in self.model.named_parameters()]
        out += [(f"master {n}", m) for n, m in zip(names, self.masters)]
        for n, m in zip(names, self.masters):
            st = self.opt.state.get(m, {})
            out += [(f"{k} {n}", v) for k, v in st.items()
                    if k != "step" and isinstance(v, torch.Tensor)]
        step = self.opt.state.get(self.masters[0], {}).get("step")
        if isinstance(step, torch.Tensor):
            out.append(("step", step))
        return out


AMP_TOY = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
               vocab_size=256, max_position_embeddings=64,
               use_flash_attention=True)
AMP_TOY_BATCH, AMP_TOY_SEQ, AMP_TOY_STEPS = 4, 64, 4
AMP_LR = {"adam": 1e-3, "lamb": 1e-3, "sgd": 1e-2}
AMP_LEVELS = (("O0 fp32", "O0", torch.float32),
              ("O2 bf16", "O2", torch.bfloat16),
              ("O2 fp16", "O2", torch.float16))
# card vs CPU, each step's loss over four steps: O0 relative (fp32
# throughout, sums in another order; phase 6's bar, read 9.9e-8); O2
# absolute on a loss near 5.6 (the kernels round P, dS and the outputs to
# the half type where the plain versions keep fp32), ten times the
# largest gap read on an NVIDIA H100 80GB HBM3 at 700 W over the three
# optimizers: bf16 4.57e-4, fp16 2.48e-5
AMP_TOY_TOL = {"O0 fp32": 1e-5, "O2 bf16": 5e-3, "O2 fp16": 2.5e-4}
AMP_2_40_STEPS = 36      # from 2^40 down past 2^16, then finite steps


def amp_toy_batches(n):
    gen = torch.Generator().manual_seed(21)
    out = []
    for _ in range(n):
        ids = torch.randint(0, AMP_TOY["vocab_size"],
                            (AMP_TOY_BATCH, AMP_TOY_SEQ + 1), generator=gen)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def amp_toy_run(device, level, half, opt_name, state, batches, scaler=None):
    """Per step (loss, finite, loss scale after the update)."""
    flags = ({} if level == "O0" else
             {"bf16": half == torch.bfloat16, "fp16": half == torch.float16})
    tr = AmpTrainer(GPTConfig(**AMP_TOY, **flags), level, half, opt_name,
                    AMP_LR[opt_name], device, state=state, scaler=scaler)
    out = []
    for tokens, labels in batches:
        loss, finite = tr.step(tokens.to(device), labels.to(device))
        out.append((loss, finite, tr.ss.loss_scale))
    return [(float(a), bool(b), float(c)) for a, b, c in out]


def amp_toy_want(half) -> dict:
    """The toy step's exact launches (no remat): K3 and K4 once a layer,
    K6 and K7 2L + 1 (two LayerNorms a layer and the final one), the
    head-dim-64 instance of the dtype's route; LayerNorm width 128 takes
    layer_norm.cu."""
    L = AMP_TOY["num_layers"]
    qkv = {torch.float32: "flash_qkv_{}_d64",
           torch.bfloat16: "flash_qkv_{}_sm90_d64",
           torch.float16: "flash_qkv_{}_sm90_d64_f16"}[half]
    lnf = "_f16" if half == torch.float16 else ""
    return {qkv.format("fwd"): L, qkv.format("bwd"): L,
            f"layer_norm_fwd{lnf}": 2 * L + 1,
            f"layer_norm_bwd{lnf}": 2 * L + 1}


def phase_amp_toy() -> dict:
    state = GPTModel(GPTConfig(**AMP_TOY), device="cpu", seed=3).state_dict()
    # one batch, every step: the loss falls on it
    batches = amp_toy_batches(1) * AMP_TOY_STEPS
    out = {"launches": {}, "gaps": {}}
    for label, level, half in AMP_LEVELS:
        for opt_name in ("adam", "lamb", "sgd"):
            kernels.reset_launch_counts()
            card = amp_toy_run("cuda", level, half, opt_name, state, batches)
            launches = {k.symbol: k.launches for k in kernels.KERNELS
                        if k.launches}
            cpu = amp_toy_run("cpu", level, half, opt_name, state, batches)
            want = {k: v * AMP_TOY_STEPS for k, v in amp_toy_want(
                half).items()}
            gaps = [abs(a[0] - b[0]) / (abs(b[0]) if level == "O0" else 1.0)
                    for a, b in zip(card, cpu)]
            ok = (max(gaps) <= AMP_TOY_TOL[label]
                  and [a[1:] for a in card] == [b[1:] for b in cpu]
                  and launches == want and all(a[1] for a in card)
                  and card[-1][0] < card[0][0])
            log(f"  toy {label} {opt_name}: losses card "
                f"{[round(a[0], 5) for a in card]}, cpu "
                f"{[round(b[0], 5) for b in cpu]}; max "
                f"{'rel ' if level == 'O0' else ''}gap {max(gaps):.3e} (tol "
                f"{AMP_TOY_TOL[label]:.1e}); scales "
                f"{[a[2] for a in card]}; launches {launches}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"amp toy {label} {opt_name}: card and "
                                     f"CPU disagree, or the wrong kernels "
                                     f"ran (want {want})")
            out["launches"][f"{label} {opt_name}"] = launches
            out["gaps"][f"{label} {opt_name}"] = max(gaps)
    # from 2^40: every step skips until the scale has halved far enough
    many = amp_toy_batches(4) * (AMP_2_40_STEPS // 4)
    kernels.reset_launch_counts()
    card = amp_toy_run("cuda", "O2", torch.float16, "adam", state, many,
                       scaler=amp.LossScaler(init_scale=2.0 ** 40))
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    cpu = amp_toy_run("cpu", "O2", torch.float16, "adam", state, many,
                      scaler=amp.LossScaler(init_scale=2.0 ** 40))
    skipped = [i for i, a in enumerate(card) if not a[1]]
    same = [a[1:] for a in card] == [b[1:] for b in cpu]
    log(f"  toy O2 fp16 adam from 2^40: skipped steps {skipped}; scales "
        f"{[a[2] for a in card]}; card == cpu (skips and scales): {same}")
    # every step skips from 2^40 down to 2^20 at least; below that the
    # four batches part (one overflows at a scale another does not)
    if not (same and skipped[:20] == list(range(20))
            and card[-1][1] and len(skipped) < len(card)):
        raise AssertionError("amp toy from 2^40: the skips or scales differ "
                             "between card and CPU, or it never recovers")
    out["from_2_40"] = {"skipped": skipped, "launches": launches,
                        "scales": [a[2] for a in card]}
    return out


AMP_FULL_STEPS = 10
AMP_FULL_LR = {"adam": 1.5e-4, "lamb": 1e-3}
AMP_FULL_RUNS = (("fp16 FusedLAMB", torch.float16, "lamb"),
                 ("fp16 FusedAdam", torch.float16, "adam"),
                 ("bf16 FusedAdam", torch.bfloat16, "adam"))
AMP_PLANT_AT = 6     # the fp16 FusedLAMB run's step with an inf planted
# kernel vs plain fp16 step from the seeded weights (dropout-free, the
# unscaled fp32 gradients of the scaled backward at 2^16; the step is
# bitwise deterministic, so the readings repeat): each bar ten times its
# reading on an NVIDIA H100 80GB HBM3 at 700 W; head 0's dK dropped in K4
# read grad norm 7.63e-4 and worst leaf 1.14e-1 (the qkv weight of layer
# 0), outside both
AMP_PLAIN_LOSS_TOL = 1e-4        # absolute, on a loss near 11.26 (read 9.5e-6)
AMP_PLAIN_NORM_TOL = 2e-4        # relative, global grad norm (read 1.6e-5)
# relative, the worst leaf (read 2.3e-3, layer 0's input LayerNorm
# weight; the median leaf 1.6e-3)
AMP_PLAIN_LEAF_TOL = 2.5e-2
AMP_KINDS = STEP_KINDS + (("where", "amp: skip select (where)"),)


def plant_inf(param):
    """A gradient hook that writes one inf into ``param``'s gradient (the
    overflow the scaler must see)."""
    def hook(g):
        g = g.clone()
        g.view(-1)[:1].fill_(float("inf"))  # a fill: no host-to-device copy
        return g
    return param.register_hook(hook)


def amp_full_run(label, half, opt_name, batches, smi) -> dict:
    L = 24
    f16 = "_f16" if half == torch.float16 else ""
    want = {f"flash_qkv_fwd_sm90{f16}": L, f"flash_qkv_bwd_sm90{f16}": L,
            f"layer_norm_fwd_sm90{f16}": 4 * L + 1,
            f"layer_norm_bwd_sm90{f16}": 2 * L + 1}
    cfg = gpt1p3b_config(bf16=half == torch.bfloat16,
                         fp16=half == torch.float16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = AmpTrainer(cfg, "O2", half, opt_name, AMP_FULL_LR[opt_name], "cuda")
    plant = opt_name == "lamb"
    kernels.reset_launch_counts()
    rec, enqueue, done, bitwise = [], [], [], None
    for it, (tokens, labels) in enumerate(batches):
        snap = hook = None
        if plant and it == AMP_PLANT_AT:
            snap = [(n, t.cpu()) for n, t in tr.written()]
            before = (tr.ss.loss_scale.item(), tr.ss.skipped.item())
            hook = plant_inf(tr.params[5])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, finite = tr.step(tokens, labels)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e3)
        done.append((t2 - t0) * 1e3)
        rec.append((loss, finite, tr.ss.loss_scale.clone(),
                    tr.ss.skipped.clone()))
        if hook is not None:
            hook.remove()
            now = dict(tr.written())
            changed = [n for n, t in snap
                       if not torch.equal(now[n].cpu(), t)]
            after = (tr.ss.loss_scale.item(), tr.ss.skipped.item())
            bitwise = dict(tensors=len(snap), changed=changed,
                           scale=(before[0], after[0]),
                           skipped=(before[1], after[1]),
                           finite=bool(finite))
            log(f"  {label}: step {it} with an inf planted in "
                f"{tr.written()[5][0]}'s gradient: finite {bool(finite)}; "
                f"{len(snap)} tensors (parameters, masters, moments, step "
                f"count), {len(changed)} changed; scale {before[0]:g} -> "
                f"{after[0]:g}; skipped {before[1]} -> {after[1]}")
            del snap, now
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = [(float(a), bool(b), float(c), int(d)) for a, b, c, d in rec]
    for it, (loss, fin, scale, skipped) in enumerate(steps):
        log(f"    step {it}: loss {loss:.5f} scale {scale:g} skipped "
            f"{skipped}{'' if fin else ' (overflow: skipped)'}")
    n = len(batches)
    per_step = {k: v / n for k, v in launches.items()}
    finite = [loss for loss, fin, _, _ in steps if fin]
    step_ms = statistics.median(done[1:])
    tokens_per_step = tokens.numel()
    m = {"losses": [x[0] for x in steps], "finite": [x[1] for x in steps],
         "scales": [x[2] for x in steps], "skipped": [x[3] for x in steps],
         "step_ms_p50": step_ms,
         "tok_per_s": tokens_per_step / step_ms * 1e3, "peak_mem_gib": peak,
         "enqueue_ms_p50": statistics.median(enqueue[1:]),
         "done_ms_p50": step_ms, "launches_per_step": per_step,
         "launches": launches, "card": smi}
    log(f"  {label}: " + json.dumps({k: v for k, v in m.items()
                                     if k not in ("losses", "finite",
                                                  "scales", "skipped",
                                                  "launches")}))
    log(f"  {label}: launches over {n} steps {launches}; per step "
        f"{per_step}, expected {want} (remat attn_res; the skipped step "
        "launches too)")
    if per_step != want:
        raise AssertionError(f"{label}: launch counts do not match")
    if not (finite and finite[-1] < finite[0] and all(map(math.isfinite,
                                                          finite))):
        raise AssertionError(f"{label}: the losses of the steps that were "
                             "not skipped do not fall")
    if plant:
        ok = (not bitwise["finite"] and not bitwise["changed"]
              and bitwise["scale"][1] == bitwise["scale"][0] / 2
              and bitwise["skipped"][1] == bitwise["skipped"][0] + 1)
        if not ok:
            raise AssertionError(f"{label}: the planted overflow was not "
                                 f"skipped bitwise ({bitwise})")
        m["planted_overflow"] = bitwise
    m["trainer"] = tr
    return m


def amp_step_gaps(tr, tokens, labels) -> dict:
    """One fp16 step's loss and unscaled gradients through the kernels,
    and with head 0's dK dropped in K4, against the same step through
    the plain versions, from the same weights and scale."""
    names = [n for n, _ in tr.model.named_parameters()]

    def run():
        loss, grads, _ = tr.grad_fn(tr.ss, tokens, labels)
        return float(loss), dict(zip(names, grads))

    patches = plain_kernels()
    with patches[0], patches[1]:
        ref_loss, ref = run()
    out = {}
    for what, fault in (("kernels", None),
                        ("head 0's dK dropped", lambda: drop_head_dk(128))):
        if fault is None:
            loss, grads = run()
        else:
            with fault():
                loss, grads = run()
        norm = multi_tensor_l2norm(list(grads.values())).item()
        ref_norm = multi_tensor_l2norm(list(ref.values())).item()
        leaf = leaf_gaps(grads, ref)
        worst = max(leaf, key=leaf.get)
        g = {"loss_diff": abs(loss - ref_loss),
             "grad_norm_rel_diff": abs(norm - ref_norm) / ref_norm,
             "worst_leaf": worst, "worst_leaf_rel_diff": leaf[worst],
             "median_leaf_rel_diff": statistics.median(leaf.values())}
        g["failed"] = [name for name, key, tol in (
            ("loss", "loss_diff", AMP_PLAIN_LOSS_TOL),
            ("grad norm", "grad_norm_rel_diff", AMP_PLAIN_NORM_TOL),
            ("worst leaf", "worst_leaf_rel_diff", AMP_PLAIN_LEAF_TOL))
            if not g[key] <= tol]
        log(f"  fp16 step, {what} vs plain: loss diff {g['loss_diff']:.3e} "
            f"(tol {AMP_PLAIN_LOSS_TOL:.1e}); grad norm rel diff "
            f"{g['grad_norm_rel_diff']:.3e} (tol {AMP_PLAIN_NORM_TOL:.0e}); "
            f"worst leaf {worst} {leaf[worst]:.3e} (tol "
            f"{AMP_PLAIN_LEAF_TOL:.0e}), median leaf "
            f"{g['median_leaf_rel_diff']:.3e}; bars missed: "
            f"{g['failed'] or 'none'}")
        out[what] = g
        del grads
    if out["kernels"]["failed"]:
        raise AssertionError("fp16 GPT-1.3B step: kernel path disagrees "
                             "with the plain path")
    if not out["head 0's dK dropped"]["failed"]:
        raise AssertionError("fp16 GPT-1.3B step: the planted K4 fault "
                             "passes the kernel-vs-plain bars")
    return out


def phase_amp_full(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(31)
    batches = []
    for _ in range(AMP_FULL_STEPS):
        ids = torch.randint(0, 51200, (4, 2049), generator=gen,
                            device="cuda")
        batches.append((ids[:, :-1], ids[:, 1:]))
    out = {}
    for label, half, opt_name in AMP_FULL_RUNS:
        m = amp_full_run(label, half, opt_name, batches, smi)
        tr = m.pop("trainer")
        if label == "fp16 FusedAdam":
            tokens, labels = batches[0]
            prof = step_profile(lambda: tr.step(tokens, labels), AMP_KINDS)
            m["step_profile"] = prof
            if prof["device_busy_ms"] > 0:
                log(f"  {label}, one step under torch.profiler: " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in prof["by_kind_ms"].items())
                    + f"; wall {prof['wall_ms']:.1f} ms, device busy "
                    f"{prof['device_busy_ms']:.1f} ms, idle "
                    f"{prof['idle_share']:.1%}")
                for name, n, t in prof["top_kernels"]:
                    log(f"    {t:8.1f} ms  x{n:<5d} {name}")
                log_other_ops(prof)
            else:
                log("  one step under torch.profiler: no device time "
                    "recorded (breakdown not measured)")
            del tr
            torch.cuda.empty_cache()
            # the kernel-vs-plain step from fresh seeded weights
            tr = AmpTrainer(gpt1p3b_config(bf16=False, fp16=True), "O2",
                            torch.float16, "adam", AMP_FULL_LR["adam"],
                            "cuda")
            m["kernel_vs_plain"] = amp_step_gaps(tr, *batches[1])
        del tr
        torch.cuda.empty_cache()
        out[label] = m
    return out


# -- phase 18: GPT-1.3B training through a checkpoint, a preemption and a
# resume ------------------------------------------------------------------

RESUME_STEPS = 6        # Run A's steps, and where C and D stop
PREEMPT_AT = 3          # Run B is preempted after this step
SAVE_EVERY = 2          # Run B's --save-interval: an async save at step 2
TOKEN_SHARDS = 4
RESUME_TRAIN = FULL_TRAIN + ["--train-iters", str(RESUME_STEPS),
                             "--log-interval", str(RESUME_STEPS)]


def write_token_shards(d: str, b: int = 4, s: int = 2048,
                       vocab: int = FULL["vocab_size"], seed: int = 18) -> int:
    """``TOKEN_SHARDS`` shards of checksummed records, each s + 1 seeded
    uint32 ids below the vocab: the records of ``RESUME_STEPS`` steps of
    b rows.  Returns the payload bytes."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (RESUME_STEPS * b, s + 1)).astype(np.uint32)
    for k, part in enumerate(np.array_split(ids, TOKEN_SHARDS)):
        write_checksummed_records(
            os.path.join(d, f"tokens_{k}.bin"),
            part.view(np.uint8).reshape(len(part), -1))
    return ids.nbytes


def state_digest(model, opt) -> list:
    """A bitwise fingerprint of every parameter and both Adam moments,
    taken on the card: for each tensor the int64 sums of its 32-bit
    words, plain and weighted by position (any changed word changes the
    plain sum), and the step count."""
    sums = []
    for p in model.parameters():
        st = opt.state[p]
        for t in (p, st["exp_avg"], st["exp_avg_sq"]):
            w = t.detach().reshape(-1).view(torch.int32).long()
            pos = torch.arange(w.numel(), device=w.device) % 8191 + 1
            sums += [w.sum(), (w * pos).sum()]
    return torch.stack(sums).tolist() + [
        opt.state[next(model.parameters())]["step"]]


def dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs) / 1e9


def resume_run(what: str, flags, preempt=None) -> dict:
    """``pretrain_gpt.main`` on the card with ``flags``: each step's loss
    and its time since the previous step's end, the state digest after
    steps ``PREEMPT_AT`` and ``RESUME_STEPS``, and (``preempt``, a
    ``SimulatedPreemption``) a poll at every step boundary."""
    losses, times, digests, held = {}, {}, {}, {}
    t_last = [None]
    setup = pretrain_gpt.setup

    def keep_setup(*a, **kw):
        out = setup(*a, **kw)
        held["opt"] = out[2]
        return out

    def record(it, loss, model):
        losses[it + 1] = float(loss)     # synchronises: the step is done
        now = time.perf_counter()
        if t_last[0] is not None:
            times[it + 1] = (now - t_last[0]) * 1e3
        if it + 1 in (PREEMPT_AT, RESUME_STEPS):
            digests[it + 1] = state_digest(model, held["opt"])
        if preempt is not None:
            preempt.poll()
        t_last[0] = time.perf_counter()

    torch.cuda.empty_cache()
    with mock.patch.object(pretrain_gpt, "setup", keep_setup):
        pretrain_gpt.main(flags, device="cuda", on_step=record)
    held.clear()
    torch.cuda.empty_cache()
    log(f"  run {what}: losses {losses}")
    return {"losses": losses, "times": times, "digests": digests}


def same_as_a(what: str, run: dict, a: dict, first: int) -> None:
    """Run ``what``'s losses from step ``first`` and its digests equal Run
    A's, bit for bit."""
    want = {s: a["losses"][s] for s in range(first, RESUME_STEPS + 1)}
    if run["losses"] != want:
        raise AssertionError(f"run {what}: losses {run['losses']} != run "
                             f"A's {want}")
    for s, dig in run["digests"].items():
        if dig != a["digests"][s]:
            bad = sum(x != y for x, y in zip(dig, a["digests"][s]))
            raise AssertionError(f"run {what}: parameters and moments after "
                                 f"step {s} differ from run A's ({bad} of "
                                 f"{len(dig)} sums)")
    log(f"  run {what}: losses of steps {first}-{RESUME_STEPS} and the "
        f"parameters and moments after steps {sorted(run['digests'])} equal "
        "run A's bit for bit")


def observed_saves(snaps: list, events: list, stream: list) -> list:
    """Each save's split, from the wrapped snapshot and save calls
    (``snaps``) and the checkpoint layer's storage events (``events``),
    in perf_counter seconds; a save fences the one before, so each
    save's events fall between its snapshot and the next one's."""
    saves = []
    evs = [e for e in stream if e["type"] == "ckpt_save"]
    for i, (ev, sn) in enumerate(zip(evs, snaps)):
        end = snaps[i + 1]["t0"] if i + 1 < len(snaps) else math.inf
        at = {k: t for t, k in events if sn["t1"] <= t < end}
        start = sn["ret"] - ev["wall_ms"] / 1e3
        saves.append({"step": ev["step"], "blocking": ev["blocking"],
                      "return_s": ev["wall_ms"] / 1e3,
                      "fence_s": sn["t0"] - start,
                      "snapshot_s": sn["t1"] - sn["t0"],
                      "crc_s": at["write_arrays"] - sn["t1"],
                      "write_s": at["write_manifest"] - at["write_arrays"],
                      "commit_s": at["commit"] - start})
    return saves


def phase_resume(smi: str) -> dict:
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        return resume_runs(tmp, smi)
    finally:
        try:
            resilience.wait_for_save()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def resume_runs(tmp: str, smi: str) -> dict:
    free = shutil.disk_usage(tmp).free
    log(f"  temp dir {tmp}: {free:,} bytes free before the phase")
    data, ck = os.path.join(tmp, "tokens"), os.path.join(tmp, "ckpt")
    os.makedirs(data)
    log(f"  {write_token_shards(data):,} bytes of seeded tokens in "
        f"{TOKEN_SHARDS} checksummed shards")
    flags = RESUME_TRAIN + ["--data-dir", data]
    kernels.reset_launch_counts()

    # A: uninterrupted
    a = resume_run("A (uninterrupted)", flags)
    if not all(math.isfinite(x) for x in a["losses"].values()):
        raise AssertionError("run A: non-finite loss")

    # B: async save at 2, a SIGTERM after 3, the blocking save, clean exit
    tele_b = os.path.join(tmp, "tele_b")
    snaps, events = [], []
    tree_fn, save_fn = pretrain_gpt.checkpoint_tree, ckpt.save_checkpoint

    def timed_tree(*args):
        t0 = time.perf_counter()
        out = tree_fn(*args)
        snaps.append({"t0": t0, "t1": time.perf_counter()})
        return out

    def timed_save(*args, **kw):
        out = save_fn(*args, **kw)
        snaps[-1]["ret"] = time.perf_counter()
        return out

    prev = ckpt_mod.set_fault_hook(
        lambda ev, path: events.append((time.perf_counter(), ev)))
    try:
        with mock.patch.object(pretrain_gpt, "checkpoint_tree", timed_tree), \
                mock.patch.object(ckpt, "save_checkpoint", timed_save):
            b = resume_run("B (save every 2, preempted after 3)", flags + [
                "--save", ck, "--save-interval", str(SAVE_EVERY),
                "--telemetry-dir", tele_b, "--watchdog-timeout", "120"],
                preempt=SimulatedPreemption(at_poll=PREEMPT_AT))
    finally:
        ckpt_mod.set_fault_hook(prev)
    want_b = {s: a["losses"][s] for s in range(1, PREEMPT_AT + 1)}
    if b["losses"] != want_b or b["digests"] != {
            PREEMPT_AT: a["digests"][PREEMPT_AT]}:
        raise AssertionError(f"run B: losses {b['losses']} or its state "
                             f"after step {PREEMPT_AT} differ from run A's")
    steps_saved = sorted(s for s in range(RESUME_STEPS + 1)
                         if os.path.isdir(ckpt.step_dir(ck, s)))
    if steps_saved != [SAVE_EVERY, PREEMPT_AT] or \
            ckpt.latest_step(ck) != PREEMPT_AT:
        raise AssertionError(f"run B saved steps {steps_saved}, want "
                             f"{[SAVE_EVERY, PREEMPT_AT]}")
    for s in steps_saved:   # (C and D verify the CRCs of 3 and 2)
        if ckpt.load_data_state(ck, s) is None:
            raise AssertionError(f"checkpoint {s} holds no data_state")
    gb = {s: dir_gb(ckpt.step_dir(ck, s)) for s in steps_saved}

    # the telemetry stream
    stream = load_jsonl(os.path.join(tele_b, "pretrain_gpt.jsonl"))
    validate_events(stream)
    kinds = [e["type"] for e in stream]
    saves_ev = [e for e in stream if e["type"] == "ckpt_save"]
    run_end = [e for e in stream if e["type"] == "run_end"]
    post = [e for e in stream if e["type"] == "postmortem"]
    if ([(e["step"], e["blocking"]) for e in saves_ev]
            != [(SAVE_EVERY, False), (PREEMPT_AT, True)]
            or not all("wall_ms" in e for e in saves_ev)):
        raise AssertionError(f"telemetry: ckpt_save events {saves_ev}")
    if not (len(run_end) == 1
            and run_end[0].get("buckets_s", {}).get("ckpt_fence", 0) > 0
            and run_end[0]["reason"] == "SIGTERM"):
        raise AssertionError(f"telemetry: run_end {run_end}")
    if not (len(post) == 1 and post[0]["reason"] == "SIGTERM"
            and os.path.isfile(post[0]["path"])):
        raise AssertionError(f"telemetry: postmortem {post}")
    log(f"  run B's stream: {len(stream)} valid events {kinds}; run_end "
        f"goodput {run_end[0]['goodput']}, buckets {run_end[0]['buckets_s']}; "
        f"postmortem {os.path.basename(post[0]['path'])} "
        f"({post[0]['ring_events']} events)")
    saves = observed_saves(snaps, events, stream)
    for sv in saves:
        sv["gb"] = gb[sv["step"]]
        kind = "blocking" if sv["blocking"] else "async"
        log(f"  save of step {sv['step']} ({kind}, {sv['gb']:.3f} GB): "
            f"returned after {sv['return_s']:.3f} s "
            f"(fence {sv['fence_s']:.3f}, snapshot {sv['snapshot_s']:.3f}), "
            f"committed after {sv['commit_s']:.3f} s (CRC32 "
            f"{sv['crc_s']:.3f}, npz write {sv['write_s']:.3f}); {smi}")

    # C: resume from step 3
    tele_c = os.path.join(tmp, "tele_c")
    c = resume_run("C (--load, from step 3)", flags + [
        "--load", ck, "--telemetry-dir", tele_c])
    same_as_a("C", c, a, PREEMPT_AT + 1)

    # D: step 3's arrays corrupt: a warned fallback to step 2
    path = corrupt_arrays(ck, PREEMPT_AT)
    log(f"  flipped a byte of {os.path.relpath(path, tmp)}")
    tele_d = os.path.join(tmp, "tele_d")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        d = resume_run("D (--load, step 3 corrupt)", flags + [
            "--load", ck, "--telemetry-dir", tele_d])
    fallbacks = [w for w in caught
                 if issubclass(w.category, CheckpointFallbackWarning)]
    if not fallbacks:
        raise AssertionError("run D: no CheckpointFallbackWarning")
    log(f"  run D warned: {str(fallbacks[-1].message)[:160]}")
    same_as_a("D", d, a, SAVE_EVERY + 1)

    restores = {}
    for what, tele, step in (("C", tele_c, PREEMPT_AT),
                             ("D", tele_d, SAVE_EVERY)):
        evs = load_jsonl(os.path.join(tele, "pretrain_gpt.jsonl"))
        validate_events(evs)
        r = [e for e in evs if e["type"] == "ckpt_restore"]
        if [e["step"] for e in r] != [step]:
            raise AssertionError(f"run {what}: ckpt_restore events {r}")
        restores[what] = {"step": step, "s": r[0]["wall_ms"] / 1e3,
                          "gb": gb[step]}
        log(f"  restore in run {what} (step {step}, {gb[step]:.3f} GB"
            f"{', after the corrupt step 3' if what == 'D' else ''}): "
            f"{restores[what]['s']:.3f} s; {smi}")

    steps_run = RESUME_STEPS + PREEMPT_AT + (RESUME_STEPS - PREEMPT_AT) + (
        RESUME_STEPS - SAVE_EVERY)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    want = {k: v * steps_run for k, v in GPT_STEP_LAUNCHES.items()}
    log(f"  launches over the {steps_run} steps of runs A-D {launches}, "
        f"expected {want}")
    if launches != want:
        raise AssertionError("phase 18 launch counts do not match the main "
                             "path")
    step_a = statistics.median(list(a["times"].values()))
    step_b = [e["step_ms"] for e in stream if e["type"] == "step"]
    log(f"  step time: run A {step_a:.1f} ms (median of steps 2-6, step end "
        f"to step end), run B {statistics.median(step_b):.1f} ms (median of "
        f"its synced step_ms {step_b}); {smi}")
    return {"launches": launches, "steps_run": steps_run, "saves": saves,
            "restores": restores, "step_ms_a": step_a,
            "step_ms_b": statistics.median(step_b), "free_bytes": free,
            "card": smi}


#: the phase running now, named in the failure line
PHASE = {"n": 0, "name": "start"}


def begin(n: int, name: str, detail: str = "") -> None:
    PHASE.update(n=n, name=name)
    log(f"phase {n} {name}{detail}")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    begin(1, "device", f": {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}")

    begin(2, "build")
    build_s = kernels.build_all()
    for src, text in sorted(kernels.build_log.items()):
        report = ptxas_report(text)
        regs = [r for _, r, _, _ in report]
        log(f"  {src}: {len(report)} kernel instances, registers "
            f"{min(regs)}..{max(regs)}")
        for fn, r, stack, spill in report:
            if stack or spill:
                log(f"    {demangle(fn)}: {r} registers, {stack} bytes stack "
                    f"frame, {spill} bytes spill stores")
    log(f"  build {build_s:.1f} s")
    sm90_build = sm90_build_checks()

    begin(3, "kernels vs plain versions on the card")
    timings = phase_kernels()

    begin(4, "toy engine, cuda vs cpu")
    toy = phase_toy()

    begin(5, "full-width engine (GPT-1.3B width, 24 layers, bf16)")
    serving = phase_full(smi)
    torch.cuda.empty_cache()

    begin(6, "toy training, cuda vs cpu")
    toy_train = phase_toy_training()

    begin(7, "full-width training (GPT-1.3B, 24 layers, bf16, batch 4 x "
          "2048)")
    train = phase_full_training(smi)
    torch.cuda.empty_cache()

    begin(8, "toy multi-head attention stack, cuda vs cpu")
    toy_mha = phase_toy_mha()

    begin(9, "full-width multi-head attention stack (Transformer-big, 6 + 6 "
          "layers, bf16, batch 32 x 256 / 192)")
    mha = phase_mha(smi)
    torch.cuda.empty_cache()

    begin(10, "toy training on the flat superblock, cuda vs cpu")
    phase_flat_toy()

    begin(11, "full-width training on the flat superblock (GPT-1.3B, "
          "FlatFusedAdam)")
    flat = phase_flat_training(smi, train)
    torch.cuda.empty_cache()

    begin(12, "roofs and floors: K9 (hbm_copy) and K10 (attention_dots), "
          "the kernel microbenches")
    probes = phase_roofs(smi)
    log("  each kernel row against what this card demonstrably reaches:")
    shares = demonstrated(timings, probes)
    torch.cuda.empty_cache()

    begin(13, "toy BERT, cuda vs cpu (fp32, 2 heads of 64, padded and "
          "packed)")
    toy_bert = phase_toy_bert()

    begin(14, "full-width BERT-large training (24 layers, hidden 1024, 16 "
          "heads of 64, bf16, padded 16 x 512 and packed 13 x 512)")
    bert = phase_bert_large(smi)
    torch.cuda.empty_cache()

    begin(15, "serving modes at full width (GPT-1.3B width, 24 layers, "
          "bf16: speculative verify k=4, chunked prefill 128, prefix "
          "sharing)")
    modes = phase_modes(smi, serving)
    torch.cuda.empty_cache()

    begin(16, "serving state, page integrity and telemetry at full width "
          "(GPT-1.3B width, 24 layers, bf16; the fp32 toy)")
    state = phase_state(smi)
    torch.cuda.empty_cache()

    begin(17, "GPT training under amp: the toy card vs CPU (O0 fp32, O2 "
          "bf16 and fp16; FusedAdam, FusedLAMB, FusedSGD; from a loss scale "
          "of 2^40), then GPT-1.3B under O2 (fp16 FusedLAMB and FusedAdam, "
          "bf16 FusedAdam; dynamic loss scaling from 2^16)")
    t17 = time.perf_counter()
    amp_toy = phase_amp_toy()
    amp_full = phase_amp_full(smi)
    log(f"  phase 17 took {time.perf_counter() - t17:.1f} s")
    torch.cuda.empty_cache()

    begin(18, "GPT-1.3B training: checkpoint, preempt, resume (--data-dir "
          "shards, an async save at 2, a SIGTERM after 3, resumed to 6 from "
          "3 and, past a corrupt step 3, from 2)")
    t18 = time.perf_counter()
    resume = phase_resume(smi)
    log(f"  phase 18 took {time.perf_counter() - t18:.1f} s")
    torch.cuda.empty_cache()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    PHASE.update(n=19, name="record")

    amp_toy_adam16 = {"launches": amp_toy["launches"]["O2 fp16 adam"]}
    record = {"kernels": [
        # K1: the bf16 route at head dims 64 and 128 on the tensor cores
        # runs the serving prefill (phase 5), the multi-head attention step
        # (phase 9) and the microbenches (phase 12); the scalar kernel is
        # the fp32 and head dim 8 route (phases 4 and 8) and is timed on
        # bf16 as the kernel it replaced there
        dict(name="flash_fwd_sm90", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="apex_tpu/ops/attention.py:738",
             launches=serving["bf16"]["launches"]["flash_fwd_sm90"],
             launches_mha=mha["launches"]["flash_fwd_sm90"],
             launches_microbench=probes["launches"]["flash_fwd_sm90"],
             launches_state=state["telemetry"]["launches"]["flash_fwd_sm90"],
             **timings["flash_fwd_sm90"]),
        dict(name="flash_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd.cu",
             replaces="apex_tpu/ops/attention.py:738",
             launches=toy_mha["launches"]["flash_fwd"],
             launches_toy_engine=toy["launches"]["flash_fwd"],
             **timings["flash_fwd"]),
        # K2: the bf16 route on the tensor cores runs the multi-head
        # attention step (phase 9); the scalar kernel is the fp32 and head
        # dim 8 route (phase 8's toy step) and is timed on bf16 as the
        # kernel it replaced there
        dict(name="flash_bwd_sm90", route="cuda",
             source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
             replaces="apex_tpu/ops/attention.py:1139",
             launches=mha["launches"]["flash_bwd_sm90"],
             **timings["flash_bwd_sm90"]),
        dict(name="flash_bwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_bwd.cu",
             replaces="apex_tpu/ops/attention.py:1139",
             launches=toy_mha["launches"]["flash_bwd"],
             **timings["flash_bwd"]),
    ] + [
        # K5: flash_decode_sm90.cu is the route at head dim 128, one entry
        # point a pool (phase 5 serves on each); flash_decode.cu is the
        # fp32 and head dim 8 route (phase 4's toy) and is timed on bf16
        # as the kernel it replaced there
        dict(name=name, route="cuda",
             source="apex_tpu_torch/csrc/flash_decode_sm90.cu",
             replaces="apex_tpu/ops/attention.py:2239",
             launches=serving[pool]["launches"][name],
             # phase 16: the telemetry serve (bf16) and the disaggregated
             # decode engines (bf16, int8)
             **({"launches_state": state["telemetry"]["launches"][name]}
                if pool == "bf16" else {}),
             **({"launches_disaggregated": state["disaggregated"][pool][
                 "decode_launches"][name]}
                if pool in state["disaggregated"] else {}),
             **timings[name])
        for pool, _, name in DECODE_POOLS
    ] + [
        # K5 where the serving modes run it (phase 15): the verify step at
        # q_len k + 1 and the chunk step at q_len 128, the same entry
        # point; their launches are phase 15's steps of that kind (the
        # entry point's total there is counted exactly), their times phase
        # 3's at the steps' shapes
        dict(name=f"flash_decode_sm90_{use}", route="cuda",
             source="apex_tpu_torch/csrc/flash_decode_sm90.cu",
             replaces="apex_tpu/ops/attention.py:2239",
             launches=FULL["num_layers"] * (modes[f"{use}_steps"] + 1),
             **timings[f"flash_decode_sm90_{use}"])
        for use in ("verify", "chunk")
    ] + [
        dict(name="flash_decode", route="cuda",
             source="apex_tpu_torch/csrc/flash_decode.cu",
             replaces="apex_tpu/ops/attention.py:2239",
             launches=toy["launches"]["flash_decode"],
             launches_toy_modes=toy["modes"]["launches"]["flash_decode"],
             **timings["flash_decode"]),
    ] + [
        # K3/K4: the bf16 route on the tensor cores runs the GPT-1.3B step
        # (phase 7, and phase 18's runs); the scalar kernels are the fp32
        # route (phase 6's toy step) and are timed on bf16 as the kernels
        # they replaced there
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=runs["launches"][name],
             **({} if runs is toy_train else dict(
                 launches_resume=resume["launches"][name])),
             **timings[name])
        for name, src, where, runs in (
            ("flash_qkv_fwd_sm90", "flash_qkv_fwd_sm90.cu",
             "apex_tpu/ops/attention.py:1766", train),
            ("flash_qkv_bwd_sm90", "flash_qkv_bwd_sm90.cu",
             "apex_tpu/ops/attention.py:1800", train),
            ("flash_qkv_fwd", "flash_qkv_fwd.cu",
             "apex_tpu/ops/attention.py:1766", toy_train),
            ("flash_qkv_bwd", "flash_qkv_bwd.cu",
             "apex_tpu/ops/attention.py:1800", toy_train))
    ] + [
        # K3/K4 at head dim 64: the tensor-core instances run the
        # BERT-large steps (phase 14, padded and packed), the scalar ones
        # are the fp32 route (phase 13's toy) and are timed on fp32 at the
        # padded BERT-large batch
        dict(name="flash_qkv_fwd_sm90_d64", route="cuda",
             source="apex_tpu_torch/csrc/flash_qkv_fwd_sm90.cu",
             replaces="apex_tpu/ops/attention.py:1766",
             launches=bert["padded"]["launches"]["flash_qkv_fwd_sm90_d64"],
             launches_packed=bert["packed"]["launches"][
                 "flash_qkv_fwd_sm90_d64"],
             **timings["flash_qkv_fwd_sm90_d64"]),
        dict(name="flash_qkv_bwd_sm90_d64", route="cuda",
             source="apex_tpu_torch/csrc/flash_qkv_bwd_sm90.cu",
             replaces="apex_tpu/ops/attention.py:1800",
             launches=bert["padded"]["launches"]["flash_qkv_bwd_sm90_d64"],
             launches_packed=bert["packed"]["launches"][
                 "flash_qkv_bwd_sm90_d64"],
             **timings["flash_qkv_bwd_sm90_d64"]),
    ] + [
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=toy_bert["padded"]["launches"][name],
             launches_packed=toy_bert["packed"]["launches"][name],
             **timings[name])
        for name, src, where in (
            ("flash_qkv_fwd_d64", "flash_qkv_fwd.cu",
             "apex_tpu/ops/attention.py:1766"),
            ("flash_qkv_bwd_d64", "flash_qkv_bwd.cu",
             "apex_tpu/ops/attention.py:1800"))
    ] + [
        # K6/K7: layer_norm_sm90.cu is the route at 1024, 2048 and 4096
        # columns: the GPT-1.3B steps (phases 7, 11 and 18), the multi-head
        # attention step (phase 9) and the LayerNorm microbench (phase 12);
        # layer_norm.cu takes every other width (the toys' 256 and 32,
        # phases 6, 8 and 10) and is timed at 2048 as the kernel it replaced
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=runs["launches"][name],
             **({} if runs is toy_train else dict(
                 launches_mha=mha["launches"][name],
                 launches_flat=flat["launches"][name],
                 launches_microbench=probes["launches"][name],
                 launches_bert=bert["padded"]["launches"][name],
                 launches_resume=resume["launches"][name])),
             **timings[name])
        for name, src, where, runs in (
            ("layer_norm_fwd_sm90", "layer_norm_sm90.cu",
             "apex_tpu/ops/fused_layer_norm.py:75", train),
            ("layer_norm_bwd_sm90", "layer_norm_sm90.cu",
             "apex_tpu/ops/fused_layer_norm.py:150", train),
            ("layer_norm_fwd", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:75", toy_train),
            ("layer_norm_bwd", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:150", toy_train))
    ] + [
        # the fp16 instances (amp's half, phase 17): K3/K4 at head dim 128
        # and K6/K7 on layer_norm_sm90.cu run the GPT-1.3B fp16 steps (the
        # FusedAdam run's launches; the FusedLAMB run's beside them); K3/K4
        # at head dim 64 and K6/K7 on layer_norm.cu (width 128) the fp16
        # toy (its FusedAdam run); times from phase 3 at GPT-1.3B's, the
        # padded BERT-large batch's and [8192, 2048]
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=runs["launches"][name],
             **({"launches_lamb": amp_full["fp16 FusedLAMB"]["launches"][
                 name]} if runs is amp_full["fp16 FusedAdam"] else {}),
             **timings[name])
        for name, src, where, runs in (
            ("flash_qkv_fwd_sm90_f16", "flash_qkv_fwd_sm90.cu",
             "apex_tpu/ops/attention.py:1766", amp_full["fp16 FusedAdam"]),
            ("flash_qkv_bwd_sm90_f16", "flash_qkv_bwd_sm90.cu",
             "apex_tpu/ops/attention.py:1800", amp_full["fp16 FusedAdam"]),
            ("flash_qkv_fwd_sm90_d64_f16", "flash_qkv_fwd_sm90.cu",
             "apex_tpu/ops/attention.py:1766", amp_toy_adam16),
            ("flash_qkv_bwd_sm90_d64_f16", "flash_qkv_bwd_sm90.cu",
             "apex_tpu/ops/attention.py:1800", amp_toy_adam16),
            ("layer_norm_fwd_sm90_f16", "layer_norm_sm90.cu",
             "apex_tpu/ops/fused_layer_norm.py:75",
             amp_full["fp16 FusedAdam"]),
            ("layer_norm_bwd_sm90_f16", "layer_norm_sm90.cu",
             "apex_tpu/ops/fused_layer_norm.py:150",
             amp_full["fp16 FusedAdam"]),
            ("layer_norm_fwd_f16", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:75", amp_toy_adam16),
            ("layer_norm_bwd_f16", "layer_norm.cu",
             "apex_tpu/ops/fused_layer_norm.py:150", amp_toy_adam16))
    ] + [
        dict(name="flat_adam", route="cuda",
             source="apex_tpu_torch/csrc/flat_adam.cu",
             replaces="apex_tpu/optimizers/flat.py:161",
             launches=flat["launches"]["flat_adam"],
             **timings["flat_adam"]),
        dict(name="hbm_copy", route="cuda",
             source="apex_tpu_torch/csrc/hbm_copy.cu", replaces="bench.py:188",
             launches=probes["launches"]["hbm_copy"],
             **probes["rows"]["hbm_copy"]),
        # K10: attention_dots_sm90.cu is the route of every input (the
        # microbench path, phase 12); attention_dots.cu, the route before,
        # is launched only to be compared with it (its launches are those
        # of the comparison), timed at the same shapes cold and in turns
        dict(name="attention_dots_sm90", route="cuda",
             source="apex_tpu_torch/csrc/attention_dots_sm90.cu",
             replaces="bench.py:2671",
             launches=probes["launches"]["attention_dots_sm90"],
             **probes["rows"]["bench"],
             at_shapes={what: probes["rows"][what]
                        for what, _ in DOT_SHAPES[1:]}),
        dict(name="attention_dots", route="cuda",
             source="apex_tpu_torch/csrc/attention_dots.cu",
             replaces="bench.py:2671",
             launches=probes["launches"]["attention_dots (comparison)"],
             **{**probes["rows"]["bench"],
                "ms": probes["rows"]["bench"]["old_ms"],
                "max_abs_err": probes["rows"]["bench"]["old_max_abs_err"]},
             at_shapes={what: dict(ms=probes["rows"][what]["old_ms"],
                                   max_abs_err=probes["rows"][what][
                                       "old_max_abs_err"])
                        for what, _ in DOT_SHAPES[1:]}),
    ]}
    for entry in record["kernels"]:
        entry.update(shares.get(entry["name"], {}))
        src = entry["source"].rsplit("/", 1)[1]
        if src in sm90_build:
            entry["sass"] = sm90_build[src]
    for entry, at in zip(record["kernels"][:2], ("flash_fwd_sm90_mha",
                                                 "flash_fwd_mha")):
        entry.update({f"{k}_mha": v for k, v in
                      {**timings[at], **shares[at]}.items()
                      if k not in ("bound_by", "flops")})
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # named on stderr, then the run fails
        print(f"chip_smoke: FAILED in phase {PHASE['n']} ({PHASE['name']}): "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        traceback.print_exc()
        code = 1
    sys.exit(code)
