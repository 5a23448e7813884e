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
microbenches with their HBM roof and attention dot floor (phase 12),
BERT-large training, padded and packed (phases 13-14), and GPT training on
the fused-softmax path and under the other remat policies, with the in-run
profile sampler and the apex ops (phase 19), ResNet-50 ImageNet training
under amp with its example, ``FP16_Optimizer`` and ASP (phase 20),
DCGAN, the RNNs, RNN-T and weight norm (phase 21), and tensor- and
data-parallel GPT training on ``torch.distributed``, its ranks sharing
the card over gloo (phase 22), pipeline-parallel GPT training, its
stages sharing the card the same way (phase 23), and ZeRO: bench.py's
GPT-1.3B flagship train step, its sharded checkpoints and elastic
recovery (phase 24), and the serving fleet: several GPT-1.3B engines
behind the router, sharing the card (phase 25), tensor-parallel
serving, ``ServingEngine(tp=N)`` over ranks sharing the card (phase 26),
the Mixture-of-Experts GPT with its expert axis and ring attention
over a sequence group (phase 27), and batch norm across ranks, the
spatial bottleneck's halo exchange and the ImageNet example's data
parallelism (phase 28).
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
    bf16 (phase 5's engine on a ``SimClock``, cut to
    :data:`SERVE_CUT_LAYERS` = 8 layers): ``trace(0, 16)`` served
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
    cut to ``RESUME_LAYERS`` = 4 layers (no remat below 12), with
    ``--data-dir`` over four checksummed shards of seeded tokens
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
    K4, K6 and K7 launch L, L, 2L + 1 and 2L + 1 a step times the 16
    steps of the four runs, exactly.  Each save's seconds and GB (the async one's
    time to return against its time to commit, with its fence, snapshot,
    CRC32 and write split), each restore's seconds and GB and run A's
    step time against run B's are printed beside the card.
19. the rest of one-card GPT training — (a) GPT-1.3B on the fused-softmax
    path (``use_flash_attention=False``, the JAX ``GPTModel``'s default;
    remat ``full``, bf16, ``FusedAdam``, one seeded 4 x 2048 batch): three
    steps with exact launches (K6 4L+1, K7 2L+1, no K3/K4), a falling loss,
    one step run twice (bitwise), its step ms, peak and device time by
    kind; one dropout-free step against the same step on the flash path
    (K3/K4) from the same weights, its bars read against the step in fp32
    (``SOFT_*``), head 0's dscores dropped in the softmax's backward
    missing one; the toy on this path under a full causal + padding [b, 1,
    s, s] mask, card vs CPU.  (b) ``pretrain_gpt`` at phase 7's flags under
    remat ``dots``, ``attn_res_mlp`` and ``attn_out``: exact launches a
    step (K3 2L / L / 2L, K4 L, K6 4L+1, K7 2L+1), losses within the bf16
    bar of phase 7's ``attn_res`` run, step ms and peak; ``attn_out`` with
    ``--profile-every 2 --telemetry-dir`` (a sampler failure fails the
    phase): valid ``profile`` and ``memory`` events, the sampler's totals,
    its overhead in the ``profile`` bucket, ``matmul``, ``vector`` and
    ``custom`` above 0, ``custom`` equal to K3/K4/K6/K7's time read from
    the same trace within 1 %, the report's total equal to the trace's
    kernels and copies, the ``summarize`` CLI's phase row.  (c) The apex
    ops at full width, card vs CPU within ``tolerance`` and timed: both
    masked softmaxes [4, 16, 2048, 2048], ``softmax_cross_entropy_loss``
    [8192, 51200] (smoothing 0 and 0.1, ``half_to_float`` both ways),
    ``FusedDenseGeluDense`` and ``MLP`` 8192 x 2048 -> 8192 -> 2048, bf16.
20. ResNet-50 ImageNet training under amp (no kernel of this package:
    cuDNN's convolutions, plain PyTorch batch norm) — (a) bench.py's
    step (``resnet50_config``, O2, ``FusedLAMB`` lr 1e-3 decay 1e-4,
    dynamic scale, one seeded batch of 128 x 224 x 224 x 3 bf16) ten
    times under ``cudnn.deterministic`` with ``benchmark`` off: finite
    falling losses, step p50, images/s, host enqueue, peak, one step's
    ``profiling.phase_report`` split (convolutions under ``matmul``); a
    second run from the same weights bitwise equal; an inf planted in one
    image skipped with every parameter, master, moment and the step count
    bitwise unchanged while the BN statistics move (the JAX step keeps the
    forward's); the first step's loss and BN statistics within
    ``RESNET_O2_*`` of the O0 fp32 step's.  (b) The ImageNet example in
    subprocesses: 2 epochs of 5 steps saving a checkpoint, ``--resume`` to
    epoch 3 (it must resume from epoch 1), one pass over 256 seeded
    ``train*.rec`` records beside those two.  (c) ``FP16_Optimizer`` around ``FusedSGD``,
    three steps bitwise equal to amp O2 + ``FusedSGD`` (every tensor half,
    as the JAX ``FP16_Optimizer`` casts them).  (d) ASP's masks of
    ResNet-50's weights, card equal to CPU bit for bit, 2:4, kept through
    three O2 steps.  (e) ``resnet_tiny`` fp32, one O0 SGD step, card vs
    CPU within ``TINY_RESNET_TOL``.
21. the other families — (f) DCGAN at the example's sizes (batch 32, 20
    steps) under O1 and O2: an inf in D's fake batch skips D alone and
    halves scale 1 only; one step card vs CPU.  (g) The mLSTM of NVIDIA's
    sentiment-discovery byte model (vocabulary 256, embedding 64, hidden
    4096; 256 steps x batch 32) and a 2-layer LSTM at hidden 1024, forward,
    backward and a ``FusedAdam`` step under O2: step ms, peak; toys card vs
    CPU.  (h) RNN-T at MLPerf RNN-T's order of size (f [16, 256, 512], g
    [16, 128, 512] bf16, the joint with relu, a linear to 1024, the loss):
    forward + backward ms and peak; packed joint, loss and gradient bitwise
    the dense ones; a toy's loss and gradient against autograd through the
    DP.  (i) Weight norm on DCGAN's discriminator, card vs CPU.  Each of
    phases 20 and 21 prints a JSON summary line.
22. tensor- and data-parallel GPT training on ``torch.distributed`` —
    ranks are processes (``parallel.multiproc.spawn``) that share this
    card over ``--distributed-backend gloo``: the machine has one card
    and NCCL refuses two ranks on one GPU, so every collective is staged
    through the host, and the wall times are of ranks time-slicing one
    card.  First K3/K4 at a rank's tp 2 shape [4, 2048, 8 x 3 x 128] bf16,
    phase 3's way (the plain versions, bitwise twice, timed cold beside
    SDPA and the bound); a probe of what gloo takes directly (CUDA sum and
    max all-reduce, all-gather, broadcast, a host bf16 sum).  (e) NCCL at
    world 1: ``all_reduce_grads`` and NCCL's own all-reduce, broadcast
    and all-gather of bf16 and fp32 CUDA tensors equal their inputs bit
    for bit.  (a) The fp32 toy (hidden 512, 4 heads of 128: the scalar
    K3/K4) through ``pretrain_gpt``, tp 2 against tp 1 from the same
    seeded master, within JAX's bar (rtol 2e-4, atol 1e-5).  (b)
    GPT-1.3B width cut to ``TP22_LAYERS`` = 2 (below 12 layers
    ``pretrain_gpt`` runs no remat; tp 2 under remat ``attn_res`` runs in
    phases 23 (c) and 24 (c); bf16, ``FusedAdam``, micro-batch 4 x 2048,
    dropout off so that tp 1 and tp 2 differ only in their arithmetic):
    three steps at tp 2 against tp 1 (``TP22_LOSS_TOL``); the replicated
    leaves bitwise equal across the tp ranks after every step; a re-run
    of two steps with ``--save`` bitwise the run's first two; (d) its
    resume from the step-2 checkpoint (the JAX example's tree, a leading
    tp axis of 2) bitwise the run's step 3 in every parameter; after the
    last step, both ranks' hidden state of a seeded sequence with dropout
    0.1/0.1 bitwise equal.  (c) tp 2 x dp 2 (four ranks, micro-batch 2,
    the same global batch) within ``TP22_DP_LOSS_TOL`` of (b), the dp
    replicas bitwise equal after every step.  (f) Every rank's exact K3,
    K4, K6 and K7 launches (L, L, 2L + 1, 2L + 1 a step) go into the
    ``kernels`` record.  (g) A JSON line: each rank's step seconds, the
    collectives' share of them, bytes and calls a step, peak memory,
    beside the card's name and power limit.  NCCL at world 1, the two
    ranks of (a) and (b) and the four of (c) run side by side.
23. pipeline-parallel GPT training on ``torch.distributed`` — the stages
    are ranks sharing this card over gloo as in phase 22, each a
    ``build_model`` chunk of ``gpt_model_provider`` cut from the whole
    model drawn from one seed, driven by ``make_gpt_stage_fns`` and the
    schedules of ``transformer.pipeline_parallel`` (GPT-1.3B width, bf16,
    remat ``attn_res``, FusedAdam lr 1.5e-4, dropout off, phase 7's
    seeded 4 x 2048 batch as 4 microbatches of 1).  First K3/K4 at the
    stages' shapes, phase 3's way: bf16 [1, 2048, 16 x 3 x 128] and fp16
    [1, 2048, 8 x 3 x 128].  (a) 1F1B at pp 2, ``PP23_LAYERS`` = 8
    layers (the depth cut for the script's time), 3 steps,
    against tp 1 / pp 1 on the same batch and master
    (``forward_backward_no_pipelining``), step by step within the
    ``PP23_*_TOL`` bars, with step 1's gradient statistics (each leaf's
    norm and its dot with a seeded random vector); a re-run bitwise; each
    rank's exact launches a step, derived from the slots
    (:func:`pp23_launches`); each rank's peak at m = 4 and m = 8 (one
    forward-backward each) within one stage input.  (b) the interleaved
    schedule at pp 4 x vpp 2 (1 layer a chunk), 2 steps, step 1 within
    (a)'s bars of (a)'s step 1, launches exact.  (c) bench.py's amp pp leg
    at tp 2 x pp 2, 4 layers, O2 fp16 from a scale of 2^16, 3 steps, on
    the ``_f16`` entries: an overflow planted on one rank at step 2 makes
    every rank skip it bitwise and halve its scale; the replicated leaves
    bitwise equal across the tp ranks after each step; launches exact.  A
    JSON line: losses, gaps, bubbles, each rank's step wall and stream
    time, transfers and peak.
24. ZeRO — ``transformer.testing.build_flagship_train_step``, the
    flagship step of bench.py's headline (``bench_gpt1p3b``):
    ``DistributedFusedAdam`` (reduce-scatter, the shard's update, all-gather)
    over the flat superblock of the JAX master tree.  (a) world 1, no
    process group: ``gpt1p3b_config()`` at ``bf16_fit``, lr 1e-4, a seeded 4
    x 2048 batch, 1 + 4 steps: the loss finite and falling, K3, K4, K6 and
    K7 a step exactly phase 7's tree step's, a re-build from the seed
    bitwise at step 1, step ms, host enqueue, one step under
    ``torch.profiler``, the steps' peak beside ``flagship_state_bytes``.
    (b) the fp32 toy (TOY_KW of ``tests/L0/test_flagship.py``) card vs CPU
    from one master: losses within 1e-6 relative, weights 1e-4; the
    scalar routes' launches exact.  (c) ranks sharing this card over gloo
    (GPT-1.3B width cut to 2 layers): (dp, tp, pp) = (2, 2, 1) bucketed at
    ``DEFAULT_BUCKET_BYTES`` and serialized, 2 steps each, bitwise equal
    (losses, parameters, moments), parameters bitwise across the ranks
    after each step, one reduce-scatter and one all-gather a bucket a
    step; dp 2 on the single-axis path; each rank's exact launches, step
    seconds and collective share, its peak beside ``flagship_state_bytes(
    ..., n_shards=world)``.  (d) 2 layers at (2, 2, 1): a format-4 save
    each step, each rank its own shard; step 2 restored onto (2, 1, 1) and
    onto world 1, each bitwise the re-partitioned stacks; ``corrupt_shard``
    at (1, 0, 1): ``verify_checkpoint`` names the file, and
    ``restore_zero_checkpoint`` falls back to step 1, bitwise.  (e) 2
    layers: ``run_elastic_training`` at (2, 2, 1) loses rank 3 at step 2
    (``DeviceLoss``), resumes on ``best_surviving_submesh``'s (1, 2, 1)
    and ends bitwise the golden run restored from the same checkpoint on
    that shape.  (e) runs beside (c)-(d): the four ranks of (c) and (d),
    then the two of dp 2, (d)'s restore onto (2, 1, 1) and (e)'s golden
    (once (e) has committed its step-1 checkpoint) beside (d)'s restore
    onto world 1.
25. the serving fleet — ``serving.fleet`` over phase 5's model and pool
    (GPT-1.3B width cut to :data:`SERVE_CUT_LAYERS` = 8 layers, bf16, page
    64, batch 8, 61 pages a replica), the replicas sharing the card, one parameter tree and one
    virtual clock ticked once a round (``bench.py::bench_fleet``'s).  (a)
    3 mixed replicas, 24 requests of ``trace(25, 24)`` from two tenants
    (``SLOClass``), drained, then submitted again with ``rolling_restart``
    3 rounds in: zero drops, every request never migrated bitwise the
    single engine's stream at the same ``max_batch``, the migrated ones
    recorded with their first divergent token and top-2 margin (a
    re-prefill runs the prefill products).  (b) ``KillReplica`` on r0 past
    its engine's recoveries (retries with backoff, fence, migration),
    ``BlackholeReplica`` on r1 (fenced at its ping), ``SlowReplica`` on r2
    under the budget (kept): zero drops.  (c) ``DisaggRouter``, 2 prefill
    and 2 decode replicas, the first 8 requests, on the bf16 and int8
    pools: over ``LocalTransport`` no retry, no fallback, every stream
    bitwise the single engine's; over ``ChaosTransport`` (drop, duplicate,
    reorder and corrupt on ``kv_page``, drops on ``kv_commit``) zero
    drops, shipped streams bitwise, retries and fallbacks counted; every
    adopted page the exporter's, byte for byte.  Throughout, K1's and
    K5's launches are read around each replica's step and restart:
    exactly 24 a prefill and 24 a decode step, nothing launched outside a
    replica, so K1 only on the prefill replicas and K5 only on the decode
    ones over ``LocalTransport``.  (d) the fp32 toy on the card through
    (a)-(c) (its own pool): every stream bitwise the single engine's,
    migrated and fallen-back requests included, each scenario's events
    and streams those of the same run on the CPU from the same weights.  Rounds, wall seconds, ms a round,
    fences, migrations, pages shipped, retries, fallbacks, export and
    import ms a page, a request's wire bytes, TTFT and TPOT p50 / p99 on
    the virtual clock and each replica's launches are printed.
26. tensor-parallel serving — ``ServingEngine(tp=N)``, one process a
    tensor rank, the ranks sharing cuda:0 over gloo (three launches side
    by side, with the tp 1 fp32 controls on this process).  (a) the main
    path: phase 5's model (GPT-1.3B width, 24 layers, bf16, its seed),
    pool geometry and three requests (``trace(1, 3)``, their budgets cut
    to :data:`TP26_NEW` tokens) at tp 2:
    ``warmup()`` and the three served together, again, and one at a
    time: the two ranks' streams identical, batched == again == one at a
    time bitwise, each rank's K1 (``flash_fwd_sm90`` at 8 heads) and K5
    (``flash_decode_sm90``) launches exactly 24 x (its prefills + 1) and
    24 x (its decode steps + 1); against phase 5's tp 1 streams the count
    of bitwise ones and the top-2 margin where one parts are printed (a
    reading: the sums are grouped otherwise); the full-batch decode step
    timed a rank with its collectives' share.  (b) the same on the int8
    pool (``flash_decode_sm90_int8``).  (c) :data:`FP32_MODES` (4 heads
    of 128) at tp 2 and tp 4 on the scalar routes (``flash_fwd.cu``,
    ``flash_decode.cu``): the streams bitwise the tp 1 engine's (the JAX
    package's contract), the launches exact; speculation (k 4) plus
    chunking (128) at tp 2 bitwise its tp 1 control.  (d) at tp 2 on an
    int8 pool of :data:`FP32_MODES`: ``ServingDeviceLoss`` installed on
    rank 0 only (both ranks recover once, the streams the control's), a
    snapshot through JSON restored into pools poisoned with sentinels (the
    control's streams), and a prefill-only engine's export, the whole
    page on every rank, landed in a tp 1 ``kv_import`` engine here that
    exports the same bytes and CRCs back and decodes the tp 2 stream.
    (e) K1 (``[1, h, 1024, 128]``, causal, segment ids) and K5
    (``[8, h, 1, 128]`` over the ragged batch, bf16 and int8 pools) at
    h = 8, 4, 2 and 1 against their plain versions at phase 3's
    tolerances, each run twice bitwise, K1's tiles walked as the rule;
    at 8 heads timed cold beside the plain versions, SDPA (page gather +
    SDPA) and the bound, and read against phase 3's 16-head rows.
27. the Mixture-of-Experts GPT and ring attention — (a) ``GPT1P3B_KW``'s
    widths with a ``SwitchMLP`` of 8 experts a layer (Switch-Base-8;
    capacity factor 1.25, aux coefficient 1e-2), cut to
    :data:`MOE27_LAYERS` = 8 layers (2.39 B parameters: the depth the
    card's memory forces), bf16, remat ``attn_res``, phase 7's flags,
    seeded 4 x 2048 batch and tree ``FusedAdam``: one warm-up and 3 timed
    steps, each under ``set_sync_debug_mode("error")``, the loss finite
    and falling, K3, K4, K6 and K7 exactly L, L, 4L + 1 and 2L + 1 a step;
    a step under ``torch.profiler``; the dropout-free step against the
    plain-version step (``MOE27_*_TOL``), the tokens routed elsewhere
    between the two and their top-2 margins printed; the same step twice
    from the seed, bitwise; step ms and the peak.  (b) the fp32 toy MoE
    GPT card vs CPU from one init, three FusedAdam steps on one batch, on
    the flash path (the scalar K3/K4) and the fused-softmax path.  (c)
    one launch of four ranks sharing the card over gloo, beside (b):
    ``SwitchMLP`` at GPT-1.3B width (E 8, F 8192, 2048 tokens a rank) at
    ep 4 and ep 2 (pairs), bf16 and fp32 tokens, forward and backward,
    each rank's outputs, input, gate and expert gradients bitwise the
    expert axis replayed op for op on one device, aux the same bits on
    every rank; bench.py's tp 2 x ep 2 leg at that width (fp32) held to
    ep 1 on one device; ring attention at sp 4 and 2 at bench.py's shape
    and at sp 2 at a GPT-1.3B rank's [64, 1024, 128] bf16, causal and
    not, output and gradients held to full attention on one device.
28. batch norm across ranks, the spatial bottleneck and the ImageNet
    example's data parallelism — side by side, a launch of four ranks
    and one of two sharing the card over gloo, the example as users
    start it and its 1-rank reference in this process.  (a)
    ``sync_batch_norm`` over the four ranks at ResNet-50's first norm
    (:data:`SYNC28_X` bf16, 32 rows a rank)
    against the same batch on one rank: each rank's rows of y and dx,
    the running statistics, the weight and bias gradients summed over the
    ranks (``SYNC28_TOL``), the backward's all-reduce dropped as a
    planted fault that must miss a bar; GroupBN at ``bn_group`` 2 within
    the pairs of ``create_syncbn_process_group(2, 4)`` against one rank's
    64 rows; bench.py's syncbn leg (``(n_dev * 4, 8)``, ``|mean(y)| <
    1e-5``, the ranks' running means equal).  (b) ``SpatialBottleneck``
    at ResNet-50's layer1 block and layer2.0 (stride 2) on ``[8, 56, 56,
    256]`` bf16 with H over four and over two ranks against the unsharded
    block: each rank's rows of the output and input gradient, every
    parameter gradient summed over the ranks (``SPATIAL28_TOL``); the
    halo rows swapped as a planted fault.  (c) ``main_amp --arch resnet50
    --opt-level O2 --optimizer lamb -b 128 --image-size 224 --n-devices 2
    --sync_bn --distributed-backend gloo`` through ``python -m
    apex_tpu_torch.parallel.multiproc --nproc 2``, 4 steps on one global
    batch of records and 2 eval steps: the losses finite and falling and
    held to the example's trainer at one rank on the same global batch
    (in this process), the parameters' update over the steps too
    (``IMAGENET28_*_TOL``); in the other launch the same
    run twice in-process with cuDNN deterministic, every rank's
    parameters and statistics bitwise the same, then with the gradient
    all-reduce dropped, which must miss the parameter bar.  Step ms, the
    share of each rank's run in collectives and the peak a rank are
    printed beside ``nvidia-smi``'s line.

The last three lines of standard output are the kernels' JSON record,
the ``nvidia-smi`` name/power line, and ``{"ok": true, "device": ...}``.
A failure prints ``chip_smoke: FAILED in phase N (<name>): <type>:
<message>`` and the traceback on standard error, and the run exits 1.
fp32 matrix products run in full fp32 (``allow_tf32`` off).
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
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
from apex_tpu_torch.transformer import parallel_state  # noqa: E402
from apex_tpu_torch.transformer.testing import (  # noqa: E402
    GPT1P3B_KW, BertModel, GPTConfig, GPTModel, gpt1p3b_config,
    gpt_param_count)
from apex_tpu_torch.transformer.testing.standalone_gpt import (  # noqa: E402
    attention_segments)
from apex_tpu_torch import checkpoint as ckpt  # noqa: E402
from apex_tpu_torch import resilience  # noqa: E402
from apex_tpu_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from apex_tpu_torch.data import write_checksummed_records  # noqa: E402
from apex_tpu_torch.resilience import CheckpointFallbackWarning  # noqa: E402
from apex_tpu_torch.resilience.chaos import (  # noqa: E402
    BlackholeReplica, KillReplica, SimulatedPreemption, SlowReplica,
    corrupt_arrays)
from apex_tpu_torch.resilience import (CorruptLivePage,  # noqa: E402
                                       ServingDeviceLoss, SlowDecode,
                                       Watchdog)
from apex_tpu_torch.serving import model as model_mod  # noqa: E402
from apex_tpu_torch.serving import (NgramProposer,  # noqa: E402
                                    PagedKVCache, PagePoolCorruption,
                                    ServingEngine, ServingModelConfig,
                                    SimClock, SpecConfig, init_params,
                                    params_to, poisson_trace,
                                    quant_pool_dtype,
                                    quantize_tokens, verify_page_payload)
from apex_tpu_torch import telemetry  # noqa: E402
from apex_tpu_torch.serving import fleet as fleet_mod  # noqa: E402
from apex_tpu_torch.telemetry.summarize import percentile  # noqa: E402
from apex_tpu_torch.ops import fused_softmax as fsm  # noqa: E402
from apex_tpu_torch.ops import xentropy as xent  # noqa: E402
from apex_tpu_torch.ops.fused_dense import (  # noqa: E402
    FusedDenseGeluDense, fused_dense, fused_dense_gelu_dense)
from apex_tpu_torch.ops.mlp import MLP as ApexMLP  # noqa: E402
from apex_tpu_torch.ops.mlp import mlp as apex_mlp  # noqa: E402
from apex_tpu_torch.profiling import trace_report  # noqa: E402
from apex_tpu_torch.telemetry import sampler as telemetry_sampler  # noqa: E402
import apex_tpu_torch.profiling as profiling  # noqa: E402
from apex_tpu_torch import fp16_utils, reparameterization  # noqa: E402
from apex_tpu_torch import rnn as rnn_mod  # noqa: E402
from apex_tpu_torch.contrib import sparsity, transducer  # noqa: E402
from apex_tpu_torch.contrib.transducer import (  # noqa: E402
    transducer as transducer_mod)
from apex_tpu_torch.data import write_records  # noqa: E402
from apex_tpu_torch.examples.dcgan import main_amp as dcgan_main  # noqa: E402
from apex_tpu_torch.examples.imagenet import (  # noqa: E402
    main_amp as imagenet_main)
from apex_tpu_torch.models import (ResNet, ResNetConfig,  # noqa: E402
                                   resnet50_config)
from apex_tpu_torch.ops.xentropy import (  # noqa: E402
    softmax_cross_entropy_loss)
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


_DEMANGLED: dict = {}


def demangle_all(names) -> None:
    """Demangle ``names`` with one ``c++filt`` (a name a line), into the
    cache :func:`demangle` reads; a name c++filt cannot read stays as it
    is."""
    todo = [n for n in dict.fromkeys(names) if n not in _DEMANGLED]
    if not todo:
        return
    try:
        full = subprocess.run(["c++filt"], input="\n".join(todo) + "\n",
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        full = None
    if full is None or len(full) != len(todo):
        _DEMANGLED.update((n, n) for n in todo)
        return
    for n, f in zip(todo, full):
        found = re.search(r"\w+<[^()]*>", f)
        _DEMANGLED[n] = found.group(0) if found else f.strip()


def demangle(name: str) -> str:
    """``flash_decode_kernel<float, 128>`` from its mangled name."""
    demangle_all([name])
    return _DEMANGLED[name]


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


def flash_fwd_case(gen, name, dtype, lengths, h=16):
    """K1 at the prefill's shape through ``flash_attention_fwd`` against
    its plain version, naming the kernel that ran (bf16 at head dim 128:
    ``flash_fwd_sm90``; fp32: the scalar ``flash_fwd``); on the tensor
    cores also run again (bitwise) counting its tiles walked, against
    :func:`flash_fwd_tiles`."""
    q, k, v, seg = prefill_operands(gen, dtype, lengths, h=h)
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
                      scalar=False, h=16):
    """K5 through ``flash_decode`` (with ``scalar``, ``flash_decode.cu``
    called directly, as on a bf16 pool before ``flash_decode_sm90.cu``)
    against its plain version, naming the entry point that ran;
    ``flash_decode_sm90.cu``'s run again (bitwise).  Returns (max error,
    operands, the entry point)."""
    ops = decode_operands(gen, dtype, q_len, lengths, h=h, quant=quant)
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


def time_flash_qkv(qkv, dctx, ctx, lse, rate, h=TRAIN["heads"]) -> tuple:
    """K3 and K4 (the tensor-core kernels, through the wrappers) timed cold
    beside their plain versions, SDPA and the scalar kernels they replace
    on bf16 (cold too); then the scalar and the tensor-core kernel of each
    in turns (a, b, b, a) in this one call (``timing.timed_pair``).  The
    scalar kernels have no fp16 instance: an fp16 qkv is timed without
    them (the third element is then None), as is a head count ``h`` other
    than GPT-1.3B's 16 (a rank's heads at tp 2)."""
    b, s, _ = qkv.shape
    d = TRAIN["d"]
    args = (None, None, h, d ** -0.5, True, rate, RATE_SEED)
    new_fwd = lambda: att._flash_qkv_fwd_cuda(qkv, *args)  # noqa: E731
    new_bwd = lambda: att._flash_qkv_bwd_cuda(  # noqa: E731
        qkv, dctx, ctx, lse, *args)
    old = qkv.dtype in kernels.DTYPE_CODES and h == TRAIN["heads"]
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
    metrics.update(launches=launches, streams=s["together"],
                   batched_eq_sequential=same,
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
# phases 16 and 25 serve phase 5's model cut to this depth: the state,
# recovery, fleet and wire they check do not change with it, and at 24
# layers the two took 42.8-60.1 s and 70.9-84.3 s of the script's time on
# an NVIDIA H100 80GB HBM3 at 700.00 W (cut for phase 27's time)
SERVE_CUT_LAYERS = 8
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
    cfg = ServingModelConfig(**dict(FULL, num_layers=SERVE_CUT_LAYERS),
                             dtype=torch.bfloat16)
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


def gpt_step_launches(layers: int = 24) -> dict:
    """A ``pretrain_gpt`` bf16 step's launches at GPT-1.3B width: the
    tensor-core K3/K4 L each, layer_norm_sm90.cu's K6 4L + 1 under remat
    attn_res (the JAX example's rule: remat from 12 layers; the
    LayerNorms run again in the recompute) and 2L + 1 below 12 layers,
    K7 2L + 1, and not one launch of the scalar K3/K4 or of
    layer_norm.cu."""
    return {"flash_qkv_fwd_sm90": layers, "flash_qkv_bwd_sm90": layers,
            "layer_norm_fwd_sm90": (4 if layers >= 12 else 2) * layers + 1,
            "layer_norm_bwd_sm90": 2 * layers + 1}


GPT_STEP_LAUNCHES = gpt_step_launches(24)


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
               "step1_loss": losses[0], "losses": losses,
               "launches_per_step": per_step,
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


_SASS: dict = {}


def sass_text(source: str) -> str:
    """``cuobjdump -sass`` of a built source's library, run once a source
    (the libraries do not change within a run)."""
    if source not in _SASS:
        tool = kernels._build.cuda_tool("cuobjdump")
        _SASS[source] = subprocess.run(
            [tool, "-sass", str(kernels._build.library_path(source))],
            capture_output=True, text=True, check=True).stdout
    return _SASS[source]


def sass_count(source: str, opcode: str) -> int:
    """Lines of one instruction (``HMMA``: ``mma.sync`` on the tensor cores,
    ``HGMMA``: ``wgmma``, ``UTMALDG``: a TMA load; a regular expression,
    matched as a word) in the SASS of a built source's library, from
    ``cuobjdump -sass``."""
    return sum(re.search(rf"\b{opcode}\b", line) is not None
               for line in sass_text(source).splitlines())


def sass_functions(source: str) -> dict:
    """The SASS of a built source's library split by kernel instance:
    {demangled name: its SASS text} (``cuobjdump -sass``)."""
    lines = sass_text(source).splitlines()
    demangle_all(line.split("Function :")[1].strip() for line in lines
                 if "Function :" in line)
    out, name = {}, None
    for line in lines:
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
    demangle_all(fn for fn, _, _, _ in report)
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
    # each library's cuobjdump at once, one thread a source
    concurrently(*(lambda src=src: sass_text(src) for src in SASS_WANT))
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
# GPT-1.3B width cut to 4 layers: the phase checks the checkpoint's
# bits and its restore, not the depth; at 24 layers (two 15.8 GB saves,
# two restores) the phase took 140.5-183.6 s of the script's 1200 s on an
# NVIDIA H100 80GB HBM3 at 700.00 W.  Below 12 layers pretrain_gpt runs
# no remat
RESUME_LAYERS = 4
RESUME_TRAIN = (FULL_TRAIN[:1] + [str(RESUME_LAYERS)] + FULL_TRAIN[2:]
                + ["--train-iters", str(RESUME_STEPS),
                   "--log-interval", str(RESUME_STEPS)])


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
    want = {k: v * steps_run
            for k, v in gpt_step_launches(RESUME_LAYERS).items()}
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


# -- phase 19: the rest of one-card GPT training: the fused-softmax GPT, the
# remat policies, --profile-every and the apex ops ---------------------------

SOFT_STEPS = 3
SOFT_LR = 1.5e-4             # pretrain_gpt's default
# the fused-softmax step against the flash step (K3/K4) from the same
# weights and batch, the leaf bars in units read from the same step in
# fp32 (the softmax path's fp32 model): SOFT_LOSS_TOL absolute on the loss
# (ten times the reading, 1.44e-4); SOFT_LEAF_RATIO on the worst leaf's
# |g_soft - g_flash| / |g_flash| over the flash step's own worst leaf gap
# from fp32 (read 1.023: the two bf16 paths sit as far apart as the flash
# step sits from fp32); SOFT_FP32_RATIO on the softmax step's median leaf
# gap from fp32 over the flash step's (read 0.991; phase 14's bar).  Head
# 0's dscores dropped read 8.97 and 1.265 (NVIDIA H100 80GB HBM3, 700 W)
SOFT_LOSS_TOL = 1.5e-3
SOFT_LEAF_RATIO = 2.0
SOFT_FP32_RATIO = 1.25
# a GPT-1.3B step on the fused-softmax path under remat "full": no K3/K4;
# K6 twice a layer forward and again in the recompute plus the final
# LayerNorm, K7 twice a layer plus the final
SOFT_LAUNCHES = {"layer_norm_fwd_sm90": 4 * 24 + 1,
                 "layer_norm_bwd_sm90": 2 * 24 + 1}
TOY_SOFT = dict(num_layers=2, hidden_size=256, num_attention_heads=2,
                vocab_size=256, max_position_embeddings=128,
                use_flash_attention=False)
# pretrain_gpt at phase 7's flags under each policy: K3 runs again in the
# recompute unless the policy keeps its outputs (attn_res_mlp), K4 once a
# layer, K6/K7 as under attn_res
POLICY_STEPS = {"dots": 4, "attn_res_mlp": 4, "attn_out": 6}
POLICY_K3 = {"dots": 48, "attn_res_mlp": 24, "attn_out": 48}
PROFILE_POLICY = "attn_out"
PROFILE_EVERY = 2
# the kernels of path (b) and the sources that define them (their
# __global__ functions are what a device trace names)
PATH_B_SOURCES = ("flash_qkv_fwd_sm90.cu", "flash_qkv_bwd_sm90.cu",
                  "layer_norm_sm90.cu")
CUSTOM_TOL = 0.01            # the custom phase against the kernels' sum


def soft_batch(seed=19, b=4, s=2048, vocab=51200):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, vocab, (b, s + 1), generator=gen, device="cuda")
    return ids[:, :-1], ids[:, 1:]


def soft_setup(**over):
    """GPT-1.3B (remat "full") on the card with FusedAdam: the fused-softmax
    path unless ``over`` says otherwise."""
    cfg = gpt1p3b_config(**{"use_flash_attention": False, "remat_policy":
                            "full", **over})
    model = GPTModel(cfg, device="cuda")
    opt = FusedAdam(model.parameters(), lr=SOFT_LR, weight_decay=0.01)
    return model, opt


def soft_step(model, opt, tokens, labels) -> torch.Tensor:
    loss = model(tokens, labels=labels).mean()
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def drop_head_dscores():
    """A planted fault on the path under test, the bars' control: the
    fused softmax's backward drops head 0's gradient in every layer."""
    real = fsm._FusedSoftmax.backward

    def faulty(ctx, dy):
        dx, *rest = real(ctx, dy)
        dx[:, 0] = 0
        return (dx, *rest)
    return mock.patch.object(fsm._FusedSoftmax, "backward",
                             staticmethod(faulty))


def soft_gaps(run, flash, grads32, loss32) -> dict:
    """A softmax step ``run`` (loss, grads) against the flash step, each
    bar read against the fp32 step (``grads32``, ``loss32``)."""
    (loss, grads), (f_loss, f_grads) = run, flash
    leaf = leaf_gaps(grads, f_grads)
    worst = max(leaf, key=leaf.get)
    flash32 = leaf_gaps(f_grads, grads32)
    soft32 = leaf_gaps(grads, grads32)
    out = {"loss_diff": abs(loss - f_loss),
           "flash_loss_diff_fp32": abs(f_loss - loss32),
           "soft_loss_diff_fp32": abs(loss - loss32),
           "worst_leaf": worst, "worst_leaf_rel_diff": leaf[worst],
           "median_leaf_rel_diff": statistics.median(leaf.values()),
           "flash_worst_leaf_fp32": max(flash32.values()),
           "flash_median_leaf_fp32": statistics.median(flash32.values()),
           "soft_median_leaf_fp32": statistics.median(soft32.values())}
    out["leaf_ratio"] = out["worst_leaf_rel_diff"] / out[
        "flash_worst_leaf_fp32"]
    out["fp32_ratio"] = out["soft_median_leaf_fp32"] / out[
        "flash_median_leaf_fp32"]
    out["failed"] = [name for name, key, tol in (
        ("loss", "loss_diff", SOFT_LOSS_TOL),
        ("worst leaf", "leaf_ratio", SOFT_LEAF_RATIO),
        ("fp32 ratio", "fp32_ratio", SOFT_FP32_RATIO))
        if not out[key] <= tol]
    log(f"    loss diff {out['loss_diff']:.3e} (tol {SOFT_LOSS_TOL:.1e}; "
        f"from fp32: flash {out['flash_loss_diff_fp32']:.3e}, softmax "
        f"{out['soft_loss_diff_fp32']:.3e}); worst leaf {worst} "
        f"{leaf[worst]:.3e}, over the flash step's worst leaf gap from fp32 "
        f"{out['flash_worst_leaf_fp32']:.3e}: {out['leaf_ratio']:.3f} (tol "
        f"{SOFT_LEAF_RATIO}); median leaf {out['median_leaf_rel_diff']:.3e}; "
        f"median leaf gap from fp32, softmax {out['soft_median_leaf_fp32']:.3e}"
        f" over flash {out['flash_median_leaf_fp32']:.3e}: "
        f"{out['fp32_ratio']:.3f} (tol {SOFT_FP32_RATIO}); bars missed: "
        f"{out['failed'] or 'none'}")
    return out


def soft_vs_flash(tokens, labels) -> dict:
    """One dropout-free step's loss and gradients on the fused-softmax path
    (and with a planted fault) against the flash path (K3/K4) from the
    same seeded weights, the bars read against the step in fp32."""
    model, _ = soft_setup()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    soft = loss_and_grads(model, tokens, labels)
    with drop_head_dscores():
        faulty = loss_and_grads(model, tokens, labels)
    del model
    torch.cuda.empty_cache()
    flash_model, _ = soft_setup(use_flash_attention=True)
    flash_model.load_state_dict(state)
    kernels.reset_launch_counts()
    flash = loss_and_grads(flash_model, tokens, labels)
    ran = {k.symbol for k in kernels.KERNELS if k.launches}
    del flash_model
    torch.cuda.empty_cache()
    if not {"flash_qkv_fwd_sm90", "flash_qkv_bwd_sm90"} <= ran:
        raise AssertionError("the flash reference step did not run K3/K4")
    model32, _ = soft_setup(bf16=False)
    model32.load_state_dict(state)
    loss32, grads32 = loss_and_grads(model32, tokens, labels)
    del model32, state
    torch.cuda.empty_cache()
    out = {}
    for what, run in (("softmax", soft), ("head 0's dscores dropped",
                                          faulty)):
        log(f"  {what} step vs the flash step (K3/K4), from the same "
            "weights:")
        out[what] = soft_gaps(run, flash, grads32, loss32)
    if out["softmax"]["failed"]:
        raise AssertionError("the fused-softmax GPT step disagrees with the "
                             "flash step")
    if not out["head 0's dscores dropped"]["failed"]:
        raise AssertionError("the planted softmax fault passes the "
                             "softmax-vs-flash bars")
    return out


def toy_mask_card_vs_cpu() -> dict:
    """One fp32 step of the toy GPT on the fused-softmax path under a full
    causal + padding [b, 1, s, s] mask (only this path takes one), on the
    card and on the CPU from the same weights."""
    b, s = 2, TOY_SOFT["max_position_embeddings"]
    lens = torch.tensor([s, s - 37])
    q, k = torch.arange(s)[:, None], torch.arange(s)[None, :]
    mask = (k > q)[None, None] | (torch.arange(s)[None, :]
                                  >= lens[:, None])[:, None, None, :]
    gen = torch.Generator().manual_seed(23)
    ids = torch.randint(0, TOY_SOFT["vocab_size"], (b, s + 1), generator=gen)
    cpu = GPTModel(GPTConfig(**TOY_SOFT), device="cpu", seed=5)
    card = GPTModel(GPTConfig(**TOY_SOFT), device="cuda")
    card.load_state_dict(cpu.state_dict())
    out = {}
    kernels.reset_launch_counts()
    for name, m, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
        loss = m(ids[:, :-1].to(dev), labels=ids[:, 1:].to(dev),
                 attention_mask=mask.to(dev)).mean()
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.cpu()
                                   for n, p in m.named_parameters()})
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    log(f"  toy step launches {launches} (width 256: layer_norm.cu)")
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    log(f"  toy fused-softmax step under a causal + padding [b, 1, s, s] "
        f"mask: loss {out['cuda'][0]!r} (card) vs {out['cpu'][0]!r} (CPU), "
        f"rel diff {rel:.3e} (tol {TOY_LOSS_TOL:.0e})")
    if not rel <= TOY_LOSS_TOL:
        raise AssertionError("toy fused-softmax step: card and CPU losses "
                             "disagree")
    worst = max(out["cpu"][1], key=lambda n: (
        out["cuda"][1][n] - out["cpu"][1][n]).abs().max().item())
    for n in (worst, "transformer.layers.0.attention.qkv.weight"):
        check(f"toy grad {n}", out["cuda"][1][n], out["cpu"][1][n])
    for n, g in out["cpu"][1].items():
        err = (out["cuda"][1][n] - g).abs().max().item()
        if not err <= tolerance(g):
            raise AssertionError(f"toy fused-softmax step: grad {n} "
                                 f"disagrees ({err:.3e})")
    return {"loss_rel_diff": rel, "launches": launches}


def phase_softmax_gpt(smi: str) -> dict:
    """Path (a): GPT-1.3B on the fused-softmax path, three FusedAdam steps
    on one seeded batch; exact launches, a falling loss, a bitwise repeat,
    the step against the flash path, the toy under a full mask."""
    L = 24
    tokens, labels = soft_batch()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt = soft_setup()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(SOFT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(soft_step(model, opt, tokens, labels)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.symbol: k.launches for k in kernels.KERNELS if k.launches}
    per_step = {k: v / SOFT_STEPS for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  losses {losses}")
    log(f"  launches over {SOFT_STEPS} steps {launches}; per step "
        f"{per_step}, expected {SOFT_LAUNCHES} (remat full: K6 4L+1, K7 "
        f"2L+1, no K3/K4)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("fused-softmax GPT: non-finite loss")
    expect = math.log(51200) + 0.02 ** 2 * 2048 / 2
    if abs(losses[0] - expect) > STEP_LOSS_TOL:
        raise AssertionError(f"fused-softmax GPT: step 1 loss {losses[0]} "
                             f"is not within {STEP_LOSS_TOL} of {expect:.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("fused-softmax GPT: the loss does not fall")
    if per_step != SOFT_LAUNCHES:
        raise AssertionError("fused-softmax GPT: launch counts do not match "
                             "its path")
    prof = step_profile(lambda: soft_step(model, opt, tokens, labels))
    out = {"losses": losses, "step_ms": statistics.median(times[1:]),
           "peak_mem_gib": peak, "launches": launches,
           "launches_per_step": per_step, "step_profile": prof, "card": smi}
    log(f"  step {out['step_ms']:.1f} ms (median of steps 2-{SOFT_STEPS}), "
        f"peak {peak:.2f} GiB; {smi}")
    if prof["device_busy_ms"] > 0:
        log("  one step under torch.profiler: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
        log_other_ops(prof)
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(breakdown not measured)")
    del model, opt
    torch.cuda.empty_cache()

    def one_step():
        m, o = soft_setup()
        loss = soft_step(m, o, tokens, labels)
        return float(loss), [p.detach().clone() for p in m.parameters()]

    loss1, w1 = one_step()
    torch.cuda.empty_cache()
    loss2, w2 = one_step()
    same = loss1 == loss2 and all(torch.equal(x, y) for x, y in zip(w1, w2))
    del w1, w2
    torch.cuda.empty_cache()
    log(f"  the same step twice from the same state: losses {loss1!r} / "
        f"{loss2!r}, weights bitwise equal: {same}")
    if not same:
        raise AssertionError("the fused-softmax GPT step is not "
                             "deterministic")
    out["vs_flash"] = soft_vs_flash(tokens, labels)
    out["toy_mask"] = toy_mask_card_vs_cpu()
    return out


class KeptTracer(telemetry_sampler.TorchProfilerTracer):
    """The sampler's tracer, keeping a copy of each capture's trace (the
    sampler deletes its own) so the kernels' time can be read again."""

    def __init__(self, keep: str):
        super().__init__()
        self.keep = keep
        self.kept: list = []

    def stop(self) -> None:
        super().stop()
        dst = os.path.join(self.keep, f"capture_{len(self.kept)}")
        shutil.copytree(self._dir, dst)
        self.kept.append(dst)


def held_sampler(keep: str, held: list):
    """``ProfileSampler`` for ``pretrain_gpt`` to build: a
    :class:`KeptTracer`, each capture's (trace dir, report) kept, and any
    failure raised (the sampler's swallow-and-disable serves a long run;
    here it must not hide a broken tracer)."""

    class HeldSampler(telemetry.ProfileSampler):

        def __init__(self, *args, **kw):
            super().__init__(*args, tracer=KeptTracer(keep), **kw)
            self.captures = []
            held.append(self)

        def _finish(self):
            report = super()._finish()
            self.captures.append((self.tracer.kept[-1], report))
            return report

        def _fail(self, err):
            raise err

    return mock.patch.object(telemetry, "ProfileSampler", HeldSampler)


def check_profile_run(tdir: str, held: list) -> dict:
    """The stream of the profiled run: profile and memory events that
    validate, the sampler's totals, its overhead in the profile bucket,
    the phases, the custom phase against the path's kernels read from the
    same trace, and the CLI's phase row."""
    path = os.path.join(tdir, "pretrain_gpt.jsonl")
    events = load_jsonl(path)
    validate_events(events)
    profs = [e for e in events if e["type"] == "profile"]
    mems = [e for e in events if e["type"] == "memory"]
    (sampler,) = held
    totals = sampler.totals()
    end = [e for e in events if e["type"] == "run_end"][-1]
    booked = end["buckets_s"].get("profile", 0.0)
    log(f"  {len(profs)} profile and {len(mems)} memory events (every event "
        f"valid); sampler totals {totals}; profile bucket {booked:.4f} s")
    for e in profs:
        log(f"    profile step {e['step']}: phase_ms {e['phase_ms']}, total "
            f"device {e['total_device_ms']} ms, span {e['span_ms']} ms, "
            f"{e['n_ops']} ops, overhead {e['overhead_ms']} ms")
    for e in mems:
        log(f"    memory step {e['step']}: live {e.get('live_bytes')} peak "
            f"{e.get('peak_bytes')} limit {e.get('limit_bytes')} bytes")
    if not (profs and mems):
        raise AssertionError("--profile-every: no profile or memory event")
    if totals["failures"] or totals["disabled"]:
        raise AssertionError("--profile-every: the sampler failed")
    if not booked > 0:
        raise AssertionError("--profile-every: no overhead in the profile "
                             "bucket")
    fns = {fn for fn, src in
           trace_report.port_kernel_functions().items()
           if src in PATH_B_SOURCES}
    out = {"profile_events": profs, "totals": totals, "booked_s": booked,
           "custom_vs_kernels": []}
    for kept, report in sampler.captures:
        ops = trace_report.parse_trace_dir(kept)
        # the device work, read from the trace file itself: Kineto's
        # kernel and copy events (memsets are skipped by name, as in JAX)
        (trace_file,) = [os.path.join(kept, f) for f in os.listdir(kept)
                         if f.endswith(".trace.json")]
        with open(trace_file) as f:
            evs = json.load(f)["traceEvents"]
        procs = sorted({str(e.get("args", {}).get("name")) for e in evs
                        if e.get("name") == "process_name"})
        cats = {}
        for e in evs:
            if e.get("ph") == "X":
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        device_ms = sum(float(e["dur"]) for e in evs if e.get("ph") == "X"
                        and e.get("cat") in ("kernel", "gpu_memcpy")) / 1e3
        log(f"    trace: process names {procs}; complete events by "
            f"category {cats}; kernels and copies {device_ms:.3f} ms, the "
            f"report's total {report.total_ms:.3f} ms")
        host = [o.name for o in ops if o.name.startswith(("aten::", "cuda"))]
        kernels_ms = sum(o.total_ms for o in ops if
                         trace_report.kernel_base_name(o.name) in fns)
        custom = report.phase_ms.get("custom", 0.0)
        gap = abs(custom - kernels_ms) / kernels_ms if kernels_ms else 1.0
        log(f"    capture {kept}: custom {custom:.3f} ms, K3/K4/K6/K7 "
            f"kernels in the same trace {kernels_ms:.3f} ms (rel diff "
            f"{gap:.2e}, tol {CUSTOM_TOL}); phases {report.phase_ms}")
        for o in ops[:8]:
            log(f"      {o.total_ms:9.3f} ms x{o.calls:<5d} "
                f"{trace_report.classify_op(o.name):7s} {o.name[:100]}")
        if host or abs(report.total_ms - device_ms) > 1e-6 * device_ms:
            raise AssertionError("the report is not the trace's device work "
                                 f"(host events {host[:3]} parsed)")
        if not all(report.phase_ms.get(p, 0) > 0
                   for p in ("matmul", "vector", "custom")):
            raise AssertionError("--profile-every: a phase of matmul, "
                                 "vector, custom is empty")
        if not gap <= CUSTOM_TOL:
            raise AssertionError("--profile-every: the custom phase is not "
                                 "the path's kernels")
        out["custom_vs_kernels"].append((custom, kernels_ms))
    cli = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.telemetry", "summarize",
         path], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    rows = [ln for ln in cli.stdout.splitlines() if "phases" in ln]
    log(f"  python -m apex_tpu_torch.telemetry summarize: rc {cli.returncode}"
        f", phase row {rows}")
    if cli.returncode != 0 or not rows:
        raise AssertionError("telemetry summarize printed no phase row: "
                             + cli.stderr[-2000:])
    return out


def phase_policies(smi: str, train: dict) -> dict:
    """Path (b): pretrain_gpt at phase 7's GPT-1.3B flags under the remat
    policies dots, attn_res_mlp and attn_out (the last with
    --profile-every): exact launches, losses against phase 7's attn_res
    run, step ms and peak memory."""
    L = 24
    out = {}
    for policy, steps in POLICY_STEPS.items():
        want = {"flash_qkv_fwd_sm90": POLICY_K3[policy],
                "flash_qkv_bwd_sm90": L,
                "layer_norm_fwd_sm90": 4 * L + 1,
                "layer_norm_bwd_sm90": 2 * L + 1}
        losses, times = [], []
        t_last = [time.perf_counter()]

        def record(it, loss, model):
            losses.append(float(loss))
            now = time.perf_counter()
            times.append((now - t_last[0]) * 1e3)
            t_last[0] = now

        flags = FULL_TRAIN + ["--train-iters", str(steps), "--log-interval",
                              str(steps), "--remat-policy", policy]
        tdir = None
        held: list = []
        patch = contextlib.nullcontext()
        if policy == PROFILE_POLICY:
            tdir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
            flags += ["--profile-every", str(PROFILE_EVERY),
                      "--telemetry-dir", tdir]
            patch = held_sampler(tdir, held)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        try:
            with patch:
                pretrain_gpt.main(flags, device="cuda", on_step=record)
            launches = {k.symbol: k.launches for k in kernels.KERNELS
                        if k.launches}
            per_step = {k: v / steps for k, v in launches.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ref = train["losses"][:steps]
            gaps = [abs(a - b) for a, b in zip(losses, ref)]
            log(f"  {policy}: losses {losses}; phase 7's (attn_res) {ref}; "
                f"bitwise equal: {losses == ref}")
            log(f"  {policy}: launches per step {per_step}, expected {want}")
            log(f"  {policy}: step {statistics.median(times[1:]):.1f} ms "
                f"(median of steps 2-{steps}), peak {peak:.2f} GiB; {smi}")
            if per_step != want:
                raise AssertionError(f"remat {policy}: launch counts do not "
                                     "match the policy")
            bar = BF16_TOL * abs(ref[0])
            if not gaps[0] <= bar:
                raise AssertionError(f"remat {policy}: step 1 loss "
                                     f"{losses[0]} is not attn_res's "
                                     f"{ref[0]} within {bar:.3e}")
            if not all(g <= BF16_TOL * abs(r) for g, r in zip(gaps, ref)):
                raise AssertionError(f"remat {policy}: the losses leave "
                                     "attn_res's")
            run = {"losses": losses, "step_ms": statistics.median(times[1:]),
                   "peak_mem_gib": peak, "launches": launches,
                   "launches_per_step": per_step,
                   "bitwise_vs_attn_res": losses == ref, "card": smi}
            if tdir is not None:
                run["profile"] = check_profile_run(tdir, held)
            out[policy] = run
        finally:
            if tdir is not None:
                shutil.rmtree(tdir, ignore_errors=True)
    return out


def op_case(name, fn, inputs, grad_seed, cpu_fn=None) -> dict:
    """``fn(*inputs)`` and its input gradients on the card against the same
    on the CPU (the inputs copied; ``cpu_fn`` in place of ``fn`` there),
    within ``tolerance``; then timed."""
    gen = torch.Generator(device="cuda").manual_seed(grad_seed)
    leaves = [x.detach().requires_grad_(x.is_floating_point())
              for x in inputs]
    y = fn(*leaves)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    y.backward(g)
    cpu = [x.detach().cpu().requires_grad_(x.is_floating_point())
           for x in inputs]
    y_cpu = (cpu_fn or fn)(*cpu)
    y_cpu.backward(g.cpu())
    errs = {"out": check(f"{name} out", y.detach().cpu(), y_cpu.detach())}
    for i, (a, b) in enumerate(zip(leaves, cpu)):
        if a.grad is not None:
            errs[f"grad{i}"] = check(f"{name} grad {i}", a.grad.cpu(),
                                     b.grad)
    del cpu, y_cpu

    def fwd():
        with torch.no_grad():
            return fn(*leaves)

    def fwd_bwd():
        fn(*leaves).backward(g)

    t = {"fwd_ms": timing.device_time_ms(fwd),
         "fwd_bwd_ms": timing.device_time_ms(fwd_bwd)}
    for x in leaves:
        x.grad = None
    log(f"  {name}: forward {t['fwd_ms']:.3f} ms, forward + backward "
        f"{t['fwd_bwd_ms']:.3f} ms")
    return {"max_abs_err": errs, **t}


def phase_ops(smi: str) -> dict:
    """The apex ops at full width, card against CPU, then timed."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    out = {}
    scores = torch.randn(4, 16, 2048, 2048, generator=gen, device="cuda"
                         ).bfloat16()
    pad = torch.rand(4, 1, 2048, 2048, generator=gen, device="cuda") < 0.2
    pad[..., 0] = False
    out["scaled_upper_triang_masked_softmax"] = op_case(
        "scaled_upper_triang_masked_softmax [4, 16, 2048, 2048] bf16",
        lambda x: fsm.scaled_upper_triang_masked_softmax(x, 0.125),
        [scores], 1)
    out["scaled_masked_softmax"] = op_case(
        "scaled_masked_softmax [4, 16, 2048, 2048] bf16",
        lambda x, m: fsm.scaled_masked_softmax(x, m, 0.125),
        [scores, pad], 2)
    del scores, pad
    torch.cuda.empty_cache()
    logits = (torch.randn(8192, 51200, generator=gen, device="cuda") * 2
              ).bfloat16()
    labels = torch.randint(0, 51200, (8192,), generator=gen, device="cuda")
    for smoothing in (0.0, 0.1):
        for h2f in (False, True):
            key = f"softmax_cross_entropy_loss s={smoothing} h2f={h2f}"
            out[key] = op_case(
                f"softmax_cross_entropy_loss [8192, 51200] bf16, smoothing "
                f"{smoothing}, half_to_float {h2f}",
                lambda z, y, s=smoothing, h=h2f:
                xent.softmax_cross_entropy_loss(z, y, s, h),
                [logits, labels], 3)
    del logits, labels
    torch.cuda.empty_cache()
    x = torch.randn(8192, 2048, generator=gen, device="cuda").bfloat16()
    dgd = FusedDenseGeluDense(2048, 8192, 2048, device="cuda",
                              dtype=torch.bfloat16)
    out["FusedDenseGeluDense"] = op_case(
        "FusedDenseGeluDense 8192 x 2048 -> 8192 -> 2048 bf16",
        lambda a, *w: fused_dense_gelu_dense(a, *w),
        [x, dgd.dense1.weight, dgd.dense1.bias, dgd.dense2.weight,
         dgd.dense2.bias], 4)
    m = ApexMLP([2048, 8192, 2048], device="cuda", dtype=torch.bfloat16)
    # ReLU's derivative is 0 or 1: where the first product lies within
    # its summation order's rounding of 0, the card and the CPU can give it
    # opposite signs, and that unit's whole gradient differs between them.
    # The CPU reference takes the card's ReLU mask (the flips are counted)
    with torch.no_grad():
        keep = fused_dense(x, m.weight_0, m.bias_0) > 0
        flips = int((keep.cpu() != (fused_dense(
            x.cpu(), m.weight_0.cpu(), m.bias_0.cpu()) > 0)).sum())
    log(f"  MLP: the first product's sign differs card vs CPU at {flips} of "
        f"{keep.numel()} units (the CPU reference takes the card's mask)")
    keep = keep.cpu()
    out["MLP"] = op_case(
        "MLP [2048, 8192, 2048] bf16, 8192 rows, relu",
        lambda a, *w: apex_mlp(a, w[0::2], w[1::2], "relu"),
        [x, m.weight_0, m.bias_0, m.weight_1, m.bias_1], 5,
        cpu_fn=lambda a, w0, b0, w1, b1: fused_dense(
            torch.where(keep, fused_dense(a, w0, b0), 0), w1, b1))
    out["MLP"]["relu_flips"] = flips
    log(f"  the ops' times on {smi}")
    return out


def phase_rest_of_training(smi: str, train: dict) -> dict:
    t0 = time.perf_counter()
    out = {"softmax_gpt": phase_softmax_gpt(smi)}
    torch.cuda.empty_cache()
    out["policies"] = phase_policies(smi, train)
    torch.cuda.empty_cache()
    out["ops"] = phase_ops(smi)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 19 took {out['wall_s']:.1f} s; {smi}")
    return out


# -- phase 20: ResNet-50 ImageNet training under amp --------------------------

#: where every tensor of phases 20 and 21 lives (the CPU only in the stated
#: card-vs-CPU comparisons)
CARD = "cuda"
RESNET_BATCH, RESNET_IMG = 128, 224     # bench.py's _resnet_setup, not cut
RESNET_STEPS = 10
RESNET_LR = 1e-3                        # bench.py's FusedLAMB rate
# O2 (bf16, FusedLAMB) against O0 (fp32) from the same weights and batch,
# the first step: the loss (absolute, on a loss near 6.93) and the BN
# running statistics after it (relative, x max(1, max|O0|), the worst
# buffer); ten times the gaps read on an NVIDIA H100 80GB HBM3 at 700.00 W
# (5.15e-5 and 7.14e-4, the same in three runs)
RESNET_O2_LOSS_TOL = 5e-4
RESNET_O2_BN_TOL = 7e-3
# card vs CPU, resnet_tiny fp32 (O0, momentum SGD), one step: the logits
# and the loss 1e-5 x max(1, max|CPU|) (fp32 sums in another order through
# 3 convolutions and 7 batch norms), the BN statistics and the weights
# after the step the same
TINY_RESNET = dict(block_sizes=(1, 1), width=8, num_classes=10)
TINY_RESNET_TOL = 1e-5
FP16_OPT_STEPS, FP16_OPT_LR = 3, 0.1
ASP_STEPS = 3
IMAGENET_FLAGS = ["--arch", "resnet50", "--opt-level", "O2", "--optimizer",
                "lamb", "-b", "128", "--image-size", "224", "--lr", "0.001",
                "--print-freq", "2"]
RECORDS, RECORD_STEPS = 256, 2          # one pass of the records


def resnet_batch(device, seed=20):
    """bench.py's one seeded batch: 128 x 224 x 224 x 3 bf16 NHWC images,
    labels in [0, 1000)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((RESNET_BATCH, RESNET_IMG, RESNET_IMG, 3), generator=gen,
                    device=device).to(torch.bfloat16)
    y = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device=device)
    return x, y


def resnet_trainer(level, make_opt, device=None, cfg=None, **kw):
    return imagenet_main.Trainer(
        cfg or resnet50_config(), amp.initialize(level, **kw), make_opt,
        torch.device(device or CARD), seed=0)


def lamb(params):
    return FusedLAMB(params, lr=RESNET_LR, weight_decay=1e-4)


def trainer_state(tr) -> dict:
    """Every tensor a step writes, and the BN statistics, on the host."""
    out = {f"param {n}": p for n, p in tr.model.named_parameters()}
    out.update({f"buffer {n}": b for n, b in tr.model.named_buffers()})
    for n, m in zip(tr.names, tr.masters):
        out[f"master {n}"] = m
        for k, v in tr.opt.state.get(m, {}).items():
            if isinstance(v, torch.Tensor) and k != "step":
                out[f"{k} {n}"] = v
    step = tr.opt.state.get(tr.masters[0], {}).get("step")
    if isinstance(step, torch.Tensor):
        out["step"] = step
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def resnet_run(x, y, steps=RESNET_STEPS) -> dict:
    """bench.py's ResNet-50 step, ``steps`` times on one batch: each
    step's loss and skip, host enqueue and device-done ms."""
    tr = resnet_trainer("O2", lamb)
    losses, finite, enq, done = [], [], [], []
    first_bn = None
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, fin = tr.train_step(x, y)
        enq.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        done.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        finite.append(fin)
        if first_bn is None:
            first_bn = {n: b.detach().cpu().float()
                        for n, b in tr.model.named_buffers()}
    return {"trainer": tr, "losses": [float(v) for v in losses],
            "skipped": [not bool(f) for f in finite], "enqueue_ms": enq,
            "done_ms": done, "first_bn": first_bn}


def resnet_split(tr, x, y) -> dict:
    """``profiling.phase_report``'s split of one step's device time, from
    a ``profiling.trace`` of it."""
    tdir = tempfile.mkdtemp(prefix="resnet_trace_")
    try:
        torch.cuda.synchronize()
        with profiling.trace(tdir):
            tr.train_step(x, y)
        rep = profiling.phase_report(tdir, top=12)
        ops = profiling.parse_trace_dir(tdir)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    vector = sorted((o for o in ops if profiling.classify_op(o.name)
                     == "vector"), key=lambda o: -o.total_ms)[:8]
    # a convolution's compute kernel left in vector; cuDNN's layout and
    # padding helpers (nchwToNhwc, nhwcAddPadding) are vector work
    conv_like = [o.name for o in ops
                 if re.search(r"conv|implicit|gemm", o.name, re.I)
                 and profiling.classify_op(o.name) == "vector"
                 and not re.search(r"nchwToNhwc|nhwcToNchw|Padding|convert",
                                   o.name, re.I)]
    return {"phase_ms": rep.phase_ms, "total_ms": rep.total_ms,
            "span_ms": rep.span_ms, "n_ops": rep.n_ops,
            "matmul_share": rep.phase_ms.get("matmul", 0.0)
            / max(rep.total_ms, 1e-9),
            "top_ops": [(o.name[:120], o.calls, o.total_ms)
                        for o in rep.top_ops],
            "top_vector": [(o.name[:120], o.calls, o.total_ms)
                           for o in vector],
            "conv_named_in_vector": conv_like}


def resnet_planted_overflow(tr, x, y) -> dict:
    """An inf in one image: the step is skipped with every parameter,
    master, moment and the step count bitwise unchanged, the scale halved
    and ``skipped`` up by one, while the BN running statistics take the
    forward's (non-finite) values, as the JAX step keeps them."""
    before = trainer_state(tr)
    scale = float(tr.scale_state.loss_scale)
    skipped = int(tr.scale_state.skipped)
    bad = x.clone()
    bad[3, 17, 29, 1] = float("inf")
    _, _, fin = tr.train_step(bad, y)
    after = trainer_state(tr)
    if bool(fin):
        raise AssertionError("a planted inf was not seen as an overflow")
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    if any(not k.startswith("buffer ") for k in moved):
        raise AssertionError(f"a skipped step wrote {moved[:4]}")
    if not moved:
        raise AssertionError("the BN statistics did not take the skipped "
                             "step's forward")
    if float(tr.scale_state.loss_scale) != scale / 2 or \
            int(tr.scale_state.skipped) != skipped + 1:
        raise AssertionError("the scale did not halve on the overflow")
    log(f"  planted inf: step skipped, {len(before) - len(moved)} tensors "
        f"bitwise unchanged, {len(moved)} BN buffers moved (non-finite: "
        f"{sum(not bool(torch.isfinite(after[k]).all()) for k in moved)}), "
        f"scale {scale:g} -> {float(tr.scale_state.loss_scale):g}")
    return {"unchanged": len(before) - len(moved), "bn_moved": len(moved),
            "scale_after": float(tr.scale_state.loss_scale)}


def resnet_o2_vs_o0(x, y, o2_first_loss, o2_bn) -> dict:
    """The first step at O0 (fp32 throughout) from the same weights and
    batch: the O2 loss and BN statistics against it."""
    tr = resnet_trainer("O0", lamb)
    loss, _, _ = tr.train_step(x.float(), y)
    loss = float(loss)
    gaps = {"loss": abs(o2_first_loss - loss)}
    worst = 0.0
    for n, b in tr.model.named_buffers():
        ref = b.detach().cpu()
        err = float((o2_bn[n] - ref).abs().max()) / max(
            1.0, float(ref.abs().max()))
        worst = max(worst, err)
    gaps["bn_rel"] = worst
    del tr
    log(f"  O2 vs O0 (fp32) first step from the same weights: loss "
        f"{o2_first_loss:.5f} vs {loss:.5f} (gap {gaps['loss']:.3e}, bar "
        f"{RESNET_O2_LOSS_TOL}); BN statistics worst relative gap "
        f"{worst:.3e} (bar {RESNET_O2_BN_TOL})")
    if gaps["loss"] > RESNET_O2_LOSS_TOL or worst > RESNET_O2_BN_TOL:
        raise AssertionError("O2 strays from O0 past its bars")
    return {"o0_loss": loss, **gaps}


def phase_resnet50_step(smi: str) -> dict:
    """(a) bench.py's ResNet-50 step on the card."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log(f"  cudnn.deterministic={torch.backends.cudnn.deterministic}, "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}")
    x, y = resnet_batch(CARD)
    torch.cuda.reset_peak_memory_stats()
    a = resnet_run(x, y)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = a["losses"]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet-50 losses {losses} are not finite "
                             "and falling")
    state_a = trainer_state(a["trainer"])
    steady = a["done_ms"][2:]
    p50 = statistics.median(steady)
    split = resnet_split(a["trainer"], x, y)
    planted = resnet_planted_overflow(a["trainer"], x, y)
    del a["trainer"]
    torch.cuda.empty_cache()

    b = resnet_run(x, y)
    state_b = trainer_state(b.pop("trainer"))
    if b["losses"] != losses or any(
            not torch.equal(state_a[k], state_b[k]) for k in state_a):
        raise AssertionError("two runs from the same weights differ")
    del state_b
    torch.cuda.empty_cache()
    vs_o0 = resnet_o2_vs_o0(x, y, losses[0], a["first_bn"])
    torch.cuda.empty_cache()
    out = {"losses": losses, "skipped": a["skipped"],
           "step_ms_p50": p50, "img_per_s": RESNET_BATCH / p50 * 1e3,
           "enqueue_ms_p50": statistics.median(a["enqueue_ms"][2:]),
           "peak_gib": peak, "split": split, "planted": planted,
           "bitwise_rerun": True, "vs_o0": vs_o0,
           "cudnn": {"deterministic": True, "benchmark": False}}
    log(f"  ResNet-50 O2 FusedLAMB, batch 128 x 224^2 bf16: losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; skipped {sum(a['skipped'])}; step p50 {p50:.1f} ms "
        f"({out['img_per_s']:.0f} img/s), host enqueue p50 "
        f"{out['enqueue_ms_p50']:.1f} ms, peak {peak:.2f} GiB; a second "
        f"run from the same weights bitwise equal; {smi}")
    log(f"  device time by phase (phase_report): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in split["phase_ms"].items())
        + f" of {split['total_ms']:.2f} ms ({split['n_ops']} ops, span "
        f"{split['span_ms']:.2f} ms); matmul (cuDNN convolutions and the "
        f"head) {100 * split['matmul_share']:.1f} % of device time")
    for name, n, t in split["top_ops"]:
        log(f"    {t:8.2f} ms  x{n:<4d} {name}")
    log("  the largest vector ops:")
    for name, n, t in split["top_vector"]:
        log(f"    {t:8.2f} ms  x{n:<4d} {name}")
    if not split["phase_ms"].get("matmul"):
        raise AssertionError("no device time under matmul: the convolutions "
                             "were not classified")
    if split["conv_named_in_vector"]:
        raise AssertionError("convolution kernels counted as vector: "
                             f"{split['conv_named_in_vector'][:3]}")
    return out


def imagenet_start(args, launcher=(), threads=None):
    """``python -m apex_tpu_torch.examples.imagenet.main_amp`` as users
    run it, started in a subprocess of its own session (``launcher``: the
    module and arguments that start it, ``python -m
    apex_tpu_torch.parallel.multiproc --nproc N -m``; ``threads``: its
    ``OMP_NUM_THREADS``, as ``torchrun`` sets 1 for several ranks): (the
    process, its start time, the files its standard output and error go
    to)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    # its output goes to files, so that no pipe fills while it runs
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", *launcher,
         "apex_tpu_torch.examples.imagenet.main_amp"] + args, stdout=out,
        stderr=err, text=True, env=env, start_new_session=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, t0, out, err


def imagenet_kill(proc) -> None:
    """Stop a started run and every process it started (its session)."""
    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, 9)
        proc.wait()


def imagenet_finish(started, what: str) -> dict:
    """The end of an :func:`imagenet_start` run: its output and wall
    seconds."""
    proc, t0, out, err = started
    try:
        proc.wait(timeout=600)
    finally:
        imagenet_kill(proc)
    wall = time.perf_counter() - t0
    with out, err:
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    if proc.returncode != 0:
        raise AssertionError(f"the ImageNet example ({what}) exited "
                             f"{proc.returncode}: {stderr[-2000:]}")
    speeds = [float(v) for v in re.findall(r"Speed (\S+) img/s", stdout)]
    prec = re.findall(r"\* Prec@1 (\S+) Prec@5 (\S+)", stdout)
    if not speeds or not prec:
        raise AssertionError(f"the ImageNet example ({what}) printed no "
                             f"Speed or Prec@1 line: {stdout[-1000:]}")
    log(f"  main_amp {what}: {wall:.1f} s; Speed "
        + ", ".join(f"{v:.0f}" for v in speeds) + " img/s; Prec@1/Prec@5 "
        + ", ".join(f"{a}/{b}" for a, b in prec))
    return {"stdout": stdout, "wall_s": wall, "speeds": speeds,
            "prec": prec}


def imagenet_run(args, what: str) -> dict:
    """:func:`imagenet_start` and :func:`imagenet_finish`."""
    return imagenet_finish(imagenet_start(args), what)


def phase_imagenet_example(smi: str) -> dict:
    """(b) the ImageNet example: train and save, resume, the records (the
    records' run beside the other two: their speeds are of a shared
    card)."""
    tmp = tempfile.mkdtemp(prefix="imagenet_")
    records = None
    try:
        data = os.path.join(tmp, "records")
        os.makedirs(data)
        rng = np.random.default_rng(20)
        n = RECORDS
        imgs = rng.integers(0, 256, (n, RESNET_IMG * RESNET_IMG * 3),
                            dtype=np.uint8)
        labels = rng.integers(0, 1000, (n,)).astype(np.int32)
        write_records(os.path.join(data, "train0.rec"), np.concatenate(
            [imgs, labels.view(np.uint8).reshape(n, 4)], axis=1))
        records = imagenet_start(IMAGENET_FLAGS + [
            "--epochs", "1", "--steps-per-epoch", str(RECORD_STEPS),
            "--eval-steps", "2", "--data", data])
        ck = os.path.join(tmp, "ckpt")
        first = imagenet_run(IMAGENET_FLAGS + [
            "--epochs", "2", "--steps-per-epoch", "5", "--eval-steps", "2",
            "--save-dir", ck], "train + save")
        if "=> saved checkpoint (epoch 1)" not in first["stdout"]:
            raise AssertionError("main_amp saved no epoch-1 checkpoint")
        second = imagenet_run(IMAGENET_FLAGS + [
            "--epochs", "3", "--steps-per-epoch", "5", "--eval-steps", "2",
            "--save-dir", ck, "--resume", ck], "resume")
        if "(epoch 1)" not in second["stdout"] or \
                "resumed from" not in second["stdout"] or \
                "Epoch: [2]" not in second["stdout"] or \
                "Epoch: [1]" in second["stdout"]:
            raise AssertionError("the resumed run did not continue after "
                                 "epoch 1")
        rec = imagenet_finish(records, "train*.rec records")
    finally:
        if records is not None:
            imagenet_kill(records[0])
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: {"wall_s": v["wall_s"], "speeds": v["speeds"],
                "prec": v["prec"]}
            for k, v in (("train", first), ("resume", second),
                         ("records", rec))}


def phase_fp16_optimizer() -> dict:
    """(c) ``FP16_Optimizer`` around ``FusedSGD`` on ResNet-50 against the
    amp O2 + ``FusedSGD`` step, every tensor half (the JAX
    ``FP16_Optimizer`` casts them all, and the CPU test shows the JAX pair
    bitwise): three steps, bitwise."""
    x, y = resnet_batch(CARD, seed=21)

    def sgd(params):
        return FusedSGD(params, lr=FP16_OPT_LR, momentum=0.9,
                        weight_decay=1e-4)

    ref = resnet_trainer("O2", sgd, keep_batchnorm_fp32=False)
    for _ in range(FP16_OPT_STEPS):
        ref.train_step(x, y)
    want_m = [m.detach().cpu() for m in ref.masters]
    want_b = [b.detach().cpu() for b in ref.model.buffers()]
    del ref
    torch.cuda.empty_cache()
    model = ResNet(resnet50_config(), device=CARD, seed=0)
    opt = fp16_utils.FP16_Optimizer(sgd(model.parameters()))
    fp16_utils.tofp16(model)
    losses = []
    for _ in range(FP16_OPT_STEPS):
        opt.backward(lambda: softmax_cross_entropy_loss(
            model(x).float(), y).mean())
        opt.step()
        losses.append(float(opt.last_loss))
    same = all(torch.equal(a.detach().cpu(), b)
               for a, b in zip(opt.master_params, want_m)) and all(
        torch.equal(a.cpu(), b) for a, b in zip(model.buffers(), want_b))
    del model, opt
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError("FP16_Optimizer's steps differ from amp O2's")
    log(f"  FP16_Optimizer(FusedSGD) on ResNet-50, {FP16_OPT_STEPS} steps: "
        "masters and BN statistics bitwise equal to amp O2 + FusedSGD "
        "(all half); losses " + ", ".join(f"{v:.4f}" for v in losses))
    return {"bitwise": True, "losses": losses}


def phase_asp(smi: str) -> dict:
    """(d) ASP over ResNet-50's weights: masks on the card equal the CPU's
    bit for bit, 2 of every 4 kept, and three O2 steps with the masks
    re-applied keep the zeros."""
    x, y = resnet_batch(CARD, seed=22)
    tr = resnet_trainer("O2", lamb)
    masters = dict(zip(tr.names, tr.masters))
    asp = sparsity.ASP()
    t0 = time.perf_counter()
    masks = asp.compute_sparse_masks(masters)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = asp.compute_sparse_masks({n: m.detach().cpu()
                                    for n, m in masters.items()})
    allowed = [n for n, m in masks.items() if m is not None]
    for n in allowed:
        if not torch.equal(masks[n].cpu(), cpu[n]):
            raise AssertionError(f"ASP mask of {n} differs on the card")
        groups = masks[n].movedim(0, -1).reshape(-1, 4).sum(-1)
        if not bool((groups == 2).all()):
            raise AssertionError(f"ASP mask of {n} is not 2:4")

    def apply():
        with torch.no_grad():
            for n in allowed:
                masters[n].mul_(masks[n])
        amp.copy_masters(tr.params, tr.masters)

    apply()
    named = dict(tr.model.named_parameters())
    for _ in range(ASP_STEPS):
        tr.train_step(x, y)
        apply()
    kept = all(bool((named[n][~masks[n]] == 0).all()) for n in allowed)
    dens = {n: float((named[n] == 0).float().mean()) for n in allowed}
    del tr
    torch.cuda.empty_cache()
    if not kept or min(dens.values()) < 0.5:
        raise AssertionError("the pruned weights did not stay zero")
    log(f"  ASP m4n2_1d over ResNet-50: {len(allowed)} of {len(masks)} "
        f"tensors allowed, masks on the card ({card_s * 1e3:.1f} ms) equal "
        f"the CPU's bit for bit, 2 of every 4 kept; after {ASP_STEPS} O2 "
        f"steps with the masks re-applied every allowed tensor is "
        f"{100 * min(dens.values()):.1f}-{100 * max(dens.values()):.1f} % "
        "zero")
    return {"allowed": len(allowed), "tensors": len(masks),
            "mask_ms": card_s * 1e3}


def phase_resnet_tiny_card_vs_cpu() -> dict:
    """(e) resnet_tiny in fp32, one O0 momentum-SGD step, card vs CPU."""
    cfg = ResNetConfig(**TINY_RESNET)
    gen = torch.Generator().manual_seed(23)
    x = torch.randn((8, 16, 16, 3), generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)
    out = {}
    for dev in (CARD, "cpu"):
        tr = resnet_trainer("O0", lambda p: FusedSGD(p, lr=0.1, momentum=0.9),
                            dev, cfg)
        loss, logits, _ = tr.train_step(x.to(dev), y.to(dev))
        out[dev] = {"logits": logits.cpu(), "loss": loss.detach().cpu(),
                    **{f"buffer {n}": b.detach().cpu()
                       for n, b in tr.model.named_buffers()},
                    **{f"param {n}": p.detach().cpu()
                       for n, p in tr.model.named_parameters()}}
    worst = 0.0
    for k, ref in out["cpu"].items():
        err = float((out[CARD][k] - ref).abs().max())
        bar = TINY_RESNET_TOL * max(1.0, float(ref.abs().max()))
        if not err <= bar:
            raise AssertionError(f"resnet_tiny {k}: card vs CPU {err:.3e} > "
                                 f"{bar:.3e}")
        worst = max(worst, err)
    log(f"  resnet_tiny fp32 O0 SGD step, card vs CPU: logits, loss, BN "
        f"statistics and weights within {TINY_RESNET_TOL} x max(1, |ref|) "
        f"(worst {worst:.3e})")
    return {"worst_abs": worst}


def phase_resnet(smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"step": phase_resnet50_step(smi)}
    out["example"] = phase_imagenet_example(smi)
    out["fp16_optimizer"] = phase_fp16_optimizer()
    out["asp"] = phase_asp(smi)
    out["tiny"] = phase_resnet_tiny_card_vs_cpu()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 20 took {out['wall_s']:.1f} s; {smi}")
    s = out["step"]
    print(json.dumps({"phase": 20, "resnet50": {
        "losses": s["losses"], "skipped": sum(s["skipped"]),
        "step_ms_p50": s["step_ms_p50"], "img_per_s": s["img_per_s"],
        "enqueue_ms_p50": s["enqueue_ms_p50"], "peak_gib": s["peak_gib"],
        "phase_ms": s["split"]["phase_ms"],
        "matmul_share": s["split"]["matmul_share"],
        "vs_o0": s["vs_o0"], "bitwise_rerun": s["bitwise_rerun"]},
        "example_wall_s": {k: v["wall_s"] for k, v in out["example"].items()},
        "example_speeds": {k: v["speeds"] for k, v in out["example"].items()},
        "wall_s": out["wall_s"], "card": smi}), flush=True)
    return out


# -- phase 21: the other one-card families ---------------------------------

DCGAN_STEPS, DCGAN_BATCH = 20, 32        # the JAX example's defaults
DCGAN_LOSS_TOL = 1e-5                    # relative, card vs CPU, fp32 math
DCGAN_WEIGHT_ATOL, DCGAN_WEIGHT_FRAC = 1e-6, 1e-3
# NVIDIA sentiment-discovery's byte mLSTM (the width apex.RNN was written
# for): vocabulary 256, embedding 64, hidden 4096; 256 steps, batch 32
MLSTM = dict(vocab=256, emb=64, hidden=4096, seq=256, batch=32)
LSTM_HIDDEN, LSTM_LAYERS = 1024, 2
RNN_STEPS = 3
TOY_RNN_TOL = 1e-5                       # x max(1, |CPU|), fp32
# MLPerf Training RNN-T's order of size: joint hidden 512, vocabulary 1024
RNNT = dict(batch=16, t=256, u=128, hidden=512, vocab=1024)
RNNT_TOY = dict(batch=2, t=6, u=4, vocab=5)
RNNT_TOY_TOL = 1e-5                      # loss and gradient vs autograd DP
WN_TOL = 1e-5                            # x max(1, |CPU|), fp32


def dcgan_card_vs_cpu(level) -> dict:
    """One three-scaler step on the card and on the CPU from the same
    weights and batch."""
    gen = torch.Generator().manual_seed(24)
    real, z = dcgan_main.batch(gen, DCGAN_BATCH, "cpu")
    got = {}
    for dev in (CARD, "cpu"):
        gan = dcgan_main.DCGAN(level, device=dev)
        ld, lg, _ = gan.step(real.to(dev), z.to(dev))
        got[dev] = (float(ld), float(lg),
                    {f"G {n}": p.detach().cpu()
                     for n, p in zip([n for n, _ in gan.G.named_parameters()],
                                     gan.g_masters)} |
                    {f"D {n}": p.detach().cpu()
                     for n, p in zip([n for n, _ in gan.D.named_parameters()],
                                     gan.d_masters)})
    (cd, cg, cw), (rd, rg, rw) = got[CARD], got["cpu"]
    for what, a, b in (("loss_D", cd, rd), ("loss_G", cg, rg)):
        if not abs(a - b) <= DCGAN_LOSS_TOL * abs(b):
            raise AssertionError(f"DCGAN {level} {what}: card {a} vs CPU {b}")
    worst_frac = 0.0
    for k, ref in rw.items():
        err = (cw[k] - ref).abs()
        frac = float((err > DCGAN_WEIGHT_ATOL).float().mean())
        worst_frac = max(worst_frac, frac)
        if float(err.max()) > 2 * 2e-4 or frac > DCGAN_WEIGHT_FRAC:
            raise AssertionError(f"DCGAN {level} {k}: card vs CPU "
                                 f"{float(err.max()):.3e}, {frac:.2e} off")
    return {"loss_D": (cd, rd), "loss_G": (cg, rg), "worst_frac": worst_frac}


def phase_dcgan(smi: str) -> dict:
    """(f) DCGAN at the example's sizes under O1 and O2: 20 steps, the
    planted overflow in D's fake batch, card vs CPU."""
    out = {}
    for level in ("O1", "O2"):
        gan = dcgan_main.DCGAN(level, device=CARD)
        gen = torch.Generator(device=CARD).manual_seed(25)
        ms = []
        for _ in range(DCGAN_STEPS):
            real, z = dcgan_main.batch(gen, DCGAN_BATCH, CARD)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ld, lg, fins = gan.step(real, z)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ld, lg = float(ld), float(lg)
        if not (math.isfinite(ld) and math.isfinite(lg)):
            raise AssertionError(f"DCGAN {level} losses {ld}, {lg}")
        d_before = [m.detach().clone() for m in gan.d_masters]
        d_state = [t.clone() for m in gan.d_masters
                   for t in gan.optD.state[m].values()]
        g_before = [m.detach().clone() for m in gan.g_masters]
        scales = [float(s.loss_scale) for s in gan.scales]

        def plant(fake):
            fake = fake.clone()
            fake[-1, 3, 7, 2] = float("inf")
            return fake

        real, z = dcgan_main.batch(gen, DCGAN_BATCH, CARD)
        _, _, (fr, ff, fg) = gan.step(real, z, fake_hook=plant)
        after = [t for m in gan.d_masters for t in gan.optD.state[m].values()]
        ok = (bool(fr) and not bool(ff) and bool(fg)
              and all(torch.equal(a, b) for a, b in zip(gan.d_masters,
                                                        d_before))
              and all(torch.equal(a, b) for a, b in zip(after, d_state))
              and any(not torch.equal(a, b) for a, b in zip(gan.g_masters,
                                                            g_before))
              and [float(s.loss_scale) for s in gan.scales]
              == [scales[0], scales[1] / 2, scales[2]])
        if not ok:
            raise AssertionError(f"DCGAN {level}: the planted overflow in "
                                 "D's fake batch was not skipped by D alone")
        vs_cpu = dcgan_card_vs_cpu(level)
        out[level] = {"loss_D": ld, "loss_G": lg,
                      "step_ms_p50": statistics.median(ms[2:]),
                      "scales": scales, "vs_cpu": vs_cpu}
        log(f"  DCGAN {level}, batch {DCGAN_BATCH}: {DCGAN_STEPS} steps, "
            f"loss_D {ld:.4f}, loss_G {lg:.4f}, scales {scales}, step p50 "
            f"{out[level]['step_ms_p50']:.2f} ms; an inf in D's fake batch "
            f"skipped D (weights and moments bitwise), halved scale 1 only, "
            f"G stepped; card vs CPU losses within {DCGAN_LOSS_TOL} "
            f"relative, weights within {DCGAN_WEIGHT_ATOL} but "
            f"{vs_cpu['worst_frac']:.1e} of a tensor (Adam's first step)")
    return out


class ByteModel(torch.nn.Module):
    """Byte embedding -> RNN -> linear to the vocabulary (the
    sentiment-discovery language model's shape)."""

    def __init__(self, rnn, vocab, emb, width, device):
        super().__init__()
        gen = torch.Generator().manual_seed(26)
        self.embed = torch.nn.Parameter(
            (torch.randn((vocab, emb), generator=gen) * 0.1).to(device))
        self.rnn = rnn
        self.head = torch.nn.Parameter(
            (torch.randn((vocab, width), generator=gen)
             / math.sqrt(width)).to(device))

    def forward(self, tokens):
        out, _ = self.rnn(F.embedding(tokens, self.embed))
        return F.linear(out, self.head.to(out.dtype))


def rnn_run(what, rnn) -> dict:
    """Forward, backward and a FusedAdam step under O2 (bf16, fp32
    masters) on seeded bytes: step ms and peak."""
    m = MLSTM
    device = CARD
    model = ByteModel(rnn, m["vocab"], m["emb"], rnn.output_size, device)
    a = amp.initialize("O2")
    masters = a.master_params(model)
    a.cast_model(model)
    params = list(model.parameters())
    opt = FusedAdam(masters, lr=5e-4)
    gen = torch.Generator(device=device).manual_seed(27)
    tokens = torch.randint(0, m["vocab"], (m["seq"] + 1, m["batch"]),
                           generator=gen, device=device)
    fn = amp.scaled_value_and_grad(
        lambda t: softmax_cross_entropy_loss(
            model(t[:-1]).float().reshape(-1, m["vocab"]),
            t[1:].reshape(-1)).mean(), a.scaler, params)
    ss = a.scaler.init(device)
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(RNN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, finite = fn(ss, tokens)
        opt.step_if_finite(finite, grads)
        del grads
        amp.copy_masters(params, masters)
        ss = a.scaler.update(ss, finite)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what} losses {losses}")
    out = {"step_ms_p50": statistics.median(ms[1:]), "peak_gib": peak,
           "losses": losses, "first_step_ms": ms[0]}
    log(f"  {what}: {m['seq']} steps x batch {m['batch']}, forward + "
        f"backward + FusedAdam under O2 (bf16): step p50 "
        f"{out['step_ms_p50']:.1f} ms (first {ms[0]:.1f} ms), peak "
        f"{peak:.2f} GiB, losses " + ", ".join(f"{v:.4f}" for v in losses))
    return out


def rnn_toys_card_vs_cpu() -> float:
    """A toy mLSTM and a toy stacked bidirectional LSTM, fp32, forward
    and backward on the card and on the CPU from the same weights."""
    worst = 0.0
    for make in (lambda d: rnn_mod.mLSTM(8, 16, 1, output_size=12, device=d),
                 lambda d: rnn_mod.LSTM(8, 16, 2, bidirectional=True,
                                        batch_first=True, device=d)):
        x = torch.randn((5, 3, 8), generator=torch.Generator().manual_seed(28))
        res = {}
        for dev in (CARD, "cpu"):
            m = make(dev)
            xi = x.to(dev).requires_grad_(True)
            out, hid = m(xi)
            (out.square().sum() + sum(h.sum() for h in hid)).backward()
            res[dev] = [out.detach().cpu(), xi.grad.cpu()] + [
                p.grad.cpu() for p in m.parameters()]
        for a, b in zip(res[CARD], res["cpu"]):
            err = float((a - b).abs().max())
            if err > TOY_RNN_TOL * max(1.0, float(b.abs().max())):
                raise AssertionError(f"toy RNN card vs CPU {err:.3e}")
            worst = max(worst, err)
    return worst


def phase_rnns(smi: str) -> dict:
    """(g) the mLSTM at sentiment-discovery's width, a 2-layer LSTM at
    hidden 1024, and toys card vs CPU."""
    m = MLSTM
    out = {"mlstm": rnn_run(
        f"mLSTM (vocab {m['vocab']}, embedding {m['emb']}, hidden "
        f"{m['hidden']})", rnn_mod.mLSTM(m["emb"], m["hidden"], 1,
                                         device=CARD))}
    torch.cuda.empty_cache()
    out["lstm"] = rnn_run(
        f"LSTM ({LSTM_LAYERS} layers, hidden {LSTM_HIDDEN})",
        rnn_mod.LSTM(m["emb"], LSTM_HIDDEN, LSTM_LAYERS, device=CARD))
    torch.cuda.empty_cache()
    out["toy_worst"] = rnn_toys_card_vs_cpu()
    log(f"  toy mLSTM and bidirectional LSTM, card vs CPU: outputs and "
        f"gradients within {TOY_RNN_TOL} x max(1, |ref|) (worst "
        f"{out['toy_worst']:.3e}); {smi}")
    return out


def rnnt_dp_autograd(x, label, f_len, y_len, blank):
    """The cell-by-cell alpha DP, differentiated by autograd (the
    reference the analytic backward is held to)."""
    y = torch.log_softmax(x.float(), dim=-1)
    losses = []
    for b in range(x.shape[0]):
        fl, yl = int(f_len[b]), int(y_len[b])
        a = {(0, 0): torch.zeros((), device=x.device)}
        for t in range(1, fl):
            a[(t, 0)] = a[(t - 1, 0)] + y[b, t - 1, 0, blank]
        for u in range(1, yl + 1):
            a[(0, u)] = a[(0, u - 1)] + y[b, 0, u - 1, label[b, u - 1]]
        for t in range(1, fl):
            for u in range(1, yl + 1):
                a[(t, u)] = torch.logaddexp(
                    a[(t - 1, u)] + y[b, t - 1, u, blank],
                    a[(t, u - 1)] + y[b, t, u - 1, label[b, u - 1]])
        losses.append(-(a[(fl - 1, yl)] + y[b, fl - 1, yl, blank]))
    return torch.stack(losses)


def rnnt_toy() -> float:
    """At a small size on the card: the loss and its gradient against
    autograd through the DP."""
    s = RNNT_TOY
    gen = torch.Generator(device=CARD).manual_seed(29)
    x = torch.randn((s["batch"], s["t"], s["u"], s["vocab"]), generator=gen,
                    device=CARD)
    label = torch.randint(1, s["vocab"], (s["batch"], s["u"] - 1),
                          generator=gen, device=CARD)
    f_len = torch.tensor([s["t"], s["t"] - 2], device=CARD)
    y_len = torch.tensor([s["u"] - 1, s["u"] - 2], device=CARD)
    a = x.clone().requires_grad_(True)
    la = transducer.transducer_loss(a, label, f_len, y_len, 0)
    la.sum().backward()
    b = x.clone().requires_grad_(True)
    lb = rnnt_dp_autograd(b, label, f_len, y_len, 0)
    lb.sum().backward()
    worst = 0.0
    for what, p, q in (("loss", la.detach(), lb.detach()),
                       ("grad", a.grad, b.grad)):
        err = float((p - q).abs().max())
        if err > RNNT_TOY_TOL * max(1.0, float(q.abs().max())):
            raise AssertionError(f"RNN-T toy {what}: {err:.3e} from the "
                                 "autograd DP")
        worst = max(worst, err)
    return worst


def phase_rnnt(smi: str) -> dict:
    """(h) the RNN-T joint, a linear to the vocabulary and the loss at
    MLPerf RNN-T's order of size, bf16, forward and backward; packed
    equal to dense; the toy against the autograd DP."""
    s = RNNT
    gen = torch.Generator(device=CARD).manual_seed(30)
    f = (torch.randn((s["batch"], s["t"], s["hidden"]), generator=gen,
                     device=CARD) * 0.5).to(torch.bfloat16)
    g = (torch.randn((s["batch"], s["u"], s["hidden"]), generator=gen,
                     device=CARD) * 0.5).to(torch.bfloat16)
    w = (torch.randn((s["vocab"], s["hidden"]), generator=gen, device=CARD)
         / math.sqrt(s["hidden"])).to(torch.bfloat16)
    f_len = torch.randint(s["t"] // 2, s["t"] + 1, (s["batch"],),
                          generator=gen, device=CARD)
    f_len[0] = s["t"]
    y_len = torch.randint(s["u"] // 2, s["u"], (s["batch"],), generator=gen,
                          device=CARD)
    y_len[0] = s["u"] - 1
    label = torch.randint(1, s["vocab"], (s["batch"], s["u"] - 1),
                          generator=gen, device=CARD)
    g_len = y_len + 1

    def dense():
        fi, gi, wi = (t.detach().requires_grad_(True) for t in (f, g, w))
        h = transducer.transducer_joint(fi, gi, f_len, g_len, relu=True)
        logits = F.linear(h, wi)
        loss = transducer.transducer_loss(logits, label, f_len, y_len, 0)
        loss.mean().backward()
        return loss.detach(), logits.detach(), (fi.grad, gi.grad, wi.grad)

    dense()                                 # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, logits, grads = dense()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not bool(torch.isfinite(loss).all()) or not all(
            bool(torch.isfinite(t.float()).all()) for t in grads):
        raise AssertionError("RNN-T loss or gradients not finite")
    # the loss alone, forward and backward, on these logits
    x = logits.requires_grad_(True)

    def loss_only():
        x.grad = None
        transducer.transducer_loss(x, label, f_len, y_len, 0).mean() \
            .backward()

    loss_ms = timing.device_time_ms(loss_only, steps=3)
    # packed: the joint's packed output is the dense one's valid cells, and
    # the loss over the packed logits equals the dense loss, gradient too
    offs = torch.cumsum(f_len * g_len, 0)
    n = int(offs[-1])
    with torch.no_grad():
        hd = transducer.transducer_joint(f, g, f_len, g_len, relu=True)
        hp = transducer.transducer_joint(f, g, f_len, g_len, relu=True,
                                         pack_output=True, batch_offset=offs,
                                         packed_batch=n)
        same_joint = torch.equal(hp, transducer_mod._pack(
            hd, f_len, g_len, offs, n))
        del hd, hp
    xp = transducer_mod._pack(x.detach(), f_len, g_len, offs, n) \
        .requires_grad_(True)
    lp = transducer.transducer_loss(xp, label, f_len, y_len, 0,
                                    packed_input=True, batch_offset=offs,
                                    max_f_len=s["t"])
    lp.mean().backward()
    x.grad = None
    ld = transducer.transducer_loss(x, label, f_len, y_len, 0)
    ld.mean().backward()
    same_loss = torch.equal(lp.detach(), ld.detach())
    same_grad = torch.equal(xp.grad, transducer_mod._pack(
        x.grad, f_len, g_len, offs, n))
    del xp, lp, ld, x, logits
    if not (same_joint and same_loss and same_grad):
        raise AssertionError(f"packed RNN-T differs from dense (joint "
                             f"{same_joint}, loss {same_loss}, gradient "
                             f"{same_grad})")
    toy = rnnt_toy()
    out = {"fwd_bwd_ms": ms, "loss_fwd_bwd_ms": loss_ms, "peak_gib": peak,
           "mean_loss": float(loss.mean()), "packed_cells": n,
           "toy_worst": toy}
    log(f"  RNN-T: f [16, 256, 512], g [16, 128, 512] bf16, joint + relu, "
        f"linear to 1024, loss over f_len {int(f_len.min())}-"
        f"{int(f_len.max())}, y_len {int(y_len.min())}-{int(y_len.max())}: "
        f"forward + backward {ms:.1f} ms (the loss alone {loss_ms:.1f} ms), "
        f"peak {peak:.2f} GiB, mean loss {out['mean_loss']:.3f}; packed "
        f"({n} cells) joint, loss and gradient bitwise the dense ones; toy "
        f"loss and gradient within {RNNT_TOY_TOL} of autograd through the "
        f"DP (worst {toy:.3e}); {smi}")
    return out


def phase_weight_norm() -> dict:
    """(i) weight norm over DCGAN's discriminator: the forward and the
    gradients of g and v, card vs CPU."""
    gen = torch.Generator().manual_seed(31)
    x = torch.randn((8, dcgan_main.IMG, dcgan_main.IMG, 3), generator=gen)
    res = {}
    for dev in (CARD, "cpu"):
        d = dcgan_main.Discriminator(device=dev)
        p = reparameterization.apply_weight_norm(d, dim=0)
        out = torch.func.functional_call(
            d, reparameterization.compute_weights(p, dim=0), (x.to(dev),))
        out.square().sum().backward()
        res[dev] = [out.detach().cpu()] + [
            t.grad.cpu() for k in sorted(p) if isinstance(p[k], dict)
            for t in (p[k]["g"], p[k]["v"])]
    worst = 0.0
    for a, b in zip(res[CARD], res["cpu"]):
        err = float((a - b).abs().max())
        if err > WN_TOL * max(1.0, float(b.abs().max())):
            raise AssertionError(f"weight norm card vs CPU {err:.3e}")
        worst = max(worst, err)
    log(f"  weight norm on DCGAN's discriminator (dim 0, all four weights): "
        f"output and the g and v gradients card vs CPU within {WN_TOL} x "
        f"max(1, |ref|) (worst {worst:.3e})")
    return {"worst_abs": worst}


def phase_families(smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"dcgan": phase_dcgan(smi)}
    out["rnn"] = phase_rnns(smi)
    torch.cuda.empty_cache()
    out["rnnt"] = phase_rnnt(smi)
    torch.cuda.empty_cache()
    out["weight_norm"] = phase_weight_norm()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 21 took {out['wall_s']:.1f} s; {smi}")
    print(json.dumps({"phase": 21, "dcgan": {
        k: {"loss_D": v["loss_D"], "loss_G": v["loss_G"],
            "step_ms_p50": v["step_ms_p50"]} for k, v in out["dcgan"].items()},
        "mlstm": {k: out["rnn"]["mlstm"][k] for k in ("step_ms_p50",
                                                     "peak_gib")},
        "lstm": {k: out["rnn"]["lstm"][k] for k in ("step_ms_p50",
                                                   "peak_gib")},
        "rnnt": {k: out["rnnt"][k] for k in ("fwd_bwd_ms", "loss_fwd_bwd_ms",
                                             "peak_gib")},
        "wall_s": out["wall_s"], "card": smi}), flush=True)
    return out


#: the phase running now, named in the failure line
# -- phase 22: tensor- and data-parallel GPT training on torch.distributed ---
#
# One card: NCCL refuses two ranks on one GPU, so the ranks share cuda:0 and
# run their collectives over gloo, which stages every CUDA tensor through the
# host.  The numbers and the kernels are checked on the card; NVLink and NCCL
# between ranks are not, and the wall times of ranks that time-slice one card
# say nothing of a run over several.

GLOO_WHY = ("ranks share cuda:0 over --distributed-backend gloo: this machine "
            "has one card and NCCL refuses two ranks on one GPU; every "
            "collective is staged through the host")
# GPT-1.3B width cut to 2 layers (pretrain_gpt runs no remat below 12;
# tp 2 under remat attn_res runs in phases 23 (c) and 24 (c)): at 12 layers
# the phase took 166.2-178.2 s of the script's 1200 s on an NVIDIA H100
# 80GB HBM3 at 700.00 W, 71-85 % of each step in host-staged collectives;
# at 4 layers 62.1 s, cut again to 2 to make room for phase 27 (the
# layouts, launches and bitwise checks do not change with the depth)
TP22_LAYERS = 2
TP22_STEPS = 3
# dropout off: tp 1 and tp 2 draw the attention masks from other streams
# (tp 2: one stream a rank over its heads), so their losses would part by
# the masks, not by the arithmetic; the dropout property is probed apart
TP22_TRAIN = (FULL_TRAIN[:1] + [str(TP22_LAYERS)] + FULL_TRAIN[2:]
              + ["--log-interval", "1", "--attention-dropout", "0",
                 "--hidden-dropout", "0"])
TP22_DP = ["--micro-batch-size", "2", "--global-batch-size", "4"]
# the fp32 toy of (a): head dim 128 (the packed kernels' scalar fp32 route),
# two heads a rank at tp = 2; JAX's own bar (tests/L0/test_megatron_models.py)
TOY22 = ["--num-layers", "2", "--hidden-size", "512", "--num-attention-heads",
         "4", "--seq-length", "256", "--max-position-embeddings", "256",
         "--micro-batch-size", "2", "--vocab-size", "1024",
         "--train-iters", "3", "--log-interval", "1",
         "--attention-dropout", "0", "--hidden-dropout", "0"]
TOY22_RTOL, TOY22_ATOL = 2e-4, 1e-5
TP22_KERNELS = ("flash_qkv_fwd_sm90", "flash_qkv_bwd_sm90",
                "layer_norm_fwd_sm90", "layer_norm_bwd_sm90")
# bars of (b) and (c), absolute on losses near 11.25, each ten times the
# largest gap of the three steps read on an H100 (phase 7's convention).
# (b): tp 1 takes the fused LM-head CE over bf16 logits, tp 2 the
# vocab-parallel CE over fp32 logits, and tp 2's row-parallel partials are
# rounded to bf16 before their sum: read 1.46e-4.  (c): each dp rank's
# backward sums over 2 rows, and the gradients' mean is taken across
# ranks: read 2.06e-4
TP22_LOSS_TOL = 1.5e-3
TP22_DP_LOSS_TOL = 2e-3


def tp22_launches(layers: int, steps: int) -> dict:
    """A rank's launches of a pretrain_gpt run: :func:`gpt_step_launches`
    a step on each rank's heads."""
    return {k: v * steps for k, v in gpt_step_launches(layers).items()}


def digest(t: torch.Tensor) -> tuple:
    """A position-sensitive sum of ``t``'s bits (two int64s): equal
    tensors give equal digests, one flipped bit changes both."""
    bits = t.detach().contiguous().view(-1)
    bits = bits.view(torch.int16 if bits.element_size() == 2 else
                     torch.int32).to(torch.int64)
    w = torch.arange(bits.numel(), device=bits.device) % 1021 + 1
    return int(bits.sum()), int((bits * w).sum())


def tp22_probe(device) -> dict:
    """What gloo takes directly, tried on this rank's tensors: sum and max
    all-reduce, all-gather and broadcast of CUDA tensors, and a bf16 sum on
    the host (the port's collectives stage and widen either way)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}

    def attempt(name, fn):
        try:
            out[name] = bool(fn())
        except (RuntimeError, ValueError) as e:
            out[name] = f"refused: {type(e).__name__}: {str(e)[:120]}"

    def reduce_(op, dtype=torch.float32, dev=device):
        t = torch.full((4,), float(rank + 1), dtype=dtype, device=dev)
        dist.all_reduce(t, op=op)
        want = (sum(range(1, world + 1)) if op == dist.ReduceOp.SUM
                else world)
        return torch.equal(t.float().cpu(), torch.full((4,), float(want)))

    def gather_():
        t = torch.full((2,), float(rank), device=device)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return all(float(p[0]) == r for r, p in enumerate(parts))

    def bcast_():
        t = torch.full((3,), float(rank + 7), device=device)
        dist.broadcast(t, src=0)
        return float(t[0]) == 7.0

    attempt("cuda_all_reduce_sum", lambda: reduce_(dist.ReduceOp.SUM))
    attempt("cuda_all_reduce_max", lambda: reduce_(dist.ReduceOp.MAX))
    attempt("cuda_all_gather", gather_)
    attempt("cuda_broadcast", bcast_)
    attempt("host_bf16_sum", lambda: reduce_(dist.ReduceOp.SUM,
                                             torch.bfloat16, "cpu"))
    return out


def tp22_toy(argv, device) -> list:
    """Losses of the fp32 toy's three steps through pretrain_gpt."""
    losses = []
    pretrain_gpt.main(argv, device=device,
                      on_step=lambda it, loss, m: losses.append(float(loss)))
    return losses


def tp22_dropout_probe(model, device) -> tuple:
    """Digests of the hidden state of one seeded sequence through the
    model's layers with dropout on (at the Megatron default rates, in K3
    on the per-rank stream and on the replicated one after each block)
    and with it off: both ranks must hold the same bits."""
    held = model.cfg
    cfg = dataclasses.replace(held, attention_dropout=0.1,
                              hidden_dropout=0.1)
    for mod in model.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = cfg
    gen = torch.Generator(device=device).manual_seed(23)
    ids = torch.randint(0, cfg.vocab_size, (1, cfg.max_position_embeddings),
                        generator=gen, device=device)
    try:
        with torch.no_grad():
            h, _ = model.transformer(model.embed(ids), dropout_seed=29)
            h0, _ = model.transformer(model.embed(ids))
    finally:
        for mod in model.modules():
            if hasattr(mod, "cfg"):
                mod.cfg = held
    return digest(h), digest(h0)


def tp22_train(argv, device, dropout_probe_at=None) -> dict:
    """One pretrain_gpt run on this rank: per-step losses, digests of every
    parameter, wall and collective seconds; the rank's launches of the
    main path's kernels over the run, its peak memory; at step
    ``dropout_probe_at`` (after the step, its launches not counted) the
    dropout probe (:func:`tp22_dropout_probe`)."""
    from apex_tpu_torch.parallel import comm

    card = device.type == "cuda"
    steps, out = [], {}
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = [time.perf_counter()]

    def on_step(it, loss, model):
        value = float(loss)
        if card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append(dict(step=it + 1, loss=value,
                          wall_s=now - t0[0],
                          comm=comm.STATS.as_dict(),
                          digests={n: digest(p) for n, p in
                                   model.named_parameters()}))
        if it + 1 == dropout_probe_at:
            out["launches"] = launch_counts()
            out["dropout_hidden"] = tp22_dropout_probe(model, device)
        comm.STATS.reset()
        t0[0] = time.perf_counter()

    comm.STATS.reset()
    pretrain_gpt.main(argv, device=device, on_step=on_step)
    launches = out.pop("launches", None) or launch_counts()
    out.update(steps=steps,
               launches={k: launches.get(k, 0) for k in TP22_KERNELS},
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if card else 0.0))
    return out


def phase22_rank(rank, world, init_file, out, jobs):
    """A rank of phase 22 (spawned): joins the process group on the jobs'
    backend, runs each job in order (a barrier after each, so a
    checkpoint is whole before the next run reads it) and writes the
    results to ``<out>/rank<r>.pt``."""
    import gc

    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = multiproc.init_file_group(jobs[0]["backend"], rank, world,
                                       init_file)
    results = {}
    for job in jobs:
        kind = job["kind"]
        if kind == "probe":
            results[job["name"]] = tp22_probe(device)
        elif kind == "nccl":
            results[job["name"]] = tp22_nccl(device)
        elif kind == "toy":
            results[job["name"]] = tp22_toy(job["argv"], device)
        else:
            results[job["name"]] = tp22_train(job["argv"], device,
                                              job.get("dropout_probe_at"))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def tp22_nccl(device) -> dict:
    """NCCL at world 1: ``all_reduce_grads`` (no collective at one rank)
    and NCCL's own all-reduce, broadcast and all-gather of bf16 and fp32
    CUDA tensors, each equal to its input bit for bit."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import all_reduce_grads

    gen = torch.Generator(device=device).manual_seed(31)
    grads = [torch.randn(1024, 2048, generator=gen, device=device),
             torch.randn(2048, generator=gen, device=device).bfloat16()]
    got = all_reduce_grads(grads, dist.group.WORLD)
    same = [torch.equal(a, b) for a, b in zip(got, grads)]
    for g in grads:
        t = g.clone()
        dist.all_reduce(t)
        same.append(torch.equal(t, g))
        t = g.clone()
        dist.broadcast(t, src=0)
        same.append(torch.equal(t, g))
        t = torch.empty_like(g)
        dist.all_gather_into_tensor(t, g)
        same.append(torch.equal(t, g))
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "bitwise": same}


def tp22_spawn(world: int, jobs: list, tmp: str, what: str,
               body=None) -> list:
    """Run ``jobs`` in ``world`` spawned ranks of ``body`` (default
    :func:`phase22_rank`); the ranks' results."""
    from apex_tpu_torch.parallel.multiproc import spawn

    out = tempfile.mkdtemp(dir=tmp, prefix=what)
    t0 = time.perf_counter()
    spawn(body or phase22_rank, world, os.path.join(out, "store"), out, jobs,
          timeout=900)
    log(f"  {what}: {world} rank(s) done in {time.perf_counter() - t0:.1f} s "
        "(process start, weights, steps)")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def concurrently(*fns) -> list:
    """Each no-argument callable in a thread of its own, all at once (the
    launches of ranks a phase holds apart: their processes share the card
    and the host, so their wall times are of a busier card); their results
    in order.  Every thread is joined before the first error is raised."""
    results, errors = [None] * len(fns), [None] * len(fns)

    def run(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # raised below, once all have ended
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def tp22_replicas(name, runs, pairs, only=None) -> None:
    """Each pair of ranks holds the same bits after every step, in every
    parameter (``only``: in the parameters it selects)."""
    for a, b in pairs:
        for sa, sb in zip(runs[a]["steps"], runs[b]["steps"]):
            for n, dg in sa["digests"].items():
                if only is not None and not only(n):
                    continue
                if dg != sb["digests"][n]:
                    raise AssertionError(
                        f"{name}: ranks {a} and {b} differ in {n} after "
                        f"step {sa['step']}")
    log(f"  {name}: bitwise equal after each of {len(runs[0]['steps'])} "
        f"steps (rank pairs {pairs})")


def is_replicated(name: str) -> bool:
    """The leaves every tp rank holds whole: the LayerNorms, the
    row-parallel biases and the position embedding."""
    return any(k in name for k in ("layernorm", "position_embeddings",
                                   "proj.bias", "dense_4h_to_h.bias"))


def tp22_losses(what, got, want, tol) -> float:
    gap = max(abs(a - b) for a, b in zip(got, want))
    log(f"  {what}: {got} against {want}: max gap {gap:.3e} (bar {tol:.1e})")
    if len(got) != len(want) or not gap <= tol:
        raise AssertionError(f"{what}: losses differ by {gap:.3e} > {tol}")
    return gap


def tp22_kernel_rows(seed: int) -> dict:
    """K3/K4 at the tp = 2 shape [4, 2048, 8 x 3 x 128] bf16 (a rank's
    heads), phase 3's way: against the plain versions with phase 3's bars,
    run twice bitwise, then timed cold beside the plain versions, SDPA and
    the bound."""
    h = FULL_HEADS_TP2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e3, e4, ops = flash_qkv_case(gen, f"bf16 causal, dropout {ATT_DROPOUT}, "
                                 f"{h} heads (a rank's at tp 2)", torch.bfloat16,
                                 ATT_DROPOUT, h=h)
    fwd, bwd, _ = time_flash_qkv(*ops, ATT_DROPOUT, h=h)
    fwd["max_abs_err"], bwd["max_abs_err"] = e3, e4
    del ops
    torch.cuda.empty_cache()
    return {"flash_qkv_fwd_sm90_tp2": fwd, "flash_qkv_bwd_sm90_tp2": bwd}


FULL_HEADS_TP2 = TRAIN["heads"] // 2


def phase_tp_dp(smi: str) -> dict:
    """Phase 22 (see the module docstring)."""
    log(f"  {GLOO_WHY}")
    t_phase = time.perf_counter()
    rows = tp22_kernel_rows(41)
    tmp = tempfile.mkdtemp(prefix="tp22_")
    try:
        gloo = {"backend": "gloo"}
        # the references of (a) and (b) on this process, at tp 1
        toy1 = tp22_toy(TOY22, CARD)
        steps = ["--train-iters", str(TP22_STEPS)]
        ref = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pretrain_gpt.main(TP22_TRAIN + steps, device=CARD,
                          on_step=lambda it, loss, m: ref.append(float(loss)))
        ref_s = time.perf_counter() - t0
        log(f"  (b) tp 1 reference (one process): losses {ref}, "
            f"{ref_s:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()

        # three launches side by side: NCCL at world 1; two ranks for the
        # gloo probe, (a) the fp32 toy at tp 2 and (b) GPT-1.3B width at
        # tp 2 (run, re-run with a save, resume); four for (c) tp 2 x dp 2
        ck = os.path.join(tmp, "ckpt")
        tp2 = ["--tensor-model-parallel-size", "2"]
        log("  the three launches below run side by side: their wall times "
            "are of a card shared by seven ranks")
        nccl, runs, dp_runs = concurrently(
            lambda: tp22_spawn(1, [dict(kind="nccl", name="nccl",
                                        backend="nccl")], tmp, "nccl"),
            lambda: tp22_spawn(2, [
                dict(gloo, kind="probe", name="probe"),
                dict(gloo, kind="toy", name="toy", argv=TOY22 + tp2),
                dict(gloo, kind="train", name="run",
                     dropout_probe_at=TP22_STEPS,
                     argv=TP22_TRAIN + tp2 + steps),
                dict(gloo, kind="train", name="saved",
                     argv=TP22_TRAIN + tp2 + ["--train-iters", "2",
                                               "--save", ck]),
                dict(gloo, kind="train", name="resumed",
                     argv=TP22_TRAIN + tp2 + steps + ["--load", ck])],
                tmp, "gloo probe, (a) fp32 toy and (b) GPT-1.3B width at "
                "tp 2"),
            lambda: tp22_spawn(4, [dict(gloo, kind="train", name="run",
                                        argv=TP22_TRAIN + tp2 + TP22_DP
                                        + steps)],
                               tmp, "(c) GPT-1.3B width at tp 2 x dp 2"))
        nccl = nccl[0]["nccl"]
        log(f"  (e) NCCL at world 1: backend {nccl['backend']}, bitwise "
            f"{nccl['bitwise']}")
        if nccl["backend"] != "nccl" or not all(nccl["bitwise"]):
            raise AssertionError("(e) NCCL at world 1 is not the identity")
        probe = runs
        log(f"  gloo on this card (rank 0): {probe[0]['probe']}")

        # (a) the fp32 toy, tp 2 against tp 1 from the same master weights
        for r, res in enumerate(runs):
            for a, b in zip(res["toy"], toy1):
                if not abs(a - b) <= TOY22_ATOL + TOY22_RTOL * abs(b):
                    raise AssertionError(f"(a) rank {r}: {res['toy']} vs "
                                         f"tp 1 {toy1}")
        log(f"  (a) fp32 toy: tp 2 {runs[0]['toy']}, tp 1 {toy1} (rtol "
            f"{TOY22_RTOL}, atol {TOY22_ATOL}): ok")

        # (b) GPT-1.3B width at tp 2 against tp 1, three steps
        run = [r["run"] for r in runs]
        losses = [s["loss"] for s in run[0]["steps"]]
        if [s["loss"] for s in run[1]["steps"]] != losses:
            raise AssertionError("(b) the tp ranks report different losses")
        gap_b = tp22_losses("(b) tp 2 against tp 1", losses, ref,
                            TP22_LOSS_TOL)
        tp22_replicas("(b) replicated leaves across the tp ranks", run,
                      [(0, 1)], only=is_replicated)
        for r, res in enumerate(runs):
            saved, resumed = res["saved"]["steps"], res["resumed"]["steps"]
            if [s["digests"] for s in saved] != [
                    s["digests"] for s in res["run"]["steps"][:2]] or [
                    s["loss"] for s in saved] != losses[:2]:
                raise AssertionError(f"(b) rank {r}: the re-run is not "
                                     "bitwise the run")
            if [s["step"] for s in resumed] != [3] or \
                    resumed[0]["loss"] != losses[2] or \
                    resumed[0]["digests"] != res["run"]["steps"][2]["digests"]:
                raise AssertionError(f"(d) rank {r}: the resume from step 2 "
                                     "is not bitwise the uninterrupted run")
        log("  (b) re-run (2 steps, saved) bitwise the run's first two; "
            "(d) resumed from its step-2 checkpoint (a leading tp axis of "
            "2) bitwise the run's step 3, every parameter, both ranks")
        h = [res["run"]["dropout_hidden"] for res in runs]
        if h[0][0] != h[1][0] or h[0][0] == h[0][1]:
            raise AssertionError("(b) with dropout on, the tp ranks' hidden "
                                 "states differ (or dropout did nothing)")
        log("  (b) dropout 0.1/0.1: both ranks' hidden state bitwise equal, "
            "and not the dropout-free one")

        # (c) tp 2 x dp 2 on the same global batch
        dp = [r["run"] for r in dp_runs]
        gap_c = tp22_losses("(c) tp 2 x dp 2 against (b)",
                            [s["loss"] for s in dp[0]["steps"]], losses,
                            TP22_DP_LOSS_TOL)
        tp22_replicas("(c) dp replicas", dp, [(0, 2), (1, 3)])
        tp22_replicas("(c) replicated leaves across the tp ranks", dp,
                      [(0, 1), (2, 3)], only=is_replicated)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (f) each rank's launches, exactly
    want = tp22_launches(TP22_LAYERS, TP22_STEPS)
    for what, rr in (("(b)", run), ("(c)", dp)):
        for r, res in enumerate(rr):
            if res["launches"] != want:
                raise AssertionError(f"(f) {what} rank {r} launched "
                                     f"{res['launches']}, expected {want}")
    log(f"  (f) launches of every rank of (b) and (c): {want} (K3 L, K4 L, "
        f"K6 2L+1 (no remat below 12 layers), K7 2L+1 a step, L = "
        f"{TP22_LAYERS}, {TP22_STEPS} steps)")

    # (g) the record: wall time, the collectives' share, each rank's peak
    def summary(rr):
        out = []
        for res in rr:
            st = res["steps"][1:]          # after the first step's warm-up
            wall = sum(s["wall_s"] for s in st)
            coll = sum(s["comm"]["seconds"] for s in st)
            out.append(dict(step_s=[round(s["wall_s"], 4) for s in
                                    res["steps"]],
                            comm_share=coll / wall,
                            comm_gb_per_step=statistics.mean(
                                s["comm"]["bytes"] for s in st) / 1e9,
                            comm_calls_per_step=statistics.mean(
                                s["comm"]["calls"] for s in st),
                            peak_gib=res["peak_gib"]))
        return out

    record = {"card": smi, "shared_card": True, "layers": TP22_LAYERS,
              "tp2": summary(run), "tp2_dp2": summary(dp),
              "tp1_reference_s": ref_s, "loss_gap_tp2_vs_tp1": gap_b,
              "loss_gap_dp2_vs_tp2": gap_c, "gloo_probe": probe[0]["probe"],
              "launches_per_rank": want}
    log("  (g) wall times are of ranks time-slicing ONE card over gloo "
        "(host-staged collectives); they say nothing of a run over several "
        "cards")
    log("  phase 22 " + json.dumps(record))
    log(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "launches": want, "ranks_tp2": [
        r["launches"] for r in run], "ranks_tp2_dp2": [
        r["launches"] for r in dp], "record": record}


# -- phase 23: pipeline-parallel GPT training on torch.distributed ----------
#
# The stages are ranks sharing cuda:0 over gloo, as in phase 22: every
# stage-to-stage transfer and collective is staged through the host.  The
# schedules' numbers, kernels and memory are checked on the card; their
# speed over several cards is not.

# GPT-1.3B width cut to 8 layers (4 a stage at pp 2, 1 a chunk at pp 4 x
# vpp 2): the phase checks the schedules' numbers, kernels and memory, not
# the depth; at 24 layers it took 72.1-104.3 s of the script's 1200 s on
# an NVIDIA H100 80GB HBM3 at 700.00 W, its launches one after the other
PP23_LAYERS = 8
PP23_KW = dict(GPT1P3B_KW, num_layers=PP23_LAYERS, attention_dropout=0.0,
               hidden_dropout=0.0)
PP23_M, PP23_SEQ = 4, 2048            # micro-batch 1: phase 7's 4 x 2048
PP23_STEPS, PP23_VPP_STEPS, PP23_AMP_STEPS = 3, 2, 3
PP23_LR = 1.5e-4
PP23_SEED = 0
PP23_AMP_LAYERS = 4                   # (c) cut as phase 22 is
PP23_PLANT_AT = 2
# a stage's input, [1, 2048, 2048] bf16: the m = 8 peak may pass the m = 4
# peak by less than this (the saved inputs do not grow with m)
PP23_STAGE_INPUT_BYTES = 1 * 2048 * 2048 * 2
# bars, from the predictions written in PERF.md before the chip runs.
# Step 1 is the same arithmetic in every layout (predicted bitwise, read
# bitwise on an H100): the loss within 1e-4, each leaf's gradient
# statistics within 1e-3 of its norm.  After step 1, (a) parts from tp 1 /
# pp 1 by its tied word embedding (the pipeline's two copies are untied):
# predicted within 5e-3, read 1.76e-2 and 5.18e-2 on losses falling 0.58
# and 0.67 a step, so the bar is the tie's size, 0.2; against the same two
# halves chained in one process (untied, no schedule) every step is the
# same arithmetic (predicted bitwise): 1e-4
PP23_STEP1_LOSS_TOL = 1e-4
PP23_STEP1_GRAD_TOL = 1e-3
PP23_TIED_LOSS_TOL = 0.2
PP23_LOSS_TOL = 1e-4
PP23_F16 = tuple(k + "_f16" for k in TP22_KERNELS)


def pp23_batch(m: int, device) -> dict:
    """Phase 7's seeded batch (its generator's first draw) as ``m``
    microbatches of one sequence: tokens and labels [m, 1, 2048] on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(11)
    ids = torch.randint(0, PP23_KW["vocab_size"], (m, PP23_SEQ + 1),
                        generator=gen, device=device)
    return {"tokens": ids[:, None, :-1], "labels": ids[:, None, 1:]}


def pp23_launches(kernel_names, layers: int, v: int, V: int, m: int) -> dict:
    """A rank's launches of one training step at virtual stage ``v``
    (remat attn_res, ``layers`` a chunk), from the schedule's slots: m
    graph-free forward slots (none on the last virtual stage, whose
    backward slot runs it), m backward slots each a forward with a graph
    and a backward whose layer recompute re-runs K6 but not K3; the last
    stage's head adds a K6 and a K7 a backward slot."""
    f = 0 if v == V - 1 else m
    post = int(v == V - 1)
    k3, k4, k6, k7 = kernel_names
    return {k3: layers * (f + m), k4: layers * m,
            k6: 2 * layers * f + (4 * layers + post) * m,
            k7: (2 * layers + post) * m}


def pp23_global(name: str, v: int, per: int) -> str:
    """A stage parameter's name in the whole model (layer i of virtual
    stage v is layer v * per + i); the last stage's word embedding is the
    head's copy."""
    if name.startswith("transformer.layers."):
        i, leaf = name[len("transformer.layers."):].split(".", 1)
        return f"transformer.layers.{v * per + int(i)}.{leaf}"
    if name.startswith("embedding.") and v > 0:
        return name + "@head"
    return name


def pp23_stats(named_grads) -> dict:
    """Each gradient's fp32 norm and its dot with a random vector seeded by
    its whole-model name (the head's embedding copy shares the embedding's
    vector, so the two copies' dots add up to a tied model's)."""
    import zlib

    out = {}
    for key, g in named_grads:
        base = key.split("@")[0]
        gen = torch.Generator(device=g.device).manual_seed(
            zlib.crc32(base.encode()))
        r = torch.randn(g.shape, generator=gen, device=g.device)
        out[key] = (float(g.float().norm()), float((g.float() * r).sum()))
        del r
    return out


def pp23_grad_gap(got: dict, want: dict) -> float:
    """The largest gap between two layouts' gradient statistics, each
    relative to the reference leaf's norm; a tied reference embedding is
    held to the sum of the copies' dots."""
    gap = 0.0
    for key, (n, d) in want.items():
        head = key + "@head"
        if head in got and head not in want:   # tied: the dots add up
            gap = max(gap, abs(got[key][1] + got[head][1] - d) / n)
        else:
            gn, gd = got[key]
            gap = max(gap, abs(gn - n) / n, abs(gd - d) / n)
    return gap


def pp23_reference(batch, tied: bool) -> dict:
    """One process, no pipeline, on the same batch from the same seed
    (``forward_backward_no_pipelining`` over ``make_gpt_stage_fns``,
    FusedAdam): ``tied``, the whole model (tp 1 / pp 1: one word embedding
    for the input and the head); untied, the two halves of (a) chained
    (the first half of the layers with the embeddings, the second with the
    final LayerNorm and the head's own copy of the word embedding), which is
    (a)'s arithmetic without its schedule.  Losses and step 1's gradient
    statistics."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    from apex_tpu_torch.transformer.testing import make_gpt_stage_fns
    from apex_tpu_torch.transformer.testing.convert import stage_state_dict

    cfg = GPTConfig(**PP23_KW)
    model = GPTModel(cfg, device=CARD, seed=PP23_SEED)
    half = cfg.num_layers // 2
    if tied:
        names = [n for n, _ in model.named_parameters()]
        stage_fn, loss_fn = make_gpt_stage_fns(cfg, 1)
        fns = (stage_fn, loss_fn)
    else:
        sd = model.state_dict()
        halves = []
        for s in range(2):
            m = GPTModel(cfg, half, device=CARD, seed=PP23_SEED,
                         pre_process=s == 0, post_process=s == 1)
            m.load_state_dict(stage_state_dict(sd, s, 2))
            halves.append(m)
        del sd
        model = torch.nn.ModuleList(halves)
        names = [pp23_global(n, s, half) for s, m in enumerate(halves)
                 for n, _ in m.named_parameters()]
        stage_fn, loss_fn = make_gpt_stage_fns(cfg, 2)

        def chained(ml, h, mb):
            return stage_fn(ml[1], stage_fn(ml[0], h, mb), mb)

        fns = (chained, lambda ml, y, mb: loss_fn(ml[1], y, mb))
    opt = FusedAdam(list(model.parameters()), lr=PP23_LR)
    out = {"losses": []}
    t0 = time.perf_counter()
    for step in range(1, PP23_STEPS + 1):
        loss, grads = forward_backward_no_pipelining(
            *fns, model, batch, n_microbatches=PP23_M,
            tensor_shape=(1, PP23_SEQ, cfg.hidden_size),
            dtype=cfg.compute_dtype)
        if step == 1:
            out["stats"] = pp23_stats(zip(names, grads))
        opt.step(grads=grads)
        out["losses"].append(float(loss))
        del grads
    out["wall_s"] = time.perf_counter() - t0
    del model, opt
    torch.cuda.empty_cache()
    return out


def pp23_chunks(cfg, pp: int, vpp: int, device):
    """This rank's chunks: ``build_model`` over ``gpt_model_provider`` (the
    flags from the rank's place), their weights cut from the whole model
    drawn from the seed (``convert.stage_state_dict``), so every layout
    starts from the same master."""
    from apex_tpu_torch.transformer.pipeline_parallel import build_model
    from apex_tpu_torch.transformer.testing import gpt_model_provider
    from apex_tpu_torch.transformer.testing.convert import stage_state_dict

    rank = parallel_state.get_pipeline_model_parallel_rank()
    full = GPTModel(cfg, device=device, seed=PP23_SEED)
    sd = full.state_dict()
    del full
    chunks = build_model(gpt_model_provider, False,
                         vpp if vpp > 1 else None, cfg,
                         num_layers=cfg.num_layers // (pp * vpp),
                         device=device, seed=PP23_SEED)
    for k, c in enumerate(chunks):
        c.load_state_dict(stage_state_dict(sd, rank, pp, chunk=k, vpp=vpp))
    del sd
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return chunks


def pp23_train(job: dict, device) -> dict:
    """One layout's steps on this rank (see :func:`phase_pipeline`): per
    step the loss, wall and stream time, transfers, launches and parameter
    digests; step 1's gradient statistics; with ``memory`` each rank's
    peak at m = 4 and m = 8; with ``amp`` the O2 fp16 recipe of bench.py's
    pp leg and an overflow planted at ``plant_at`` on one rank."""
    from apex_tpu_torch.parallel import all_reduce_grads, comm
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_with_interleaving,
        forward_backward_pipelining_without_interleaving, schedules)
    from apex_tpu_torch.transformer.testing import make_gpt_stage_fns

    tp, pp, vpp = job["tp"], job["pp"], job.get("vpp", 1)
    parallel_state.initialize_model_parallel(tp, pp,
                                             vpp if vpp > 1 else None)
    rank = parallel_state.get_pipeline_model_parallel_rank()
    cfg = GPTConfig(**{**PP23_KW, **job.get("cfg", {}), "tp_size": tp})
    chunks = pp23_chunks(cfg, pp, vpp, device)
    card = device.type == "cuda"
    V, per = pp * vpp, cfg.num_layers // (pp * vpp)
    names = [[pp23_global(n, rank + pp * k, per)
              for n, _ in c.named_parameters()] for k, c in enumerate(chunks)]
    stage_fn, loss_fn = make_gpt_stage_fns(cfg, V)
    params = [p for c in chunks for p in c.parameters()]
    dtype = cfg.compute_dtype
    scaler = plant = None
    if job.get("amp"):
        a = amp.initialize("O2", half_dtype=torch.float16)
        masters = [m for c in chunks for m in a.master_params(c)]
        for c in chunks:
            a.cast_model(c)
        params = [p for c in chunks for p in c.parameters()]
        opt = make_optimizer("adam", masters, PP23_LR)
        scaler = GradScaler()
        ss = scaler.init(device)
        plant = (job["plant_at"] if rank == pp - 1 and
                 parallel_state.get_tensor_model_parallel_rank() == 0
                 else None)
    else:
        opt = FusedAdam(params, lr=PP23_LR)
    batch = {k: v.to(device) for k, v in job["batch"].items()}
    shape = (1, PP23_SEQ, cfg.hidden_size)

    def schedule(mb, m, lf):
        if vpp > 1:
            loss, grads = forward_backward_pipelining_with_interleaving(
                stage_fn, lf, chunks, mb, n_microbatches=m,
                num_model_chunks=vpp, tensor_shape=shape, dtype=dtype)
            return loss, [g for gs in grads for g in gs]
        return forward_backward_pipelining_without_interleaving(
            stage_fn, lf, chunks[0], mb,
            n_microbatches=m, tensor_shape=shape, dtype=dtype)

    out = {"steps": [], "scales": [], "skipped": []}
    for step in range(1, job["steps"] + 1):
        if card:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        comm.STATS.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lf = loss_fn
        if scaler is not None:
            def lf(st, y, b, ss=ss):
                return scaler.scale(loss_fn(st, y, b), ss)
        loss, grads = schedule(batch, PP23_M, lf)
        sched = dict(peak_saved=list(schedules.STATS.peak_saved_inputs),
                     forward_slots=list(schedules.STATS.forward_slots),
                     backward_slots=list(schedules.STATS.backward_slots))
        if scaler is not None:
            loss = loss / ss.loss_scale
            grads = list(scaler.unscale(grads, ss)[0])
            if step == plant:
                grads[-1] = grads[-1].clone()
                grads[-1].view(-1)[:1].fill_(float("inf"))
        grads = all_reduce_grads(grads)      # dp 1 here: the recipe's mean
        if step == 1:
            flat = [n for ns in names for n in ns]
            out["stats"] = pp23_stats(zip(flat, grads))
        if scaler is not None:
            found = scaler.found_inf(grads)
            opt.step_if_finite(~found, grads)
            amp.copy_masters(params, masters)
            ss = scaler.update(ss, ~found)
            out["scales"].append(float(ss.loss_scale))
            out["skipped"].append(bool(found))
        else:
            opt.step(grads=grads)
        del grads
        if card:
            end.record()
        value = float(loss)
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["steps"].append(dict(
            step=step, loss=value, wall_s=wall,
            stream_ms=start.elapsed_time(end) if card else 0.0,
            comm=comm.STATS.as_dict(),
            launches=launch_counts(), schedule=sched,
            digests={n: digest(p) for ns, c in zip(names, chunks)
                     for n, p in zip(ns, c.parameters())}))
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                       if card else 0.0)
    if job.get("memory"):
        del opt
        gc.collect()
        peaks = {}
        for m in (PP23_M, 2 * PP23_M):
            mb = pp23_batch(m, device)
            if card:
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            res = schedule(mb, m, loss_fn)
            if card:
                torch.cuda.synchronize()
            peaks[m] = (torch.cuda.max_memory_allocated() if card else 0,
                        list(schedules.STATS.peak_saved_inputs))
            del res, mb
        out["memory"] = peaks
    parallel_state.destroy_model_parallel()
    return out


def phase23_rank(rank, world, init_file, out, jobs):
    """A rank of phase 23 (spawned): joins the gloo group, runs each job
    (a barrier after each) and writes the results to
    ``<out>/rank<r>.pt``."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = multiproc.init_file_group("gloo", rank, world, init_file)
    results = {}
    for job in jobs:
        results[job["name"]] = pp23_train(job, device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def pp23_kernel_rows(seed: int) -> dict:
    """K3/K4 at a stage's shapes, phase 3's way (against the plain versions,
    twice bitwise, then timed cold beside the plain versions, SDPA and the
    bound): bf16 [1, 2048, 16 x 3 x 128] ((a), (b): micro-batch 1) and
    fp16 [1, 2048, 8 x 3 x 128] ((c): a tp rank's heads); no dropout, as
    the stages run."""
    rows = {}
    gen = torch.Generator(device=CARD).manual_seed(seed)
    for tag, h, dtype in (("pp", 16, torch.bfloat16),
                          ("tp2pp2", 8, torch.float16)):
        e3, e4, ops = flash_qkv_case(
            gen, f"{dtype} causal, no dropout, micro-batch 1, {h} heads "
            f"({tag} stage)", dtype, 0.0, b=1, h=h)
        fwd, bwd, _ = time_flash_qkv(*ops, 0.0, h=h)
        fwd["max_abs_err"], bwd["max_abs_err"] = e3, e4
        suffix = "_f16" if dtype == torch.float16 else ""
        rows[f"flash_qkv_fwd_sm90{suffix}_{tag}"] = fwd
        rows[f"flash_qkv_bwd_sm90{suffix}_{tag}"] = bwd
        del ops
        torch.cuda.empty_cache()
    return rows


def pp23_same_losses(what: str, runs: list) -> list:
    losses = [[s["loss"] for s in r["steps"]] for r in runs]
    if any(lo != losses[0] for lo in losses):
        raise AssertionError(f"{what}: the ranks report different losses "
                             f"{losses}")
    return losses[0]


def pp23_check_launches(what, runs, kernel_names, layers, pp, vpp, coords):
    """Each rank's launches of each step against :func:`pp23_launches`
    summed over its chunks, and its schedule's slots."""
    V = pp * vpp
    for r, res in enumerate(runs):
        p = coords[r]
        want = {k: 0 for k in kernel_names}
        for k in range(vpp):
            for n, c in pp23_launches(kernel_names, layers, p + pp * k, V,
                                      PP23_M).items():
                want[n] += c
        for st in res["steps"]:
            got = {k: st["launches"].get(k, 0) for k in kernel_names}
            if got != want:
                raise AssertionError(f"{what} rank {r} step {st['step']} "
                                     f"launched {got}, expected {want}")
            sched = st["schedule"]
            if sched["backward_slots"] != [PP23_M] * vpp or \
                    sched["forward_slots"] != [
                        0 if p + pp * k == V - 1 else PP23_M
                        for k in range(vpp)] or \
                    sched["peak_saved"] != [min(PP23_M, 2 * (V - 1 - p - pp * k)
                                                + 1) for k in range(vpp)]:
                raise AssertionError(f"{what} rank {r}: slots {sched}")
        res["launches_per_step"] = want
    log(f"  {what}: each rank's launches every step as its slots give them: "
        + "; ".join(f"rank {r} {res['launches_per_step']}"
                    for r, res in enumerate(runs)))


def pp23_summary(runs: list) -> list:
    """Per rank: step wall and stream time, the transfers (calls, GB, host
    seconds and their share of the step), the peak; after step 1."""
    out = []
    for res in runs:
        st = res["steps"][1:]
        wall = sum(s["wall_s"] for s in st)
        out.append(dict(
            step_s=[round(s["wall_s"], 4) for s in res["steps"]],
            stream_ms=[round(s["stream_ms"], 1) for s in res["steps"]],
            comm_calls_per_step=statistics.mean(s["comm"]["calls"]
                                                for s in st),
            comm_gb_per_step=statistics.mean(s["comm"]["bytes"]
                                             for s in st) / 1e9,
            comm_share=sum(s["comm"]["seconds"] for s in st) / wall,
            peak_gib=res["peak_gib"]))
    return out


def phase_pipeline(smi: str) -> dict:
    """Phase 23 (see the module docstring)."""
    log(f"  {GLOO_WHY}")
    t_phase = time.perf_counter()
    rows = pp23_kernel_rows(43)
    batch = pp23_batch(PP23_M, CARD)
    ref = pp23_reference(batch, tied=True)
    log(f"  tp 1 / pp 1 reference (this process, {PP23_LAYERS} layers, 4 "
        f"microbatches of 1): losses {ref['losses']}, {ref['wall_s']:.1f} s")
    chain = pp23_reference(batch, tied=False)
    log(f"  the two halves chained in this process (untied, no schedule): "
        f"losses {chain['losses']}, {chain['wall_s']:.1f} s")
    host = {k: v.cpu() for k, v in batch.items()}
    del batch
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pp23_")
    try:
        base = dict(batch=host, steps=PP23_STEPS)
        log("  the launches of (a) and of (b)-(c) run side by side: their "
            "wall times are of a card shared by six ranks")
        a, bc = concurrently(
            lambda: tp22_spawn(
                2, [dict(base, name="run", tp=1, pp=2, memory=True),
                    dict(base, name="rerun", tp=1, pp=2)],
                tmp, f"(a) 1F1B at pp 2, {PP23_LAYERS} layers",
                body=phase23_rank),
            lambda: tp22_spawn(
                4, [dict(base, name="vpp", tp=1, pp=4, vpp=2,
                         steps=PP23_VPP_STEPS),
                    dict(base, name="amp", tp=2, pp=2, amp=True,
                         plant_at=PP23_PLANT_AT, steps=PP23_AMP_STEPS,
                         cfg=dict(num_layers=PP23_AMP_LAYERS, bf16=False,
                                  fp16=True))],
                tmp, "(b) pp 4 x vpp 2 and (c) amp at tp 2 x pp 2",
                body=phase23_rank))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (a) 1F1B at pp 2 against tp 1 / pp 1
    run = [r["run"] for r in a]
    losses = pp23_same_losses("(a)", run)
    stats_a = {**run[0]["stats"], **run[1]["stats"]}
    gaps = [abs(x - y) for x, y in zip(losses, ref["losses"])]
    gap_g = pp23_grad_gap(stats_a, ref["stats"])
    cgaps = [abs(x - y) for x, y in zip(losses, chain["losses"])]
    cgap_g = pp23_grad_gap(stats_a, chain["stats"])
    log(f"  (a) pp 2 losses {losses}; tp 1 / pp 1 {ref['losses']}: gaps "
        f"{gaps} (bars {PP23_STEP1_LOSS_TOL} at step 1, then "
        f"{PP23_TIED_LOSS_TOL}: the tied embedding), step-1 gradient "
        f"statistics gap {gap_g:.3e} (bar {PP23_STEP1_GRAD_TOL}); the chained "
        f"halves {chain['losses']}: gaps {cgaps} (bar {PP23_LOSS_TOL} every "
        f"step), gradient statistics gap {cgap_g:.3e}")
    if not (gaps[0] <= PP23_STEP1_LOSS_TOL
            and max(gaps) <= PP23_TIED_LOSS_TOL
            and gap_g <= PP23_STEP1_GRAD_TOL
            and max(cgaps) <= PP23_LOSS_TOL
            and cgap_g <= PP23_STEP1_GRAD_TOL):
        raise AssertionError("(a) pp 2 is not within its bars of tp 1 / pp 1 "
                             "and of the chained halves")
    for r, res in enumerate(a):
        if [s["digests"] for s in res["rerun"]["steps"]] != [
                s["digests"] for s in res["run"]["steps"]] or [
                s["loss"] for s in res["rerun"]["steps"]] != losses:
            raise AssertionError(f"(a) rank {r}: the re-run is not bitwise "
                                 "the run")
    log("  (a) re-run bitwise the run: every loss and parameter, each step, "
        "both ranks")
    L = PP23_KW["num_layers"]
    pp23_check_launches("(a)", run, TP22_KERNELS, L // 2, 2, 1, [0, 1])
    mem = []
    for r, res in enumerate(run):
        (p4, s4), (p8, s8) = (res["memory"][m] for m in (PP23_M, 2 * PP23_M))
        mem.append(dict(peak_m4_gib=p4 / 2 ** 30, peak_m8_gib=p8 / 2 ** 30,
                        growth_mib=(p8 - p4) / 2 ** 20, saved=(s4, s8)))
        if not p8 - p4 < PP23_STAGE_INPUT_BYTES or s4 != s8:
            raise AssertionError(f"(a) rank {r}: the peak grew from "
                                 f"{p4} at m = 4 to {p8} at m = 8 (saved "
                                 f"inputs {s4}, {s8})")
    log(f"  (a) memory, one forward-backward at m = 4 and m = 8: {mem} (the "
        f"m = 8 peak within one stage input, {PP23_STAGE_INPUT_BYTES / 2 ** 20:.0f}"
        " MiB, of the m = 4 peak)")

    # (b) interleaved at pp 4 x vpp 2 against (a)'s step 1
    vpp = [r["vpp"] for r in bc]
    vlosses = pp23_same_losses("(b)", vpp)
    stats_b = {}
    for res in vpp:
        stats_b.update(res["stats"])
    gap_bl = abs(vlosses[0] - losses[0])
    gap_bg = pp23_grad_gap(stats_b, stats_a)
    log(f"  (b) pp 4 x vpp 2 losses {vlosses}; step 1 against (a): loss gap "
        f"{gap_bl:.3e} (bar {PP23_STEP1_LOSS_TOL}), gradient statistics gap "
        f"{gap_bg:.3e} (bar {PP23_STEP1_GRAD_TOL})")
    if not (gap_bl <= PP23_STEP1_LOSS_TOL and gap_bg <= PP23_STEP1_GRAD_TOL
            and set(stats_b) == set(stats_a)):
        raise AssertionError("(b) pp 4 x vpp 2 is not within (a)'s bars")
    pp23_check_launches("(b)", vpp, TP22_KERNELS, L // 8, 4, 2,
                        [0, 1, 2, 3])

    # (c) bench.py's amp pp leg at tp 2 x pp 2: the planted overflow
    ampr = [r["amp"] for r in bc]
    clos = pp23_same_losses("(c)", ampr)
    scales = [res["scales"] for res in ampr]
    for r, res in enumerate(ampr):
        i = PP23_PLANT_AT - 1
        before = res["scales"][i - 1] if i else float(2 ** 16)
        if not res["skipped"][i] or res["scales"][i] != before / 2 or \
                res["steps"][i]["digests"] != res["steps"][i - 1]["digests"]:
            raise AssertionError(f"(c) rank {r}: step {PP23_PLANT_AT} was "
                                 f"not skipped bitwise with the scale halved "
                                 f"({res['skipped']}, {res['scales']})")
        if res["skipped"] != ampr[0]["skipped"] or \
                res["scales"] != ampr[0]["scales"]:
            raise AssertionError("(c) the ranks disagree on the skips")
    coords = [parallel_state.coordinates(r, 4, 2, 2) for r in range(4)]
    for x in range(4):
        for y in range(x + 1, 4):
            if coords[x][1] != coords[y][1]:
                continue       # another stage
            for sa, sb in zip(ampr[x]["steps"], ampr[y]["steps"]):
                for n, dg in sa["digests"].items():
                    if is_replicated(n) and dg != sb["digests"][n]:
                        raise AssertionError(f"(c) tp ranks {x}, {y} differ "
                                             f"in {n} after step {sa['step']}")
    log(f"  (c) amp O2 fp16 at tp 2 x pp 2, {PP23_AMP_LAYERS} layers: "
        f"losses {clos}, "
        f"skipped {ampr[0]['skipped']}, scales {scales[0]}: the overflow "
        f"planted on one rank at step {PP23_PLANT_AT} skipped bitwise on "
        "every rank, every scale halved; the replicated leaves bitwise equal "
        "across the tp ranks after each step")
    pp23_check_launches("(c)", ampr, PP23_F16, PP23_AMP_LAYERS // 2, 2, 1,
                        [c[1] for c in coords])

    record = {"card": smi, "shared_card": True, "micro_batch": 1,
              "microbatches": PP23_M,
              "pp2": dict(losses=losses, reference_losses=ref["losses"],
                          loss_gaps=gaps, grad_gap=gap_g,
                          chained_losses=chain["losses"],
                          chained_loss_gaps=cgaps, chained_grad_gap=cgap_g,
                          memory=mem,
                          bubble=1 / (PP23_M + 1),
                          ranks=pp23_summary(run)),
              "pp4_vpp2": dict(losses=vlosses, loss_gap=gap_bl,
                               grad_gap=gap_bg, bubble=7 / (PP23_M + 7),
                               ranks=pp23_summary(vpp)),
              "tp2_pp2_amp": dict(losses=clos, scales=scales[0],
                                  skipped=ampr[0]["skipped"],
                                  bubble=1 / (PP23_M + 1),
                                  ranks=pp23_summary(ampr))}
    log("  wall times are of ranks time-slicing ONE card over gloo "
        "(host-staged transfers); they say nothing of a pipeline over "
        "several cards")
    log("  phase 23 " + json.dumps(record))
    log(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "record": record,
            "launches": {"pp2": [r["launches_per_step"] for r in run],
                         "pp4_vpp2": [r["launches_per_step"] for r in vpp],
                         "tp2_pp2": [r["launches_per_step"] for r in ampr]},
            "steps": {"pp2": PP23_STEPS, "pp4_vpp2": PP23_VPP_STEPS,
                      "tp2_pp2": PP23_AMP_STEPS}}


# -- phase 24: ZeRO — the GPT-1.3B flagship train step (bench.py's headline),
# over dp x tp ranks, sharded checkpoints and elastic recovery --------------
#
# (a) runs on this process with no process group (world 1: the collectives
# are the identity); (c)-(e) run ranks sharing cuda:0 over gloo, as phases
# 22-23 do, at GPT-1.3B width with the depth cut (they check layouts and
# bits, not speed): 2 layers in (c), as phase 22 cuts it, and in (d)-(e),
# whose checkpoints are written and read whole.

ZERO24_OVER: dict = {}          # a CPU rehearsal shrinks the width here
ZERO24_BATCH = (4, 2048)        # bench.py's flagship batch
ZERO24_SEQ = 2048
ZERO24_LR = 1e-4                # bench.py's flagship lr
ZERO24_STEPS = 4                # timed, after one warm step
# (c) cut to 2 layers, as phase 22 is: at 12 a (2, 2, 1) step took
# 7.9-9.1 s a rank and the phase 249-312 s on an NVIDIA H100 80GB HBM3 at
# 700.00 W, more than the script's 1200 s leave it; at 4 layers the phase
# took 186.1 s, cut again to make room for phase 27; the layouts checked
# do not change with the depth
ZERO24_RANK_LAYERS = 2
ZERO24_RANK_STEPS = 2
ZERO24_SAVE_LAYERS = 2          # (d) and (e)
ZERO24_ELASTIC_STEPS, ZERO24_LOSE_AT, ZERO24_LOST = 3, 2, [3]
# (b): TOY_KW of tests/L0/test_flagship.py at fp32, plan fp32, lr 1e-3
ZERO24_TOY = dict(num_layers=2, hidden_size=256, num_attention_heads=2,
                  vocab_size=256, max_position_embeddings=64, bf16=False)
ZERO24_TOY_LOSS_TOL = 1e-6      # relative, card vs CPU (read 9.5e-8)
# absolute, ten times the largest gap read on an NVIDIA H100 80GB HBM3 at
# 700.00 W (8.09e-5, in three runs: Adam's first steps move a weight whose
# gradient is near eps by up to lr either way); two steps at lr 1e-3
# move a weight by up to 2e-3, so a skipped update fails it
ZERO24_TOY_WEIGHT_TOL = 8e-4
ZERO24_SCALAR = ("flash_qkv_fwd", "flash_qkv_bwd", "layer_norm_fwd",
                 "layer_norm_bwd")


def zero24_cfg(layers=None, **over):
    kw = dict(ZERO24_OVER, **over)
    if layers is not None:
        kw["num_layers"] = layers
    return gpt1p3b_config(**kw)


def zero24_batch(cfg, seed=24, device="cpu"):
    """A seeded token batch [4, 2048] and its labels rolled by one."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    b, s = ZERO24_BATCH[0], min(ZERO24_SEQ, cfg.max_position_embeddings)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    return tokens.to(device), tokens.roll(-1, -1).to(device)


def tree_digests(tree, chunk=1 << 26) -> list:
    """:func:`digest` of every leaf of a nested dict / tuple of tensors,
    taken ``chunk`` elements at a time (the same two int64 sums, modulo
    2^64, with int64 temporaries of ``chunk`` elements)."""
    from apex_tpu_torch.multi_tensor.flat import _tree_flatten

    out = []
    for t in _tree_flatten(tree)[0]:
        bits = t.detach().contiguous().view(-1)
        bits = bits.view(torch.int16 if bits.element_size() == 2 else
                         torch.int32)
        s0 = s1 = 0
        for a in range(0, bits.numel(), chunk):
            b = bits[a:a + chunk].to(torch.int64)
            w = torch.arange(a, a + b.numel(), device=b.device) % 1021 + 1
            s0 += int(b.sum())
            s1 += int((b * w).sum())
        out.append(((s0 + 2 ** 63) % 2 ** 64 - 2 ** 63,
                    (s1 + 2 ** 63) % 2 ** 64 - 2 ** 63))
    return out


def zero24_launches(layers: int, steps: int, names=TP22_KERNELS) -> dict:
    """A step's launches under remat attn_res (phase 7's counts)."""
    return dict(zip(names, (layers * steps, layers * steps,
                            (4 * layers + 1) * steps,
                            (2 * layers + 1) * steps)))


def zero24_flagship(smi: str) -> dict:
    """(a): bench.py's recipe on this card at world 1."""
    from apex_tpu_torch.transformer.testing import (
        FIT_PLANS, build_flagship_train_step, flagship_state_bytes)

    cfg = zero24_cfg()
    L = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fs = build_flagship_train_step(cfg, plan="bf16_fit", lr=ZERO24_LR,
                                   device=CARD)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tokens, labels = zero24_batch(cfg, device=CARD)
    p, s, loss = fs.step(fs.params, fs.opt_state, tokens, labels)
    losses = [float(loss)]
    after1 = (tree_digests(p), tree_digests(s))
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    enqueue, done = [], []
    for _ in range(ZERO24_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, loss = fs.step(p, s, tokens, labels)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        done.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: launches.get(k, 0) / ZERO24_STEPS for k in TP22_KERNELS}
    want = zero24_launches(L, 1)
    log(f"  (a) world 1, no process group: build {build_s:.1f} s; losses "
        f"{losses}; launches over {ZERO24_STEPS} steps {launches}, per step "
        f"{per_step} (phase 7's tree step: {want})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("(a): non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a): the loss does not fall: {losses}")
    expect = math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.hidden_size / 2
    if abs(losses[0] - expect) > STEP_LOSS_TOL:
        raise AssertionError(f"(a): step 1 loss {losses[0]} is not within "
                             f"{STEP_LOSS_TOL} of {expect:.3f}")
    if per_step != {k: float(v) for k, v in want.items()} or any(
            launches.get(k, 0) for k in ZERO24_SCALAR):
        raise AssertionError("(a): launches a step are not phase 7's tree "
                             "step's")
    sb = flagship_state_bytes(cfg, FIT_PLANS["bf16_fit"])
    prof = step_profile(lambda: fs.step(p, s, tokens, labels))
    if prof["device_busy_ms"] > 0:
        log("  (a) one step under torch.profiler: " + ", ".join(
            f"{k} {v:.1f} ms ({v / prof['wall_ms']:.1%})"
            for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
        log_other_ops(prof)
    del fs, p, s
    gc.collect()
    torch.cuda.empty_cache()
    # the same build from the same seed, its first step bitwise
    fs = build_flagship_train_step(cfg, plan="bf16_fit", lr=ZERO24_LR,
                                   device=CARD)
    p, s, loss = fs.step(fs.params, fs.opt_state, tokens, labels)
    same = float(loss) == losses[0] and (tree_digests(p),
                                         tree_digests(s)) == after1
    log(f"  (a) a re-build from the same seed, step 1: loss {float(loss)!r} "
        f"vs {losses[0]!r}, params and moments bitwise equal: {same}")
    if not same:
        raise AssertionError("(a): the re-build is not bitwise the build")
    n = gpt_param_count(cfg)
    step_ms = statistics.median(done)
    out = dict(params=n, build_s=build_s, losses=losses,
               step_ms=step_ms, step_ms_all=done,
               step_enqueue_ms=statistics.median(enqueue),
               tok_per_s=ZERO24_BATCH[0] * tokens.shape[1] / step_ms * 1e3,
               peak_gib=peak / 2 ** 30, build_peak_gib=build_peak / 2 ** 30,
               state_bytes={k: v / 2 ** 30 for k, v in sb.items()},
               launches=launches, launches_per_step=per_step,
               deterministic=same, step_profile=prof, card=smi)
    log(f"  (a) step {step_ms:.1f} ms (median of {ZERO24_STEPS}; host "
        f"enqueue {out['step_enqueue_ms']:.1f} ms), {out['tok_per_s']:.0f} "
        f"tok/s; build peak {out['build_peak_gib']:.2f} GiB; steps' peak "
        f"{out['peak_gib']:.2f} GiB beside the step_peak "
        f"{out['state_bytes']['step_peak']:.2f} GiB of flagship_state_bytes "
        f"(+ activations), on {smi}")
    del fs, p, s
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zero24_toy() -> dict:
    """(b): the fp32 toy, card against CPU, from one master."""
    from apex_tpu_torch.transformer.testing import build_flagship_train_step

    cfg = gpt1p3b_config(**ZERO24_TOY)
    runs = {}
    cpu = build_flagship_train_step(cfg, plan="fp32", lr=1e-3, device="cpu",
                                    donate=False)
    card = build_flagship_train_step(cfg, plan="fp32", lr=1e-3, device=CARD,
                                     master=cpu.params)
    gen = np.random.RandomState(1)
    tokens = torch.from_numpy(gen.randint(0, cfg.vocab_size, (8, 64)))
    labels = tokens.roll(-1, -1)
    for name, fs in (("cpu", cpu), ("card", card)):
        if name == "card":
            kernels.reset_launch_counts()
        p, s, losses = fs.params, fs.opt_state, []
        for _ in range(2):
            p, s, loss = fs.step(p, s, tokens, labels)
            losses.append(float(loss))
        runs[name] = (losses, [v.float().cpu() for v in _flat_leaves(p)])
    launches = launch_counts()
    dl = max(abs(a - b) / abs(b) for a, b in zip(runs["card"][0],
                                                 runs["cpu"][0]))
    dw = max(float((a - b).abs().max())
             for a, b in zip(runs["card"][1], runs["cpu"][1]))
    want = zero24_launches(cfg.num_layers, 2, ZERO24_SCALAR)
    got = {k: launches.get(k, 0) for k in ZERO24_SCALAR}
    log(f"  (b) the fp32 toy card vs CPU: losses {runs['card'][0]} vs "
        f"{runs['cpu'][0]} (max rel gap {dl:.3e}, bar "
        f"{ZERO24_TOY_LOSS_TOL:.0e}); weights max |gap| {dw:.3e} (bar "
        f"{ZERO24_TOY_WEIGHT_TOL:.0e}); launches {got} (want {want})")
    if not (dl <= ZERO24_TOY_LOSS_TOL and dw <= ZERO24_TOY_WEIGHT_TOL):
        raise AssertionError("(b): the card's toy is not the CPU's")
    if got != want:
        raise AssertionError("(b): the toy's scalar-route launches differ")
    return dict(loss_rel_gap=dl, weight_gap=dw, launches=got)


def _flat_leaves(tree) -> list:
    from apex_tpu_torch.multi_tensor.flat import _tree_flatten

    return _tree_flatten(tree)[0]


def zero24_train(job) -> dict:
    """One flagship trajectory on this rank (a job of (c))."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.testing import build_flagship_train_step

    cfg = zero24_cfg(job["layers"])
    kw = ({} if job["shape"] is None
          else dict(mesh_shape=job["shape"], bucket_bytes=job["bucket"]))
    t0 = time.perf_counter()
    fs = build_flagship_train_step(cfg, plan="bf16_fit", lr=ZERO24_LR,
                                   device=CARD, **kw)
    build_s = time.perf_counter() - t0
    if CARD == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tokens, labels = job["batch"]
    p, s = fs.params, fs.opt_state
    steps = []
    peak = 0
    for i in range(job["steps"]):
        comm.STATS.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        p, s, loss = fs.step(p, s, tokens, labels)
        loss = float(loss)
        wall = time.perf_counter() - t0
        if CARD == "cuda":      # the step's peak, not the digests'
            peak = max(peak, torch.cuda.max_memory_allocated())
        steps.append(dict(loss=loss, wall_s=wall, params=tree_digests(p),
                          opt=tree_digests(s),
                          ops=dict(comm.STATS.by_op),
                          comm_s=comm.STATS.seconds,
                          comm_bytes=comm.STATS.bytes,
                          launches={k: v for k, v in launch_counts().items()}))
        if CARD == "cuda":
            torch.cuda.reset_peak_memory_stats()
    return dict(steps=steps, build_s=build_s,
                n_buckets=(fs.bucket_plan.num_buckets
                           if fs.bucket_plan else 1),
                schema_total=fs.schema.total,
                peak_gib=peak / 2 ** 30)


def zero24_save(job) -> dict:
    """(d): a (2, 2, 1) run saving each step sharded (format 4, each rank
    its own shard); this rank's blocks after each step, on the host."""
    import torch.distributed as dist

    from apex_tpu_torch.resilience import save_zero_checkpoint
    from apex_tpu_torch.resilience.elastic import _host_tree
    from apex_tpu_torch.transformer.testing import build_flagship_train_step

    cfg = zero24_cfg(job["layers"])
    fs = build_flagship_train_step(cfg, plan="bf16_fit", lr=ZERO24_LR,
                                   device=CARD, mesh_shape=job["shape"])
    tokens, labels = job["batch"]
    p, s = fs.params, fs.opt_state
    states = {}
    for step in (1, 2):
        p, s, _ = fs.step(p, s, tokens, labels)
        save_zero_checkpoint(job["dir"], (p, s), step=step,
                             shardings=fs.shardings,
                             shard_axes=fs.mesh_axes,
                             group=dist.group.WORLD)
        states[step] = _host_tree((p, s))
    return dict(states=states, shardings=fs.shardings,
                axes=fs.mesh_axes)


def zero24_restore(job) -> dict:
    """(d): the step's checkpoint restored onto this world's blocks."""
    import torch.distributed as dist

    from apex_tpu_torch.resilience import restore_zero_checkpoint
    from apex_tpu_torch.resilience.elastic import _host_tree
    from apex_tpu_torch.transformer.testing import build_flagship_train_step

    fs = build_flagship_train_step(zero24_cfg(job["layers"]),
                                   plan="bf16_fit", lr=ZERO24_LR,
                                   device=CARD, mesh_shape=job["shape"])
    state, step = restore_zero_checkpoint(
        job["dir"], (fs.params, fs.opt_state), shardings=fs.shardings,
        shard_axes=fs.mesh_axes, group=dist.group.WORLD, step=job["step"])
    return dict(state=_host_tree(state), step=step)


def zero24_golden(job) -> dict:
    """(e): the recovery's checkpoint restored on the survivors' shape,
    then the rest of the batches without interruption."""
    import torch.distributed as dist

    from apex_tpu_torch.resilience import restore_zero_checkpoint
    from apex_tpu_torch.resilience.elastic import _host_tree

    step_fn, state, shardings = job["build"](mesh_shape=job["shape"])
    dp, tp, pp = job["shape"]
    state, step = restore_zero_checkpoint(
        job["dir"], state, shardings=shardings,
        shard_axes={"data": dp, "pipeline": pp, "tensor": tp},
        group=dist.group.WORLD, step=job["step"])
    for batch in job["batches"][step:]:
        state, _ = step_fn(state, batch)
    return dict(losses=list(step_fn.losses), state=_host_tree(state),
                shardings=shardings)


def phase24_rank(rank, world, init_file, out, jobs):
    """A rank of phase 24 (spawned): joins the gloo group, runs each job
    (a barrier after each, so a checkpoint is whole before the next job
    reads it) and writes the results to ``<out>/rank<r>.pt``."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multiproc.init_file_group("gloo", rank, world, init_file)
    results = {}
    for job in jobs:
        fn = {"train": zero24_train, "save": zero24_save,
              "restore": zero24_restore, "golden": zero24_golden}[job["kind"]]
        results[job["name"]] = fn(job)
        gc.collect()
        if CARD == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def zero24_ranks_same(what, runs) -> None:
    """Every rank's parameters the same bits after every step."""
    for i, st in enumerate(runs[0]["steps"]):
        for r, run in enumerate(runs[1:], 1):
            if run["steps"][i]["params"] != st["params"] or \
                    run["steps"][i]["loss"] != st["loss"]:
                raise AssertionError(f"{what}: rank {r} differs from rank 0 "
                                     f"after step {i + 1}")


def zero24_check_ranks(what, runs, layers) -> dict:
    """(c)'s checks of one trajectory: parameters bitwise across ranks,
    one reduce-scatter and one all-gather a bucket a step, each rank's
    exact K3/K4/K6/K7 launches; its summary."""
    zero24_ranks_same(what, runs)
    nb = runs[0]["n_buckets"]
    want = zero24_launches(layers, 1)
    for r, run in enumerate(runs):
        for i, st in enumerate(run["steps"]):
            ops = st["ops"]
            if ops.get("reduce_scatter") != nb or ops.get("all_gather") != nb:
                raise AssertionError(f"{what}: rank {r} step {i + 1} ran "
                                     f"{ops}, want {nb} reduce-scatters and "
                                     f"all-gathers")
            got = {k: st["launches"].get(k, 0) for k in TP22_KERNELS}
            if got != want:
                raise AssertionError(f"{what}: rank {r} step {i + 1} "
                                     f"launched {got}, want {want}")
    walls = [st["wall_s"] for run in runs for st in run["steps"]]
    comm_s = [st["comm_s"] for run in runs for st in run["steps"]]
    summary = dict(losses=[st["loss"] for st in runs[0]["steps"]],
                   buckets=nb, ops_per_step=runs[0]["steps"][0]["ops"],
                   comm_bytes_per_step=runs[0]["steps"][0]["comm_bytes"],
                   step_s_per_rank=[[st["wall_s"] for st in run["steps"]]
                                    for run in runs],
                   build_s_per_rank=[run["build_s"] for run in runs],
                   comm_share=sum(comm_s) / sum(walls),
                   peak_gib_per_rank=[run["peak_gib"] for run in runs],
                   launches_per_step=[{k: run["steps"][0]["launches"].get(
                       k, 0) for k in TP22_KERNELS} for run in runs])
    log(f"  {what}: losses {summary['losses']}, {nb} bucket(s), a step's "
        f"collectives {summary['ops_per_step']}, "
        f"{summary['comm_bytes_per_step'] / 2 ** 30:.2f} GiB carried by rank "
        f"0; build s per rank {summary['build_s_per_rank']}; step s per rank "
        f"{summary['step_s_per_rank']} (collectives "
        f"{summary['comm_share']:.1%} of it); peak GiB per rank "
        f"{[round(x, 2) for x in summary['peak_gib_per_rank']]}; parameters "
        "bitwise equal on every rank after every step")
    return summary


def zero24_same_bits(what, a, b) -> None:
    from apex_tpu_torch.utils.tree import keystr, tree_flatten_with_path

    la, lb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    if len(la) != len(lb):
        raise AssertionError(f"{what}: {len(la)} leaves vs {len(lb)}")
    for (path, x), (_, y) in zip(la, lb):
        bx = x.view(torch.int16) if x.element_size() == 2 else x
        by = y.view(torch.int16) if y.element_size() == 2 else y
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                bx.cpu(), by.cpu()):
            raise AssertionError(
                f"{what}: {keystr(path)} differs ({x.dtype} {tuple(x.shape)}"
                f" vs {y.dtype} {tuple(y.shape)})")


def zero24_expected_blocks(save_runs, step, axes_to, shard) -> list:
    """The whole (2, 2, 1) stacks of a step re-partitioned onto ``axes_to``
    (``shard`` elements a rank), one state per target rank (rank order):
    what a restore there must give bitwise.  A leaf's flat value is its
    C-order flatten; growth reads zeros, a shrink drops only zeros."""
    from apex_tpu_torch.multi_tensor.flat import (_tree_flatten,
                                                  _tree_unflatten,
                                                  expand_specs,
                                                  spec_lead_axes)
    from apex_tpu_torch.resilience.elastic import stack_rank_states

    sh, axes = save_runs[0]["shardings"], save_runs[0]["axes"]
    whole = stack_rank_states([r["states"][step] for r in save_runs], sh,
                              axes)
    leaves, treedef = _tree_flatten(whole)
    specs = expand_specs(sh, whole)
    n_to, ones = int(np.prod(list(axes_to.values()))), (1,) * len(axes_to)
    out = []
    for r in range(n_to):
        blk = []
        for leaf, spec in zip(leaves, specs):
            lead = spec_lead_axes(spec, axes)
            if not lead:
                blk.append(leaf)
            elif leaf.dim() == len(lead):        # the step counter
                blk.append(leaf.reshape(-1)[0].reshape(ones))
            else:
                flat = leaf.reshape(-1)
                n = n_to * shard
                if n > flat.numel():
                    flat = torch.cat([flat, flat.new_zeros(n - flat.numel())])
                elif n < flat.numel():
                    if torch.any(flat[n:] != 0):
                        raise AssertionError("(d): the stack's tail is real "
                                             "state")
                    flat = flat[:n]
                blk.append(flat[r * shard:(r + 1) * shard].reshape(
                    ones + (shard,)))
        out.append(_tree_unflatten(treedef, blk))
    return out


def phase_zero(smi: str) -> dict:
    """Phase 24 (see the module docstring)."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.resilience import (DeviceLoss,
                                           restore_zero_checkpoint,
                                           run_elastic_training)
    from apex_tpu_torch.resilience.chaos import corrupt_shard
    from apex_tpu_torch.resilience.elastic import stack_rank_states
    from apex_tpu_torch.transformer.testing import (
        FIT_PLANS, build_flagship_train_step, flagship_elastic_build,
        flagship_state_bytes)
    from apex_tpu_torch.transformer.testing.flagship import master_shapes

    t_phase = time.perf_counter()

    def lap(what):
        log(f"  [{time.perf_counter() - t_phase:6.1f} s] {what}")

    record = {"flagship": zero24_flagship(smi)}
    lap("(a) done")
    record["toy"] = zero24_toy()
    lap("(b) done")
    log(f"  {GLOO_WHY}")
    tmp = tempfile.mkdtemp(prefix="zero24_")
    try:
        cfg_r = zero24_cfg(ZERO24_RANK_LAYERS)
        batch_r = zero24_batch(cfg_r)
        cfg_s = zero24_cfg(ZERO24_SAVE_LAYERS)
        batch_s = zero24_batch(cfg_s, seed=25)
        save_dir = os.path.join(tmp, "ckpt221")
        base = dict(layers=ZERO24_RANK_LAYERS, steps=ZERO24_RANK_STEPS,
                    batch=batch_r)
        # (e) elastic: four ranks at (2, 2, 1) lose rank 3 at step 2
        edir = os.path.join(tmp, "elastic")
        build = flagship_elastic_build(cfg_s, plan="bf16_fit", lr=ZERO24_LR,
                                       device=CARD)
        batches = [zero24_batch(cfg_s, seed=30 + i % 2)
                   for i in range(ZERO24_ELASTIC_STEPS)]
        dl = DeviceLoss(at_step=ZERO24_LOSE_AT, device_ids=ZERO24_LOST)

        elastic_done = threading.Event()

        def elastic():
            t0 = time.perf_counter()
            try:
                res = run_elastic_training(
                    build, list(range(4)), batches, ckpt_dir=edir,
                    save_every=1, on_step=dl.poll, max_restarts=1,
                    mesh_shape=(2, 2, 1), batch_size=ZERO24_BATCH[0],
                    work_dir=os.path.join(tmp, "ework"), log_fn=log)
            finally:
                elastic_done.set()
            return res, time.perf_counter() - t0

        def golden_ready():
            """(e)'s checkpoint of the step before the loss is committed
            (an atomic rename; (e) writes no step twice and prunes none),
            so the golden may restore it while (e) runs on."""
            while (ckpt.latest_step(edir) or 0) < ZERO24_LOSE_AT - 1:
                if elastic_done.is_set():
                    raise AssertionError("(e) ended before its step "
                                         f"{ZERO24_LOSE_AT - 1} checkpoint")
                time.sleep(0.5)

        log("  (e)'s recovery runs beside (c)-(d): the launch of four ranks, "
            "then the two-rank launch (with (e)'s golden, from (e)'s "
            "checkpoint before the loss) beside (d)'s restore onto world 1 "
            "on this process: their wall times are of a shared card")
        adam = DistributedFusedAdam()
        totals = {n: adam.make_schema(master_shapes(cfg_s), n).total
                  for n in (1, 2)}
        held = {}

        def restore_world1(saves):
            fs1 = build_flagship_train_step(cfg_s, plan="bf16_fit",
                                            lr=ZERO24_LR, device=CARD)
            held["target"] = (fs1.params, fs1.opt_state)
            one, _ = restore_zero_checkpoint(save_dir, held["target"])
            want1 = zero24_expected_blocks(saves, 2, {"data": 1},
                                           totals[1])[0]
            zero24_same_bits("(d) restore onto world 1", one, want1)

        def c_and_d():
            a = tp22_spawn(4, [
                dict(base, kind="train", name="bucketed", shape=(2, 2, 1),
                     bucket="auto"),
                dict(base, kind="train", name="serialized", shape=(2, 2, 1),
                     bucket=None),
                dict(kind="save", name="save", layers=ZERO24_SAVE_LAYERS,
                     shape=(2, 2, 1), batch=batch_s, dir=save_dir)],
                tmp, "(c) (2, 2, 1) bucketed and serialized, (d) a sharded "
                "save", body=phase24_rank)
            lap("(c) at (2, 2, 1) and (d)'s save done")
            saves = [r["save"] for r in a]
            golden_ready()
            b, _ = concurrently(
                lambda: tp22_spawn(2, [
                    dict(kind="train", name="dp2",
                         layers=ZERO24_RANK_LAYERS, steps=ZERO24_RANK_STEPS,
                         batch=batch_r, shape=None, bucket="auto"),
                    dict(kind="restore", name="restore211",
                         layers=ZERO24_SAVE_LAYERS, shape=(2, 1, 1),
                         dir=save_dir, step=2),
                    dict(kind="golden", name="golden", build=build,
                         shape=(1, 2, 1), dir=edir, step=ZERO24_LOSE_AT - 1,
                         batches=batches)],
                    tmp, "(c) dp 2, (d) restore onto (2, 1, 1), (e) the "
                    "golden", body=phase24_rank),
                lambda: restore_world1(saves))
            lap("the two-rank launch and (d)'s restore onto world 1 done")
            return a, saves, b

        (a, saves, b), (res, elastic_s) = concurrently(c_and_d, elastic)
        lap("(c)-(d) and (e)'s recovery done")
        plan = FIT_PLANS["bf16_fit"]
        ranks = {}
        for name in ("bucketed", "serialized"):
            ranks[name] = zero24_check_ranks(
                f"(c) (2, 2, 1) {name}, {ZERO24_RANK_LAYERS} layers",
                [r[name] for r in a], ZERO24_RANK_LAYERS)
        for r, run in enumerate(a):
            x, y = run["bucketed"]["steps"], run["serialized"]["steps"]
            if [(s["loss"], s["params"], s["opt"]) for s in x] != \
                    [(s["loss"], s["params"], s["opt"]) for s in y]:
                raise AssertionError(f"(c) rank {r}: bucketed and "
                                     "serialized are not bitwise equal")
        log("  (c) bucketed == serialized: losses, parameters and moments "
            "bitwise on every rank after every step")
        log(f"  (e) elastic: lost {res.lost_devices}, resumed on "
            f"{res.mesh_shape} ({len(res.devices)} ranks), step {res.step}, "
            f"restarts {res.restarts}, losses {res.losses}, "
            f"{elastic_s:.1f} s")
        if not (res.restarts == 1 and res.mesh_shape == (1, 2, 1)
                and res.step == ZERO24_ELASTIC_STEPS):
            raise AssertionError("(e): the recovery is not the expected one")
        ranks["dp2"] = zero24_check_ranks(
            f"(c) dp 2 single-axis, {ZERO24_RANK_LAYERS} layers",
            [r["dp2"] for r in b], ZERO24_RANK_LAYERS)
        for name, n in (("bucketed", 4), ("serialized", 4), ("dp2", 2)):
            ranks[name]["state_bytes_gib"] = {
                k: v / 2 ** 30 for k, v in flagship_state_bytes(
                    cfg_r, plan, n_shards=n).items()}
        want211 = zero24_expected_blocks(saves, 2, {"data": 2, "pipeline": 1,
                                                    "tensor": 1},
                                         totals[2] // 2)
        for r, run in enumerate(b):
            got = run["restore211"]
            if got["step"] != 2:
                raise AssertionError("(d): the (2, 1, 1) restore's step")
            zero24_same_bits(f"(d) restore onto (2, 1, 1), rank {r}",
                             got["state"], want211[r])
        log("  (d) format 4 at (2, 2, 1) restored onto (2, 1, 1) and onto "
            "world 1: bitwise the re-partitioned stacks")

        # the corruption only once no rank reads the checkpoint
        bad = corrupt_shard(save_dir, 2, (1, 0, 1))
        try:
            ckpt.verify_checkpoint(save_dir, 2)
            raise AssertionError("(d): a corrupt shard verified")
        except ckpt.CheckpointCorruptionError as e:
            if os.path.basename(bad) not in str(e):
                raise AssertionError(f"(d): verify did not name "
                                     f"{os.path.basename(bad)}: {e}")
            log(f"  (d) corrupt_shard(step 2, (1, 0, 1)): verify names it: "
                f"{str(e)[:160]}")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            back, step = restore_zero_checkpoint(save_dir, held["target"])
        want_back = zero24_expected_blocks(saves, 1, {"data": 1},
                                           totals[1])[0]
        zero24_same_bits("(d) fallback to step 1", back, want_back)
        if step != 1 or not any(issubclass(w.category,
                                           CheckpointFallbackWarning)
                                for w in seen):
            raise AssertionError("(d): no fallback to the intact step 1")
        log("  (d) restore_zero_checkpoint fell back to step 1 (warned), "
            "bitwise step 1's state")
        lap("(d)'s fallback done")
        del held, back
        gc.collect()
        torch.cuda.empty_cache()

        gold = [r["golden"] for r in b]
        if res.losses[ZERO24_LOSE_AT:] != gold[0]["losses"]:
            raise AssertionError(f"(e): losses {res.losses} vs the golden "
                                 f"{gold[0]['losses']}")
        want_e = stack_rank_states([g["state"] for g in gold],
                                   gold[0]["shardings"],
                                   {"data": 1, "pipeline": 1, "tensor": 2})
        zero24_same_bits("(e) the recovery vs its golden", res.state, want_e)
        log("  (e) the recovery ends bitwise the golden run from the same "
            "checkpoint on (1, 2, 1)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record.update(ranks=ranks, elastic=dict(
        lost=res.lost_devices, shape=res.mesh_shape, losses=res.losses,
        wall_s=elastic_s))
    record["wall_s"] = time.perf_counter() - t_phase
    log("  phase 24 " + json.dumps({k: v for k, v in record.items()
                                    if k not in ("flagship",)}, default=str))
    log(f"  phase 24 took {record['wall_s']:.1f} s")
    return record


# -- phase 25: the serving fleet ---------------------------------------------

FLEET25_OVER: dict = {}     # a CPU rehearsal narrows the model here
FLEET25_REQS = 24           # (a): a segment's requests, two tenants
FLEET25_FAULT_REQS = 12     # (b): (a)'s first 12, cut for time
FLEET25_SHIP_REQS = 8       # (c): (a)'s first 8, each pool and transport
FLEET25_ROUND_S = 0.01      # virtual seconds a fleet round (bench_fleet's)
FLEET25_PRE_ROUNDS = 3      # segment 2's rounds before the rolling restart
FLEET25_DOWNTIME = 3        # rounds a replica sits out (bench_fleet: 25)
FLEET25_KILL_AT = 5         # (b): r0's step from which every step raises
FLEET25_BLACKHOLE_AT = 9    # (b): r1's ping from which none is answered
FLEET25_SLOW_S = 0.1        # (b): r2's probe latency, under the 0.25 s budget
# (c) over ChaosTransport: (message class, fault) -> the class's message
# numbers it hits.  The first 16 commits drop: on the toy the earliest
# transfer spends its budget (3 attempts) and falls back to a re-prefill
# on its decode replica, the others land after retries
FLEET25_CHAOS = {("kv_page", "drop"): {2}, ("kv_page", "duplicate"): {4},
                 ("kv_page", "reorder"): {6}, ("kv_page", "corrupt"): {3, 9},
                 ("kv_commit", "drop"): set(range(1, 17))}
FLEET25_TENANTS = (fleet_mod.SLOClass("interactive", deadline_s=30.0),
                   fleet_mod.SLOClass("batch"))
TOY_FLEET = dict(num_pages=64, page_size=8, max_batch=4, prefill_budget=96)


class RoundClock:
    """The fleet's virtual time, ticked once a round by the router's
    ``on_round`` (``bench.py::bench_fleet``'s clock): the replicas step one
    after another here but at once in a real fleet, so a round costs one
    tick however many stepped.  A plain callable, so the engines' own
    ``SimClock`` advance does not apply."""

    def __init__(self, dt: float = FLEET25_ROUND_S):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.dt


class MeteredTransport(fleet_mod.LocalTransport):
    """The in-process transport, counting each shipment's wire bytes (its
    ``kv_page`` and ``kv_commit`` messages, by transfer id)."""

    def __init__(self):
        super().__init__()
        self.wire_bytes: dict = {}

    def serialize(self, dst, msg_class, payload, trace=None):
        wire = super().serialize(dst, msg_class, payload, trace)
        if msg_class in ("kv_page", "kv_commit"):
            tid = payload["transfer_id"]
            self.wire_bytes[tid] = self.wire_bytes.get(tid, 0) + len(wire)
        return wire


class ReplicaMeter:
    """K1's and K5's launches read around each replica's steps and
    restarts (the counters are global to the process, the replicas share
    the card): each step's exactly ``L`` x its engine's new prefills (K1)
    and decode steps (K5), a restart's one warm-up of each, and nothing
    launched anywhere else.  ``names`` is None on the CPU (no kernel)."""

    def __init__(self, reps, layers: int, names):
        self.L, self.names = layers, names
        self.by_replica = {r.name: {} for r in reps}
        self.wrong: list = []
        kernels.reset_launch_counts()
        for rep in reps:
            rep.step = self._wrap(rep, rep.step, "step")
            rep.restart = self._wrap(rep, rep.restart, "restart")

    def _wrap(self, rep, fn, what):
        def call():
            eng = rep.engine
            before = launch_counts()
            p0, d0 = eng.prefills, eng.decode_steps
            try:
                return fn()
            finally:
                after = launch_counts()
                got = {k: after[k] - before.get(k, 0) for k in after
                       if after[k] != before.get(k, 0)}
                if self.names is not None:
                    k1, k5 = self.names
                    n1, n5 = ((1, 1) if what == "restart" else
                              (eng.prefills - p0, eng.decode_steps - d0))
                    want = {k: self.L * n for k, n in ((k1, n1), (k5, n5))
                            if n}
                    if got != want:
                        self.wrong.append((rep.name, what, got, want))
                mine = self.by_replica[rep.name]
                for k, n in got.items():
                    mine[k] = mine.get(k, 0) + n
        return call

    def check(self, what: str) -> dict:
        total = launch_counts()
        summed: dict = {}
        for counts in self.by_replica.values():
            for k, n in counts.items():
                summed[k] = summed.get(k, 0) + n
        if self.wrong or total != summed:
            raise AssertionError(
                f"{what}: launches not exactly the replicas' prefills and "
                f"decode steps ({self.wrong[:3]}), or launched outside a "
                f"replica's step ({total} against {summed})")
        return dict(self.by_replica)


def fleet_reps(setup, clock, bus, roles=("mixed",) * 3, **kw):
    """Replicas over one shared parameter tree and one clock; ``prefill``
    ones are ``prefill_only`` engines, ``decode`` ones ``kv_import``."""
    role_kw = {"mixed": {}, "prefill": {"prefill_only": True},
               "decode": {"kv_import": True}}
    reps, seen = [], {}
    for role in roles:
        tag = "r" if role == "mixed" else role[0]
        name = f"{tag}{seen.get(tag, 0)}"
        seen[tag] = seen.get(tag, 0) + 1

        def build(role=role):
            return ServingEngine(setup["cfg"], setup["params"], clock=clock,
                                 telemetry=bus, device=setup["device"],
                                 **setup["engine"], **role_kw[role], **kw)
        reps.append(fleet_mod.ReplicaProxy(name, build, role=role))
    return reps


def fleet_bus(name: str):
    mem = MemorySink()
    return TelemetryBus(run_id=f"fleet-{name}", sinks=[mem]), mem


def fleet_events(mem) -> list:
    """The recorded events without the bus's own stamps (run id, mesh,
    wall time): what a card run and a CPU run must share."""
    return [{k: v for k, v in e.items() if k not in ("run_id", "mesh", "t",
                                                     "ts")}
            for e in mem.events]


def fleet_counts(mem) -> dict:
    n = {}
    for e in mem.events:
        n[e["type"]] = n.get(e["type"], 0) + 1
    return {k: n.get(k, 0) for k in (
        "replica_fence", "request_migrate", "kv_ship", "kv_ship_retry",
        "kv_ship_fallback", "migrate_refused", "fault_injected")}


def fleet_latency(mem) -> dict:
    """TTFT and TPOT p50 / p99 over the retired requests, on the virtual
    clock (ms)."""
    out = {}
    for key in ("ttft_ms", "tpot_ms"):
        vals = sorted(e[key] for e in mem.events
                      if e["type"] == "request_retire" and e.get(key)
                      is not None)
        out[key] = dict(p50=percentile(vals, 0.5),
                        p99=percentile(vals, 0.99))
    return out


def fleet_drive(fleet, fn) -> dict:
    """Run ``fn`` on ``fleet``: its rounds, wall seconds and ms a round."""
    t0, r0 = time.perf_counter(), fleet.round
    fn()
    if fleet.replicas[0].engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = fleet.round - r0
    return dict(rounds=rounds, wall_s=wall,
                ms_a_round=wall * 1e3 / max(1, rounds))


def fleet_submit(fleet, reqs) -> list:
    return [fleet.submit(r.prompt, r.max_new_tokens,
                         slo=FLEET25_TENANTS[i % 2].name)
            for i, r in enumerate(reqs)]


def fleet_check_served(what, fleet, reqs, rids, control, migrated,
                       required_all, margins_engine) -> dict:
    """Zero drops; each request never migrated (nor re-prefilled by a
    fallback) bitwise the control's stream; the others bitwise too when
    ``required_all`` (the fp32 toy), else recorded with their first
    divergent token and the control's top-2 margin there."""
    done = [fleet.handles[r] for r in rids]
    dropped = [h.rid for h in done if h.finish_reason not in ("eos",
                                                              "length")]
    if dropped or len(done) != len(reqs):
        raise AssertionError(f"{what}: requests dropped {dropped}")
    got = {rid: list(fleet.handles[rid].generated) for rid in rids}
    ref = {rid: control[i] for i, rid in enumerate(rids)}
    prompts = {rid: reqs[i].prompt for i, rid in enumerate(rids)}
    stay = [rid for rid in rids if rid not in migrated]
    if any(got[r] != ref[r] for r in stay):
        raise AssertionError(f"{what}: a request never moved differs from "
                             "the single engine's stream")
    moved = [rid for rid in rids if rid in migrated]
    held = dict(never_moved=len(stay), moved=len(moved))
    if moved:
        held["moved_streams"] = held_streams(
            f"{what}, moved requests", {r: got[r] for r in moved},
            {r: ref[r] for r in moved}, prompts, margins_engine,
            required_all)
    return held


def fleet_colocated(setup, reqs, control, required_all, margins) -> dict:
    """(a): 3 mixed replicas, the requests of two tenants drained, then
    submitted again with a rolling restart ``FLEET25_PRE_ROUNDS`` in."""
    clock = RoundClock()
    bus, mem = fleet_bus("colocated")
    reps = fleet_reps(setup, clock, bus)
    fleet = fleet_mod.FleetRouter(reps, telemetry=bus, on_round=clock.tick,
                                  slo_classes=FLEET25_TENANTS)
    fleet.warmup()
    meter = ReplicaMeter(reps, setup["cfg"].num_layers, setup["names"])
    seg1 = fleet_submit(fleet, reqs)
    steady = fleet_drive(fleet, fleet.run)
    fleet.emit_scale_hint()
    seg2 = fleet_submit(fleet, reqs)

    def restart():
        for _ in range(FLEET25_PRE_ROUNDS):
            fleet.step()
        fleet_mod.rolling_restart(fleet, serve_between=FLEET25_DOWNTIME)
        fleet.run()
    rolled = fleet_drive(fleet, restart)
    hint = fleet.emit_scale_hint()
    launches = meter.check("(a) colocated")
    migrated = {e["rid"] for e in mem.events
                if e["type"] == "request_migrate"}
    fences = [e["cause"] for e in mem.events
              if e["type"] == "replica_fence"]
    if fences != ["rolling_restart"] * 3 or not all(
            r.restarts == 1 and r.healthy for r in reps):
        raise AssertionError(f"(a): the rolling restart fenced {fences}")
    out = dict(steady=steady, restart=rolled, counts=fleet_counts(mem),
               latency=fleet_latency(mem), launches=launches,
               hint=hint, events=fleet_events(mem),
               tokens=by_rid(fleet.handles.values()))
    out["steady_streams"] = fleet_check_served(
        "(a) steady", fleet, reqs, seg1, control, migrated, required_all,
        margins)
    out["restart_streams"] = fleet_check_served(
        "(a) rolling restart", fleet, reqs, seg2, control, migrated,
        required_all, margins)
    return out


def fleet_faults(setup, reqs, control, required_all, margins) -> dict:
    """(b): ``KillReplica`` on r0 past its engine's recoveries (retries
    with backoff, fence, migration), ``BlackholeReplica`` on r1 (its ping
    times out virtually: fenced), ``SlowReplica`` on r2 under the budget
    (tolerated)."""
    clock = RoundClock()
    bus, mem = fleet_bus("faults")
    reps = fleet_reps(setup, clock, bus)
    fleet = fleet_mod.FleetRouter(reps, telemetry=bus, on_round=clock.tick,
                                  slo_classes=FLEET25_TENANTS,
                                  health_timeout_s=0.25)
    fleet.warmup()
    meter = ReplicaMeter(reps, setup["cfg"].num_layers, setup["names"])
    rids = fleet_submit(fleet, reqs)

    def serve():
        with KillReplica("r0", at_step=FLEET25_KILL_AT, telemetry=bus), \
                BlackholeReplica("r1", at_ping=FLEET25_BLACKHOLE_AT,
                                 telemetry=bus), \
                SlowReplica("r2", latency_s=FLEET25_SLOW_S, telemetry=bus):
            fleet.run()
    drive = fleet_drive(fleet, serve)
    launches = meter.check("(b) faults")
    fences = {e["replica"]: e["cause"] for e in mem.events
              if e["type"] == "replica_fence"}
    if fences != {"r0": "DeviceLossError", "r1": "health_check_timeout"} \
            or not reps[2].healthy \
            or reps[0].engine.recoveries != reps[0].engine.max_recoveries:
        raise AssertionError(f"(b): fences {fences}, r2 healthy "
                             f"{reps[2].healthy}, r0's recoveries "
                             f"{reps[0].engine.recoveries}")
    migrated = {e["rid"] for e in mem.events
                if e["type"] == "request_migrate"}
    out = dict(drive=drive, counts=fleet_counts(mem), fences=fences,
               latency=fleet_latency(mem), launches=launches,
               events=fleet_events(mem),
               tokens=by_rid(fleet.handles.values()))
    out["streams"] = fleet_check_served("(b) faults", fleet, reqs, rids,
                                        control, migrated, required_all,
                                        margins)
    return out


def fleet_disagg(setup, reqs, control, quant, chaos, required_all,
                 margins) -> dict:
    """(c): ``DisaggRouter`` over 2 prefill and 2 decode replicas on the
    ``quant`` pool, over ``LocalTransport`` (``chaos`` False: no retry, no
    fallback, K1 only on the prefill replicas and K5 only on the decode
    ones) or under ``FLEET25_CHAOS`` (retries and fallbacks counted).
    Every adopted page is the exporter's, byte for byte."""
    clock = RoundClock()
    bus, mem = fleet_bus("disagg")
    wire = MeteredTransport()
    transport = (fleet_mod.ChaosTransport(wire, schedule=FLEET25_CHAOS,
                                          telemetry=bus) if chaos else wire)
    reps = fleet_reps(setup, clock, bus, ("prefill", "prefill", "decode",
                                          "decode"), kv_quant=quant)
    fleet = fleet_mod.DisaggRouter(reps, telemetry=bus, transport=transport,
                                   on_round=clock.tick,
                                   slo_classes=FLEET25_TENANTS)
    fleet.warmup()
    exported, adopted, timing = {}, [], dict(export_s=0.0, import_s=0.0,
                                             pages=0)
    on_card = setup["device"] == "cuda"

    def export(eng):
        def call(rid):
            t0 = time.perf_counter()
            shipped = type(eng).export_request(eng, rid)
            timing["export_s"] += time.perf_counter() - t0
            timing["pages"] += len(shipped[1])
            exported[rid] = shipped[1]
            return shipped
        return call

    def land(eng):
        def call(record, pages, kv_len):
            t0 = time.perf_counter()
            req = type(eng).adopt_prefilled(eng, record, pages, kv_len)
            if on_card:
                torch.cuda.synchronize()
            timing["import_s"] += time.perf_counter() - t0
            adopted.append((req.rid, pages == exported[req.rid]))
            return req
        return call

    for rep in reps:
        if rep.role == "prefill":
            rep.engine.export_request = export(rep.engine)
        else:
            rep.engine.adopt_prefilled = land(rep.engine)
    meter = ReplicaMeter(reps, setup["cfg"].num_layers, setup["names"])
    rids = fleet_submit(fleet, reqs)
    drive = fleet_drive(fleet, fleet.run)
    launches = meter.check(f"(c) {quant or 'default'} pool")
    counts = fleet_counts(mem)
    if not all(same for _, same in adopted):
        raise AssertionError("(c): a page was adopted that the prefill "
                             "replica did not export")
    shipped = {e["rid"] for e in mem.events if e["type"] == "kv_ship"}
    fallen = {e["rid"] for e in mem.events if e["type"] == "kv_ship_fallback"}
    if not chaos:
        k1, k5 = setup["names"] or (None, None)
        pre = {n: v for n, v in launches.items() if n.startswith("p")}
        dec = {n: v for n, v in launches.items() if n.startswith("d")}
        if (counts["kv_ship_retry"] or counts["kv_ship_fallback"]
                or shipped != set(rids)
                or any(k5 in v for v in pre.values())
                or any(k1 in v for v in dec.values())
                or any(r.engine.prefills for r in reps[2:])):
            raise AssertionError(
                f"(c) over LocalTransport: retries {counts['kv_ship_retry']}"
                f", fallbacks {counts['kv_ship_fallback']}, or not K1 only "
                f"on the prefill replicas and K5 only on the decode ones "
                f"({launches})")
    pages = max(1, timing["pages"])
    out = dict(pool=quant or str(setup["cfg"].dtype).replace("torch.", ""),
               transport="chaos" if chaos else "local",
               drive=drive, counts=counts, launches=launches,
               latency=fleet_latency(mem), shipped=len(shipped),
               fallbacks=sorted(fallen), adopted=len(adopted),
               pages_shipped=timing["pages"],
               export_ms_a_page=timing["export_s"] * 1e3 / pages,
               import_ms_a_page=timing["import_s"] * 1e3 / pages,
               wire_bytes_one_request=wire.wire_bytes.get(f"t{rids[0]}"),
               events=fleet_events(mem),
               tokens=by_rid(fleet.handles.values()))
    if chaos:
        out["injected"] = dict(transport.injected)
    # a fallback re-prefills on the decode replica: recorded at bf16
    out["streams"] = fleet_check_served(
        f"(c) {out['pool']} over {out['transport']}", fleet, reqs, rids,
        control, fallen, required_all, margins)
    return out


def fleet_scenarios(setup, reqs, controls, pools, required_all,
                    margins) -> dict:
    """(a)-(c) on one setup.  ``pools`` lists ``(kv_quant, K5's entry
    point)``, the default pool first ((a) and (b) run on it);
    ``controls`` maps a pool to the single engine's streams of ``reqs``
    by index."""
    k1 = setup["k1"]
    setup["names"] = (k1, pools[0][1]) if k1 else None
    out = dict(colocated=fleet_colocated(setup, reqs, controls[None],
                                         required_all, margins))
    gc.collect()    # a scenario's replicas hold their pools in cycles
    out["faults"] = fleet_faults(setup, reqs[:FLEET25_FAULT_REQS],
                                 controls[None], required_all, margins)
    for quant, k5 in pools:
        setup["names"] = (k1, k5) if k1 else None
        for chaos in (False, True):
            gc.collect()
            out[f"disagg_{quant or 'default'}_"
                f"{'chaos' if chaos else 'local'}"] = fleet_disagg(
                setup, reqs[:FLEET25_SHIP_REQS], controls[quant], quant,
                chaos, required_all, margins)
    gc.collect()
    return out


def fleet_control(setup, reqs, quant=None):
    """The single engine at the same ``max_batch``: its streams by index,
    and the engine (whose prefill gives the top-2 margins)."""
    eng = ServingEngine(setup["cfg"], setup["params"], clock=SimClock(),
                        device=setup["device"], kv_quant=quant,
                        **setup["engine"])
    eng.warmup()
    handles = [eng.submit(r.prompt, r.max_new_tokens) for r in reqs]
    eng.run()
    return [list(h.generated) for h in handles], eng


def fleet_launches(runs: dict) -> dict:
    """Each kernel's launches summed over the scenarios' replicas."""
    total: dict = {}
    for run in runs.values():
        for counts in run["launches"].values():
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
    return total


def fleet_log(what: str, runs: dict, smi: str) -> None:
    """The numbers each scenario is read by, one line each."""
    for key, run in runs.items():
        drives = {k: run[k] for k in ("steady", "restart", "drive")
                  if k in run}
        row = dict(drives=drives, counts=run["counts"],
                   latency_virtual_ms=run["latency"],
                   launches=run["launches"])
        for k in ("pages_shipped", "export_ms_a_page", "import_ms_a_page",
                  "wire_bytes_one_request", "fallbacks", "injected",
                  "fences", "hint"):
            if k in run:
                row[k] = run[k]
        row["streams"] = {k: v for k, v in run.items()
                          if k.endswith("streams")}
        log(f"  {what} {key}: {json.dumps(row, default=str)}; {smi}")


def fleet_toy(smi: str) -> dict:
    """(d): the fp32 toy on the card through (a)-(c)'s scenarios (its own
    pool only: a quantized pool at head dim 8 has no kernel), every
    stream bitwise the single engine's, moved and fallen-back requests
    too, and each scenario's events and streams those of the port's run
    of it on the CPU from the same weights."""
    cfg = ServingModelConfig(**TOY_SERVE)
    reqs = poisson_trace(5, FLEET25_REQS, rate=2.0, prompt_len=(4, 20),
                         max_new=(3, 12), vocab_size=TOY_SERVE["vocab_size"])
    runs = {}
    params = init_params(cfg, seed=0, device="cpu")   # one draw, both runs
    for device in dict.fromkeys((CARD, "cpu")):
        on_card = device != "cpu"
        setup = dict(cfg=cfg, params=params_to(params, device),
                     device=device, engine=TOY_FLEET,
                     k1="flash_fwd" if on_card else None)
        control, eng = fleet_control(setup, reqs)
        runs[device] = fleet_scenarios(
            setup, reqs, {None: control},
            ((None, "flash_decode" if on_card else None),), True, eng)
    card, cpu = runs[CARD], runs["cpu"]
    for key in card:
        for what in ("events", "tokens"):
            if card[key][what] != cpu[key][what]:
                raise AssertionError(f"(d) toy {key}: the card's {what} "
                                     "differ from the CPU's")
    chaos = card["disagg_default_chaos"]
    if not chaos["fallbacks"] or not chaos["counts"]["kv_ship_retry"]:
        raise AssertionError("(d) toy: the chaos schedule made no retry or "
                             "no fallback")
    fleet_log("(d) toy", card, smi)
    out = {k: {n: v for n, v in r.items() if n not in ("events", "tokens")}
           for k, r in card.items()}
    out["launches"] = fleet_launches(card)
    return out


def phase_fleet(smi: str) -> dict:
    """Phase 25: the serving fleet at GPT-1.3B width (phase 5's model and
    pool; the replicas share the card, one parameter tree and one virtual
    clock) and the fp32 toy on the card against the CPU."""
    t0 = time.perf_counter()
    cfg = ServingModelConfig(**{"dtype": torch.bfloat16, **FULL,
                                "num_layers": SERVE_CUT_LAYERS,
                                **FLEET25_OVER})
    on_card = CARD != "cpu"
    setup = dict(cfg=cfg, params=init_params(cfg, seed=0, device=CARD),
                 device=CARD, k1="flash_fwd_sm90" if on_card else None,
                 engine=dict(num_pages=NUM_PAGES, page_size=PAGE,
                             max_batch=BATCH,
                             max_pages_per_request=PAGES_PER_REQ,
                             prefill_budget=cfg.max_position))
    reqs = (poisson_trace(25, FLEET25_REQS, rate=8.0, prompt_len=(4, 60),
                          max_new=(3, 16), vocab_size=cfg.vocab_size)
            if FLEET25_OVER else trace(25, FLEET25_REQS))
    control, margins = fleet_control(setup, reqs)
    int8, _ = fleet_control(setup, reqs[:FLEET25_SHIP_REQS], "int8")
    pools = ((None, "flash_decode_sm90" if on_card else None),
             ("int8", "flash_decode_sm90_int8" if on_card else None))
    out = fleet_scenarios(setup, reqs, {None: control, "int8": int8}, pools,
                          False, margins)
    fleet_log("full width", out, smi)
    out = {k: {n: v for n, v in r.items() if n not in ("events", "tokens")}
           for k, r in out.items()}
    out["launches"] = fleet_launches(out)
    out["launches_disaggregated"] = {
        pool: out[f"disagg_{pool}_local"]["launches"]
        for pool in ("default", "int8")}
    del margins, setup
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["toy"] = fleet_toy(smi)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 25 took {out['wall_s']:.1f} s; launches {out['launches']}"
        f"; toy {out['toy']['launches']}; {smi}")
    return out


# -- phase 26: tensor-parallel serving on torch.distributed -----------------
#
# The tensor ranks are processes sharing cuda:0 over gloo, as in phases
# 22-24: every block's partial residual (two a layer) and every agreement
# (the clock, the fault verdict) is staged through the host.  The streams,
# the kernels at a rank's shapes and the launch counts are checked on the
# card; a tp engine's speed over several cards is not.

TP26_HEADS = FULL["num_heads"] // 2       # a rank's heads at tp 2
# K1 and K5 held to their plain versions at every head count a rank of
# FULL or FP32_MODES can hold: the grids and K1's TMA descriptors
TP26_HEAD_COUNTS = (8, 4, 2, 1)
TP26_LOSS_AT = 6      # (d): the decode boundary the device loss hits
TP26_SNAP_AT = 5      # (d): engine steps before the snapshot
TP26_SPLIT_STEPS = 6   # (a): full-batch decode steps timed a rank
# every request of the phase: phase 5's three (trace(1, 3)) with their
# budgets (16-64 tokens) cut to 12 new tokens: a decode step of ranks that
# time-slice the card takes ~0.3 s (measured on one H100), and at the full
# budgets the phase took 160.7 s
TP26_NEW = 12
# (c)'s speculative engine: phase 15's draft width and chunk
TP26_SPEC = dict(k=SPEC_K, chunk_size=CHUNK)


def tp26_engine(params, cfg, tp, prefill=None, **kw) -> ServingEngine:
    """Phase 5's pool geometry (pages of 64, batch 8, 5 pages a request)
    at ``tp`` ranks on the card."""
    return ServingEngine(cfg, params, num_pages=NUM_PAGES, page_size=PAGE,
                         max_batch=BATCH, max_pages_per_request=PAGES_PER_REQ,
                         prefill_budget=prefill or cfg.max_position,
                         device="cuda", tp=tp, **kw)


def tp26_requests() -> list:
    """Phase 5's three requests with their budgets cut to
    :data:`TP26_NEW` tokens (a greedy stream's first tokens do not depend
    on its budget)."""
    reqs = trace(1, 3)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, TP26_NEW)
    return reqs


def tp26_cfg(job) -> ServingModelConfig:
    return ServingModelConfig(**job["cfg"], dtype=getattr(torch, job["dtype"]))


def tp26_step_split(eng, steps=TP26_SPLIT_STEPS) -> dict:
    """Full-batch decode steps of a tp engine (every rank at once): the
    median wall to the device's end, and the share of it the host spent
    in the staged all-reduces (``comm.STATS``)."""
    from apex_tpu_torch.parallel import comm

    dev = full_batch_operands(eng)
    eng._decode(dev)
    torch.cuda.synchronize()
    walls = []
    comm.STATS.reset()
    for _ in range(steps):
        t0 = time.perf_counter()
        eng._decode(dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    st = comm.STATS.as_dict()
    return dict(step_ms_p50=statistics.median(walls), step_ms=walls,
                collectives_per_step=st["calls"] / steps,
                collective_bytes_per_step=st["bytes"] / steps,
                collective_share=st["seconds"] * 1e3 / sum(walls))


@torch.no_grad()
def tp26_streams(job) -> dict:
    """One pool at this launch's tp: ``warmup()`` and the three requests
    served together, metered (each rank's exact K1 and K5 launches, its
    collectives, wall and peak), then again and one at a time; with
    ``split``, the full-batch decode step timed."""
    from apex_tpu_torch.parallel import comm

    cfg = tp26_cfg(job)
    params = init_params(cfg, seed=0, device="cuda")
    tp = parallel_state.get_tensor_model_parallel_world_size()
    spec = SpecConfig(**job["spec"]) if job.get("spec") else None
    reqs = tp26_requests()

    def engine():
        return tp26_engine(params, cfg, tp, job.get("prefill"),
                           kv_quant=job.get("quant"), spec=spec)

    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    comm.STATS.reset()
    t0 = time.perf_counter()
    eng.warmup()
    together = streams_of(eng, reqs)
    torch.cuda.synchronize()
    out = dict(together=together, wall_s=time.perf_counter() - t0,
               launches=launch_counts(), comm=comm.STATS.as_dict(),
               prefills=eng.prefills, decode_steps=eng.decode_steps,
               verify_steps=eng.verify_steps, chunk_steps=eng.chunk_steps,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               pool=tuple(eng.cache.k.shape))
    if spec is None:
        L = cfg.num_layers
        out["want"] = {job["k1"]: L * (eng.prefills + 1),
                       job["k5"]: L * (eng.decode_steps + 1)}
    if job.get("split"):
        out["split"] = tp26_step_split(eng)
    del eng
    if not job.get("together_only"):
        out["again"] = streams_of(engine(), reqs)
        out["one_at_a_time"] = streams_of(engine(), reqs, one_at_a_time=True)
    return out


@torch.no_grad()
def tp26_resilience(job) -> dict:
    """(d) at tp 2 on an int8 pool: a device loss injected on the group's
    first rank only, a snapshot restored into pools poisoned with
    sentinels, and a prefill-only engine's export of one request."""
    cfg = tp26_cfg(job)
    params = init_params(cfg, seed=0, device="cuda")
    reqs = tp26_requests()
    rank = parallel_state.get_tensor_model_parallel_rank()

    def engine(**kw):
        return tp26_engine(params, cfg, 2, job["prefill"], kv_quant="int8",
                           clock=SimClock(), **kw)

    out = {"control": streams_of(engine(), reqs)}
    eng = engine()
    if rank == 0:
        with ServingDeviceLoss(at_step=TP26_LOSS_AT, device_ids=[0]) as dl:
            out["lost"] = streams_of(eng, reqs)
        out["fired"] = dl.fired
    else:
        out["lost"] = streams_of(eng, reqs)
    out["recoveries"] = eng.recoveries
    src = engine()
    for r in reqs:
        src.submit(r.prompt, r.max_new_tokens)
    for _ in range(TP26_SNAP_AT):
        src.step()
    snap = json.loads(json.dumps(src.snapshot()))
    dst = engine()
    for t, fill in ((dst.cache.k, 101), (dst.cache.v, 102),
                    (dst.cache.k_scale, 1e3), (dst.cache.v_scale, 1e3)):
        t.fill_(fill)
    restored = dst.restore(snap)
    dst.run()
    out["restored"] = {r.rid: list(r.generated) for r in restored}
    pre = engine(prefill_only=True)
    pre.warmup()
    r = pre.submit(reqs[0].prompt, reqs[0].max_new_tokens)
    pre.step()
    out["export"] = pre.export_request(r.rid)
    return out


TP26_JOBS = {"streams": tp26_streams, "resilience": tp26_resilience}


def phase26_rank(rank, world, init_file, out, jobs):
    """A rank of phase 26 (spawned): joins the gloo group and the tensor
    group of ``world`` ranks, runs each job in order (a barrier after
    each) and writes the results to ``<out>/rank<r>.pt``."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multiproc.init_file_group("gloo", rank, world, init_file)
    parallel_state.initialize_model_parallel(world)
    results = {}
    for job in jobs:
        t0 = time.perf_counter()
        results[job["name"]] = TP26_JOBS[job["kind"]](job)
        results[job["name"]]["job_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    parallel_state.destroy_model_parallel()
    dist.destroy_process_group()


def tp26_kernel_rows(seed: int, timings: dict) -> dict:
    """(e) K1 and K5 at a rank's shapes: held to their plain versions at
    every head count of :data:`TP26_HEAD_COUNTS` (each run twice bitwise,
    K1's tiles walked as the rule), then timed at tp 2's 8 heads beside
    the plain versions, the library calls and the bound, and read against
    phase 3's 16-head rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    errs: dict = {}
    ops = {}
    for h in TP26_HEAD_COUNTS:
        err, o = flash_fwd_case(gen, f"bf16 one segment C=700 + pad, {h} "
                                f"head(s)", bf16, [700], h=h)
        errs.setdefault("flash_fwd_sm90", []).append(err)
        if h == TP26_HEADS:
            ops["flash_fwd_sm90"] = o
        for pool, quant, name in DECODE_POOLS[:2]:
            err, o, ran = flash_decode_case(
                gen, f"{pool} pool q_len=1, {h} head(s)", bf16, 1,
                DECODE_RAGGED, quant, h=h)
            if ran != name:
                raise AssertionError(f"(e) the {pool} pool at {h} heads ran "
                                     f"{ran}, not {name}")
            errs.setdefault(name, []).append(err)
            if h == TP26_HEADS:
                ops[name] = o
    fwd, _ = time_flash_fwd(bf16, *ops.pop("flash_fwd_sm90"))
    rows = {"flash_fwd_sm90_tp2": fwd}
    for name, o in ops.items():
        rows[f"{name}_tp2"] = time_flash_decode(f"{name} ragged, "
                                                f"{TP26_HEADS} heads", o)
    for name, row in rows.items():
        base = name[:-len("_tp2")]
        row["max_abs_err"] = max(errs[base])
        row["max_abs_err_by_heads"] = dict(zip(TP26_HEAD_COUNTS, errs[base]))
        row["ms_16_heads"] = timings[base]["ms"]
        log(f"  (e) {name}: {row['ms']:.4f} ms at {TP26_HEADS} heads against "
            f"{row['ms_16_heads']:.4f} at 16 (phase 3): "
            f"{row['ms'] / row['ms_16_heads']:.2f}x")
    torch.cuda.empty_cache()
    return rows


def tp26_same(what: str, runs: list, key: str) -> None:
    """Every rank's ``key`` equal to rank 0's (the one-token contract)."""
    for r, res in enumerate(runs[1:], 1):
        if res[key] != runs[0][key]:
            raise AssertionError(f"{what}: rank {r}'s {key} streams differ "
                                 "from rank 0's")


def tp26_check_streams(what: str, runs: list, launch_bar: bool = True
                       ) -> dict:
    """A streams job on every rank: identical streams across ranks,
    batched == one at a time == again bitwise, each rank's launches the
    exact count of its own prefills and decode steps."""
    for key in ("together", "again", "one_at_a_time"):
        tp26_same(what, runs, key)
    r0 = runs[0]
    if not r0["together"] == r0["again"] == r0["one_at_a_time"]:
        raise AssertionError(f"{what}: batched, re-run and one-at-a-time "
                             "streams differ")
    if launch_bar:
        for r, res in enumerate(runs):
            if res["launches"] != res["want"]:
                raise AssertionError(f"{what}: rank {r} launched "
                                     f"{res['launches']}, expected "
                                     f"{res['want']}")
    by_op = r0["comm"]["by_op"]
    log(f"  {what}: {len(runs)} ranks' streams identical; batched == "
        f"again == one at a time at max_batch {BATCH}; rank 0: "
        f"{r0['prefills']} prefills, {r0['decode_steps']} decode steps, "
        f"launches {r0['launches']} a rank (exact), pool {r0['pool']}, "
        f"{r0['comm']['calls']} collectives {by_op} "
        f"({r0['comm']['seconds']:.2f} s of {r0['wall_s']:.2f} s), peak "
        f"{r0['peak_gib']:.2f} GiB")
    if sum(by_op.values()) != r0["comm"]["calls"]:
        raise AssertionError(f"{what}: comm.STATS.by_op names "
                             f"{sum(by_op.values())} of "
                             f"{r0['comm']['calls']} calls")
    return r0


def tp26_controls(job_fp32: dict) -> dict:
    """The tp 1 fp32 controls of (c) on this process: the plain engine's
    streams and the speculative engine's."""
    cfg = tp26_cfg(job_fp32)
    params = init_params(cfg, seed=0, device="cuda")
    out = {}
    for key, spec in (("plain", None), ("spec", SpecConfig(**TP26_SPEC))):
        eng = tp26_engine(params, cfg, 1, FP32_PREFILL, spec=spec)
        out[key] = streams_of(eng, tp26_requests())
        del eng
    torch.cuda.empty_cache()
    return out


def phase_tp_serving(smi: str, timings: dict, serving: dict) -> dict:
    """Phase 26 (see the module docstring)."""
    log(f"  {GLOO_WHY}")
    t_phase = time.perf_counter()
    rows = tp26_kernel_rows(43, timings)
    full = dict(cfg=FULL, dtype="bfloat16", kind="streams",
                k1="flash_fwd_sm90")
    fp32 = dict(cfg=FP32_MODES, dtype="float32", kind="streams",
                prefill=FP32_PREFILL, k1="flash_fwd", k5="flash_decode")
    tmp = tempfile.mkdtemp(prefix="tp26_")
    try:
        log("  the launches below run side by side, with the tp 1 fp32 "
            "controls on this process: their wall times are of a card "
            "shared by eight ranks")
        a, b, tp4, ctrl = concurrently(
            lambda: tp22_spawn(2, [
                dict(full, name="a", split=True, k5="flash_decode_sm90"),
                dict(fp32, name="c"),
                dict(fp32, name="c_spec", spec=TP26_SPEC,
                     together_only=True)], tmp,
                "(a) GPT-1.3B width, bf16, and (c) fp32 at tp 2",
                body=phase26_rank),
            lambda: tp22_spawn(2, [
                dict(full, name="b", quant="int8",
                     k5="flash_decode_sm90_int8"),
                dict(cfg=FP32_MODES, dtype="float32", kind="resilience",
                     name="d", prefill=FP32_PREFILL)], tmp,
                "(b) int8 at full width and (d) resilience at tp 2",
                body=phase26_rank),
            lambda: tp22_spawn(4, [dict(fp32, name="c")], tmp,
                               "(c) fp32 at tp 4", body=phase26_rank),
            lambda: tp26_controls(fp32))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (a) the main path: GPT-1.3B width at tp 2
    ra = [r["a"] for r in a]
    a0 = tp26_check_streams("(a) bf16 at tp 2", ra)
    tp1 = [st[:TP26_NEW] for st in serving["bf16"]["streams"]]
    reqs = tp26_requests()
    got = dict(enumerate(a0["together"]))
    ref = dict(enumerate(tp1))
    n_same = sum(got[i] == ref[i] for i in ref)
    div = {"diverged": len(ref) - n_same, "divergences": []}
    if n_same != len(ref):
        cfg = ServingModelConfig(**FULL, dtype=torch.bfloat16)
        eng = full_engine(init_params(cfg, seed=0, device="cuda"), cfg)
        div = divergences(got, ref, [r.prompt for r in reqs], eng)
        del eng
        torch.cuda.empty_cache()
    log(f"  (a) against phase 5's tp 1 streams: {n_same} of {len(ref)} "
        f"bitwise (a reading, not a bar: the tp 2 sums are grouped "
        f"otherwise); divergences {div['divergences']}")
    split = [r["split"] for r in ra]
    log(f"  (a) full-batch decode step at tp 2: "
        f"{[round(s['step_ms_p50'], 3) for s in split]} ms p50 a rank, "
        f"{split[0]['collectives_per_step']:.0f} collectives a step "
        f"({split[0]['collective_bytes_per_step'] / 1e6:.3f} MB), "
        f"{[round(s['collective_share'], 3) for s in split]} of the step in "
        f"them; phase 5's tp 1 step: host enqueue "
        f"{serving['bf16']['decode_enqueue_ms_p50']:.3f} ms, device done "
        f"{serving['bf16']['decode_done_ms_p50']:.3f} ms")

    # (b) the int8 pool at full width
    rb = [r["b"] for r in b]
    b0 = tp26_check_streams("(b) int8 at tp 2", rb)

    # (c) fp32 at tp 2 and tp 4: JAX's bitwise contracts
    rc2, rc4 = [r["c"] for r in a], [r["c"] for r in tp4]
    c2 = tp26_check_streams("(c) fp32 at tp 2", rc2)
    c4 = tp26_check_streams("(c) fp32 at tp 4", rc4)
    for what, c in (("tp 2", c2), ("tp 4", c4)):
        if c["together"] != ctrl["plain"]:
            raise AssertionError(f"(c) fp32 at {what}: the streams are not "
                                 "tp 1's")
    spec = [r["c_spec"] for r in a]
    tp26_same("(c) speculative fp32 at tp 2", spec, "together")
    if spec[0]["together"] != ctrl["spec"]:
        raise AssertionError("(c) speculation + chunking at tp 2 differs "
                             "from its tp 1 control")
    log(f"  (c) fp32 at {FP32_MODES['hidden_size']} x "
        f"{FP32_MODES['num_layers']} layers, {FP32_MODES['num_heads']} heads: "
        f"tp 2 and tp 4 streams bitwise tp 1's; speculation (k {SPEC_K}) + "
        f"chunking ({CHUNK}) at tp 2 bitwise its tp 1 control "
        f"({spec[0]['verify_steps']} verify, {spec[0]['chunk_steps']} chunk "
        "steps)")

    # (d) resilience at tp 2 + int8
    rd = [r["d"] for r in b]
    d0 = rd[0]
    if not d0.get("fired") or "fired" in rd[1]:
        raise AssertionError("(d) the injector did not fire on rank 0 alone")
    for r, res in enumerate(rd):
        if res["recoveries"] != 1 or res["lost"] != res["control"]:
            raise AssertionError(f"(d) rank {r}: {res['recoveries']} "
                                 "recoveries, or the streams after the "
                                 "device loss are not the control's")
        want = dict(enumerate(res["control"]))
        if not res["restored"] or any(s != want[rid] for rid, s in
                                      res["restored"].items()):
            raise AssertionError(f"(d) rank {r}: the restored streams are "
                                 "not the control's")
    tp26_same("(d)", rd, "control")
    record, pages, kv_len = d0["export"]
    if rd[1]["export"][1] != pages:
        raise AssertionError("(d) the ranks exported different payloads")
    cfg = tp26_cfg(dict(cfg=FP32_MODES, dtype="float32"))
    one = tp26_engine(init_params(cfg, seed=0, device="cuda"), cfg, 1,
                      FP32_PREFILL, kv_quant="int8", kv_import=True,
                      validate_pages=True, clock=SimClock())
    landed = one.adopt_prefilled(record, pages, kv_len)
    back = [one.cache.export_page_bytes(p) for p in landed.pages]
    one.run()
    if back != pages or not all(verify_page_payload(p) for p in pages):
        raise AssertionError("(d) the tp 1 engine's export of the landed "
                             "pages is not the tp 2 engine's bytes and CRCs")
    if list(landed.generated) != d0["control"][0]:
        raise AssertionError("(d) the tp 1 engine did not decode the tp 2 "
                             "engine's stream from its pages")
    del one
    torch.cuda.empty_cache()
    log(f"  (d) int8 at tp 2: a device loss on rank 0 only at decode "
        f"boundary {TP26_LOSS_AT}: both ranks recovered once, streams the "
        f"control's; a snapshot after {TP26_SNAP_AT} steps restored into "
        f"poisoned pools: {len(d0['restored'])} requests, the control's; "
        f"{len(pages)} pages exported at tp 2 (whole pages, "
        f"{len(base64.b64decode(pages[0]['k']))} bytes of K a page), landed "
        "in a tp 1 engine that exported the same bytes and CRCs back and "
        "decoded the tp 2 stream")

    secs = time.perf_counter() - t_phase
    record = {"card": smi, "shared_card": True,
              "a": {k: a0[k] for k in ("wall_s", "prefills", "decode_steps",
                                       "launches", "comm", "peak_gib",
                                       "job_s")},
              "a_split": split, "a_vs_tp1_bitwise": n_same,
              "a_divergences": div["divergences"],
              "b": {k: b0[k] for k in ("wall_s", "decode_steps", "launches",
                                       "peak_gib", "job_s")},
              "c_tp2_launches": c2["launches"],
              "c_tp4_launches": c4["launches"],
              "phase_s": secs}
    log("  phase 26 " + json.dumps(record))
    log(f"  phase 26 took {secs:.1f} s; {smi}")
    return {"rows": rows, "a": ra, "b": rb, "c_tp2": rc2, "c_tp4": rc4,
            "record": record}


# -- phase 27: the Mixture-of-Experts GPT and ring attention ------------------

MOE27_OVER: dict = {}           # a CPU rehearsal narrows the model here
# GPT1P3B_KW's widths with Switch-Base-8's experts (Fedus et al. 2021) at
# JAX's defaults; depth cut to 8 layers, a cut the card forces: a layer
# holds 16.8 M attention and 8 x 2 x 2048 x 8192 = 268.4 M expert
# parameters, so 24 layers are 6.95 B parameters, ~111 GB of fp32
# masters, gradients and Adam moments, and 8 layers 2.39 B, ~38 GB
MOE27_LAYERS = 8
MOE27_MOE = dict(num_experts=8, moe_capacity_factor=1.25,
                 moe_aux_loss_coeff=1e-2)
MOE27_TRAIN = (FULL_TRAIN[:1] + [str(MOE27_LAYERS)] + FULL_TRAIN[2:]
               + ["--log-interval", "1"])
MOE27_STEPS = 3                 # timed, after one warm-up step
# kernel vs plain step (dropout off, bf16), the plain step routed as the
# kernel step was (RouteTap): ten times the gaps read on an NVIDIA H100
# 80GB HBM3 at 700.00 W.  Unpinned, a bf16 difference flips 6-24 near-ties
# a layer (top-2 margins 3e-5 to 6e-3) and each moves a token's expert
# output wholesale: the same step read 1.7e-3 on the grad norm and 7.6e-2
# on the worst leaf (layer 5's experts.w1), so the routing is pinned and
# the reroutes are printed as a reading.  Absolute on a loss near 9.7
# (read 5.6e-5):
MOE27_LOSS_TOL = 6e-4
MOE27_NORM_TOL = 1e-3       # relative, global grad norm (read 9.7e-5)
# relative, the worst leaf (read 6.7e-3, layer 5's experts.w1; the median
# leaf 2.6e-3)
MOE27_LEAF_TOL = 7e-2
# (b): the fp32 toy card vs CPU, flash and fused-softmax paths
MOE27_TOY = dict(num_layers=2, hidden_size=256, num_attention_heads=2,
                 vocab_size=256, max_position_embeddings=128, num_experts=4,
                 moe_capacity_factor=1.25)
MOE27_TOY_STEPS = 3
# final weights, card vs CPU, absolute: ten times the largest gap read on
# an H100 (5.7e-5 on the flash path, 4.4e-5 on the fused-softmax one; the
# fp32 toy of phase 6 reads 9.6e-6, but this one takes three Adam steps at
# lr 1e-3 on one batch); three steps move a weight by up to 3e-3, so a
# skipped update fails it.  Losses within TOY_LOSS_TOL (read 1.7e-7)
MOE27_TOY_WEIGHT_TOL = 6e-4
# (c): SwitchMLP at GPT-1.3B width on each rank's 2048 tokens
MOE27_EP = dict(hidden_size=2048, ffn_hidden_size=8192, num_experts=8,
                capacity_factor=1.25)
MOE27_EP_TOKENS = 2048
# tp 2 x ep 2 held to ep 1 (fp32), relative: ten times the gaps read on
# an H100 (outputs 2.0e-6 and the loss 0; the dense block's and the gate's
# gradients 1.3e-6, the experts' statistics 2.4e-6): the tp sum and the
# experts' doubled rows are summed in another order
MOE27_TPEP_OUT_TOL = 2e-5
MOE27_TPEP_GRAD_TOL = 2.5e-5
# ring attention: bench.py's shape (bh 2, s 8 x sp, d 8, fp32) and a
# GPT-1.3B rank's at sp 2 ([4 x 16, 1024, 128] bf16)
RING27_BENCH = (2, 8, 8)
RING27_GPT = (64, 1024, 128)


def moe27_setup(device, over=None):
    """(args, model, opt): phase 7's flags at :data:`MOE27_LAYERS` layers,
    its config made MoE under remat attn_res, tree ``FusedAdam``."""
    args, model, opt = pretrain_gpt.setup(MOE27_TRAIN, device)
    cfg = dataclasses.replace(model.cfg, remat=True, remat_policy="attn_res",
                              **MOE27_MOE, **(over or MOE27_OVER))
    del model, opt
    gc.collect()
    model = GPTModel(cfg, device=device, seed=args.seed)
    opt = FusedAdam(model.parameters(), lr=args.lr,
                    weight_decay=args.weight_decay,
                    betas=(args.adam_beta1, args.adam_beta2),
                    eps=args.adam_eps)
    return args, model, opt


class RouteTap:
    """Each layer's ``SwitchMLP`` routing over one forward: ``record``
    keeps, by module, its input and its experts, slots and token shares
    at its first call (the remat recompute calls it again);
    ``pinned()`` then makes a later run route every token as recorded
    (its gate weight the probability of that expert, recomputed), so that
    two runs' arithmetic can be compared without a near-tie's flip moving
    a token to another expert wholesale."""

    def __init__(self):
        from apex_tpu_torch.transformer import moe as tmoe

        self.cls = tmoe.SwitchMLP
        self.route = tmoe.SwitchMLP.route
        self.seen, self.kept = {}, {}

    def record(self):
        tap = self

        def route(mod, h):
            got = tap.route(mod, h)
            tap.seen.setdefault(id(mod), (mod, h.detach()))
            tap.kept.setdefault(id(mod), (got[0], got[2], got[3]))
            return got

        return mock.patch.object(self.cls, "route", route)

    def pinned(self):
        tap = self

        def route(mod, h):
            tap.seen.setdefault(id(mod), (mod, h.detach()))
            expert, slot, frac = tap.kept[id(mod)]
            probs = torch.softmax(h.float() @ mod.gate.weight.float(), -1)
            return (expert, probs.gather(1, expert[:, None])[:, 0], slot,
                    frac, probs.mean(dim=0))

        return mock.patch.object(self.cls, "route", route)

    def routes(self) -> list:
        """Each layer's expert ids and top-2 gate margins at its recorded
        input (where that run would have routed it), in layer order."""
        out = []
        with torch.no_grad():
            for mod, h in self.seen.values():
                probs = torch.softmax(h.float() @ mod.gate.weight.float(), -1)
                top = probs.topk(2, dim=-1).values
                out.append((probs.argmax(-1), top[:, 0] - top[:, 1]))
        self.seen = {}
        return out


def moe27_rerouted(got: list, ref: list) -> list:
    """The tokens whose expert differs between two runs' routings, by
    layer, with the reference's top-2 margins at the first eight."""
    out = []
    for (ids, _), (ref_ids, margin) in zip(got, ref):
        moved = (ids != ref_ids).nonzero().flatten()
        out.append(dict(n=int(moved.numel()),
                        margins=[float(m) for m in margin[moved][:8]]))
    return out


def moe27_train(smi: str) -> dict:
    """(a): the MoE GPT step at GPT-1.3B width."""
    L = MOE27_LAYERS
    want = zero24_launches(L, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args, model, opt = moe27_setup(CARD)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=CARD).manual_seed(11)
    tokens, labels = next(pretrain_gpt.synthetic_batches(args, gen))
    losses = [float(pretrain_gpt.train_step(args, model, opt, tokens, labels,
                                            0))]
    kernels.reset_launch_counts()
    enqueue, done = [], []
    for it in range(1, 1 + MOE27_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = pretrain_gpt.train_step(args, model, opt, tokens, labels,
                                           it)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        done.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = launch_counts()
    per_step = {k: launches.get(k, 0) / MOE27_STEPS for k in TP22_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = (math.log(model.cfg.vocab_size)
              + 0.02 ** 2 * model.cfg.hidden_size / 2
              + model.cfg.moe_aux_loss_coeff * L)  # aux ~1 a layer at init
    log(f"  (a) {n_params} parameters ({L} layers, 8 experts a layer), built "
        f"in {build_s:.1f} s; losses {losses} (step 1 expected near "
        f"{expect:.3f}); launches over {MOE27_STEPS} steps {launches}, per "
        f"step {per_step} (remat attn_res: {want}); the timed steps under "
        "set_sync_debug_mode('error'): no host sync")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("(a): non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a): the loss does not fall: {losses}")
    if abs(losses[0] - expect) > STEP_LOSS_TOL:
        raise AssertionError(f"(a): step 1 loss {losses[0]} is not within "
                             f"{STEP_LOSS_TOL} of {expect:.3f}")
    if per_step != {k: float(v) for k, v in want.items()} or any(
            launches.get(k, 0) for k in ZERO24_SCALAR):
        raise AssertionError("(a): launches a step are not the main path's")
    step_ms = statistics.median(done)
    prof = step_profile(lambda: pretrain_gpt.train_step(
        args, model, opt, tokens, labels, 9))
    if prof["device_busy_ms"] > 0:
        log("  (a) one step under torch.profiler: " + ", ".join(
            f"{k} {v:.1f} ms ({v / prof['wall_ms']:.1%})"
            for k, v in prof["by_kind_ms"].items())
            + f"; wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}")
        for name, n, t in prof["top_kernels"]:
            log(f"    {t:8.1f} ms  x{n:<5d} {name}")
        log_other_ops(prof)
    del opt
    gc.collect()
    torch.cuda.empty_cache()

    # kernels vs plain versions, one dropout-free step from the same
    # weights, the plain step routed as the kernel step was
    tap = RouteTap()
    with tap.record():
        loss, grads = loss_and_grads(model, tokens, labels)
    kr = tap.routes()
    patches = plain_kernels()
    with patches[0], patches[1], tap.pinned():
        ref_loss, ref_grads = loss_and_grads(model, tokens, labels)
    rerouted = moe27_rerouted(kr, tap.routes())
    norm = multi_tensor_l2norm(list(grads.values())).item()
    ref_norm = multi_tensor_l2norm(list(ref_grads.values())).item()
    dl, dn = abs(loss - ref_loss), abs(norm - ref_norm) / ref_norm
    leaf = {n: ((grads[n] - g).norm() / g.norm()).item()
            for n, g in ref_grads.items() if g.norm() > 0}
    worst = max(leaf, key=leaf.get)
    log(f"  (a) dropout-free step, kernels vs plain (the plain step routed "
        f"as the kernel step): loss {loss:.6f} vs {ref_loss:.6f} (diff "
        f"{dl:.3e}, tol {MOE27_LOSS_TOL:.1e}); grad norm rel diff {dn:.3e} "
        f"(tol {MOE27_NORM_TOL:.0e}); worst leaf {worst} {leaf[worst]:.3e} "
        f"(tol {MOE27_LEAF_TOL:.0e}), median over {len(leaf)} leaves "
        f"{statistics.median(leaf.values()):.3e}; tokens the plain step "
        f"would have routed elsewhere, by layer (a reading: a bf16 "
        f"difference flips a near-tie), with its top-2 margins there: "
        f"{rerouted}")
    if not (dl <= MOE27_LOSS_TOL and dn <= MOE27_NORM_TOL
            and leaf[worst] <= MOE27_LEAF_TOL):
        raise AssertionError("(a): the kernel step disagrees with the plain "
                             "step")
    del model, grads, ref_grads, tap
    gc.collect()
    torch.cuda.empty_cache()

    # determinism: the same step (dropout on) twice from the same seed
    def one_step():
        a, m, o = moe27_setup(CARD)
        loss = float(pretrain_gpt.train_step(a, m, o, tokens, labels, 0))
        d = tree_digests([p for p in m.parameters()])
        del a, m, o
        gc.collect()
        torch.cuda.empty_cache()
        return loss, d

    run1, run2 = one_step(), one_step()
    same = run1 == run2
    log(f"  (a) the same step twice from the same seed (dropout on): losses "
        f"{run1[0]!r} / {run2[0]!r}, parameters bitwise equal: {same}")
    if not same:
        raise AssertionError("(a): the MoE step is not deterministic")
    out = dict(params=n_params, build_s=build_s, losses=losses,
               step_ms=step_ms, step_ms_all=done,
               step_enqueue_ms=statistics.median(enqueue),
               tok_per_s=tokens.numel() / step_ms * 1e3, peak_gib=peak,
               launches=launches, launches_per_step=per_step,
               kernel_vs_plain=dict(loss=dl, norm=dn, worst_leaf=leaf[worst],
                                    worst=worst, rerouted=rerouted),
               deterministic=same, step_profile=prof, card=smi)
    log(f"  (a) step {step_ms:.1f} ms (median of {MOE27_STEPS}; host enqueue "
        f"{out['step_enqueue_ms']:.1f} ms), {out['tok_per_s']:.0f} tok/s, "
        f"peak {peak:.2f} GiB (max_memory_allocated), on {smi}")
    return out


def moe27_toy_run(device, state, batches, flash):
    cfg = GPTConfig(**MOE27_TOY, use_flash_attention=flash)
    model = GPTModel(cfg, device=device)
    model.load_state_dict(state)
    opt = FusedAdam(model.parameters(), lr=1e-3)
    losses = []
    for tokens, labels in batches:
        loss = model(tokens.to(device), labels=labels.to(device)).mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    return losses, {k: v.detach().cpu() for k, v in
                    model.state_dict().items()}


def moe27_toy() -> dict:
    """(b): the fp32 toy MoE GPT, card against CPU, from one init, through
    the flash path (the scalar K3/K4) and the fused-softmax path."""
    state = GPTModel(GPTConfig(**MOE27_TOY), device="cpu").state_dict()
    gen = torch.Generator().manual_seed(27)
    ids = torch.randint(0, MOE27_TOY["vocab_size"], (2, 129), generator=gen)
    batches = [(ids[:, :-1], ids[:, 1:])] * MOE27_TOY_STEPS   # it must fall
    out = {}
    for flash in (True, False):
        kernels.reset_launch_counts()
        on_card, w_card = moe27_toy_run(CARD, state, batches, flash)
        launches = launch_counts()
        on_cpu, w_cpu = moe27_toy_run("cpu", state, batches, flash)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
        w_err = max((w_card[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
        path = "flash" if flash else "fused softmax"
        moved = max((w_cpu[k] - state[k]).abs().max().item() for k in w_cpu)
        log(f"  (b) toy {path}: losses card {on_card}, CPU {on_cpu}; loss rel "
            f"diff {loss_err:.3e} (tol {TOY_LOSS_TOL:.0e}), weights max diff "
            f"{w_err:.3e} (tol {MOE27_TOY_WEIGHT_TOL:.0e}), the largest update "
            f"on the CPU {moved:.3e}; launches {launches}")
        want_k3 = MOE27_TOY["num_layers"] * MOE27_TOY_STEPS if flash else 0
        if CARD == "cuda" and (launches.get("flash_qkv_fwd", 0) != want_k3
                               or launches.get("flash_qkv_bwd", 0) != want_k3
                               or not launches.get("layer_norm_fwd")):
            raise AssertionError(f"(b) {path}: not the scalar routes")
        if not (loss_err <= TOY_LOSS_TOL and w_err <= MOE27_TOY_WEIGHT_TOL
                and moved > 2 * MOE27_TOY_WEIGHT_TOL
                and on_cpu[-1] < on_cpu[0]):
            raise AssertionError(f"(b) {path}: card and CPU disagree")
        out[path] = dict(losses=on_card, loss_rel_diff=loss_err,
                         weight_max_diff=w_err, launches=launches)
    return out


def ep27_tokens(i: int, dtype) -> torch.Tensor:
    """Rank ``i``'s seeded tokens [2048, 2048] on the card."""
    gen = torch.Generator().manual_seed(2700 + i)
    return torch.randn(MOE27_EP_TOKENS, MOE27_EP["hidden_size"],
                       generator=gen).to(CARD, dtype)


def ep27_master() -> dict:
    """The one-rank SwitchMLP's weights (seeded, on the card)."""
    from apex_tpu_torch.transformer import moe as tmoe

    gen = torch.Generator(device=CARD).manual_seed(27)
    return tmoe.SwitchMLP(tmoe.MoEConfig(**MOE27_EP), device=CARD,
                          generator=gen).state_dict()


def ep27_module(master, group=None, rank=0, world=1):
    from apex_tpu_torch.transformer import moe as tmoe

    m = tmoe.SwitchMLP(tmoe.MoEConfig(**MOE27_EP), group=group, device=CARD)
    m.load_state_dict(tmoe.shard_master(master, rank, world))
    return m


def ep27_record(outs, hs, aux, mods, gate_mods) -> list:
    """Per rank: digests of its outputs, input gradients, expert
    gradients (its own experts) and gate gradient, and aux's bits."""
    recs = []
    for r, (out, h) in enumerate(zip(outs, hs)):
        ex = mods[r].experts
        recs.append(dict(out=digest(out), dh=digest(h.grad),
                         aux=float(aux.detach()), gate=digest(gate_mods[r].gate.weight
                                                     .grad),
                         experts={k: digest(getattr(ex, k).grad)
                                  for k in ("w1", "b1", "w2", "b2")}))
    return recs


def ep27_rank_leg(group, idx: int, dtype, master) -> dict:
    """SwitchMLP over the expert ``group`` on rank ``idx``'s tokens:
    forward and backward of sum(out^2) + 0.01 aux."""
    from apex_tpu_torch.parallel import comm

    g_rank, g_world = comm.group_rank(group), comm.group_size(group)
    m = ep27_module(master, group, g_rank, g_world)
    h = ep27_tokens(idx, dtype).requires_grad_()
    comm.STATS.reset()
    t0 = time.perf_counter()
    out, aux = m(h)
    (out.float().pow(2).sum() + 0.01 * aux).backward()
    if CARD == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = ep27_record([out], [h], aux, [m], [m])[0]
    rec["experts_owned"] = [g_rank * m.e_local, (g_rank + 1) * m.e_local]
    rec.update(wall_s=wall, comm=comm.STATS.as_dict())
    return rec


def ep27_replay(world: int, idxs, dtype, master) -> list:
    """Expert parallelism over ``world`` ranks replayed on one device, op
    for op: each rank's routing on a module of its own (its gate
    gradient apart), the statistics' fp64 mean, the slabs the all-to-all
    would carry, each owner's experts on every rank's tokens at the
    owner's shapes, and the combine; the loss the sum of every rank's.
    Per rank what :func:`ep27_rank_leg` records."""
    from apex_tpu_torch.transformer import moe as tmoe

    mods = [ep27_module(master) for _ in range(world)]
    E, el = MOE27_EP["num_experts"], MOE27_EP["num_experts"] // world
    H = MOE27_EP["hidden_size"]
    hs = [ep27_tokens(i, dtype).requires_grad_() for i in idxs]
    C = mods[0].capacity(hs[0].shape[0])
    routes = [m.route(h) for m, h in zip(mods, hs)]
    frac, mean_p = ((torch.stack([r[k] for r in routes]).double().sum(0)
                     / world).float() for k in (3, 4))
    aux = E * torch.sum(frac * mean_p)
    disp = torch.stack([m.dispatch(h, r[2])[0] for m, h, r in
                        zip(mods, hs, routes)]).view(world, world, el, C, H)
    ex = mods[0].experts
    backs = []
    for o in range(world):
        x = disp[:, o].transpose(0, 1).reshape(el, world * C, H)
        sl = slice(o * el, (o + 1) * el)
        y = tmoe.expert_ffn(x, ex.w1[sl], ex.b1[sl], ex.w2[sl], ex.b2[sl])
        backs.append(y.to(dtype).view(el, world, C, H).transpose(0, 1))
    back = torch.stack(backs, 1)
    outs = [m.combine(back[r].reshape(E, C, H), route[2], route[1])
            for r, (m, route) in enumerate(zip(mods, routes))]
    loss = sum(o.float().pow(2).sum() for o in outs) + world * (0.01 * aux)
    loss.backward()
    recs = ep27_record(outs, hs, aux, [mods[0]] * world, mods)
    for r, rec in enumerate(recs):   # each owner's slice of the experts
        sl = slice(r * el, (r + 1) * el)
        rec["experts"] = {k: digest(getattr(ex, k).grad[sl])
                          for k in ("w1", "b1", "w2", "b2")}
    return recs


def tpep27_case():
    """bench.py:1444-1502's composition at GPT-1.3B width (fp32): a dense
    block [2048 -> 4096 -> 2048] sharded column/row over tp, feeding the
    Switch MLP of :data:`MOE27_EP` on 2048 tokens every rank shares."""
    gen = torch.Generator().manual_seed(2701)
    H = MOE27_EP["hidden_size"]
    col = torch.randn(H, 2 * H, generator=gen) * 0.02
    row = torch.randn(2 * H, H, generator=gen) * 0.02
    h = torch.randn(MOE27_EP_TOKENS, H, generator=gen)
    return col.to(CARD), row.to(CARD), h.to(CARD)


def tpep27_run(master, tp_group=None, ep_group=None) -> dict:
    """The leg on this rank (tensor rank t, expert rank e), or on one
    device with both groups None (the dense block whole, all eight
    experts local): outputs, expert ids, the loss sum(out^2) + 0.01 aux,
    each leaf's gradient statistics (:func:`pp23_stats`) and the
    gradients of the leaves that are not experts."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer import tensor_parallel as tpl

    tp, t = comm.group_size(tp_group), comm.group_rank(tp_group)
    ep, e = comm.group_size(ep_group), comm.group_rank(ep_group)
    col, row, h = tpep27_case()
    H = h.shape[1]
    col = col.view(H, tp, -1)[:, t].contiguous().requires_grad_()
    row = row.view(tp, -1, H)[t].contiguous().requires_grad_()
    m = ep27_module(master, ep_group, e, ep)
    a = F.gelu(h @ col, approximate="tanh")
    y = tpl.reduce_from_tensor_model_parallel_region(a @ row, tp_group)
    out, aux = m(y)
    loss = out.pow(2).sum() + 0.01 * aux
    loss.backward()
    leaves = {"col_w": col, "row_w": row,
              **{f"moe.{k}": p for k, p in m.named_parameters()}}
    res = dict(out=out.detach(), loss=float(loss.detach()),
               expert=m.route(y.detach())[0],
               grads={k: p.grad for k, p in leaves.items()
                      if not k.startswith("moe.experts")})
    if tp_group is None:
        res["experts"] = {k: p.grad for k, p in leaves.items()
                          if k.startswith("moe.experts")}
    else:
        res["stats"] = pp23_stats((k, p.grad) for k, p in leaves.items()
                                  if k.startswith("moe.experts"))
    return res


def ring27_inputs(shape, sp, seed, dtype):
    """The whole sequence's q, k, v [bh, s_local x sp, d] (seeded)."""
    bh, n, d = shape
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(bh, n * sp, d, generator=gen).to(CARD, dtype)
            for _ in range(3)]


def ring27_full(q, k, v, causal):
    """Full attention on one device in fp32 from the same inputs, and
    the gradients of sum(o^2) (plain autograd), in the inputs' dtype."""
    q, k, v = (t.detach().float().requires_grad_() for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                     device=s.device).triu(1), float("-inf"))
    o = torch.softmax(s, -1) @ v
    o.pow(2).sum().backward()
    return [o.detach(), q.grad, k.grad, v.grad]


def ring27_rank(group, shape, seed, dtype) -> dict:
    """Ring attention on this rank's chunk, causal and not, forward and
    backward of sum(o^2), held here to full attention on the whole
    sequence (recomputed from the seed on this rank's device): each
    tensor's max |diff| and its bar."""
    from apex_tpu_torch.ops import ring_attention
    from apex_tpu_torch.parallel import comm

    sp, r = comm.group_size(group), comm.group_rank(group)
    n = shape[1]
    out = {}
    for causal in (False, True):
        whole = ring27_inputs(shape, sp, seed, dtype)
        q, k, v = (t[:, r * n:(r + 1) * n].clone().requires_grad_()
                   for t in whole)
        comm.STATS.reset()
        t0 = time.perf_counter()
        o = ring_attention(q, k, v, group, causal=causal)
        o.float().pow(2).sum().backward()
        if CARD == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref = [t[:, r * n:(r + 1) * n].to(dtype)
               for t in ring27_full(*whole, causal)]
        errs = [((a.float() - b.float()).abs().max().item(), tolerance(b))
                for a, b in zip((o, q.grad, k.grad, v.grad), ref)]
        out[causal] = dict(errs=errs, wall_s=wall, comm=comm.STATS.as_dict())
        del whole, ref
    return out


def phase27_rank(rank, world, init_file, out, job):
    """A rank of phase 27's launch (spawned, four ranks over gloo): ep 4
    over all, ep 2 over the pairs [0, 1] and [2, 3], in bf16 and fp32;
    tp 2 x ep 2 (tensor groups [0, 2] and [1, 3], expert groups [0, 1]
    and [2, 3]); ring attention at sp 4 and sp 2 (the pairs)."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multiproc.init_file_group("gloo", rank, world, init_file)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    cols = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    groups = {4: dist.group.WORLD, 2: pairs[rank // 2]}
    master = ep27_master()
    res = {}
    with parallel_state.uninitialized_scope():
        t0 = time.perf_counter()
        for ep, group in groups.items():
            for name, dtype in (("bf16", torch.bfloat16),
                                ("fp32", torch.float32)):
                res[("ep", ep, name)] = ep27_rank_leg(group, rank, dtype,
                                                      master)
                gc.collect()
        res["ep_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["tpep"] = tpep27_run(master, cols[rank % 2], pairs[rank // 2])
        res["tpep_s"] = time.perf_counter() - t0
        del master
        gc.collect()
        t0 = time.perf_counter()
        for sp, group in groups.items():
            res[("ring", "bench", sp)] = ring27_rank(
                group, RING27_BENCH, 2710 + rank // sp, torch.float32)
        res[("ring", "gpt", 2)] = ring27_rank(groups[2], RING27_GPT, 2712,
                                              torch.bfloat16)
        res["ring_s"] = time.perf_counter() - t0
    if CARD == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def ep27_check(runs) -> dict:
    """Each ep leg against its one-device replay, bitwise; aux the same
    bits on every rank of a group."""
    master = ep27_master()
    out = {}
    for ep in (4, 2):
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            for g0 in range(0, 4, ep):
                got = [runs[g0 + r][("ep", ep, name)] for r in range(ep)]
                want = ep27_replay(ep, range(g0, g0 + ep), dtype, master)
                gc.collect()
                for r, (a, b) in enumerate(zip(got, want)):
                    for key in ("out", "dh", "aux", "gate", "experts"):
                        if a[key] != b[key]:
                            raise AssertionError(
                                f"(c) ep {ep} {name}, group rank {r} of "
                                f"ranks {g0}-{g0 + ep - 1}: {key} is not "
                                "bitwise the one-device replay's")
                if len({a["aux"] for a in got}) != 1:
                    raise AssertionError(f"(c) ep {ep} {name}: aux differs "
                                         "across the ranks")
            a0 = runs[0][("ep", ep, name)]
            out[(ep, name)] = dict(aux=a0["aux"], wall_s=[
                runs[r][("ep", ep, name)]["wall_s"] for r in range(4)],
                comm=a0["comm"])
            log(f"  (c) ep {ep} {name} ({MOE27_EP}, {MOE27_EP_TOKENS} "
                f"tokens a rank): every rank's outputs, input "
                f"gradients, gate and expert gradients bitwise the "
                f"one-device replay, aux {a0['aux']!r} on every rank; rank "
                f"walls {[round(w, 3) for w in out[(ep, name)]['wall_s']]} s,"
                f" collectives {a0['comm']['by_op']}")
    return out


def tpep27_check(runs) -> list:
    """tp 2 x ep 2 held to ep 1 on one device (the same weights and
    tokens): the expert ids (those that differ, a reading), outputs and
    loss, and each rank's gradients: its slices of the dense block's and
    the gate's whole, its experts' by their statistics against ep x the
    one device's (both expert ranks of a tensor rank carry the same
    tokens, so every expert sees each token twice)."""
    master = ep27_master()
    ref = tpep27_run(master)
    del master
    H = MOE27_EP["hidden_size"]
    el = MOE27_EP["num_experts"] // 2
    gaps = []
    for rank, run in enumerate(runs):
        t, e = rank // 2, rank % 2
        got = run["tpep"]
        moved = int((got["expert"] != ref["expert"]).sum())
        want = {"col_w": ref["grads"]["col_w"].view(H, 2, -1)[:, t],
                "row_w": ref["grads"]["row_w"].view(2, -1, H)[t],
                "moe.gate.weight": ref["grads"]["moe.gate.weight"]}
        stats = pp23_stats((k, 2 * g[e * el:(e + 1) * el])
                           for k, g in ref["experts"].items())
        gap = dict(
            rerouted=moved,
            out=((got["out"] - ref["out"]).norm() / ref["out"].norm()).item(),
            loss=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            grads=max(((got["grads"][k] - v).norm() / v.norm()).item()
                      for k, v in want.items()),
            experts=pp23_grad_gap(got["stats"], stats))
        gaps.append(gap)
        log(f"  (c) tp 2 x ep 2, rank {rank} (t {t}, e {e}) against ep 1 on "
            f"one device: {moved} tokens routed elsewhere; relative gaps "
            f"out {gap['out']:.3e}, loss {gap['loss']:.3e} (tol "
            f"{MOE27_TPEP_OUT_TOL:.0e}); col_w, row_w, gate gradients "
            f"{gap['grads']:.3e}, experts' statistics {gap['experts']:.3e} "
            f"(tol {MOE27_TPEP_GRAD_TOL:.0e})")
        if max(gap["out"], gap["loss"]) > MOE27_TPEP_OUT_TOL or \
                max(gap["grads"], gap["experts"]) > MOE27_TPEP_GRAD_TOL:
            raise AssertionError(f"(c) tp 2 x ep 2 rank {rank}: not ep 1's")
    return gaps


def ring27_check(runs) -> dict:
    """Each ring leg's tensors within their bars on every rank."""
    out = {}
    for key, what in ((("ring", "bench", 4), "bench.py's shape, sp 4"),
                      (("ring", "bench", 2), "bench.py's shape, sp 2"),
                      (("ring", "gpt", 2), "a GPT-1.3B rank's [64, 1024, "
                                           "128] bf16, sp 2")):
        for causal in (False, True):
            worst, walls = 0.0, []
            for rank, run in enumerate(runs):
                leg = run[key][causal]
                walls.append(leg["wall_s"])
                for (err, tol), name in zip(leg["errs"],
                                            ("o", "dq", "dk", "dv")):
                    if not (math.isfinite(err) and err <= tol):
                        raise AssertionError(
                            f"(c) ring attention {what}, causal {causal}, "
                            f"rank {rank}: {name} {err:.3e} > {tol:.3e}")
                    worst = max(worst, err / tol if tol else 0.0)
            out[(key[1], key[2], causal)] = dict(worst_share_of_bar=worst,
                                                 wall_s=walls)
            c = runs[0][key][causal]["comm"]
            log(f"  (c) ring attention {what}, {'causal' if causal else 'not causal'}"
                f": o, dq, dk, dv on every rank within their bars against "
                f"full attention on one device (worst {worst:.1%} of its "
                f"bar); rank walls {[round(w, 3) for w in walls]} s, "
                f"{c['calls']} messages ({c['by_op']}) a rank")
    return out


def phase_moe_ring(smi: str) -> dict:
    """Phase 27 (see the module docstring)."""
    t_phase = time.perf_counter()

    def lap(what):
        log(f"  [{time.perf_counter() - t_phase:6.1f} s] {what}")

    record = {"train": moe27_train(smi)}
    lap("(a) done")
    log(f"  {GLOO_WHY}")
    tmp = tempfile.mkdtemp(prefix="moe27_")
    try:
        runs, record["toy"] = concurrently(
            lambda: tp22_spawn(4, {}, tmp, "(c) ep 4 and 2, tp 2 x ep 2, "
                               "ring attention at sp 4 and 2",
                               body=phase27_rank),
            moe27_toy)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lap("(b) and (c)'s ranks done (side by side)")
    record["ep"] = ep27_check(runs)
    torch.cuda.empty_cache()
    record["tp_ep"] = tpep27_check(runs)
    torch.cuda.empty_cache()
    record["ring"] = ring27_check(runs)
    record["ranks"] = [dict(ep_s=r["ep_s"], tpep_s=r["tpep_s"],
                            ring_s=r["ring_s"], peak_gib=r.get("peak_gib"))
                       for r in runs]
    lap("(c)'s checks done")
    record["wall_s"] = time.perf_counter() - t_phase
    log("  phase 27 " + json.dumps(
        {k: v for k, v in record.items() if k in ("toy", "ranks")},
        default=str))
    log(f"  phase 27 took {record['wall_s']:.1f} s")
    return record


# -- phase 28: batch norm across ranks, the spatial bottleneck, ImageNet dp ----

#: ResNet-50's first norm (bench.py's batch after the 7x7/s2 stem): [128,
#: 112, 112, 64] bf16 NHWC, 32 rows a rank over four
SYNC28_X = (128, 112, 112, 64)
#: the cotangent of the norms' checks: unit noise plus a per-channel offset
#: and a share of x, as a network's gradients carry (zero-mean noise alone
#: would leave the ranks' sum of dy near zero, and a dropped backward
#: all-reduce with it)
SYNC28_DY_OFFSET, SYNC28_DY_OF_X = 0.5, 0.25
#: bars, x max(1, max|one rank|): the bf16 tensors one bf16 ulp at the
#: output's scale (BF16_TOL; read 9.9e-4 and 4.1e-3 for y and dx), the fp32
#: ones about ten times the worst reading (the running statistics 9.2e-8
#: and 1.8e-7 with GroupBN's minibatch ones, the summed weight and bias
#: gradients 3.1e-7 and 4.6e-7) on an NVIDIA H100 80GB HBM3 at 700.00 W;
#: the backward all-reduce dropped read dx 0.48
SYNC28_TOL = dict(y=BF16_TOL, dx=BF16_TOL, stats=1e-6, dwdb=5e-6)
GROUPBN28_TOL = dict(y=BF16_TOL, dx=BF16_TOL, stats=2e-6, dwdb=5e-6)
#: the spatial blocks at ResNet-50's stage-1 activation [N, 56, 56, 256]:
#: layer1's block (256 -> 64 -> 256) and layer2.0 (256 -> 128 -> 512,
#: stride 2), bf16, the frozen-BN affines seeded
SPATIAL28_N, SPATIAL28_HW = 8, 56
SPATIAL28_BLOCKS = {"layer1 (s 1)": (256, 64, 256, 1),
                    "layer2.0 (s 2)": (256, 128, 512, 2)}
#: y and dx one bf16 ulp (read 3.0e-3 and 4.0e-3), the parameter gradients
#: summed over the ranks against the unsharded block's ten times the worst
#: reading (5.2e-3); the halo rows swapped read y 0.61, dx 0.86
SPATIAL28_TOL = dict(y=BF16_TOL, dx=BF16_TOL, grads=5e-2)
#: (c): the ImageNet example at phase 20's width, 4 steps on one global
#: batch of records (every step the same 128 images), then 2 eval steps
IMAGENET28_STEPS, IMAGENET28_BATCH = 4, 128
IMAGENET28_FLAGS = ["--arch", "resnet50", "--opt-level", "O2", "--optimizer",
                    "lamb", "-b", str(IMAGENET28_BATCH), "--image-size",
                    str(RESNET_IMG), "--lr",
                    "0.001", "--print-freq", "1", "--epochs", "1",
                    "--steps-per-epoch", str(IMAGENET28_STEPS),
                    "--eval-steps", "2"]
IMAGENET28_DP = ["--n-devices", "2", "--sync_bn", "--distributed-backend",
                 "gloo"]
#: 2 ranks against 1 at the same global batch: each printed loss (near
#: 7.0) absolutely, about ten times the reading (1.7e-4 against the 1-rank
#: reference's unrounded losses, 2.0e-4 against its printed ones); and
#: ||update at 2 ranks - update at 1|| / ||update at 1|| over every
#: parameter (the update: the parameters after the steps less the seeded
#: initial ones; read 0.122: LAMB's first steps divide by sqrt(v), so an
#: element whose gradient is near zero steps either way with its last
#: bits).  The gradient all-reduce dropped read 7.5e-2 and 1.06.
IMAGENET28_LOSS_TOL = 2e-3
IMAGENET28_UPDATE_TOL = 0.3
BENCH28_ROWS = 4                # bench.py's syncbn leg: (n_dev * 4, 8)
LOSS28_RE = re.compile(r"Loss (\S+) \(")


def gap28(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max(1, max |ref|), in fp32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def sync28_operands(dev):
    gen = torch.Generator(device=dev).manual_seed(28)
    x = (torch.randn(SYNC28_X, generator=gen, device=dev) * 2 + 0.5)
    dy = (torch.randn(SYNC28_X, generator=gen, device=dev)
          + SYNC28_DY_OFFSET * torch.rand(SYNC28_X[-1], generator=gen,
                                          device=dev) + SYNC28_DY_OF_X * x)
    c = SYNC28_X[-1]
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.randn(c, generator=gen, device=dev)
    return x.bfloat16(), dy.bfloat16(), w, b


def sync28_bn(x, dy, w, b, group, drop_backward=False) -> dict:
    """sync_batch_norm over ``group`` (training, running statistics from
    zeros and ones) and the gradients of sum(dy * y); ``drop_backward``
    plants a fault: the backward's all-reduce returns its input."""
    from apex_tpu_torch.parallel import comm, sync_batchnorm as sbn

    xs = x.clone().requires_grad_()
    ws, bs = w.clone().requires_grad_(), b.clone().requires_grad_()
    c = w.numel()
    y, rm, rv = sbn.sync_batch_norm(
        xs, ws, bs, torch.zeros(c, device=x.device),
        torch.ones(c, device=x.device), axis_name=group, training=True)
    with (mock.patch.object(comm, "all_reduce", lambda t, g, op="sum": t)
          if drop_backward else contextlib.nullcontext()):
        (y.float() * dy.float()).sum().backward()
    return dict(y=y.detach(), rm=rm, rv=rv, dx=xs.grad, dw=ws.grad,
                db=bs.grad)


def sync28_gaps(got: dict, ref: dict, rows, group) -> dict:
    """This rank's rows and statistics against one rank's whole batch;
    the weight and bias gradients summed over ``group`` against the
    whole batch's."""
    from apex_tpu_torch.parallel import comm

    return dict(
        y=gap28(got["y"], ref["y"][rows]), dx=gap28(got["dx"],
                                                    ref["dx"][rows]),
        stats=max(gap28(got["rm"], ref["rm"]), gap28(got["rv"], ref["rv"])),
        dwdb=max(gap28(comm.all_reduce(got[k], group), ref[k])
                 for k in ("dw", "db")))


def sync28_norms(rank: int, pair, dev) -> dict:
    """(a) on this rank: SyncBN over all four ("data") at the first norm's
    shape, with the backward all-reduce dropped as the planted fault;
    GroupBN at bn_group 2 within ``pair``; bench.py's syncbn leg."""
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import comm, sync_batch_norm

    out = {}
    x, dy, w, b = sync28_operands(dev)
    n = SYNC28_X[0] // 4
    rows = slice(rank * n, (rank + 1) * n)
    ref = sync28_bn(x, dy, w, b, None)
    data = parallel_state.get_data_parallel_group()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    comm.STATS.reset()
    t0 = time.perf_counter()
    got = sync28_bn(x[rows], dy[rows], w, b, "data")
    sync()
    out["syncbn_ms"] = (time.perf_counter() - t0) * 1e3
    out["syncbn_comm"] = comm.STATS.as_dict()
    out["syncbn"] = sync28_gaps(got, ref, rows, data)
    planted = sync28_bn(x[rows], dy[rows], w, b, "data", drop_backward=True)
    out["syncbn_dropped_backward"] = sync28_gaps(planted, ref, rows, data)
    del got, planted
    # GroupBN: each pair pools its 64 rows
    p, r = rank // 2, rank % 2
    prow = slice(p * 2 * n, (p + 1) * 2 * n)
    mine = slice(p * 2 * n + r * n, p * 2 * n + (r + 1) * n)

    def groupbn(xs, dys, **kw):
        bn = BatchNorm2d_NHWC(SYNC28_X[-1], device=dev, **kw)
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        xs = xs.clone().requires_grad_()
        y = bn(xs)
        (y.float() * dys.float()).sum().backward()
        return dict(y=y.detach(), dx=xs.grad, dw=bn.weight.grad,
                    db=bn.bias.grad, rm=bn.running_mean, rv=bn.running_var,
                    mm=bn.minibatch_mean, riv=bn.minibatch_riv)

    gref = groupbn(x[prow], dy[prow])
    ggot = groupbn(x[mine], dy[mine], bn_group=2, axis_name=pair)
    gap = sync28_gaps(ggot, gref, slice(r * n, (r + 1) * n), pair)
    gap["stats"] = max(gap["stats"], gap28(ggot["mm"], gref["mm"]),
                       gap28(ggot["riv"], gref["riv"]))
    out["groupbn"] = gap
    del x, dy, ref, gref, ggot
    # bench.py:1392-1413: (n_dev * 4, 8), normalised with the global stats
    xb = torch.randn((4 * BENCH28_ROWS, 8), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    yb, rmb, _ = sync_batch_norm(
        xb[rank * BENCH28_ROWS:(rank + 1) * BENCH28_ROWS], torch.ones(
            8, device=dev), torch.zeros(8, device=dev),
        torch.zeros(8, device=dev), torch.ones(8, device=dev),
        axis_name="data", training=True)
    means = comm.all_gather(rmb[None], data, dim=0)
    out["bench"] = dict(
        mean_y=float(comm.all_reduce(yb.sum(), data)) / yb.numel() / 4,
        means_gap=float((means[0] - means[-1]).abs().max()),
        shape=(4 * BENCH28_ROWS, 8))
    return out


def spatial28_leg(name: str, group, dev, swap: bool = False) -> dict:
    """(b): the block ``name`` with H over ``group``'s ranks against the
    unsharded block on this card (the same seeded weights and input): this
    rank's rows of the output and the input gradient, and each parameter
    gradient summed over the group; ``swap`` plants a fault (each rank
    sends its top rows down and its bottom rows up)."""
    from apex_tpu_torch.contrib.bottleneck import bottleneck as bneck
    from apex_tpu_torch.parallel import comm, resolve_group

    cin, mid, cout, s = SPATIAL28_BLOCKS[name]
    group = resolve_group(group)
    world, r = comm.group_size(group), comm.group_rank(group)
    kw = dict(stride=s, device=dev, dtype=torch.bfloat16, seed=28)
    full = bneck.Bottleneck(cin, mid, cout, **kw)
    shard = bneck.SpatialBottleneck(cin, mid, cout, axis_name=group, **kw)
    gen = torch.Generator(device=dev).manual_seed(282)
    with torch.no_grad():
        for n, p in full.named_parameters():
            if n.startswith(("scale", "bias")):
                v = (torch.rand(p.shape, generator=gen, device=dev) + 0.5
                     if n.startswith("scale") else
                     0.1 * torch.randn(p.shape, generator=gen, device=dev))
                p.copy_(v)
        shard.load_state_dict(full.state_dict())
    hw = SPATIAL28_HW
    x = torch.randn((SPATIAL28_N, hw, hw, cin), generator=gen,
                    device=dev).bfloat16()
    dy = torch.randn((SPATIAL28_N, hw // s, hw // s, cout), generator=gen,
                     device=dev).bfloat16()
    xf = x.clone().requires_grad_()
    yf = full(xf)
    (yf.float() * dy.float()).sum().backward()
    h, ho = hw // world, hw // world // s
    xs = x[:, r * h:(r + 1) * h].clone().requires_grad_()
    real = bneck._swap_edges

    def swapped(group, down, up):
        return real(group, up, down)

    comm.STATS.reset()
    with (mock.patch.object(bneck, "_swap_edges", swapped) if swap
          else contextlib.nullcontext()):
        ys = shard(xs)
        (ys.float() * dy[:, r * ho:(r + 1) * ho].float()).sum().backward()
    grads = max(gap28(comm.all_reduce(p.grad.float(), group),
                      dict(full.named_parameters())[n].grad)
                for n, p in shard.named_parameters())
    return dict(y=gap28(ys.detach(), yf.detach()[:, r * ho:(r + 1) * ho]),
                dx=gap28(xs.grad, xf.grad[:, r * h:(r + 1) * h]),
                grads=grads, comm=comm.STATS.as_dict())


def imagenet28_rank_runs(job: dict, dev) -> dict:
    """(c) in this rank (the process group joined): the example at
    --n-devices 2 --sync_bn, each run of ``job["runs"]`` in turn with
    cuDNN deterministic: "a" and "b" (a rerun is bitwise), "planted" with
    the gradient all-reduce dropped (rank 0 saves its checkpoint)."""
    import io

    from apex_tpu_torch.parallel import comm

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    # no eval: the launch as users start it evaluates
    for name in job["runs"]:
        planted = name == "planted"
        extra = ["--eval-steps", "0"] + (
            ["--save-dir", job["planted_dir"]] if planted else [])
        text = io.StringIO()
        comm.STATS.reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text), (
                mock.patch.object(imagenet_main, "mean_over_ranks",
                                  lambda grads, group: grads)
                if planted else contextlib.nullcontext()):
            st = imagenet_main.main(job["argv"] + extra, device=dev)
        wall = time.perf_counter() - t0
        out[name] = dict(
            out=text.getvalue(), wall_s=wall, comm=comm.STATS.as_dict(),
            peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if dev.type == "cuda" else 0.0),
            digests=tree_digests({"params": st.params,
                                  "model_state": st.model_state}))
        del st
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase28_rank(rank, world, init_file, out, job):
    """A rank of phase 28 (spawned, gloo on this card): ``job["kind"]``
    "norms" runs (a) and (b) over four ranks, "imagenet" (c)'s in-process
    runs over two."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import create_syncbn_process_group, multiproc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = multiproc.init_file_group("gloo", rank, world, init_file)
    if CARD != "cuda":
        dev = torch.device(CARD)
    res = {}
    if job["kind"] == "imagenet":
        res = imagenet28_rank_runs(job, dev)
    else:
        pair = create_syncbn_process_group(2, world)
        parallel_state.initialize_model_parallel(1)     # "data": all four
        try:
            t0 = time.perf_counter()
            res["norms"] = sync28_norms(rank, pair, dev)
            res["norms_s"] = time.perf_counter() - t0
            gc.collect()
            t0 = time.perf_counter()
            for name in SPATIAL28_BLOCKS:
                for sp, group in ((4, "data"), (2, pair)):
                    res[(name, sp)] = spatial28_leg(name, group, dev)
            res[("layer1 (s 1)", "swapped")] = spatial28_leg(
                "layer1 (s 1)", "data", dev, swap=True)
            res["spatial_s"] = time.perf_counter() - t0
        finally:
            parallel_state.destroy_model_parallel()
        if dev.type == "cuda":
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def bar28(what: str, gaps: dict, tol: dict, fault: dict = None) -> None:
    """Every gap within its bar on this rank; a planted fault's gaps must
    miss at least one bar."""
    for k, v in gaps.items():
        if k in tol and not (math.isfinite(v) and v <= tol[k]):
            raise AssertionError(f"{what}: {k} gap {v:.3e} > {tol[k]:.1e}")
    if fault is not None and all(fault[k] <= tol[k] for k in tol
                                 if k in fault):
        raise AssertionError(f"{what}: the planted fault {fault} missed no "
                             f"bar {tol}")


def check28_norms(runs: list) -> dict:
    worst = {}
    for rank, run in enumerate(runs):
        nr = run["norms"]
        bar28(f"(a) SyncBN rank {rank}", nr["syncbn"], SYNC28_TOL,
              nr["syncbn_dropped_backward"])
        bar28(f"(a) GroupBN bn_group 2 rank {rank}", nr["groupbn"],
              GROUPBN28_TOL)
        bench = nr["bench"]
        if not (abs(bench["mean_y"]) < 1e-5 and bench["means_gap"] <= 1e-6):
            raise AssertionError(f"(a) bench.py's syncbn leg: {bench}")
        for leg in ("syncbn", "syncbn_dropped_backward", "groupbn"):
            for k, v in nr[leg].items():
                worst.setdefault(leg, {})[k] = max(
                    worst.get(leg, {}).get(k, 0.0), v)
    r0 = runs[0]["norms"]
    log(f"  (a) SyncBN over 4 ranks at {list(SYNC28_X)} bf16 against one "
        f"rank's batch, worst over the ranks: {worst['syncbn']} (bars "
        f"{SYNC28_TOL}); the backward all-reduce dropped: "
        f"{worst['syncbn_dropped_backward']}; a rank's forward + backward "
        f"{r0['syncbn_ms']:.1f} ms, collectives {r0['syncbn_comm']}")
    log(f"  (a) GroupBN bn_group 2 within [0, 1] / [2, 3] against one rank's "
        f"{SYNC28_X[0] // 2} rows: {worst['groupbn']} (bars "
        f"{GROUPBN28_TOL})")
    log(f"  (a) bench.py's syncbn leg {r0['bench']['shape']}: |mean(y)| "
        f"{abs(r0['bench']['mean_y']):.2e} < 1e-5, the ranks' running means "
        f"within {r0['bench']['means_gap']:.1e}")
    return worst


def check28_spatial(runs: list) -> dict:
    worst = {}
    for name in SPATIAL28_BLOCKS:
        for sp in (4, 2):
            for rank, run in enumerate(runs):
                bar28(f"(b) {name} H over {sp}, rank {rank}",
                      run[(name, sp)], SPATIAL28_TOL)
            worst[(name, sp)] = {k: max(r[(name, sp)][k] for r in runs)
                                 for k in SPATIAL28_TOL}
            c = runs[1][(name, sp)]["comm"]
            hw = SPATIAL28_HW
            log(f"  (b) SpatialBottleneck {name} [{SPATIAL28_N}, {hw}, {hw}, "
                f"{SPATIAL28_BLOCKS[name][0]}] bf16, H over {sp} ranks, "
                f"against the unsharded block: {worst[(name, sp)]} (bars "
                f"{SPATIAL28_TOL}); rank 1's messages {c['by_op']}")
    fault = {k: max(r[("layer1 (s 1)", "swapped")][k] for r in runs)
             for k in SPATIAL28_TOL}
    log(f"  (b) the halo rows swapped (layer1, H over 4): {fault}")
    if all(fault[k] <= SPATIAL28_TOL[k] for k in SPATIAL28_TOL):
        raise AssertionError("(b) swapped halo rows missed every bar")
    worst["swapped"] = fault
    return worst


def imagenet28_one_rank(flags: list) -> dict:
    """(c)'s reference in this process: the example's trainer at world 1
    on the same flags and records, its losses, the initial fp32 parameters
    and their update over the steps."""
    args = imagenet_main.parse_args(flags)
    dev = torch.device(CARD)
    with parallel_state.uninitialized_scope():
        parallel_state.initialize_model_parallel(1)     # world 1: no group
        tr = imagenet_main.build(args, dev)
        batcher = imagenet_main.make_batcher(args, dev)
        init = {n: m.detach().float().cpu().clone()
                for n, m in zip(tr.names, tr.masters)}
        t0 = time.perf_counter()
        losses = []
        for i in range(args.steps_per_epoch):
            x, y = batcher(0, i, train=True)
            losses.append(float(tr.train_step(x, y)[0]))
        wall = time.perf_counter() - t0
        update = torch.cat([(m.detach().float().cpu() - init[n]).reshape(-1)
                            for n, m in zip(tr.names, tr.masters)])
        batcher.close()
    return dict(losses=losses, init=init, update=update, steps_s=wall)


def imagenet28_losses(text: str, what: str) -> list:
    losses = [float(v) for v in LOSS28_RE.findall(text)]
    if len(losses) != IMAGENET28_STEPS or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"(c) {what}: losses {losses}")
    return losses


def imagenet28_update(path: str, init: dict) -> torch.Tensor:
    """The saved parameters less the initial ones, flat, fp32."""
    tree = ckpt.restore_checkpoint(path)[0]
    return torch.cat([(tree["params"][k].float() - v).reshape(-1)
                      for k, v in init.items()])


def imagenet28_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    return float((a - b).norm() / b.norm())


def check28_imagenet(user, one, ranks, dirs) -> dict:
    """(c): the user-path launch's losses finite and falling and held to
    the 1-rank reference's; the parameters' update over the steps held to
    it; the in-process rerun bitwise; the planted fault past the bar."""
    dp = imagenet28_losses(user["stdout"], "2 ranks (multiproc)")
    ref = one["losses"]
    if not dp[-1] < dp[0] or not all(math.isfinite(v) for v in ref):
        raise AssertionError(f"(c) 2-rank losses {dp} are not falling, or "
                             f"1 rank's {ref} not finite")
    loss_gap = max(abs(a - b) for a, b in zip(dp, ref))
    param_gap = imagenet28_gap(imagenet28_update(dirs["dp"], one["init"]),
                               one["update"])
    planted_gap = imagenet28_gap(imagenet28_update(dirs["planted"],
                                                   one["init"]),
                                 one["update"])
    planted = imagenet28_losses(ranks[0]["planted"]["out"], "planted")
    a, b = ranks[0]["a"], ranks[0]["b"]
    la = imagenet28_losses(a["out"], "in-process a")
    lb = imagenet28_losses(b["out"], "in-process b")
    rerun = la == lb and all(r["a"]["digests"] == r["b"]["digests"]
                             for r in ranks)
    speeds = [float(v) for v in re.findall(r"Speed (\S+) img/s",
                                           user["stdout"])]
    steady_ms = [IMAGENET28_BATCH / v * 1e3 for v in speeds[1:]]
    # the share of run a's steps (their wall from rank 0's Speed lines:
    # one step a line) in collectives, each rank's host seconds
    steps_s = sum(IMAGENET28_BATCH / float(v) for v in re.findall(
        r"Speed (\S+) img/s", a["out"]))
    comm_share = [r["a"]["comm"]["seconds"] / steps_s for r in ranks]
    log(f"  (c) main_amp --n-devices 2 --sync_bn (multiproc, gloo): losses "
        f"{dp}; 1 rank at the same global batch {ref}; gap {loss_gap:.2e} "
        f"(bar {IMAGENET28_LOSS_TOL}); the parameters' update over "
        f"{IMAGENET28_STEPS} steps against 1 rank's: relative gap "
        f"{param_gap:.2e} (bar {IMAGENET28_UPDATE_TOL}); the gradient "
        f"all-reduce dropped: {planted_gap:.2e} (losses {planted})")
    log(f"  (c) in-process reruns (cuDNN deterministic): {la} and {lb}, "
        f"every rank's parameters and BN statistics bitwise equal: {rerun}; "
        f"step ms (multiproc run, after the first) "
        + ", ".join(f"{v:.1f}" for v in steady_ms)
        + f"; collectives {[round(100 * s, 1) for s in comm_share]} % of "
        f"run a's {IMAGENET28_STEPS} steps, each rank's (calls "
        f"{a['comm']['calls']}, "
        f"{a['comm']['bytes'] / 2 ** 20:.1f} MiB); peak "
        f"{[round(r['a']['peak_gib'], 2) for r in ranks]} GiB a rank; "
        f"walls: multiproc {user['wall_s']:.1f} s, the 1-rank reference's "
        f"{IMAGENET28_STEPS} steps {one['steps_s']:.1f} s")
    if loss_gap > IMAGENET28_LOSS_TOL or param_gap > IMAGENET28_UPDATE_TOL:
        raise AssertionError("(c) 2 ranks stray from 1 rank past the bars")
    if planted_gap <= IMAGENET28_UPDATE_TOL:
        raise AssertionError("(c) the dropped gradient all-reduce missed "
                             "the bar")
    if not rerun:
        raise AssertionError("(c) a rerun from the same weights differs")
    return dict(losses=dp, one_rank=ref, loss_gap=loss_gap,
                param_gap=param_gap, planted_gap=planted_gap,
                step_ms=steady_ms, comm_share=comm_share,
                peak_gib=[r["a"]["peak_gib"] for r in ranks],
                wall_s=dict(multiproc=user["wall_s"], one=one["steps_s"]))


def phase_syncbn_spatial_dp(smi: str) -> dict:
    """Phase 28 (see the module docstring)."""
    t_phase = time.perf_counter()

    def lap(what):
        log(f"  [{time.perf_counter() - t_phase:6.1f} s] {what}")

    log(f"  {GLOO_WHY}")
    tmp = tempfile.mkdtemp(prefix="phase28_")
    started = []
    try:
        data = os.path.join(tmp, "records")
        os.makedirs(data)
        rng = np.random.default_rng(28)
        n = IMAGENET28_BATCH
        imgs = rng.integers(0, 256, (n, RESNET_IMG * RESNET_IMG * 3),
                            dtype=np.uint8)
        labels = rng.integers(0, 1000, (n,)).astype(np.int32)
        write_records(os.path.join(data, "train0.rec"), np.concatenate(
            [imgs, labels.view(np.uint8).reshape(n, 4)], axis=1))
        dirs = {k: os.path.join(tmp, k) for k in ("dp", "planted")}
        flags = IMAGENET28_FLAGS + ["--data", data]
        # every launch side by side: the example as users start it (a
        # subprocess), the ranks of (a)/(b), (c)'s in-process ranks and
        # its 1-rank reference (in this process)
        started.append(imagenet_start(
            flags + IMAGENET28_DP + ["--save-dir", dirs["dp"]],
            launcher=["apex_tpu_torch.parallel.multiproc", "--nproc", "2",
                      "-m"], threads=1))
        norms, ranks, one = concurrently(
            lambda: tp22_spawn(4, dict(kind="norms"), tmp,
                               "(a) and (b)", body=phase28_rank),
            lambda: tp22_spawn(2, dict(kind="imagenet",
                                       runs=("a", "b", "planted"),
                                       argv=flags + IMAGENET28_DP,
                                       planted_dir=dirs["planted"]), tmp,
                               "(c) in-process reruns and the planted fault",
                               body=phase28_rank),
            lambda: imagenet28_one_rank(flags))
        lap("(a), (b), (c)'s in-process ranks and its 1-rank reference done")
        record = {"norms": check28_norms(norms),
                  "spatial": check28_spatial(norms)}
        user = imagenet_finish(started[0], "--n-devices 2 --sync_bn "
                                           "(multiproc)")
        lap("(c)'s multiproc launch done")
        record["imagenet"] = check28_imagenet(user, one, ranks, dirs)
        record["ranks"] = [dict(norms_s=r["norms_s"],
                                spatial_s=r["spatial_s"],
                                peak_gib=r.get("peak_gib")) for r in norms]
    finally:
        for proc, *_ in started:
            imagenet_kill(proc)
        shutil.rmtree(tmp, ignore_errors=True)
    record["wall_s"] = time.perf_counter() - t_phase
    log("  phase 28 " + json.dumps({"ranks": record["ranks"], "smi": smi},
                                   default=str))
    log(f"  phase 28 took {record['wall_s']:.1f} s")
    return record


PHASE = {"n": 0, "name": "start", "t": None, "t0": None}


def phase_lap() -> None:
    """The phase that ends now: its seconds and the script's so far, on
    standard output and standard error (where a run cut at its time limit
    still shows how far it got)."""
    now = time.perf_counter()
    if PHASE["t"] is not None:
        line = (f"  [phase {PHASE['n']} took {now - PHASE['t']:.1f} s; "
                f"script at {now - PHASE['t0']:.1f} s]")
        log(line)
        print(line.strip(), file=sys.stderr, flush=True)
    PHASE["t"] = now
    if PHASE["t0"] is None:
        PHASE["t0"] = now


def begin(n: int, name: str, detail: str = "") -> None:
    phase_lap()
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
          f"(GPT-1.3B width, {SERVE_CUT_LAYERS} layers, bf16; the fp32 toy)")
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

    begin(18, f"GPT-1.3B training ({RESUME_LAYERS} layers): checkpoint, "
          "preempt, resume (--data-dir "
          "shards, an async save at 2, a SIGTERM after 3, resumed to 6 from "
          "3 and, past a corrupt step 3, from 2)")
    t18 = time.perf_counter()
    resume = phase_resume(smi)
    log(f"  phase 18 took {time.perf_counter() - t18:.1f} s")
    torch.cuda.empty_cache()

    begin(19, "the rest of one-card GPT training: GPT-1.3B on the "
          "fused-softmax path (remat full, bf16), pretrain_gpt at phase 7's "
          "flags under remat dots, attn_res_mlp and attn_out (with "
          "--profile-every), the apex ops at full width")
    rest = phase_rest_of_training(smi, train)
    torch.cuda.empty_cache()

    begin(20, "ResNet-50 ImageNet training under amp: bench.py's step (O2, "
          "FusedLAMB, batch 128 x 224^2 bf16), the ImageNet example (save, "
          "resume, train*.rec records), FP16_Optimizer, ASP, resnet_tiny "
          "card vs CPU")
    phase_resnet(smi)
    torch.cuda.empty_cache()

    begin(21, "the other one-card families: DCGAN (O1, O2), the mLSTM at "
          "hidden 4096 and a 2-layer LSTM, RNN-T at joint 512 x vocabulary "
          "1024, weight norm")
    phase_families(smi)
    torch.cuda.empty_cache()

    begin(22, "tensor- and data-parallel GPT training on torch.distributed "
          f"(GPT-1.3B width, {TP22_LAYERS} layers, bf16, no remat: tp "
          "2, tp 2 x dp 2, a tp 2 save and resume; the fp32 toy tp 2 vs tp "
          "1; NCCL at world 1), the ranks sharing this card over gloo")
    tpdp = phase_tp_dp(smi)
    torch.cuda.empty_cache()

    begin(23, "pipeline-parallel GPT training on torch.distributed "
          "(GPT-1.3B width, bf16, remat attn_res, micro-batch 1 x 4: 1F1B at "
          f"pp 2 with {PP23_LAYERS} layers against tp 1 / pp 1, interleaved "
          "at pp 4 x vpp "
          f"2, bench.py's amp leg at tp 2 x pp 2 with {PP23_AMP_LAYERS} "
          "layers in fp16 and a "
          "planted overflow), the stages sharing this card over gloo")
    pipe = phase_pipeline(smi)
    torch.cuda.empty_cache()

    begin(24, "ZeRO: the GPT-1.3B flagship train step (bench.py's headline: "
          "DistributedFusedAdam, bf16_fit, batch 4 x 2048) at world 1, the "
          "fp32 toy card vs CPU, dp 2 and (dp, tp, pp) = (2, 2, 1) bucketed "
          f"and serialized ({ZERO24_RANK_LAYERS} layers), a format-4 save "
          "restored onto (2, 1, 1) and world 1 past a corrupt shard, elastic "
          f"recovery from the loss of a rank ({ZERO24_SAVE_LAYERS} layers), "
          "the ranks sharing this card over gloo")
    zero = phase_zero(smi)
    torch.cuda.empty_cache()

    begin(25, f"the serving fleet (GPT-1.3B width, {SERVE_CUT_LAYERS} "
          "layers, bf16; replicas "
          "sharing this card and one parameter tree): 3 mixed replicas "
          "through a rolling restart, KillReplica / BlackholeReplica / "
          "SlowReplica, DisaggRouter with 2 prefill and 2 decode replicas "
          "on the bf16 and int8 pools over LocalTransport and "
          "ChaosTransport; the fp32 toy card vs CPU")
    fleet = phase_fleet(smi)
    torch.cuda.empty_cache()

    begin(26, "tensor-parallel serving on torch.distributed (GPT-1.3B width, "
          "24 layers: bf16 and int8 at tp 2; the fp32 legs at tp 2 and 4, "
          "speculation and chunking at tp 2; a device loss on one rank, a "
          "restore into poisoned pools and a page shipped from tp 2 to tp 1 "
          "on int8; K1 and K5 at a rank's 8, 4, 2 and 1 heads), the ranks "
          "sharing this card over gloo")
    tps = phase_tp_serving(smi, timings, serving)
    torch.cuda.empty_cache()

    begin(27, "Mixture-of-Experts GPT and ring attention (GPT-1.3B width "
          f"with 8 Switch experts a layer, {MOE27_LAYERS} layers, bf16, "
          "remat attn_res; the fp32 toy card vs CPU; ep 4 and 2, tp 2 x ep "
          "2 and ring attention at sp 4 and 2, the ranks sharing this card "
          "over gloo)")
    moe = phase_moe_ring(smi)
    torch.cuda.empty_cache()

    begin(28, "batch norm across ranks, the spatial bottleneck's halo "
          "exchange and the ImageNet example's data parallelism (SyncBN at "
          "ResNet-50's first norm over 4 ranks, GroupBN bn_group 2, "
          "bench.py's syncbn leg; SpatialBottleneck at ResNet-50's stage-1 "
          "blocks with H over 4 and 2 ranks; main_amp --n-devices 2 "
          "--sync_bn at phase 20's width against 1 rank), the ranks sharing "
          "this card over gloo")
    phase_syncbn_spatial_dp(smi)
    torch.cuda.empty_cache()
    phase_lap()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    PHASE.update(n=29, name="record")
    moe_toy = {k: sum(r["launches"].get(k, 0) for r in moe["toy"].values())
               for k in ("flash_qkv_fwd", "flash_qkv_bwd", "layer_norm_fwd",
                         "layer_norm_bwd")}
    policies = rest["policies"]

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
             # phase 25: every replica of (a)-(c), and each replica of (c)
             # over LocalTransport (K1 on the prefill replicas alone)
             launches_fleet=fleet["launches"]["flash_fwd_sm90"],
             launches_fleet_disaggregated=fleet["launches_disaggregated"][
                 "default"],
             **timings["flash_fwd_sm90"]),
        dict(name="flash_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd.cu",
             replaces="apex_tpu/ops/attention.py:738",
             launches=toy_mha["launches"]["flash_fwd"],
             launches_toy_engine=toy["launches"]["flash_fwd"],
             launches_fleet_toy=fleet["toy"]["launches"]["flash_fwd"],
             # phase 26 (c): each rank of the fp32 engine at tp 2 and tp 4
             launches_ranks_tp2=[r["launches"]["flash_fwd"]
                                 for r in tps["c_tp2"]],
             launches_ranks_tp4=[r["launches"]["flash_fwd"]
                                 for r in tps["c_tp4"]],
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
             # phase 25: every replica of (a)-(c) on this pool
             **({"launches_fleet": fleet["launches"][name]}
                if name in fleet["launches"] else {}),
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
             launches_fleet_toy=fleet["toy"]["launches"]["flash_decode"],
             launches_ranks_tp2=[r["launches"]["flash_decode"]
                                 for r in tps["c_tp2"]],
             launches_ranks_tp4=[r["launches"]["flash_decode"]
                                 for r in tps["c_tp4"]],
             **timings["flash_decode"]),
    ] + [
        # K1 and K5 at a rank's head slice (phase 26): [1, 8, 1024, 128]
        # and [8, 8, 1, 128]; launches: rank 0's over (a) (bf16) and (b)
        # (int8), each rank's beside; the rows' numbers are (e)'s
        dict(name=f"{name}_tp2", route="cuda",
             source=f"apex_tpu_torch/csrc/{src}", replaces=where,
             launches=runs[0]["launches"][name],
             launches_ranks_tp2=[r["launches"][name] for r in runs],
             **tps["rows"][f"{name}_tp2"])
        for name, src, where, runs in (
            ("flash_fwd_sm90", "flash_fwd_sm90.cu",
             "apex_tpu/ops/attention.py:738", tps["a"]),
            ("flash_decode_sm90", "flash_decode_sm90.cu",
             "apex_tpu/ops/attention.py:2239", tps["a"]),
            ("flash_decode_sm90_int8", "flash_decode_sm90.cu",
             "apex_tpu/ops/attention.py:2239", tps["b"]))
    ] + [
        # K3/K4: the bf16 route on the tensor cores runs the GPT-1.3B step
        # (phase 7, and phase 18's runs); the scalar kernels are the fp32
        # route (phase 6's toy step) and are timed on bf16 as the kernels
        # they replaced there
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=runs["launches"][name],
             **(dict(launches_zero_toy=zero["toy"]["launches"][name],
                     # phase 27 (b): the fp32 MoE toy, both paths
                     launches_moe_toy=moe_toy[name])
                if runs is toy_train else dict(
                 launches_resume=resume["launches"][name],
                 # phase 27 (a): the MoE GPT step's (its timed steps)
                 launches_moe=moe["train"]["launches"][name],
                 # phase 19: pretrain_gpt under each remat policy
                 launches_policies={p: r["launches"][name]
                                    for p, r in policies.items()},
                 # phase 24: the ZeRO flagship step's (world 1, its timed
                 # steps) and each dp 2 rank's a step
                 launches_zero_flagship=zero["flagship"]["launches"][name],
                 launches_zero_per_step_ranks_dp2=[
                     r[name] for r in zero["ranks"]["dp2"][
                         "launches_per_step"]])),
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
        # K3/K4 at a rank's shape at tp 2 ([4, 2048, 8 x 3 x 128]): the
        # main path of phase 22, each rank's exact launches of (b) and (c)
        dict(name=f"{name}_tp2", route="cuda",
             source=f"apex_tpu_torch/csrc/{name}.cu", replaces=where,
             launches=tpdp["launches"][name],
             launches_ranks_tp2=[r[name] for r in tpdp["ranks_tp2"]],
             launches_ranks_tp2_dp2=[r[name] for r in tpdp["ranks_tp2_dp2"]],
             # phase 24: each (2, 2, 1) rank's a step, bucketed
             launches_zero_per_step_ranks_221=[
                 r[name] for r in zero["ranks"]["bucketed"][
                     "launches_per_step"]],
             **tpdp["rows"][f"{name}_tp2"])
        for name, where in (("flash_qkv_fwd_sm90",
                             "apex_tpu/ops/attention.py:1766"),
                            ("flash_qkv_bwd_sm90",
                             "apex_tpu/ops/attention.py:1800"))
    ] + [
        # K3/K4 at a pipeline stage's shapes (phase 23): bf16 [1, 2048, 16 x
        # 3 x 128] on the ranks of 1F1B at pp 2 and of pp 4 x vpp 2, fp16
        # [1, 2048, 8 x 3 x 128] on the ranks of the amp leg at tp 2 x pp 2;
        # launches: rank 0's over its run, every rank's a step beside
        dict(name=f"{name}_{tag}", route="cuda",
             source=f"apex_tpu_torch/csrc/{name.replace('_f16', '')}.cu",
             replaces=where,
             launches=pipe["launches"][runs][0][entry] * pipe["steps"][runs],
             **{f"launches_per_step_ranks_{r}": [
                 lp[entry] for lp in pipe["launches"][r]] for r in (
                 ("pp2", "pp4_vpp2") if tag == "pp" else ("tp2_pp2",))},
             **pipe["rows"][f"{name}_{tag}"])
        for name, entry, where, tag, runs in (
            ("flash_qkv_fwd_sm90", "flash_qkv_fwd_sm90",
             "apex_tpu/ops/attention.py:1766", "pp", "pp2"),
            ("flash_qkv_bwd_sm90", "flash_qkv_bwd_sm90",
             "apex_tpu/ops/attention.py:1800", "pp", "pp2"),
            ("flash_qkv_fwd_sm90_f16", "flash_qkv_fwd_sm90_f16",
             "apex_tpu/ops/attention.py:1766", "tp2pp2", "tp2_pp2"),
            ("flash_qkv_bwd_sm90_f16", "flash_qkv_bwd_sm90_f16",
             "apex_tpu/ops/attention.py:1800", "tp2pp2", "tp2_pp2"))
    ] + [
        # K6/K7: layer_norm_sm90.cu is the route at 1024, 2048 and 4096
        # columns: the GPT-1.3B steps (phases 7, 11 and 18), the multi-head
        # attention step (phase 9) and the LayerNorm microbench (phase 12);
        # layer_norm.cu takes every other width (the toys' 256 and 32,
        # phases 6, 8 and 10) and is timed at 2048 as the kernel it replaced
        dict(name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
             replaces=where, launches=runs["launches"][name],
             **(dict(launches_softmax_toy=rest["softmax_gpt"]["toy_mask"][
                 "launches"][name],
                 launches_zero_toy=zero["toy"]["launches"][name],
                 launches_moe_toy=moe_toy[name])
                if runs is toy_train else dict(
                 launches_moe=moe["train"]["launches"][name],
                 launches_mha=mha["launches"][name],
                 launches_flat=flat["launches"][name],
                 launches_microbench=probes["launches"][name],
                 launches_bert=bert["padded"]["launches"][name],
                 launches_resume=resume["launches"][name],
                 # phase 19: the fused-softmax GPT-1.3B steps and
                 # pretrain_gpt under each remat policy
                 launches_softmax_gpt=rest["softmax_gpt"]["launches"][name],
                 launches_policies={p: r["launches"][name]
                                    for p, r in policies.items()},
                 # phase 22: each rank of the tp 2 and tp 2 x dp 2 runs
                 launches_ranks_tp2=[r[name] for r in tpdp["ranks_tp2"]],
                 launches_ranks_tp2_dp2=[
                     r[name] for r in tpdp["ranks_tp2_dp2"]],
                 # phase 23: each rank's a step, 1F1B at pp 2 and pp 4 x
                 # vpp 2
                 launches_per_step_ranks_pp2=[
                     lp[name] for lp in pipe["launches"]["pp2"]],
                 launches_per_step_ranks_pp4_vpp2=[
                     lp[name] for lp in pipe["launches"]["pp4_vpp2"]],
                 # phase 24: the ZeRO flagship step's, and each rank's a
                 # step at dp 2 and at (2, 2, 1)
                 launches_zero_flagship=zero["flagship"]["launches"][name],
                 launches_zero_per_step_ranks_dp2=[
                     r[name] for r in zero["ranks"]["dp2"][
                         "launches_per_step"]],
                 launches_zero_per_step_ranks_221=[
                     r[name] for r in zero["ranks"]["bucketed"][
                         "launches_per_step"]])),
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
