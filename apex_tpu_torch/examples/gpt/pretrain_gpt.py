"""Megatron-style GPT pretraining, tensor- and data-parallel.

PyTorch port of the JAX package's ``examples/gpt/pretrain_gpt.py``: the
same Megatron flags
(:mod:`apex_tpu_torch.transformer.testing.arguments`), the same model
(:class:`~apex_tpu_torch.transformer.testing.GPTModel`, built on the
card), ``FusedAdam``, global-norm clipping::

    # GPT-1.3B on one H100
    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --num-layers 24 \\
        --hidden-size 2048 --num-attention-heads 16 --seq-length 2048 \\
        --max-position-embeddings 2048 --micro-batch-size 4 --bf16 \\
        --train-iters 20 --log-interval 5 --data-dir shards/ \\
        --save ckpt/ --save-interval 10 --load ckpt/

    # tp 2 x dp 2: four ranks, one process each
    python -m apex_tpu_torch.parallel.multiproc --nproc 4 \
        -m apex_tpu_torch.examples.gpt.pretrain_gpt \
        --tensor-model-parallel-size 2 --distributed-backend nccl ...

Each rank is a process (``torchrun`` or :mod:`apex_tpu_torch.parallel.
multiproc` sets ``RANK``/``WORLD_SIZE``; a caller may also join the
process group itself before :func:`main`).  The world is the process
group's, dp = world / tp, and the global batch is micro x dp, as the JAX
example derives it: every rank draws (or reads) the whole global batch
and keeps its dp rows, so the sample stream and the iterator position
are the JAX example's.  The gradients are averaged over dp with
:func:`~apex_tpu_torch.parallel.all_reduce_grads`, the reported loss is
the dp mean, and the clip's norm is the norm of the whole model's
gradient (each tensor-parallel shard once, each replicated parameter
once), so tp ranks train as tp = 1 does.  ``--distributed-backend``
names the transport and is never switched: ranks that share a card need
``gloo`` (NCCL refuses them, and the launch says so).

Each step: forward, backward, ``clip_grad_norm``, optimizer step; every
``--log-interval`` steps it prints ``iter i/n loss x ms/iter tok/s``.
``main`` returns the final loss.

Data is synthetic tokens by default; ``--data-dir`` (``*.bin`` shards of
checksummed uint32 records of seq + 1 ids,
:func:`apex_tpu_torch.data.write_checksummed_records`) or ``--data-path``
(explicit shard files of raw records, no CRC) stream real tokens through
the checkpointable :class:`~apex_tpu_torch.data.ShardedRecordIterator`
behind the :class:`~apex_tpu_torch.data.AsyncPrefetcher`, which copies
each batch to the card on its thread.  ``--save``/``--save-interval``
write checkpoints (asynchronous every interval, blocking on preemption
and at the end) with the iterator's position in the same manifest;
``--load`` resumes from the newest intact one
(:func:`~apex_tpu_torch.resilience.restore_resilient`).  The checkpoint
is the JAX example's tree, ``(params, AdamState(step, exp_avg,
exp_avg_sq))`` with the layers stacked and a leading tensor-parallel axis
of tp, in the JAX package's format: a run started by either example
resumes in the other at the same step and data position.  At tp above 1
the tp ranks of data-parallel rank 0 gather their shards to global rank
0, which writes; on restore each rank reads the tree and keeps its own
index.  Telemetry and the log lines come from global rank 0.
``--telemetry-dir`` writes the event stream (``run_start``, ``step``
events through the goodput accountant, ``ckpt_save``, ``ckpt_restore``,
``run_end``) and a postmortem on every abnormal exit;
``--watchdog-timeout`` arms a deadline around each step that escalates to
the grace-period save-and-exit path SIGTERM takes.  ``--profile-every N``
(with ``--telemetry-dir``) captures a ``torch.profiler`` window after
every N steps (:class:`~apex_tpu_torch.telemetry.ProfileSampler`) and
writes its ``profile`` (device ms by phase) and ``memory`` events into the
same stream.  ``--remat-policy`` takes the JAX example's five policies
(remat is on from 12 layers).

``--pipeline-model-parallel-size`` above 1 raises
``NotImplementedError``: the JAX example runs no pipeline (it builds its
mesh at pipeline size 1 whatever the flag), so neither does this one;
pipelined training is :mod:`apex_tpu_torch.transformer.pipeline_parallel`'s
schedules over ``make_gpt_stage_fns``.
"""

from __future__ import annotations

import glob
import math
import os
import sys
import time
from typing import (Callable, Iterable, Iterator, Mapping, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch import resilience
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.multi_tensor import clip_grad_norm, multi_tensor_l2norm
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import all_reduce_grads, comm
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.random import fold_in
from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel
from apex_tpu_torch.transformer.testing.arguments import parse_args
from apex_tpu_torch.transformer.testing.convert import _flatten, nest

Batch = Tuple[torch.Tensor, torch.Tensor]
_LAYERS = "transformer.layers."


class AdamState(NamedTuple):
    """The JAX package's ``FusedAdam`` state, as the checkpoint holds it:
    the step count (int32) and the moments, trees shaped as the params."""

    step: object
    exp_avg: object
    exp_avg_sq: object


def _extra_args(parser):
    # --data-path / --save / --save-interval / --load come from the
    # Megatron argument clone (arguments.py); only add what it lacks
    g = parser.add_argument_group("pretrain_gpt")
    g.add_argument("--remat-policy", default="attn_res",
                   choices=["full", "dots", "attn_res", "attn_res_mlp",
                            "attn_out"])
    g.add_argument("--data-dir", default=None,
                   help="directory of *.bin token shards (checksummed "
                        "uint32 records of seq+1 ids, "
                        "apex_tpu_torch.data.write_checksummed_records) fed "
                        "through the checkpointable sharded iterator + "
                        "async prefetcher; default: synthetic tokens")
    g.add_argument("--vocab-size", type=int, default=51200,
                   help="unpadded vocab; padded to "
                        "--make-vocab-size-divisible-by x tp")
    g.add_argument("--watchdog-timeout", type=float, default=0.0,
                   help="seconds a train step may run before the watchdog "
                        "logs a straggler diagnostic and escalates to the "
                        "grace-period save-and-exit path; 0 disables")
    g.add_argument("--telemetry-dir", default=None,
                   help="write a structured telemetry JSONL stream (step "
                        "events with loss/throughput, ckpt_save, "
                        "ckpt_restore, watchdog) under this directory, "
                        "plus a postmortem_*.jsonl flight-recorder dump on "
                        "preemption/escalation/crash")
    g.add_argument("--profile-every", type=int, default=0,
                   help="with --telemetry-dir: every N steps capture a "
                        "short in-run profiler window and emit "
                        "profile/memory attribution events (per-phase "
                        "device ms, exposed-collective ms, live/peak "
                        "device memory) into the stream; overhead is "
                        "booked to the `profile` goodput bucket and "
                        "bounded to 1%; 0 disables")
    return parser


def _refuse_unported(args) -> None:
    if args.pipeline_model_parallel_size != 1:
        raise NotImplementedError(
            f"--pipeline-model-parallel-size "
            f"{args.pipeline_model_parallel_size}: the JAX example this "
            "script ports runs no pipeline (its mesh has pipeline size 1), "
            "so neither does this script; train a pipeline with the "
            "schedules of apex_tpu_torch.transformer.pipeline_parallel and "
            "make_gpt_stage_fns")


def build_config(args) -> GPTConfig:
    """The JAX example's config: vocab padded to the divisibility flag,
    positions default to the sequence length, flash attention on, remat
    from 12 layers."""
    mult = args.make_vocab_size_divisible_by * args.tensor_model_parallel_size
    args.padded_vocab_size = ((args.vocab_size + mult - 1) // mult) * mult
    if args.max_position_embeddings is None:
        args.max_position_embeddings = args.seq_length
    return GPTConfig(
        num_layers=args.num_layers,
        hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        vocab_size=args.padded_vocab_size,
        max_position_embeddings=args.max_position_embeddings,
        layernorm_epsilon=args.layernorm_epsilon,
        init_method_std=args.init_method_std,
        tp_size=args.tensor_model_parallel_size,
        bf16=args.bf16,
        fp16=args.fp16,
        attention_dropout=args.attention_dropout,
        hidden_dropout=args.hidden_dropout,
        use_flash_attention=True,
        remat=args.num_layers >= 12,
        remat_policy=args.remat_policy,
    )


def synthetic_batches(args, generator: torch.Generator) -> Iterator[Batch]:
    """(tokens, labels) int64 [global_batch, seq] forever, drawn on the
    generator's device (the reference test loop's synthetic data); every
    rank draws the whole global batch."""
    b, s = args.global_batch_size, args.seq_length
    while True:
        ids = torch.randint(0, args.padded_vocab_size, (b, s + 1),
                            generator=generator, device=generator.device)
        yield ids[:, :-1], ids[:, 1:]


def build_data_iter(args, device, telemetry=None):
    """The real-token path: ``--data-dir`` / ``--data-path`` shards
    through :class:`~apex_tpu_torch.data.ShardedRecordIterator`
    (checkpointable, quarantining, retry/re-assign on shard faults)
    behind :class:`~apex_tpu_torch.data.AsyncPrefetcher` (the copy to
    ``device`` on the loader thread, ``data_stall`` telemetry).  The
    records and their order are the JAX example's for the same flags."""
    from apex_tpu_torch.data import (AsyncPrefetcher, ShardedRecordIterator,
                                     to_device)
    from apex_tpu_torch.data.records import RECORD_CRC_BYTES

    if args.data_dir:
        paths = sorted(glob.glob(os.path.join(args.data_dir, "*.bin")))
        if not paths:
            raise SystemExit(f"--data-dir {args.data_dir}: no *.bin shards")
        checksummed = True
    else:
        # --data-path keeps its documented legacy format: RAW uint32
        # records of seq+1 ids, no CRC trailer
        paths = list(args.data_path)
        checksummed = False
    b, s = args.global_batch_size, args.seq_length
    vocab = args.padded_vocab_size

    def decode(mat):
        ids = np.ascontiguousarray(mat).view(np.uint32).reshape(
            b, s + 1).astype(np.int64) % vocab
        return ids[:, :-1], ids[:, 1:]

    rb = 4 * (s + 1) + (RECORD_CRC_BYTES if checksummed else 0)
    it = ShardedRecordIterator(
        paths, rb, b, checksummed=checksummed,
        seed=args.seed, decode=decode, telemetry=telemetry,
        slow_read_threshold=1.0)
    return AsyncPrefetcher(it, depth=2, telemetry=telemetry,
                           transfer=to_device(device))


def setup(argv=None, device=None):
    """Parse the flags, join the process group when the world is above one
    and none is joined yet (from the launcher's environment, on
    ``--distributed-backend``), register the tensor x data layout and
    build (args, model, optimizer) on ``device``."""
    args = parse_args(extra_args_provider=_extra_args, args=argv,
                      defaults={"train_iters": 100, "lr": 1.5e-4})
    _refuse_unported(args)
    derived = args.micro_batch_size * args.data_parallel_size
    if args.global_batch_size != derived:
        raise SystemExit(
            f"--global-batch-size {args.global_batch_size} != "
            f"micro-batch-size x dp = {derived}: gradient accumulation is "
            "not wired in this example")
    if args.world_size > 1 and not dist.is_initialized():
        card = initialize_distributed(args.distributed_backend)
        if device is None and card.type == "cuda":
            device = card
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(
        args.tensor_model_parallel_size, args.pipeline_model_parallel_size)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # bf16 and fp16 GEMMs reduce in fp32, as the TPU's MXU passes and
        # the JAX package's fp32-accumulated products do
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            False
    cfg = build_config(args)
    model = GPTModel(cfg, device=dev, seed=args.seed)
    opt = FusedAdam(model.parameters(), lr=args.lr,
                    weight_decay=args.weight_decay,
                    betas=(args.adam_beta1, args.adam_beta2),
                    eps=args.adam_eps)
    return args, model, opt


def step_seed(args, it: int) -> Optional[int]:
    """The dropout seed of step ``it`` (None when dropout is off)."""
    if args.attention_dropout <= 0 and args.hidden_dropout <= 0:
        return None
    return fold_in(args.seed + 2, it)


def dp_rows(batch: Batch) -> Batch:
    """This data-parallel rank's rows of a global batch (rows [i m, (i +
    1) m) of dp rank i, as the JAX example's ``P("data")`` shards it)."""
    dp = parallel_state.get_data_parallel_world_size()
    if dp == 1:
        return batch
    i, m = parallel_state.get_data_parallel_rank(), batch[0].shape[0] // dp
    return tuple(t[i * m:(i + 1) * m] for t in batch)


def clip_grads(model: GPTModel, max_norm: float,
               eps: float = 1e-6) -> torch.Tensor:
    """Clip every ``.grad`` in place by min(1, max_norm / (norm + eps)),
    the norm that of the whole model's gradient: at tp above 1 the
    tensor-parallel shards' squares are summed over the tensor group and
    each replicated parameter counts once (its gradient is the same on
    every rank), so the clip is tp = 1's.  Returns the norm."""
    grads = [p.grad for p in model.parameters()]
    group = parallel_state.get_tensor_model_parallel_group()
    if comm.group_size(group) == 1:
        return clip_grad_norm(grads, max_norm, eps=eps)
    sharded = [p.grad for p in model.parameters()
               if getattr(p, "tensor_model_parallel", False)]
    replicated = [p.grad for p in model.parameters()
                  if not getattr(p, "tensor_model_parallel", False)]
    sq = comm.all_reduce(multi_tensor_l2norm(sharded) ** 2, group)
    norm = torch.sqrt(sq + multi_tensor_l2norm(replicated) ** 2)
    torch._foreach_mul_(grads, torch.clamp(max_norm / (norm + eps), max=1.0))
    return norm


def forward_backward(args, model: GPTModel, tokens: torch.Tensor,
                     labels: torch.Tensor, it: int) -> torch.Tensor:
    """Forward and backward of this rank's rows (accumulating into each
    parameter's ``.grad``), the gradients' mean over dp and the
    global-norm clip of step ``it`` (in place, over every ``.grad``),
    before any optimizer.  Returns the loss, the dp mean (a device
    scalar; at dp = 1 nothing here synchronises)."""
    loss = model(tokens, labels=labels, dropout_seed=step_seed(args, it)
                 ).mean()
    loss.backward()
    dp_group = parallel_state.get_data_parallel_group()
    params = list(model.parameters())
    if comm.group_size(dp_group) > 1:
        for p, g in zip(params, all_reduce_grads([p.grad for p in params],
                                                 dp_group)):
            p.grad = g
        loss = comm.all_reduce(loss.detach(), dp_group) / comm.group_size(
            dp_group)
    if args.clip_grad and args.clip_grad > 0:
        clip_grads(model, args.clip_grad)
    return loss.detach()


def train_step(args, model: GPTModel, opt: FusedAdam, tokens: torch.Tensor,
               labels: torch.Tensor, it: int) -> torch.Tensor:
    """One step: :func:`forward_backward`, then the optimizer step, then
    the gradients dropped.  Returns the loss (a device scalar)."""
    loss = forward_backward(args, model, tokens, labels, it)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss


# -- the checkpoint: the JAX example's (params, AdamState) tree ------------


def _stack_names(model: GPTModel) -> dict:
    """JAX leaf name -> the port's parameter names it stacks (one for a
    leaf outside the layers, one a layer for a layer leaf)."""
    groups: dict = {}
    for name, _ in model.named_parameters():
        if name.startswith(_LAYERS):
            i, leaf = name[len(_LAYERS):].split(".", 1)
            groups.setdefault(_LAYERS + leaf, []).append((int(i), name))
        else:
            groups[name] = [(0, name)]
    return {k: [n for _, n in sorted(v)] for k, v in groups.items()}


def _leaf_shape(key: str, names: list, t: torch.Tensor, tp: int = 1
                ) -> tuple:
    # the leading tensor-parallel axis, then the layer axis
    return ((tp,) + ((len(names),) if key.startswith(_LAYERS) else ())
            + tuple(t.shape))


def _host_stack(key: str, names: list, tensors: Mapping[str, torch.Tensor]
                ) -> np.ndarray:
    """One JAX leaf on the host: the tensors copied straight into their
    slots of a new stacked array (a snapshot)."""
    first = tensors[names[0]]
    out = np.empty(_leaf_shape(key, names, first),
                   torch.empty((), dtype=first.dtype).numpy().dtype)
    view = torch.from_numpy(out).reshape((len(names),) + tuple(first.shape))
    for i, n in enumerate(names):
        view[i].copy_(tensors[n].detach())
    return out


def checkpoint_tree(model: GPTModel, opt: FusedAdam) -> Optional[tuple]:
    """``(params, AdamState(step, exp_avg, exp_avg_sq))`` as the JAX
    example checkpoints them, as new host arrays: the layers stacked, a
    leading tensor-parallel axis of tp, the step count int32.  At tp above
    1 the ranks of the tensor group of data-parallel rank 0 gather their
    shards to its tp rank 0, which gets the tree; every other rank gets
    None (and the ranks of other dp ranks take part in nothing)."""
    if parallel_state.get_data_parallel_rank() != 0:
        return None
    group = parallel_state.get_tensor_model_parallel_group()
    groups = _stack_names(model)
    named = dict(model.named_parameters())
    states = [opt.state[p] for p in named.values()]
    if all(states):
        step = states[0]["step"]
        m = {n: opt.state[p]["exp_avg"] for n, p in named.items()}
        v = {n: opt.state[p]["exp_avg_sq"] for n, p in named.items()}
    else:   # no step taken: the JAX init's zero moments
        step = 0
        m = v = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in named.items()}

    def tree(tensors):
        out = {}
        for k, ns in groups.items():
            leaf = _host_stack(k, ns, tensors)
            if comm.group_size(group) > 1:
                leaf = comm.gather(torch.from_numpy(leaf), group)
                leaf = None if leaf is None else leaf.numpy()
            out[k] = leaf
        return nest(out)

    trees = (tree(named), tree(m), tree(v))
    if parallel_state.get_tensor_model_parallel_rank() != 0:
        return None
    return (trees[0],
            AdamState(step=np.asarray(int(step), np.int32),
                      exp_avg=trees[1], exp_avg_sq=trees[2]))


def checkpoint_target(model: GPTModel) -> tuple:
    """The restore target of :func:`checkpoint_tree`: the same structure
    with ``meta`` tensors (shapes and dtypes only)."""
    groups = _stack_names(model)
    named = dict(model.named_parameters())
    tp = model.cfg.tp_size

    def tree(dtype=None):
        return nest({k: torch.empty(_leaf_shape(k, ns, named[ns[0]], tp),
                                    dtype=dtype or named[ns[0]].dtype,
                                    device="meta")
                     for k, ns in groups.items()})

    return (tree(), AdamState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        exp_avg=tree(torch.float32), exp_avg_sq=tree(torch.float32)))


@torch.no_grad()
def load_checkpoint_tree(model: GPTModel, opt: FusedAdam, tree) -> None:
    """Put a restored :func:`checkpoint_tree` (host tensors) into the
    model's parameters and the optimizer's state (this tp rank's index of
    the leading axis)."""
    params, adam = tree
    named = dict(model.named_parameters())
    r = model.embedding.tp_rank
    leaves = [_flatten(params), _flatten(adam.exp_avg),
              _flatten(adam.exp_avg_sq)]
    step = int(adam.step)
    for key, names in _stack_names(model).items():
        got = [torch.from_numpy(leaf[key][r]).reshape(
            (len(names),) + tuple(named[names[0]].shape)) for leaf in leaves]
        for i, n in enumerate(names):
            p = named[n]
            p.copy_(got[0][i])
            opt.state[p] = {
                "step": step,
                "exp_avg": got[1][i].to(p.device, torch.float32, copy=True),
                "exp_avg_sq": got[2][i].to(p.device, torch.float32,
                                           copy=True)}


def _sync(dev: torch.device) -> None:
    """Wait for the work queued on ``dev``'s current stream."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def main(argv=None, device=None, *,
         state_dict: Optional[Mapping[str, torch.Tensor]] = None,
         batches: Optional[Iterable[Batch]] = None,
         on_step: Optional[Callable[[int, torch.Tensor, GPTModel], None]] = None
         ) -> Optional[float]:
    """Train to ``--train-iters`` steps and return the final loss (None
    when a resumed run had nothing to do).

    ``device`` defaults to the card.  ``state_dict`` replaces the seeded
    initial weights (at tp above 1, this rank's shard; ``--load`` then
    replaces both), ``batches`` the synthetic data (global batches), and
    ``on_step(it, loss, model)`` is called on every rank after each
    step, before the preemption check (tests and the smoke run hold the
    port against references, and inject preemptions, through these).
    The model-parallel state is registered for the run and forgotten at
    its end, and a process group this call joined is left at its end."""
    owns_group = not dist.is_initialized()
    args, model, opt = setup(argv, device)
    owns_group = owns_group and dist.is_initialized()
    try:
        return _train(args, model, opt, state_dict, batches, on_step)
    finally:
        parallel_state.destroy_model_parallel()
        if owns_group:
            dist.destroy_process_group()


def _stop_agreed(flag: bool, dev: torch.device) -> bool:
    """Whether any rank asks to stop (a max over the world; one rank that
    stopped alone would leave the others waiting in a collective)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.full((), int(flag), dtype=torch.int32, device=dev)
    return bool(comm.all_reduce(t, dist.group.WORLD, op="max"))


def _train(args, model, opt, state_dict, batches, on_step):
    dev = next(model.parameters()).device
    lead = args.rank == 0
    use_pipeline = bool(args.data_dir or args.data_path)
    if use_pipeline and batches is not None:
        raise ValueError("batches replaces the synthetic data; it cannot "
                         "be combined with --data-dir / --data-path")
    if state_dict is not None:
        model.load_state_dict(state_dict)

    # telemetry: structured stream + crash flight recorder; step events
    # carry the data-wait/step wall split, the loss rides the windowed read
    bus = acct = sampler = None
    if args.telemetry_dir and lead:
        from apex_tpu_torch import telemetry as tele

        bus = tele.TelemetryBus(
            run_id=f"pretrain-gpt-{os.getpid()}",
            sinks=[tele.JsonlSink(os.path.join(args.telemetry_dir,
                                               "pretrain_gpt.jsonl"))],
            mesh={"n_devices": args.world_size,
                  "tp": args.tensor_model_parallel_size,
                  "dp": args.data_parallel_size,
                  "platform": "gpu" if dev.type == "cuda" else "cpu"})
        acct = bus.accountant(window=args.log_interval)
        if args.profile_every > 0:
            # in-run attribution: periodic phase / memory sampling through
            # the same stream, its overhead booked to the profile bucket
            sampler = tele.ProfileSampler(bus, every=args.profile_every,
                                          accountant=acct)

    step0 = 0
    if args.load:
        # CRC-verified restore; a corrupt latest checkpoint (killed
        # mid-incident) falls back to the newest intact older one
        t_restore = time.perf_counter()
        tree, step0 = resilience.restore_resilient(
            args.load, target=checkpoint_target(model), device="cpu")
        load_checkpoint_tree(model, opt, tree)
        del tree
        _sync(dev)
        dt = time.perf_counter() - t_restore
        if lead:
            print(f"resumed from step {step0} ({dt:.3f} s)", flush=True)
        if bus is not None:
            acct.pause(dt, "restore")
            bus.emit("ckpt_restore", step=step0, wall_ms=round(dt * 1e3, 3))

    if step0 >= args.train_iters:
        if lead:
            print(f"nothing to do: resumed step {step0} >= --train-iters "
                  f"{args.train_iters}")
        if bus is not None:
            bus.close()
        return None

    if bus is not None:
        bus.emit("run_start", step=step0, workload="pretrain_gpt",
                 config={"num_layers": args.num_layers,
                         "hidden_size": args.hidden_size,
                         "seq_length": args.seq_length,
                         "global_batch_size": args.global_batch_size,
                         "train_iters": args.train_iters})

    # data: real shards ride the checkpointable pipeline — the iterator
    # position is saved with every checkpoint and restored with --load,
    # so a preempted run's sample stream has no duplicates and no drops
    if use_pipeline:
        batches = build_data_iter(args, dev, telemetry=bus)
        if step0:
            ds = ckpt.load_data_state(args.load, step=step0)
            if ds is None:
                batches.close()
                raise SystemExit(
                    f"checkpoint step {step0} under --load carries no "
                    "data_state but this run streams real data — "
                    "resuming would silently replay or skip training "
                    "samples (the checkpoint predates the fault-"
                    "tolerant pipeline)")
            batches.load_state_dict(ds)
    else:
        if batches is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed + 1)
            batches = synthetic_batches(args, gen)
        batches = iter(batches)
        for _ in range(step0):
            next(batches)  # a resumed run must not re-see consumed batches

    tokens_per_step = args.global_batch_size * args.seq_length
    loss = None
    preempted = False

    def _save(step, blocking):
        t_save = time.perf_counter()
        # fence the previous write before taking the next snapshot, so at
        # most one copy of the state is held on the host
        resilience.wait_for_save()
        tree = checkpoint_tree(model, opt)   # None but on the writer
        if tree is not None:
            ckpt.save_checkpoint(args.save, tree, step=step,
                                 blocking=blocking,
                                 data_state=(batches.state_dict()
                                             if use_pipeline else None))
        del tree
        if bus is not None:
            dt_save = time.perf_counter() - t_save
            acct.pause(dt_save, "ckpt_fence")
            bus.emit("ckpt_save", step=step, blocking=blocking,
                     wall_ms=round(dt_save * 1e3, 3))

    t0 = time.perf_counter()
    try:
        with resilience.GracePeriodHandler() as preempt:
            # the watchdog arms a deadline around each step; a hang logs
            # heartbeat ages + duration percentiles and lands in the same
            # grace-period exit as SIGTERM
            watchdog = (resilience.Watchdog(args.watchdog_timeout,
                                            handler=preempt)
                        if args.watchdog_timeout > 0 else None)
            if bus is not None and watchdog is not None:
                bus.attach_watchdog(watchdog)

            for it in range(step0, args.train_iters):
                t_data = time.perf_counter()
                tokens, labels = dp_rows(tuple(t.to(dev)
                                               for t in next(batches)))
                t_step = time.perf_counter()
                if watchdog is not None:
                    with watchdog.step(it):
                        loss = train_step(args, model, opt, tokens, labels,
                                          it)
                        _sync(dev)
                else:
                    loss = train_step(args, model, opt, tokens, labels, it)
                if acct is not None:
                    if watchdog is None:
                        # telemetry-grade step timing needs the step's
                        # device wall, not the host's launch time
                        _sync(dev)
                    acct.step_done(it + 1,
                                   step_s=time.perf_counter() - t_step,
                                   data_wait_s=t_step - t_data,
                                   scalars={"loss": loss}, timing="synced")
                if sampler is not None:
                    sampler.on_step(it + 1)  # never raises into the run
                if on_step is not None:
                    on_step(it, loss, model)
                if lead and (it + 1) % args.log_interval == 0:
                    value = float(loss)   # synchronises: the window is done
                    dt = (time.perf_counter() - t0) / args.log_interval
                    print(f"iter {it + 1}/{args.train_iters} loss "
                          f"{value:.4f} {dt * 1e3:.0f} ms/iter "
                          f"{tokens_per_step / dt:,.0f} tok/s", flush=True)
                    t0 = time.perf_counter()
                if _stop_agreed(preempt.should_stop, dev):
                    # grace period: make the finished step durable, exit
                    # clean
                    preempted = True
                    if args.save:
                        _save(it + 1, blocking=True)
                    outcome = ("checkpoint written" if args.save
                               else "no --save dir, progress lost")
                    if lead:
                        print(f"preempted ({preempt.reason}) at iter "
                              f"{it + 1}: {outcome}, exiting", flush=True)
                    if bus is not None:
                        bus.flush_postmortem(preempt.reason or "preempted",
                                             step=it + 1, watchdog=watchdog)
                    break
                if args.save and args.save_interval and \
                        (it + 1) % args.save_interval == 0:
                    # async: the write overlaps the next training steps
                    # and the next save (or exit) fences on it
                    _save(it + 1, blocking=False)
            if watchdog is not None:
                watchdog.close()
    except BaseException as e:
        # hard crash (CUDA error, ^C): the postmortem is the record of how
        # the run died — flush it before unwinding, never letting
        # telemetry mask the primary failure
        if bus is not None:
            try:
                if sampler is not None:
                    sampler.close()
                bus.flush_postmortem(type(e).__name__)
                acct.finish(reason=type(e).__name__)
                bus.close()
            except Exception:
                pass
        raise
    finally:
        if use_pipeline:
            batches.close()
    if args.save and not preempted and not (
            args.save_interval
            and args.train_iters % args.save_interval == 0):
        # the final checkpoint rides the same instrumented path
        _save(args.train_iters, blocking=True)
    resilience.wait_for_save()
    if sampler is not None:
        sampler.close()
    if bus is not None:
        acct.finish(step=args.train_iters if not preempted else None,
                    reason=(preempt.reason or "preempted") if preempted
                    else "completed")
        bus.close()
    final = float(loss)
    if preempted:
        return final
    if not math.isfinite(final):
        raise FloatingPointError(f"diverged: final loss {final}")
    if lead:
        print(f"done: final loss {final:.4f}")
    return final


__all__ = ["AdamState", "build_config", "synthetic_batches",
           "build_data_iter", "setup", "step_seed", "dp_rows", "clip_grads",
           "forward_backward",
           "train_step", "checkpoint_tree", "checkpoint_target",
           "load_checkpoint_tree", "main"]

if __name__ == "__main__":
    main(sys.argv[1:])
