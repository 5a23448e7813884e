"""Megatron-style GPT pretraining on one card.

PyTorch port of the JAX package's ``examples/gpt/pretrain_gpt.py`` at
tensor- and data-parallel size 1: the same Megatron flags
(:mod:`apex_tpu_torch.transformer.testing.arguments`), the same model
(:class:`~apex_tpu_torch.transformer.testing.GPTModel`, built on the
card), ``FusedAdam``, global-norm clipping, synthetic token batches::

    # GPT-1.3B on one H100
    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --num-layers 24 \\
        --hidden-size 2048 --num-attention-heads 16 --seq-length 2048 \\
        --max-position-embeddings 2048 --micro-batch-size 4 --bf16 \\
        --train-iters 20 --log-interval 5

Each step: forward, backward, ``clip_grad_norm``, optimizer step; every
``--log-interval`` steps it prints ``iter i/n loss x ms/iter tok/s``.
``main`` returns the final loss.  Options the port does not have yet
raise ``NotImplementedError`` (ROADMAP.md): tensor parallelism above 1,
more than one process, ``--data-dir``/``--data-path``,
``--save``/``--load``, ``--telemetry-dir``, ``--profile-every``,
``--watchdog-timeout``, and remat policies other than ``attn_res`` and
``full``.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Iterable, Iterator, Mapping, Optional, Tuple

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.multi_tensor import clip_grad_norm
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.tensor_parallel.random import fold_in
from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel
from apex_tpu_torch.transformer.testing.arguments import parse_args

Batch = Tuple[torch.Tensor, torch.Tensor]


def _extra_args(parser):
    # the flags the JAX example adds to the Megatron argument clone
    g = parser.add_argument_group("pretrain_gpt")
    g.add_argument("--remat-policy", default="attn_res",
                   choices=["full", "dots", "attn_res", "attn_res_mlp",
                            "attn_out"])
    g.add_argument("--data-dir", default=None,
                   help="not ported: synthetic tokens only")
    g.add_argument("--vocab-size", type=int, default=51200,
                   help="unpadded vocab; padded to "
                        "--make-vocab-size-divisible-by x tp")
    g.add_argument("--watchdog-timeout", type=float, default=0.0,
                   help="not ported")
    g.add_argument("--telemetry-dir", default=None, help="not ported")
    g.add_argument("--profile-every", type=int, default=0,
                   help="not ported")
    return parser


def _refuse_unported(args) -> None:
    unported = []
    if args.tensor_model_parallel_size != 1:
        unported.append(
            f"--tensor-model-parallel-size {args.tensor_model_parallel_size}")
    if args.pipeline_model_parallel_size != 1:
        unported.append(f"--pipeline-model-parallel-size "
                        f"{args.pipeline_model_parallel_size}")
    if args.world_size != 1:
        unported.append(f"--world-size {args.world_size}")
    for flag in ("data_dir", "data_path", "save", "load", "telemetry_dir"):
        if getattr(args, flag):
            unported.append("--" + flag.replace("_", "-"))
    if args.watchdog_timeout > 0:
        unported.append("--watchdog-timeout")
    if args.profile_every > 0:
        unported.append("--profile-every")
    if unported:
        raise NotImplementedError(
            "not ported to apex_tpu_torch (ROADMAP.md): " + ", ".join(unported))


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
    generator's device (the reference test loop's synthetic data)."""
    b, s = args.global_batch_size, args.seq_length
    while True:
        ids = torch.randint(0, args.padded_vocab_size, (b, s + 1),
                            generator=generator, device=generator.device)
        yield ids[:, :-1], ids[:, 1:]


def setup(argv=None, device=None):
    """Parse the flags and build (args, model, optimizer) on ``device``."""
    args = parse_args(extra_args_provider=_extra_args, args=argv,
                      defaults={"train_iters": 100, "lr": 1.5e-4})
    _refuse_unported(args)
    if args.global_batch_size != args.micro_batch_size:
        raise SystemExit(
            f"--global-batch-size {args.global_batch_size} != "
            f"--micro-batch-size {args.micro_batch_size}: one process, and "
            "gradient accumulation is not wired in this example")
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


def forward_backward(args, model: GPTModel, tokens: torch.Tensor,
                     labels: torch.Tensor, it: int) -> torch.Tensor:
    """Forward, backward (accumulating into each parameter's ``.grad``)
    and the global-norm clip of step ``it`` (in place, over every
    ``.grad``), before any optimizer.  Returns the loss (a device scalar;
    nothing here synchronises)."""
    loss = model(tokens, labels=labels, dropout_seed=step_seed(args, it)
                 ).mean()
    loss.backward()
    if args.clip_grad and args.clip_grad > 0:
        clip_grad_norm([p.grad for p in model.parameters()], args.clip_grad)
    return loss.detach()


def train_step(args, model: GPTModel, opt: FusedAdam, tokens: torch.Tensor,
               labels: torch.Tensor, it: int) -> torch.Tensor:
    """One step: :func:`forward_backward`, then the optimizer step, then
    the gradients dropped.  Returns the loss (a device scalar)."""
    loss = forward_backward(args, model, tokens, labels, it)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss


def main(argv=None, device=None, *,
         state_dict: Optional[Mapping[str, torch.Tensor]] = None,
         batches: Optional[Iterable[Batch]] = None,
         on_step: Optional[Callable[[int, torch.Tensor, GPTModel], None]] = None
         ) -> float:
    """Train ``--train-iters`` steps and return the final loss.

    ``device`` defaults to the card.  ``state_dict`` replaces the seeded
    initial weights, ``batches`` the synthetic data, and ``on_step(it,
    loss, model)`` is called after each step (tests and the smoke run
    hold the port against references through these)."""
    args, model, opt = setup(argv, device)
    dev = next(model.parameters()).device
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if batches is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        batches = synthetic_batches(args, gen)
    batches = iter(batches)
    tokens_per_step = args.global_batch_size * args.seq_length
    loss = None
    t0 = time.perf_counter()
    for it in range(args.train_iters):
        tokens, labels = (t.to(dev) for t in next(batches))
        loss = train_step(args, model, opt, tokens, labels, it)
        if on_step is not None:
            on_step(it, loss, model)
        if (it + 1) % args.log_interval == 0:
            value = float(loss)   # synchronises: the window's steps are done
            dt = (time.perf_counter() - t0) / args.log_interval
            print(f"iter {it + 1}/{args.train_iters} loss {value:.4f} "
                  f"{dt * 1e3:.0f} ms/iter {tokens_per_step / dt:,.0f} tok/s",
                  flush=True)
            t0 = time.perf_counter()
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError(f"diverged: final loss {final}")
    print(f"done: final loss {final:.4f}")
    return final


__all__ = ["build_config", "synthetic_batches", "setup", "step_seed",
           "forward_backward", "train_step", "main"]

if __name__ == "__main__":
    main(sys.argv[1:])
