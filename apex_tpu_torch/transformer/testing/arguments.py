"""Megatron-style argument parsing (reference
apex/transformer/testing/arguments.py:23-806).

PyTorch port of the JAX package's
``apex_tpu/transformer/testing/arguments.py``, flag for flag, so the same
command lines parse.  Deltas from the JAX file, each deliberate:

- world size is ``--world-size`` when given, else tp x pp (the JAX file
  takes the device count); the port's training path runs one process on
  one card and refuses more (its entry point says so);
- ``params_dtype`` is a torch dtype; bf16 forces fp32 grad accumulation
  exactly as the reference does (arguments.py:149-158);
- DDP_impl/contiguous-buffer knobs are accepted but have no effect
  (flagged in help), kept so reference scripts parse unchanged.

All of the reference's argument groups are present, including the
autoresume, biencoder (ICT/retriever) and ViT groups (reference
arguments.py:725-806); those are parse-surface only, so reference launch
scripts run unmodified, and each help string says so.  Which flags the
training path refuses is up to its entry point
(:mod:`apex_tpu_torch.examples.gpt.pretrain_gpt`).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import torch


def parse_args(extra_args_provider: Optional[Callable] = None, defaults: dict = {},
               ignore_unknown_args: bool = False, args=None):
    """Parse all arguments (reference arguments.py:23-280)."""
    parser = argparse.ArgumentParser(description="apex_tpu_torch Megatron Arguments",
                                     allow_abbrev=False)
    parser = _add_network_size_args(parser)
    parser = _add_regularization_args(parser)
    parser = _add_training_args(parser)
    parser = _add_initialization_args(parser)
    parser = _add_learning_rate_args(parser)
    parser = _add_checkpointing_args(parser)
    parser = _add_mixed_precision_args(parser)
    parser = _add_distributed_args(parser)
    parser = _add_validation_args(parser)
    parser = _add_data_args(parser)
    parser = _add_autoresume_args(parser)
    parser = _add_biencoder_args(parser)
    parser = _add_vit_args(parser)
    parser = _add_logging_args(parser)
    if extra_args_provider is not None:
        parser = extra_args_provider(parser)

    if ignore_unknown_args:
        parsed, _ = parser.parse_known_args(args)
    else:
        parsed = parser.parse_args(args)
    return _validate_and_derive(parsed, defaults)


def _validate_and_derive(args, defaults):
    """The consistency-check block (reference arguments.py:55-280)."""
    # world size: explicit flag, else as many processes as the parallel
    # sizes ask for (a tp or pp flag is never clamped away silently)
    if args.world_size is None:
        args.world_size = (args.tensor_model_parallel_size
                           * args.pipeline_model_parallel_size)
    args.rank = int(os.getenv("RANK", "0"))

    assert args.tensor_model_parallel_size >= 1, (
        f"tensor model parallel size "
        f"({args.tensor_model_parallel_size}) must be >= 1")
    args.tensor_model_parallel_size = min(
        args.tensor_model_parallel_size, args.world_size)
    assert args.world_size % args.tensor_model_parallel_size == 0, (
        f"world size ({args.world_size}) is not divisible by tensor model "
        f"parallel size ({args.tensor_model_parallel_size})")
    args.pipeline_model_parallel_size = min(
        args.pipeline_model_parallel_size,
        args.world_size // args.tensor_model_parallel_size)
    model_parallel_size = (
        args.pipeline_model_parallel_size * args.tensor_model_parallel_size)
    assert args.world_size % model_parallel_size == 0, (
        f"world size ({args.world_size}) is not divisible by tensor parallel "
        f"size ({args.tensor_model_parallel_size}) times pipeline parallel "
        f"size ({args.pipeline_model_parallel_size})")
    args.data_parallel_size = args.world_size // model_parallel_size

    # user-supplied defaults only fill unset (None) args — reference :108-120
    for key, val in defaults.items():
        if getattr(args, key, None) is None:
            setattr(args, key, val)

    # batch sizes — reference :122-130
    assert args.micro_batch_size is not None and args.micro_batch_size > 0
    if args.global_batch_size is None:
        args.global_batch_size = args.micro_batch_size * args.data_parallel_size
    assert args.global_batch_size > 0
    assert args.global_batch_size % (
        args.micro_batch_size * args.data_parallel_size) == 0

    # virtual pipeline — reference :131-141
    if args.num_layers_per_virtual_pipeline_stage is not None:
        assert args.pipeline_model_parallel_size > 2, (
            "pipeline-model-parallel size should be greater than 2 with "
            "interleaved schedule")
        assert args.num_layers % args.num_layers_per_virtual_pipeline_stage == 0
        args.virtual_pipeline_model_parallel_size = (
            args.num_layers // args.pipeline_model_parallel_size
        ) // args.num_layers_per_virtual_pipeline_stage
    else:
        args.virtual_pipeline_model_parallel_size = None

    # params dtype — reference :145-163
    assert not (args.fp16 and args.bf16)
    args.params_dtype = torch.float32
    if args.fp16:
        args.params_dtype = torch.float16
    if args.bf16:
        args.params_dtype = torch.bfloat16
        # bf16 grads accumulate/all-reduce in fp32 (reference :152-158)
        args.accumulate_allreduce_grads_in_fp32 = True

    if args.lr is not None and args.min_lr is not None:
        assert args.min_lr <= args.lr
    if args.lr_warmup_fraction is not None:
        assert args.lr_warmup_iters == 0, (
            "can only specify one of lr-warmup-fraction and lr-warmup-iters")
    if args.save_interval is not None:
        assert args.save is not None, "--save-interval needs --save"
    for req in ("hidden_size", "num_attention_heads"):
        assert getattr(args, req) is not None, f"--{req.replace('_', '-')} is required"
    assert args.hidden_size % args.num_attention_heads == 0
    # derived network sizes (reference arguments.py network-size defaults)
    if args.ffn_hidden_size is None:
        args.ffn_hidden_size = 4 * args.hidden_size
    if args.kv_channels is None:
        args.kv_channels = args.hidden_size // args.num_attention_heads
    if args.seq_length is not None and args.max_position_embeddings is not None:
        assert args.max_position_embeddings >= args.seq_length
    if args.fp32_residual_connection:
        assert args.fp16 or args.bf16

    args.consumed_train_samples = 0
    args.consumed_valid_samples = 0
    return args


def _add_network_size_args(parser):
    group = parser.add_argument_group(title="network size")
    group.add_argument("--num-layers", type=int, default=None)
    group.add_argument("--hidden-size", type=int, default=None)
    group.add_argument("--ffn-hidden-size", type=int, default=None,
                       help="defaults to 4*hidden-size")
    group.add_argument("--num-attention-heads", type=int, default=None)
    group.add_argument("--kv-channels", type=int, default=None)
    group.add_argument("--max-position-embeddings", type=int, default=None)
    group.add_argument("--make-vocab-size-divisible-by", type=int, default=128)
    group.add_argument("--layernorm-epsilon", type=float, default=1e-5)
    group.add_argument("--apply-residual-connection-post-layernorm",
                       action="store_true")
    group.add_argument("--openai-gelu", action="store_true")
    group.add_argument("--onnx-safe", type=bool, default=None)
    return parser


def _add_regularization_args(parser):
    group = parser.add_argument_group(title="regularization")
    group.add_argument("--attention-dropout", type=float, default=0.1)
    group.add_argument("--hidden-dropout", type=float, default=0.1)
    group.add_argument("--weight-decay", type=float, default=0.01)
    group.add_argument("--clip-grad", type=float, default=1.0)
    group.add_argument("--adam-beta1", type=float, default=0.9)
    group.add_argument("--adam-beta2", type=float, default=0.999)
    group.add_argument("--adam-eps", type=float, default=1e-8)
    group.add_argument("--sgd-momentum", type=float, default=0.9)
    return parser


def _add_training_args(parser):
    group = parser.add_argument_group(title="training")
    group.add_argument("--micro-batch-size", type=int, default=None)
    group.add_argument("--global-batch-size", type=int, default=None)
    group.add_argument("--rampup-batch-size", nargs="*", default=None,
                       help="<start batch size> <increment> <ramp-up samples>")
    group.add_argument("--train-iters", type=int, default=None)
    group.add_argument("--train-samples", type=int, default=None)
    group.add_argument("--log-interval", type=int, default=100)
    group.add_argument("--exit-interval", type=int, default=None)
    group.add_argument("--tensorboard-dir", type=str, default=None)
    group.add_argument("--activations-checkpoint-method", type=str,
                       choices=["uniform", "block"], default=None)
    group.add_argument("--activations-checkpoint-num-layers", type=int, default=1)
    group.add_argument("--distribute-checkpointed-activations",
                       action="store_true")
    group.add_argument("--optimizer", type=str, default="adam",
                       choices=["adam", "sgd", "lamb", "novograd", "adagrad"])
    group.add_argument("--dataloader-type", type=str, default="single",
                       choices=["single", "cyclic"])
    return parser


def _add_initialization_args(parser):
    group = parser.add_argument_group(title="initialization")
    group.add_argument("--seed", type=int, default=1234)
    group.add_argument("--init-method-std", type=float, default=0.02)
    group.add_argument("--init-method-xavier-uniform", action="store_true")
    return parser


def _add_learning_rate_args(parser):
    group = parser.add_argument_group(title="learning rate")
    group.add_argument("--lr", type=float, default=None)
    group.add_argument("--lr-decay-style", type=str, default="linear",
                       choices=["constant", "linear", "cosine"])
    group.add_argument("--lr-decay-iters", type=int, default=None)
    group.add_argument("--lr-decay-samples", type=int, default=None)
    group.add_argument("--lr-warmup-fraction", type=float, default=None)
    group.add_argument("--lr-warmup-iters", type=int, default=0)
    group.add_argument("--lr-warmup-samples", type=int, default=0)
    group.add_argument("--min-lr", type=float, default=0.0)
    group.add_argument("--override-lr-scheduler", action="store_true")
    group.add_argument("--use-checkpoint-lr-scheduler", action="store_true")
    return parser


def _add_checkpointing_args(parser):
    group = parser.add_argument_group(title="checkpointing")
    group.add_argument("--save", type=str, default=None)
    group.add_argument("--save-interval", type=int, default=None)
    group.add_argument("--no-save-optim", action="store_true", default=None)
    group.add_argument("--no-save-rng", action="store_true", default=None)
    group.add_argument("--load", type=str, default=None)
    group.add_argument("--no-load-optim", action="store_true", default=None)
    group.add_argument("--no-load-rng", action="store_true", default=None)
    group.add_argument("--finetune", action="store_true")
    return parser


def _add_mixed_precision_args(parser):
    group = parser.add_argument_group(title="mixed precision")
    group.add_argument("--fp16", action="store_true",
                       help="fp16 + loss scaling (reference parity mode)")
    group.add_argument("--bf16", action="store_true",
                       help="bfloat16 compute, fp32 master weights")
    group.add_argument("--loss-scale", type=float, default=None,
                       help="static loss scale; None = dynamic")
    group.add_argument("--initial-loss-scale", type=float, default=2 ** 16)
    group.add_argument("--min-loss-scale", type=float, default=1.0)
    group.add_argument("--loss-scale-window", type=float, default=2000)
    group.add_argument("--hysteresis", type=int, default=2)
    group.add_argument("--fp32-residual-connection", action="store_true")
    group.add_argument("--accumulate-allreduce-grads-in-fp32",
                       action="store_true")
    group.add_argument("--attention-softmax-in-fp32", action="store_true")
    return parser


def _add_distributed_args(parser):
    group = parser.add_argument_group(title="distributed")
    group.add_argument("--tensor-model-parallel-size", type=int, default=1)
    group.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    group.add_argument("--pipeline-model-parallel-split-rank", type=int,
                       default=None)
    group.add_argument("--num-layers-per-virtual-pipeline-stage", type=int,
                       default=None)
    group.add_argument("--world-size", type=int, default=None,
                       help="number of processes (default 1: one card)")
    group.add_argument("--distributed-backend", default="nccl",
                       choices=["xla", "nccl", "gloo"],
                       help="accepted for script parity; one process runs "
                            "no collectives")
    group.add_argument("--DDP-impl", default="local",
                       choices=["local", "torch"],
                       help="accepted for script parity; no effect")
    group.add_argument("--use-contiguous-buffers-in-local-ddp",
                       action="store_true",
                       help="accepted for script parity; no effect")
    group.add_argument("--local_rank", type=int, default=None)
    return parser


def _add_validation_args(parser):
    group = parser.add_argument_group(title="validation")
    group.add_argument("--eval-iters", type=int, default=100)
    group.add_argument("--eval-interval", type=int, default=1000)
    return parser


def _add_data_args(parser):
    group = parser.add_argument_group(title="data and dataloader")
    group.add_argument("--data-path", nargs="*", default=None)
    group.add_argument("--split", type=str, default="969, 30, 1")
    group.add_argument("--vocab-file", type=str, default=None)
    group.add_argument("--merge-file", type=str, default=None)
    group.add_argument("--seq-length", type=int, default=None)
    group.add_argument("--encoder-seq-length", type=int, default=None)
    group.add_argument("--decoder-seq-length", type=int, default=None)
    group.add_argument("--num-workers", type=int, default=2)
    group.add_argument("--reset-position-ids", action="store_true")
    group.add_argument("--reset-attention-mask", action="store_true")
    group.add_argument("--eod-mask-loss", action="store_true")
    return parser


def _add_autoresume_args(parser):
    """Reference arguments.py:725-733.  Parse-surface parity only: the
    port has no autoresume hook."""
    group = parser.add_argument_group(title="autoresume")
    group.add_argument("--adlr-autoresume", action="store_true",
                       help="accepted for script parity; no effect")
    group.add_argument("--adlr-autoresume-interval", type=int, default=1000,
                       help="intervals over which check for autoresume "
                            "termination signal (parity no-op)")
    return parser


def _add_biencoder_args(parser):
    """Reference arguments.py:736-775 — the ICT/REALM biencoder +
    retriever flag set.  The testing tier does not instantiate these
    models; the flags exist so reference launch scripts parse
    unchanged."""
    group = parser.add_argument_group(title="biencoder")

    # network size
    group.add_argument("--ict-head-size", type=int, default=None,
                       help="size of block embeddings to be used in "
                            "ICT and REALM")
    group.add_argument("--biencoder-projection-dim", type=int, default=0,
                       help="dimension of projection head used in "
                            "biencoder")
    group.add_argument("--biencoder-shared-query-context-model",
                       action="store_true",
                       help="whether to share the parameters of the "
                            "query and context models")

    # checkpointing
    group.add_argument("--ict-load", type=str, default=None,
                       help="directory containing an ICTBertModel "
                            "checkpoint")
    group.add_argument("--bert-load", type=str, default=None,
                       help="directory containing an BertModel "
                            "checkpoint (needed to start ICT and REALM)")

    # data
    group.add_argument("--titles-data-path", type=str, default=None,
                       help="path to titles dataset used for ICT")
    group.add_argument("--query-in-block-prob", type=float, default=0.1,
                       help="probability of keeping query in block for "
                            "ICT dataset")
    group.add_argument("--use-one-sent-docs", action="store_true",
                       help="whether to use one sentence documents in ICT")
    group.add_argument("--evidence-data-path", type=str, default=None,
                       help="path to Wikipedia evidence from DPR paper")

    # training
    group.add_argument("--retriever-report-topk-accuracies", nargs="+",
                       type=int, default=[],
                       help="which top-k accuracies to report (e.g. "
                            "'1 5 20')")
    group.add_argument("--retriever-score-scaling", action="store_true",
                       help="whether to scale retriever scores by "
                            "inverse square root of hidden size")

    # faiss index
    group.add_argument("--block-data-path", type=str, default=None,
                       help="where to save/load BlockData to/from")
    group.add_argument("--embedding-path", type=str, default=None,
                       help="where to save/load Open-Retrieval "
                            "Embedding data to/from")

    # indexer
    group.add_argument("--indexer-batch-size", type=int, default=128,
                       help="how large of batches to use when doing "
                            "indexing jobs")
    group.add_argument("--indexer-log-interval", type=int, default=1000,
                       help="after how many batches should the indexer "
                            "report progress")
    return parser


def _add_vit_args(parser):
    """Reference arguments.py:778-806 — the vision-transformer flag
    group (parse-surface parity; the testing tier's models are GPT and
    BERT)."""
    group = parser.add_argument_group(title="vit")
    group.add_argument("--num-classes", type=int, default=1000,
                       help="num of classes in vision classification task")
    group.add_argument("--img-dim", type=int, default=224,
                       help="image size for vision classification task")
    group.add_argument("--num-channels", type=int, default=3,
                       help="number of image channels")
    group.add_argument("--patch-dim", type=int, default=16,
                       help="patch dimension used in vit")
    return parser


def _add_logging_args(parser):
    group = parser.add_argument_group(title="logging")
    group.add_argument("--log-params-norm", action="store_true")
    group.add_argument("--log-num-zeros-in-grad", action="store_true")
    group.add_argument("--timing-log-level", type=int, default=0,
                       choices=range(0, 3))
    group.add_argument("--log-timers-to-tensorboard", action="store_true")
    group.add_argument("--log-memory-to-tensorboard", action="store_true")
    return parser
