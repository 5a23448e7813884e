"""PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper (sm_90a).

A package of its own beside the JAX package, which stays the reference:
the port imports ``torch`` and never ``jax`` or ``apex_tpu``.  Every
kernel that the JAX package wrote in Pallas for the TPU becomes a kernel
written by hand for Hopper (``csrc/``, built with ``nvcc`` at first use);
the code around the kernels is plain PyTorch.  Entry points run on the
card unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.

Ported so far — the serving path, the GPT training step, the contrib
multi-head attention training path, the flat superblock optimizer, the
bench's roofs, floor and kernel microbenches, and the one-card model
families of the ImageNet, DCGAN, RNN and RNN-T workloads:

* :mod:`apex_tpu_torch.ops` — ``flash_attention`` with its backward
  (prefill, the attention modules) and ``flash_attention_varlen``,
  ``flash_decode`` (paged decode), ``flash_attention_qkv`` (packed
  self-attention with its backward), ``layer_norm``, and the fused LM-head
  cross-entropy;
* :mod:`apex_tpu_torch.contrib.multihead_attn` — ``SelfMultiheadAttn``
  and ``EncdecMultiheadAttn``;
* :mod:`apex_tpu_torch.serving` — the paged KV pool, the decoder model,
  the continuous-batching scheduler and ``ServingEngine``;
* :mod:`apex_tpu_torch.transformer` — the tensor-parallel layers at tp=1
  and the standalone GPT (``transformer.testing``);
* :mod:`apex_tpu_torch.optimizers`, :mod:`apex_tpu_torch.multi_tensor` —
  ``FusedAdam``, ``FlatFusedAdam`` over one flat superblock, the
  superblock's pack/unpack and bucket planner, global-norm clipping and
  the multi-tensor ops;
* :mod:`apex_tpu_torch.examples.gpt.pretrain_gpt` — GPT pretraining on
  one card;
* :mod:`apex_tpu_torch.models`, :mod:`apex_tpu_torch.parallel` —
  ResNet (NHWC, cuDNN convolutions) over SyncBatchNorm, its statistics
  over a group of ranks; :mod:`apex_tpu_torch.examples.imagenet.main_amp`
  (data-parallel at ``--n-devices N``) and
  :mod:`apex_tpu_torch.examples.dcgan.main_amp` train them under amp;
* :mod:`apex_tpu_torch.contrib` ``groupbn``, ``bottleneck``,
  ``transducer`` (the RNN-T joint and loss), ``sparsity`` (ASP),
  :mod:`apex_tpu_torch.rnn`, :mod:`apex_tpu_torch.reparameterization` and
  :mod:`apex_tpu_torch.fp16_utils`;
* :mod:`apex_tpu_torch.profiling` — CUDA-event timers, the HBM roof
  (``hbm_copy``), the matmul roof, the attention dot floor
  (``attention_dots``) and the kernel microbenches, on the card only.

What is still to port, in order, is in ROADMAP.md.
"""

__all__ = ["contrib", "examples", "fp16_utils", "kernels", "models",
           "multi_tensor", "ops", "optimizers", "parallel", "profiling",
           "reparameterization", "rnn", "serving", "transformer"]
