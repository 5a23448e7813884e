"""PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper (sm_90a).

A package of its own beside the JAX package, which stays the reference:
the port imports ``torch`` and never ``jax`` or ``apex_tpu``.  Every
kernel that the JAX package wrote in Pallas for the TPU becomes a kernel
written by hand for Hopper (``csrc/``, built with ``nvcc`` at first use);
the code around the kernels is plain PyTorch.  Entry points run on the
card unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.

Ported so far — the serving path, the GPT training step, the contrib
multi-head attention training path and the flat superblock optimizer:

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
  one card.

What is still to port, in order, is in ROADMAP.md.
"""

__all__ = ["contrib", "examples", "kernels", "multi_tensor", "ops",
           "optimizers", "serving", "transformer"]
