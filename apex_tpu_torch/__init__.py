"""PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper (sm_90a).

A package of its own beside the JAX package, which stays the reference:
the port imports ``torch`` and never ``jax`` or ``apex_tpu``.  Every
kernel that the JAX package wrote in Pallas for the TPU becomes a kernel
written by hand for Hopper (``csrc/``, built with ``nvcc`` at first use);
the code around the kernels is plain PyTorch.  Entry points run on the
card unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.

Ported so far — the serving path:

* :mod:`apex_tpu_torch.ops` — ``flash_attention`` (prefill) and
  ``flash_decode`` (paged decode);
* :mod:`apex_tpu_torch.serving` — the paged KV pool, the decoder model,
  the continuous-batching scheduler and ``ServingEngine``.

What is still to port, in order, is in ROADMAP.md.
"""

__all__ = ["kernels", "ops", "serving"]
