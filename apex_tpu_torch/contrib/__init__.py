"""Optional extensions (the JAX package's ``apex_tpu.contrib``).  Ported
so far: :mod:`~apex_tpu_torch.contrib.multihead_attn`, the ZeRO
optimizers of :mod:`~apex_tpu_torch.contrib.optimizers`, and on one card
:mod:`~apex_tpu_torch.contrib.groupbn`,
:mod:`~apex_tpu_torch.contrib.bottleneck`,
:mod:`~apex_tpu_torch.contrib.transducer` and
:mod:`~apex_tpu_torch.contrib.sparsity`."""

__all__ = ["bottleneck", "groupbn", "multihead_attn", "optimizers",
           "sparsity", "transducer"]
