"""Optional extensions (the JAX package's ``apex_tpu.contrib``).  Ported
so far: :mod:`apex_tpu_torch.contrib.multihead_attn`."""

__all__ = ["multihead_attn"]
