"""Operators of the serving path: flash attention (prefill) and paged
decode attention, each a CUDA kernel for CUDA tensors and a plain
PyTorch version for CPU tensors."""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    _blockwise_fwd,
    _paged_attention,
    flash_attention,
    flash_attention_fwd,
    flash_decode,
)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_decode",
           "_blockwise_fwd", "_paged_attention"]
