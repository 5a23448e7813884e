"""Operators of the ported paths, each a CUDA kernel for CUDA tensors and a
plain PyTorch version for CPU tensors: flash attention with its backward
(prefill, the multi-head attention modules, varlen), paged decode
attention, packed-QKV self-attention with its backward (training) and
LayerNorm; plus the fused LM-head cross-entropy, which is plain PyTorch on
both."""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    _blockwise_bwd,
    _blockwise_fwd,
    _paged_attention,
    flash_attention,
    flash_attention_fwd,
    flash_attention_qkv,
    flash_attention_varlen,
    flash_decode,
)
from apex_tpu_torch.ops.fused_layer_norm import (  # noqa: F401
    FastLayerNorm,
    FusedLayerNorm,
    MixedFusedLayerNorm,
    fast_layer_norm,
    layer_norm,
    rms_norm,
)
from apex_tpu_torch.ops.fused_linear_xent import (  # noqa: F401
    fused_linear_cross_entropy,
)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_qkv",
           "flash_attention_varlen", "flash_decode", "layer_norm", "rms_norm", "FusedLayerNorm",
           "MixedFusedLayerNorm", "FastLayerNorm", "fast_layer_norm",
           "fused_linear_cross_entropy", "_blockwise_fwd", "_blockwise_bwd",
           "_paged_attention"]
