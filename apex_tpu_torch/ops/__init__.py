"""Operators of the ported paths, each a CUDA kernel for CUDA tensors and a
plain PyTorch version for CPU tensors: flash attention with its backward
(prefill, the multi-head attention modules, varlen), paged decode
attention, packed-QKV self-attention with its backward (training) and
LayerNorm; plus ops that are plain PyTorch on both, as the JAX package's
are XLA formulations (no Pallas kernel): ring attention over a group of
ranks, the fused LM-head cross-entropy,
the fused scaled masked softmax, the softmax cross-entropy with label
smoothing, the fused dense layers and the MLP."""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    _blockwise_bwd,
    _blockwise_fwd,
    _paged_attention,
    flash_attention,
    flash_attention_fwd,
    flash_attention_qkv,
    flash_attention_qkv_route,
    flash_attention_route,
    flash_attention_varlen,
    flash_decode,
    flash_decode_route,
    ring_attention,
    routing_override,
)
from apex_tpu_torch.ops.fused_dense import (  # noqa: F401
    FusedDense,
    FusedDenseGeluDense,
    fused_dense,
    fused_dense_gelu_dense,
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
from apex_tpu_torch.ops.fused_softmax import (  # noqa: F401
    AttnMaskType,
    FusedScaleMaskSoftmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.ops.mlp import MLP, mlp  # noqa: F401
from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)

__all__ = ["flash_attention_route", "flash_attention_qkv_route",
           "flash_decode_route", "routing_override", "flash_attention", "flash_attention_fwd", "flash_attention_qkv",
           "flash_attention_varlen", "flash_decode", "ring_attention", "layer_norm", "rms_norm", "FusedLayerNorm",
           "MixedFusedLayerNorm", "FastLayerNorm", "fast_layer_norm",
           "fused_linear_cross_entropy", "_blockwise_fwd", "_blockwise_bwd",
           "_paged_attention", "AttnMaskType", "FusedScaleMaskSoftmax",
           "scaled_masked_softmax", "scaled_softmax",
           "scaled_upper_triang_masked_softmax", "FusedDense",
           "FusedDenseGeluDense", "fused_dense", "fused_dense_gelu_dense",
           "MLP", "mlp", "SoftmaxCrossEntropyLoss",
           "softmax_cross_entropy_loss"]
