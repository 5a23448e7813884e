"""Fused self and encoder-decoder multi-head attention modules (the JAX
package's ``apex_tpu.contrib.multihead_attn``)."""

from apex_tpu_torch.contrib.multihead_attn.attn import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
from apex_tpu_torch.contrib.multihead_attn.convert import (  # noqa: F401
    state_dict_from_jax,
)

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn", "state_dict_from_jax"]
