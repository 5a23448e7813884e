"""The bottleneck block (the JAX package's ``apex_tpu.contrib.bottleneck``)
and its spatial form, H sharded over a group of ranks."""

from apex_tpu_torch.contrib.bottleneck.bottleneck import (
    Bottleneck,
    SpatialBottleneck,
    bottleneck_state_dict_from_jax,
    halo_exchange,
    spatial_conv2d,
)

__all__ = ["Bottleneck", "SpatialBottleneck", "bottleneck_state_dict_from_jax",
           "halo_exchange", "spatial_conv2d"]
