"""apex_tpu_torch.amp — mixed-precision policies and dynamic loss scaling.

PyTorch port of the JAX package's ``apex_tpu/amp`` (reference
``apex.amp``), with its exports: :class:`Properties` and the levels
``O0``-``O3``, ``initialize`` (returns the dtype rules and a
:class:`LossScaler`, mutates nothing), the :class:`LossScaler` state
machine whose :class:`LossScaleState` lives on the device,
``scaled_value_and_grad`` / ``scale_loss`` / ``skip_or_step``, the O1
cast wrappers, and :class:`OptimWrapper`.  Beside them, ``cast_model``
casts a module in place and ``copy_masters`` writes fp32 masters back
into its half parameters (the PyTorch form of O2).  Scale, unscale, the
finite check, the skip and the scale update never read a device value
on the host.
"""

from apex_tpu_torch.amp import handle  # noqa: F401
from apex_tpu_torch.amp.handle import (  # noqa: F401
    scale_loss,
    scaled_value_and_grad,
    skip_or_step,
)
from apex_tpu_torch.amp.lists import (  # noqa: F401
    autocast_policy,
    float_function,
    half_function,
    promote_function,
)
from apex_tpu_torch.amp.opt import OptimWrapper  # noqa: F401
from apex_tpu_torch.amp.properties import (  # noqa: F401
    O0,
    O1,
    O2,
    O3,
    AmpState,
    Properties,
    cast_inputs,
    cast_model,
    copy_masters,
    initialize,
    master_params,
    o2_state_dict,
    opt_levels,
)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaler,
    LossScaleState,
    load_state_dict,
    state_dict,
)

__all__ = ["handle", "scale_loss", "scaled_value_and_grad", "skip_or_step",
           "autocast_policy", "float_function", "half_function",
           "promote_function", "OptimWrapper", "O0", "O1", "O2", "O3",
           "AmpState", "Properties", "cast_inputs", "cast_model",
           "copy_masters", "initialize", "master_params", "o2_state_dict",
           "opt_levels", "LossScaler", "LossScaleState", "load_state_dict",
           "state_dict"]
