"""Opt levels, their properties, and ``initialize``.

PyTorch port of the JAX package's ``apex_tpu/amp/properties.py``
(reference apex/amp/frontend.py): the knobs of :class:`Properties`, the
levels O0-O3, user overrides and ``initialize``, which hands back an
:class:`AmpState` (the dtype rules and a :class:`LossScaler`) and
mutates nothing.

========  ===============  ==============  ==============  ==========
level     cast_model_type  per-op casts    master weights  loss scale
========  ===============  ==============  ==============  ==========
O0        fp32             no              no              1.0
O1        none             yes             no              dynamic
O2        half             no              yes             dynamic
O3        half             no              no              1.0
========  ===============  ==============  ==============  ==========

``half_dtype`` is bfloat16 by default, as in the JAX package; float16 is
the reference's half and the type dynamic loss scaling exists for.

The PyTorch idiom of O2 (:meth:`AmpState.cast_model` on a module): the
module's parameters are cast in place to the half dtype, the norms'
kept fp32 by the JAX package's name rule (:func:`_is_bn_path` on the
dot-split ``named_parameters`` names); the optimizer steps fp32 masters
(:meth:`AmpState.master_params`), and :func:`copy_masters` writes them
back into the half parameters after each step.  Numerically that is the
JAX package's ``cast_model`` of an fp32 master tree every step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.utils.tree import tree_cast

# Path components treated as normalisation parameters that stay fp32
# under keep_batchnorm_fp32 (the JAX package's list; the reference keys
# off module type)
_BN_NAME_HINTS = ("batchnorm", "batch_norm", "bn", "norm", "layernorm",
                  "layer_norm", "ln")


@dataclasses.dataclass(frozen=True)
class Properties:
    """The amp option set (reference frontend.py:7-97), ``half_dtype``
    beside it."""

    opt_level: str = "O0"
    cast_model_type: Optional[Any] = None
    per_op_cast: bool = False  # reference name: patch_torch_functions (O1)
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Union[float, str] = 1.0
    half_dtype: Any = torch.bfloat16

    def with_overrides(self, **kwargs) -> "Properties":
        """User overrides on top of the level's defaults (reference
        frontend.py:336-352); ``cast_model_type="half"`` means
        ``half_dtype``."""
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        if kwargs.get("cast_model_type") == "half":
            kwargs["cast_model_type"] = self.half_dtype
        return dataclasses.replace(self, **kwargs)


def _level(opt_level: str, half) -> Properties:
    if opt_level == "O0":
        return Properties("O0", torch.float32, False, False, False, 1.0, half)
    if opt_level == "O1":
        return Properties("O1", None, True, None, False, "dynamic", half)
    if opt_level == "O2":
        return Properties("O2", half, False, True, True, "dynamic", half)
    if opt_level == "O3":
        return Properties("O3", half, False, False, False, 1.0, half)
    raise ValueError(f"Unexpected optimization level {opt_level}")


O0 = _level("O0", torch.bfloat16)
O1 = _level("O1", torch.bfloat16)
O2 = _level("O2", torch.bfloat16)
O3 = _level("O3", torch.bfloat16)
opt_levels = {"O0": O0, "O1": O1, "O2": O2, "O3": O3}


def _is_bn_path(path: Sequence) -> bool:
    """The JAX package's rule, over a parameter's path components (a
    dot-split ``named_parameters`` name, or dict keys): a component that
    is a hint, holds one as an ``_``-separated word, or starts with
    one."""
    for p in path:
        name = str(p).lower()
        if any(h == name or h in name.split("_") or name.startswith(h)
               for h in _BN_NAME_HINTS):
            return True
    return False


def _split(name) -> tuple:
    return tuple(name.split(".")) if isinstance(name, str) else tuple(name)


def cast_model(model, props: Properties, *,
               bn_predicate: Callable = _is_bn_path):
    """Cast to the model's compute dtype (``convert_network`` with
    keep-BN-fp32, reference _initialize.py:176-182).  An ``nn.Module``
    is cast in place (each floating parameter and buffer; the norms
    fp32 under ``keep_batchnorm_fp32``) and returned; a dict of tensors
    (a ``state_dict``) comes back cast, the input untouched."""
    if props.cast_model_type is None:
        return model
    target = props.cast_model_type

    def dtype_of(path) -> torch.dtype:
        if props.keep_batchnorm_fp32 and bn_predicate(path):
            return torch.float32
        return target

    if isinstance(model, nn.Module):
        with torch.no_grad():
            for name, t in list(model.named_parameters()) + list(
                    model.named_buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(dtype_of(_split(name)))
        return model
    return {name: (t.to(dtype_of(_split(name))) if t.is_floating_point()
                   else t) for name, t in model.items()}


def cast_inputs(batch, props: Properties):
    """Floating inputs cast to the compute dtype (the reference patches
    ``model.forward`` for this, _initialize.py:190-201)."""
    if props.cast_model_type is None or props.cast_model_type == torch.float32:
        return batch
    return tree_cast(batch, props.cast_model_type)


def master_params(params, props: Properties) -> List[torch.Tensor]:
    """What the optimizer steps: with master weights, an fp32 copy of
    each parameter (a new leaf; take it BEFORE :func:`cast_model`, from
    the fp32 model), else the parameters themselves.  ``params``: a
    module or an iterable of tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    params = list(params)
    if not props.master_weights:
        return params
    return [p.detach().float().clone().requires_grad_(p.requires_grad)
            for p in params]


@torch.no_grad()
def copy_masters(model_params: Sequence[torch.Tensor],
                 masters: Sequence[torch.Tensor]) -> None:
    """Each master rounded into its model parameter (``(master).to(p.dtype)``,
    round to nearest even), one fused copy over the list.  A skipped step
    left the masters bitwise as they were, and so the copy leaves the
    parameters."""
    pairs = [(p, m) for p, m in zip(model_params, masters) if p is not m]
    if pairs:
        torch._foreach_copy_([p for p, _ in pairs], [m for _, m in pairs])


def o2_state_dict(params) -> dict:
    """A (possibly half) ``state_dict`` in fp32 for checkpointing
    (reference ``O2StateDictHook``, _initialize.py:133-142)."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    return tree_cast(dict(params), torch.float32)


@dataclasses.dataclass(frozen=True)
class AmpState:
    """What ``initialize`` hands back: dtype rules and a loss scaler."""

    props: Properties
    scaler: LossScaler

    def cast_model(self, model, **kw):
        return cast_model(model, self.props, **kw)

    def cast_inputs(self, batch):
        return cast_inputs(batch, self.props)

    def master_params(self, params) -> List[torch.Tensor]:
        return master_params(params, self.props)


def initialize(opt_level: str = "O1", *, half_dtype=torch.bfloat16,
               cast_model_type=None, keep_batchnorm_fp32=None,
               master_weights=None, loss_scale=None, min_loss_scale=None,
               max_loss_scale=2.0 ** 24) -> AmpState:
    """An :class:`AmpState` from an opt level and overrides (reference
    frontend.py:195-352), the JAX package's ``initialize``: apply
    ``cast_model``/``master_params`` yourself and carry
    ``scaler.init(device)`` beside the model."""
    if opt_level not in opt_levels:
        raise ValueError(f"Unexpected optimization level {opt_level}. "
                         "Options are 'O0', 'O1', 'O2', 'O3'.")
    props = _level(opt_level, half_dtype).with_overrides(
        cast_model_type=cast_model_type,
        keep_batchnorm_fp32=keep_batchnorm_fp32,
        master_weights=master_weights, loss_scale=loss_scale)
    if props.loss_scale == "dynamic":
        scaler = LossScaler.dynamic_scaler(
            min_scale=1.0 if min_loss_scale is None else min_loss_scale,
            max_scale=max_loss_scale)
    else:
        scaler = LossScaler.static(float(props.loss_scale))
    return AmpState(props=props, scaler=scaler)


__all__ = ["Properties", "O0", "O1", "O2", "O3", "opt_levels", "cast_model",
           "cast_inputs", "master_params", "copy_masters", "o2_state_dict",
           "AmpState", "initialize"]
