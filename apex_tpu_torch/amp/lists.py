"""The per-op cast policy (the O1 surface).

PyTorch port of the JAX package's ``apex_tpu/amp/lists.py``.  The
reference implements O1 by patching ~150 torch functions with cast
wrappers built from white and black lists (apex/amp/lists/*.py,
wrappers in apex/amp/wrap.py); the JAX package, and this port, keep the
same lists and express the policy as explicit wrappers:

* :func:`half_function` — run in the half dtype (``FP16_FUNCS``);
* :func:`float_function` — run in fp32 (``FP32_FUNCS``);
* :func:`promote_function` — promote mixed floating args to the widest
  type (``CASTS``);

and :func:`autocast_policy` looks an op name up in the same table.
"""

from __future__ import annotations

import functools

import torch

from apex_tpu_torch.utils.tree import tree_cast

# Reference torch_overrides.py:7-27: safe and fast in half
FP16_FUNCS = [
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "conv_general_dilated", "dot", "dot_general",
    "matmul", "einsum", "mm", "bmm", "addmm", "linear", "prelu",
]

# Reference torch_overrides.py:29-84: reductions and transcendentals that
# need fp32
FP32_FUNCS = [
    "acos", "asin", "cosh", "erfinv", "exp", "expm1", "log", "log10",
    "log2", "log1p", "reciprocal", "rsqrt", "sinh", "tan", "pow",
    "softmax", "log_softmax", "cumprod", "cumsum", "dist", "mean",
    "norm", "prod", "std", "sum", "var", "renorm",
    "cross_entropy", "nll_loss", "l1_loss", "mse_loss", "smooth_l1_loss",
    "kl_div", "layer_norm", "group_norm", "batch_norm",
]

# Reference torch_overrides.py:86-111: mixed floating args promoted to
# the widest
CASTS = [
    "addcdiv", "addcmul", "atan2", "cross", "bilinear", "add", "div",
    "mul", "sub", "eq", "ge", "gt", "le", "lt", "ne", "equal", "where",
]

# Reference functional_overrides.py:70-76: refused in half
BANNED_FUNCS = ["binary_cross_entropy"]


def _cast_args(args, kwargs, dtype):
    return tree_cast(list(args), dtype), tree_cast(dict(kwargs), dtype)


def half_function(fn, half_dtype=torch.bfloat16):
    """Floating args cast to ``half_dtype`` before the call (reference
    amp.py:30-36)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args, kwargs = _cast_args(args, kwargs, half_dtype)
        return fn(*args, **kwargs)

    return wrapper


def float_function(fn):
    """Floating args cast to fp32 before the call (reference
    amp.py:39-44)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args, kwargs = _cast_args(args, kwargs, torch.float32)
        return fn(*args, **kwargs)

    return wrapper


def _floating_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _floating_leaves(t)]
    return []


def promote_function(fn):
    """Floating args promoted to their widest common dtype (reference
    wrap.py:66-94)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        leaves = _floating_leaves((args, kwargs))
        if leaves:
            widest = functools.reduce(torch.promote_types,
                                      [x.dtype for x in leaves])
            args, kwargs = _cast_args(args, kwargs, widest)
        return fn(*args, **kwargs)

    return wrapper


def autocast_policy(op_name: str):
    """``"half"``, ``"float"``, ``"promote"`` or None for a named op;
    a banned op raises ``NotImplementedError``."""
    if op_name in BANNED_FUNCS:
        raise NotImplementedError(
            f"{op_name} is banned under mixed precision (reference "
            "functional_overrides.py:70); use a fused, fp32-accumulating "
            "equivalent.")
    if op_name in FP16_FUNCS:
        return "half"
    if op_name in FP32_FUNCS:
        return "float"
    if op_name in CASTS:
        return "promote"
    return None


__all__ = ["FP16_FUNCS", "FP32_FUNCS", "CASTS", "BANNED_FUNCS",
           "half_function", "float_function", "promote_function",
           "autocast_policy"]
