"""Tensor-list utilities shared by amp and the optimizers."""

from apex_tpu_torch.utils.tree import (  # noqa: F401
    tree_cast,
    tree_global_norm,
    tree_isfinite,
    tree_select,
    tree_select_,
)

__all__ = ["tree_cast", "tree_global_norm", "tree_isfinite", "tree_select",
           "tree_select_"]
