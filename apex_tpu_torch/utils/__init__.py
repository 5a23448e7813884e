"""Tensor-list utilities shared by amp and the optimizers, and the
rank-aware logger."""

from apex_tpu_torch.utils.logging import (  # noqa: F401
    RankInfoFormatter,
    get_logger,
)
from apex_tpu_torch.utils.tree import (  # noqa: F401
    tree_cast,
    tree_global_norm,
    tree_isfinite,
    tree_select,
    tree_select_,
    tree_size,
    tree_zeros_like,
)

__all__ = ["RankInfoFormatter", "get_logger", "tree_cast", "tree_global_norm",
           "tree_isfinite", "tree_select", "tree_select_", "tree_size",
           "tree_zeros_like"]
