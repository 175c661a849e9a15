"""Tree helpers and metric logging."""

from repro_torch.utils.metrics import MetricHistory
from repro_torch.utils.tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zeros_like,
)

__all__ = ["MetricHistory", "tree_flatten", "tree_leaves", "tree_map",
           "tree_unflatten", "tree_zeros_like"]
