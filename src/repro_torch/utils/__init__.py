"""Tree helpers and metric logging."""

from repro_torch.utils.metrics import CSVLogger, MetricHistory
from repro_torch.utils.tree import (
    tree_add,
    tree_axpy,
    tree_bytes,
    tree_cast,
    tree_dot,
    tree_flatten,
    tree_flatten_with_path,
    tree_l2_norm,
    tree_leaves,
    tree_map,
    tree_scale,
    tree_size,
    tree_sub,
    tree_unflatten,
    tree_weighted_sum,
    tree_zeros_like,
)

__all__ = ["CSVLogger", "MetricHistory", "tree_add", "tree_axpy",
           "tree_bytes", "tree_cast", "tree_dot", "tree_flatten",
           "tree_flatten_with_path", "tree_l2_norm", "tree_leaves", "tree_map",
           "tree_scale", "tree_size", "tree_sub", "tree_unflatten",
           "tree_weighted_sum", "tree_zeros_like"]
