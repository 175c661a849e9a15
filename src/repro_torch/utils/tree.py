"""Parameter-tree helpers over nested dicts / lists / tuples of tensors.

The port keeps parameters as plain nested dicts of tensors.  Every walk
over them uses JAX's leaf order — dict keys **sorted**, lists and tuples in
position order — so packed flat buffers line up bit for bit with the JAX
package's (``"h10"`` comes before ``"h2"``; Python insertion order would
not).  ``None`` is an empty node, as in JAX, and a named tuple (a wire
entry such as ``TopKWire``) keeps its type.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

PyTree = Any

_LEAF = ("leaf",)
_NONE = ("none",)


# The walks below are module-level functions that take their accumulator
# as an argument.  A recursive closure refers to itself through its own
# cell, a reference cycle that holds the leaves it gathered (views of whole
# parameter buckets) until Python's cyclic collector runs, steps later.

def _flatten(t, leaves: List[Any]) -> tuple:
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_flatten(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        kind = type(t) if hasattr(t, "_fields") else type(t).__name__
        return (kind, tuple(_flatten(x, leaves) for x in t))
    if t is None:
        return _NONE
    leaves.append(t)
    return _LEAF


def tree_flatten(tree: PyTree) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)``; ``treedef`` is a hashable nested tuple."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _build(d: tuple, it) -> PyTree:
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    children = [_build(c, it) for c in d[1]]
    if isinstance(kind, type):
        return kind._make(children)
    return children if kind == "list" else tuple(children)


def tree_unflatten(treedef: tuple, leaves) -> PyTree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def _with_path(t, path: tuple, out: List[Tuple[tuple, Any]]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _with_path(t[k], path + (k,), out)
    elif isinstance(t, (list, tuple)):
        names = getattr(t, "_fields", None)
        for i, x in enumerate(t):
            _with_path(x, path + ((f".{names[i]}" if names else i),), out)
    elif t is not None:
        out.append((path, t))


def tree_flatten_with_path(tree: PyTree) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf)]`` in :func:`tree_flatten`'s order.  A path entry is
    a dict key, a list / tuple index, or ``".name"`` for a named tuple's
    field (``str`` of JAX's ``GetAttrKey``)."""
    out: List[Tuple[tuple, Any]] = []
    _with_path(tree, (), out)
    return out


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(s, tree: PyTree) -> PyTree:
    return tree_map(lambda x: s * x, tree)


def tree_axpy(a, x: PyTree, y: PyTree) -> PyTree:
    """``a * x + y``, leaf-wise."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def tree_weighted_sum(weights: Sequence, trees: Sequence[PyTree]) -> PyTree:
    """``sum_i weights[i] * trees[i]``, leaf-wise, in ``i`` order: one row
    of ``(Pi x)_j = sum_l pi_jl x_l`` (paper eq. 5)."""
    if len(weights) != len(trees):
        raise ValueError(f"{len(weights)} weights vs {len(trees)} trees")

    def leaf(*leaves):
        acc = weights[0] * leaves[0]
        for w, x in zip(weights[1:], leaves[1:]):
            acc = acc + w * x
        return acc

    return tree_map(leaf, *trees)


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Inner product over all leaves, in float32 (one sum per leaf, then
    the sum of those)."""
    sums = [torch.sum(x.float() * y.float())
            for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.sum(torch.stack(sums)) if sums else torch.tensor(0.0)


def tree_l2_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_dot(tree, tree))


def tree_cast(tree: PyTree, dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_size(tree: PyTree) -> int:
    """Total number of scalar parameters."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
