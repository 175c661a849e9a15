"""Parameter-tree helpers over nested dicts / lists / tuples of tensors.

The port keeps parameters as plain nested dicts of tensors.  Every walk
over them uses JAX's leaf order — dict keys **sorted**, lists and tuples in
position order — so packed flat buffers line up bit for bit with the JAX
package's (``"h10"`` comes before ``"h2"``; Python insertion order would
not).  ``None`` is an empty node, as in JAX, and a named tuple (a wire
entry such as ``TopKWire``) keeps its type.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

PyTree = Any

_LEAF = ("leaf",)
_NONE = ("none",)


def tree_flatten(tree: PyTree) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)``; ``treedef`` is a hashable nested tuple."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = type(t) if hasattr(t, "_fields") else type(t).__name__
            return (kind, tuple(walk(x) for x in t))
        if t is None:
            return _NONE
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: tuple, leaves) -> PyTree:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        if isinstance(kind, type):
            return kind._make(children)
        return children if kind == "list" else tuple(children)

    out = build(treedef)
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
