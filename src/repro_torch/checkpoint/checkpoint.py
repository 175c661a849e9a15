"""Checkpointing: trees saved as .npz keyed by flattened tree paths, as
:mod:`repro.checkpoint.checkpoint` writes them.

The format is the JAX package's, key for key, so a checkpoint crosses
between the packages in both directions:

* a leaf's key is its path joined with ``::`` — dict keys, list / tuple
  indices, and ``.name`` for a named tuple's field (``params::w``,
  ``opt_state::.step``, ``opt_state::.wire::0::0``);
  :func:`~repro_torch.utils.tree.tree_flatten_with_path` walks the tree in
  JAX's order;
* bfloat16 and float8 leaves (no numpy dtype) are stored as their raw
  ``uint8`` bytes, which doubles a bfloat16 leaf's last axis;
* a Python int leaf (the port's ``OptState.step``) is stored as a 0-d
  int32 array, as the JAX package's ``step`` is, and read back as an int.

:func:`save_train_state` / :func:`restore_train_state` checkpoint the FULL
collaborative state — params plus the whole ``OptState``: the optimizer's
``inner`` state, the overlap ``wire`` (a :class:`~repro_torch.core.
consensus.WireRing` on the fault path), the error-feedback ``residual``
and the rank compressor's ``qwarm`` — so a resumed run continues bit for
bit.  Restore validates against a template of the same configuration: a
missing key raises ``KeyError``, a shape mismatch ``ValueError``.  Leaves
are restored onto the template leaf's device and dtype.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import (
    tree_flatten,
    tree_flatten_with_path,
    tree_unflatten,
)

PyTree = Any

_SEP = "::"
#: dtypes numpy cannot hold: stored as raw bytes (JAX's ml_dtypes leaves)
_RAW = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _path_str(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        return (t.view(torch.uint8) if t.dtype in _RAW else t).numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like, key: str):
    """``arr`` as a leaf shaped, typed and placed like the template ``like``."""
    if isinstance(like, torch.Tensor):
        if like.dtype in _RAW and arr.dtype == np.uint8:
            t = torch.from_numpy(arr.copy()).view(like.dtype)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"expected {tuple(like.shape)}")
        return t.to(dtype=like.dtype, device=like.device)
    if arr.shape != np.shape(like):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected "
                         f"{np.shape(like)}")
    return type(like)(arr.item()) if np.ndim(like) == 0 else arr


def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    """Writes ``<dir>/ckpt_<step>.npz``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {_path_str(path): _to_numpy(leaf)
              for path, leaf in tree_flatten_with_path(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for f in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def save_train_state(directory: str, step: int, params: PyTree,
                     opt_state: Any) -> str:
    """Checkpoint params + the full optimizer state (momenta, step counter,
    overlap wire buffers, error-feedback residuals) as one tree."""
    return save_checkpoint(directory, step,
                           {"params": params, "opt_state": opt_state})


def restore_train_state(directory: str, params_like: PyTree,
                        opt_state_like: Any, step: Optional[int] = None):
    """Restore ``(params, opt_state)`` into the given template structures.

    ``opt_state_like`` must come from the SAME step-program configuration
    (``StepProgram.init_state``, e.g. a fresh trainer's state) so the
    wire / residual buffers exist in the template; a checkpoint written
    without them (or with a different schedule / strategy) fails loudly
    instead of silently resetting state.
    """
    tree = restore_checkpoint(directory,
                              {"params": params_like,
                               "opt_state": opt_state_like}, step=step)
    return tree["params"], tree["opt_state"]


def restore_checkpoint(directory: str, like: PyTree,
                       step: Optional[int] = None) -> PyTree:
    """Restore into the structure of ``like`` (shapes / dtypes validated,
    leaves on the template leaves' devices)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    _, treedef = tree_flatten(like)
    leaves = []
    with np.load(path) as data:
        for p, ref in tree_flatten_with_path(like):
            k = _path_str(p)
            if k not in data:
                raise KeyError(f"checkpoint {path} missing key {k!r}")
            leaves.append(_from_numpy(data[k], ref, k))
    return tree_unflatten(treedef, leaves)
