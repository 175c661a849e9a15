"""Sharding resolution of the sharded mode: logical axes to the agent axis.

The agent-axis part of :mod:`repro.launch.sharding`.  In ``train`` mode
every agent is one rank of the :class:`~repro_torch.launch.mesh.AgentMesh`
(the reference's ``data`` axis, or ``pod x data`` on a factored mesh):
params carry a leading ``agent`` axis sharded there, and every other
logical axis replicates.  The reference's
non-agent axes (``tp`` / ``expert`` over ``model``, ``fsdp`` over ``data``
in ``train_hier``) and the ``serve`` mode are ROADMAP A16.2 and raise.

A rank holds slice ``rank`` of every agent-stacked tensor: its params
(the template without the agent axis) and its batch
(:func:`local_batch` of what :func:`repro_torch.data.lm_agent_batches`
makes, plus a frontend model's stub embeddings).  A frontend model's
sequence budget goes first to its stub embeddings (the reference's
``min(frontend_tokens, seq // 2)``), the rest to text.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import AGENT_AXIS, POD_AXIS
from repro_torch.nn.param import (MODEL_AXIS_ITEM, ParamDef, PartitionSpec,
                                  partition_specs)
from repro_torch.utils.tree import tree_map

MODES = ("train", "train_hier", "serve")


def rules_for_mode(mode: str, mesh) -> Dict[str, Any]:
    """Logical axis -> mesh axes.  ``train``: the agents on ``("data",)``,
    or ``("pod", "data")`` when the mesh has a ``pod`` axis (the
    reference's multi-pod rule), every other logical axis replicated.
    ``train_hier`` and ``serve`` shard model weights over non-agent axes:
    ROADMAP A16.2."""
    if mode == "train":
        agent = ((POD_AXIS, AGENT_AXIS) if POD_AXIS in mesh.shape
                 else (AGENT_AXIS,))
        return {"agent": agent, "tp": None, "expert": None, "fsdp": None}
    if mode in ("train_hier", "serve"):
        raise NotImplementedError(
            f"mode {mode!r} shards weights over non-agent mesh axes "
            f"(fsdp / model): {MODEL_AXIS_ITEM}")
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    return math.prod(mesh.shape[a] for a in entry)


def agent_count(mesh, mode: str) -> int:
    rules = rules_for_mode(mode, mesh)
    if "agent" not in rules:
        return 1
    return _axes_size(mesh, rules["agent"])


def safe_partition_specs(template, rules: Dict[str, Any], mesh):
    """:func:`~repro_torch.nn.param.partition_specs` with the reference's
    divisibility fallback: a dimension whose size does not divide its mesh
    axes replicates."""

    def leaf(pd: ParamDef, spec: PartitionSpec) -> PartitionSpec:
        resolved = [m if m is None or dim % _axes_size(mesh, m) == 0 else None
                    for dim, m in zip(pd.shape, spec.axes)]
        while resolved and resolved[-1] is None:
            resolved.pop()
        return PartitionSpec(tuple(resolved))

    return tree_map(leaf, template, partition_specs(template, rules))


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The global (agent-stacked) shape, dtype and per-dimension mesh axes
    of one batch leaf; a rank holds ``shape[1:]``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: PartitionSpec


def _frontend_budget(cfg: ArchConfig, seq: int) -> Tuple[int, int]:
    """``(frontend tokens, text tokens)`` of a ``seq``-token budget: a
    frontend model spends ``min(frontend_tokens, seq // 2)`` on its stub
    embeddings and the rest on text (an encoder-decoder's text keeps all)."""
    front = 0
    if cfg.modality in ("audio", "vlm"):
        front = min(cfg.frontend_tokens, seq // 2)
        if not cfg.is_encoder_decoder:
            seq = seq - front
    return front, seq


def train_batch_specs(cfg: ArchConfig, shape: InputShape, mesh, mode: str):
    """Per-agent stacked batch ``{"inputs", "targets"[, "frontend"]}``:
    ``(agents, global_batch / agents, text)`` int32 and a frontend model's
    ``(agents, global_batch / agents, front, frontend_dim)`` bfloat16 stub
    embeddings (:func:`_frontend_budget`), the agent dimension sharded."""
    rules = rules_for_mode(mode, mesh)
    a = agent_count(mesh, mode)
    if shape.global_batch % a:
        raise ValueError(f"global_batch {shape.global_batch} not divisible by "
                         f"{a} agents")
    b_local = shape.global_batch // a
    front, seq = _frontend_budget(cfg, shape.seq_len)
    spec = PartitionSpec((rules["agent"], None, None))
    dims = (a, b_local, seq)
    out = {"inputs": TensorSpec(dims, torch.int32, spec),
           "targets": TensorSpec(dims, torch.int32, spec)}
    if front:
        out["frontend"] = TensorSpec((a, b_local, front, cfg.frontend_dim),
                                     torch.bfloat16,
                                     PartitionSpec((rules["agent"], None, None, None)))
    return out


def serve_batch_count(shape: InputShape, mesh) -> Tuple[int, Any]:
    """``(batch, batch mesh axes)`` of serving: the batch over every agent
    axis when it divides, else over ``data``, else replicated."""
    axes = [a for a in (POD_AXIS, AGENT_AXIS) if a in mesh.shape]
    b = shape.global_batch
    if b % math.prod(mesh.shape[a] for a in axes) == 0:
        return b, tuple(axes)
    if b % mesh.shape[AGENT_AXIS] == 0:
        return b, (AGENT_AXIS,)
    return b, None


def prefill_batch_specs(cfg: ArchConfig, shape: InputShape, mesh):
    """Prefill batch ``{"inputs", "targets"[, "frontend"]}``: ``(b, text)``
    int32 and a frontend model's ``(b, front, frontend_dim)`` bfloat16, the
    batch over :func:`serve_batch_count`'s axes."""
    b, b_ax = serve_batch_count(shape, mesh)
    front, seq = _frontend_budget(cfg, shape.seq_len)
    spec = PartitionSpec((b_ax, None))
    out = {"inputs": TensorSpec((b, seq), torch.int32, spec),
           "targets": TensorSpec((b, seq), torch.int32, spec)}
    if front:
        out["frontend"] = TensorSpec((b, front, cfg.frontend_dim), torch.bfloat16,
                                     PartitionSpec((b_ax, None, None)))
    return out


def local_batch(batch: Dict[str, Any], mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of an agent-stacked batch (numpy or tensors), on
    the rank's device."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] != mesh.size:
            raise ValueError(f"batch leaf {k!r} has {v.shape[0]} agents, the "
                             f"mesh {mesh.size}")
        row = v[mesh.rank]
        out[k] = torch.as_tensor(np.ascontiguousarray(row)
                                 if isinstance(row, np.ndarray) else row,
                                 device=mesh.device)
    return out
