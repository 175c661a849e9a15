"""Sharding resolution of the sharded mode: logical axes to mesh axes,
with the reference's divisibility guards (:mod:`repro.launch.sharding`).

Rules by execution mode (axis names are the process mesh's,
:class:`~repro_torch.launch.mesh.AgentMesh`):

* ``train`` (paper-faithful CDSGD): every agent is one slice of the agent
  axes (``data``, or ``pod x data``); params carry a leading ``agent``
  axis sharded there; ``tp`` and ``expert`` dims shard over ``model``,
  ``fsdp`` dims replicate.  The port trains the dense family's ``tp`` dims
  over ``model`` (:func:`repro_torch.launch.steps.build_train_step`); the
  other families and MoE's ``expert`` split raise on a ``model`` axis of
  more than one rank (ROADMAP A16.2.3).
* ``train_hier``: agents on ``pod`` only, ``fsdp`` over ``data`` (on a
  single pod the agents stay on ``data`` and ``fsdp`` replicates).  Its
  step raises (ROADMAP A16.2.2).
* ``serve``: no agent axis; ``fsdp`` dims over ``data``, ``tp`` /
  ``expert`` over ``model``.

A logical dim is sharded only if its size divides its mesh axes' rank
count, and only over axes the mesh has; otherwise it replicates (e.g.
granite's 49155-token vocabulary on the ``model`` axis).

A rank holds its agent's slice of every agent-stacked tensor in training
(:func:`local_batch` of what :func:`repro_torch.data.lm_agent_batches`
makes, plus a frontend model's stub embeddings; the agent's blocks of its
params, :func:`repro_torch.nn.param.local_shard` with ``stacked=True``),
and in serving its block
of every param, cache and input leaf
(:func:`repro_torch.nn.param.local_shard`, :func:`local_cache`).  A
frontend model's sequence budget goes first to its stub embeddings (the
reference's ``min(frontend_tokens, seq // 2)``), the rest to text.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import AGENT_AXIS, MODEL_AXIS, POD_AXIS
from repro_torch.nn.param import (ParamDef, PartitionSpec, local_zeros,
                                  partition_specs)
from repro_torch.nn.transformer import init_cache
from repro_torch.utils.tree import (tree_flatten, tree_flatten_with_path, tree_map,
                                    tree_unflatten)

MODES = ("train", "train_hier", "serve")


def rules_for_mode(mode: str, mesh) -> Dict[str, Any]:
    """Logical axis -> mesh axes of ``mode`` (the reference's rules)."""
    multi_pod = POD_AXIS in mesh.shape
    if mode == "train":
        agent = (POD_AXIS, AGENT_AXIS) if multi_pod else (AGENT_AXIS,)
        return {"agent": agent, "tp": MODEL_AXIS, "expert": MODEL_AXIS,
                "fsdp": None}
    if mode == "train_hier":
        if not multi_pod:
            # single pod: the agents keep the data axis, fsdp replicates
            return {"agent": (AGENT_AXIS,), "tp": MODEL_AXIS,
                    "expert": MODEL_AXIS, "fsdp": None}
        return {"agent": (POD_AXIS,), "tp": MODEL_AXIS, "expert": MODEL_AXIS,
                "fsdp": AGENT_AXIS}
    if mode == "serve":
        return {"tp": MODEL_AXIS, "expert": MODEL_AXIS, "fsdp": AGENT_AXIS}
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def agent_count(mesh, mode: str) -> int:
    rules = rules_for_mode(mode, mesh)
    if "agent" not in rules:
        return 1
    return mesh.entry_size(rules["agent"])


def safe_partition_specs(template, rules: Dict[str, Any], mesh):
    """:func:`~repro_torch.nn.param.partition_specs` with the reference's
    divisibility fallback: a dimension whose size does not divide its mesh
    axes, or that names an axis the mesh lacks, replicates."""

    def leaf(pd: ParamDef, spec: PartitionSpec) -> PartitionSpec:
        resolved = []
        for dim, m in zip(pd.shape, spec.axes):
            if m is not None and (any(a not in mesh.shape for a in mesh.axes_of(m))
                                  or dim % mesh.entry_size(m)):
                m = None
            resolved.append(m)
        while resolved and resolved[-1] is None:
            resolved.pop()
        return PartitionSpec(tuple(resolved))

    return tree_map(leaf, template, partition_specs(template, rules))


def batch_axes(mesh, mode: str):
    """Mesh axes over which the *within-agent* batch dim shards."""
    if mode == "train_hier" and POD_AXIS in mesh.shape:
        return AGENT_AXIS
    return None


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


# --------------------------------------------------------------------------
# decode cache specs
# --------------------------------------------------------------------------


def _cache_structure(cfg: ArchConfig, shape: InputShape):
    """``init_cache(cfg, b, seq_len)`` on ``meta``: shapes and dtypes only."""
    enc_len = cfg.frontend_tokens if cfg.is_encoder_decoder else 0
    return init_cache(cfg, shape.global_batch, shape.seq_len, enc_len=enc_len,
                      device="meta")


def cache_partition_specs(cfg: ArchConfig, shape: InputShape, mesh):
    """:class:`PartitionSpec` tree mirroring ``init_cache(cfg, b,
    max_len)``, the reference's heuristics: the batch over the data axes
    when it divides; otherwise (the ``long_500k`` single request) the
    *sequence* dim of KV caches over every axis.  KV-head dims over
    ``model`` when they divide, else the sequence dim takes ``model``.
    The rwkv state's heads, its ``shift`` / ``cm`` and mamba's inner dim
    over ``model`` when they divide; MLA's ``c`` / ``kr`` like a KV cache
    without heads; ``enc_out`` by batch."""
    b, b_ax = serve_batch_count(shape, mesh)
    model_sz = mesh.shape[MODEL_AXIS]
    all_axes = tuple(a for a in (POD_AXIS, AGENT_AXIS) if a in mesh.shape)
    structure = _cache_structure(cfg, shape)

    def leaf_spec(keys, leaf) -> PartitionSpec:
        shp = leaf.shape
        if "enc_out" in keys:           # (b, F, d)
            return PartitionSpec((b_ax, None, None))
        if "S" in keys:                 # rwkv state (L, b, n_h, hs, hs)
            nh_ax = MODEL_AXIS if shp[2] % model_sz == 0 else None
            return PartitionSpec((None, b_ax, nh_ax, None, None))
        if "shift" in keys or keys[-1] == "cm":   # (L, b, d)
            d_ax = MODEL_AXIS if shp[2] % model_sz == 0 else None
            return PartitionSpec((None, b_ax, d_ax))
        if "mamba" in keys:             # (L, b, di, n)
            d_ax = MODEL_AXIS if shp[2] % model_sz == 0 else None
            return PartitionSpec((None, b_ax, d_ax, None))
        if keys[-1] in ("k", "v"):      # (L[, period], b, S, KV, hd)
            lead = len(shp) - 4
            if b_ax is None:            # long-context single request
                return PartitionSpec((None,) * (lead + 1)
                                     + (all_axes + (MODEL_AXIS,), None, None))
            kv_ax = MODEL_AXIS if shp[lead + 2] % model_sz == 0 else None
            seq_ax = None if kv_ax else (
                MODEL_AXIS if shp[lead + 1] % model_sz == 0 else None)
            return PartitionSpec((None,) * lead + (b_ax, seq_ax, kv_ax, None))
        if keys[-1] in ("c", "kr"):     # MLA (L, b, S, r)
            if b_ax is None:
                return PartitionSpec((None, None, all_axes + (MODEL_AXIS,), None))
            seq_ax = MODEL_AXIS if shp[2] % model_sz == 0 else None
            return PartitionSpec((None, b_ax, seq_ax, None))
        return PartitionSpec((None,) * len(shp))

    flat = tree_flatten_with_path(structure)
    _, treedef = tree_flatten(structure)
    return tree_unflatten(treedef, [leaf_spec(tuple(path), leaf)
                                    for path, leaf in flat])


def decode_input_specs(cfg: ArchConfig, shape: InputShape, mesh):
    """``(cache, tokens, cur_index)`` :class:`TensorSpec` stand-ins of the
    serve step: the global cache with :func:`cache_partition_specs`,
    ``tokens (b, 1)`` int32 over the batch axes, a scalar int32."""
    _, b_ax = serve_batch_count(shape, mesh)
    specs = cache_partition_specs(cfg, shape, mesh)
    cache = tree_map(lambda t, sp: TensorSpec(tuple(t.shape), t.dtype, sp),
                     _cache_structure(cfg, shape), specs)
    tokens = TensorSpec((shape.global_batch, 1), torch.int32,
                        PartitionSpec((b_ax, None)))
    return cache, tokens, TensorSpec((), torch.int32, PartitionSpec(()))


def local_cache(cfg: ArchConfig, shape: InputShape, mesh, device=None):
    """This rank's block of the zeroed decode cache of ``shape``
    (:func:`cache_partition_specs`), allocated at the block's size only."""
    return local_zeros(_cache_structure(cfg, shape),
                       cache_partition_specs(cfg, shape, mesh), mesh, device)


def local_batch(batch: Dict[str, Any], mesh) -> Dict[str, torch.Tensor]:
    """This rank's agent's slice of an agent-stacked batch (numpy or
    tensors), on the rank's device: the batch is replicated over
    ``model``."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] != mesh.n_agents:
            raise ValueError(f"batch leaf {k!r} has {v.shape[0]} agents, the "
                             f"mesh {mesh.n_agents}")
        row = v[mesh.agent]
        out[k] = torch.as_tensor(np.ascontiguousarray(row)
                                 if isinstance(row, np.ndarray) else row,
                                 device=mesh.device)
    return out
