"""Consensus mixing ``w = Pi x`` over agent-stacked tensors (f32 wire).

The stacked-simulation slice of :mod:`repro.core.consensus`:

* :func:`mix_stacked` / :func:`mix_pytree_stacked` — every leaf carries a
  leading agent axis ``(N, ...)``; mixing is a dense matmul with ``Pi``
  (the per-leaf reference path of the unfused optimizers);
* :func:`stacked_flat_comm` — the fused path's :class:`FlatComm` for the
  native-precision (``"f32"``) wire and the paper's fixed ``Pi``: its
  ``gather`` hands the fused kernels the whole packed agent stack with the
  dense ``Pi`` as ``(A, A)`` weights (the JAX package's ``legacy_gather``);
* :func:`consensus_error_pytree` and the f32 wire-byte accounting.

Quantized wires, time-varying / multi-round / error-feedback programs and
the sharded mode are later slices; asking for them raises
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import flatbuf
from repro_torch.core.topology import Topology
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


def check_exchange(exchange: str) -> str:
    """Only the native-precision wire is ported; fail at construction."""
    if exchange == "f32":
        return exchange
    if exchange in flatbuf.EXCHANGE_DTYPES:
        raise NotImplementedError(
            f"exchange={exchange!r} is not ported yet: ROADMAP A11 "
            "(quantized wire, with kernel B3 sr_quantize_2d)")
    raise ValueError(f"unknown exchange precision {exchange!r}; "
                     f"expected one of {flatbuf.EXCHANGE_DTYPES}")


@dataclasses.dataclass(frozen=True)
class FlatComm:
    """Whole-model fused-update support carried inside ``CommOps``.

    ``gather(bufs, seed) -> (neighbor_stacks, weights)`` maps the packed
    self-buffers to kernel-ready operands.  In the stacked f32 form it
    returns the agent stack itself per bucket and the dense ``Pi`` as
    ``(A, A)`` float32 weights (the unquantized operand form; ``seed``
    drives the stochastic rounding of quantized wires, not ported yet).
    """

    lead: int                     # leading replica axes excluded from packing
    gather: Callable

    def spec(self, tree: PyTree) -> flatbuf.FlatSpec:
        return flatbuf.make_flat_spec(tree, lead=self.lead)

    def pack(self, tree: PyTree, spec: flatbuf.FlatSpec):
        return flatbuf.pack(tree, spec)

    def unpack(self, bufs, spec: flatbuf.FlatSpec) -> PyTree:
        return flatbuf.unpack(bufs, spec)


def stacked_flat_comm(pi: torch.Tensor, *, exchange: str = "f32") -> FlatComm:
    """FlatComm for agent-stacked trees: dense float32 ``Pi`` (A, A), any
    topology, on the device of the buffers it will mix."""
    check_exchange(exchange)

    def gather(bufs, seed):
        return list(bufs), pi

    return FlatComm(lead=1, gather=gather)


def mix_stacked(pi: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(Pi x)_j = sum_l pi_{jl} x_l`` for ``x`` of shape (N, ...)."""
    flat = x.reshape(x.shape[0], -1).float()
    mixed = pi.float() @ flat
    return mixed.to(x.dtype).reshape(x.shape)


def mix_pytree_stacked(pi: torch.Tensor, tree: PyTree) -> PyTree:
    """Apply :func:`mix_stacked` to every leaf of an agent-stacked tree."""
    return tree_map(lambda x: mix_stacked(pi, x), tree)


def exchange_bytes_per_step(spec: flatbuf.FlatSpec, topology: Topology,
                            exchange: str = "f32") -> dict:
    """Per-step bytes-on-wire of the fused consensus exchange (f32 wire).

    The paper's fixed-topology cost model (eq. 5/6): each agent sends and
    receives ``degree`` whole-model transfers per step, one round of one
    payload (the parameters).  The keys are the JAX package's, so
    ``rounds`` and ``payloads`` are the constant 1 and the native-precision
    total equals ``per_step_bytes``.
    """
    check_exchange(exchange)
    per_neighbor = spec.exchange_bytes("f32")
    degree = topology.degree()
    per_step = per_neighbor * degree
    return {
        "exchange": exchange,
        "degree": degree,
        "rounds": 1,
        "payloads": 1,
        "per_neighbor_bytes": per_neighbor,
        "per_step_bytes": per_step,
        "native_per_step_bytes": per_step,
    }


def consensus_error_pytree(tree: PyTree) -> torch.Tensor:
    """Aggregate consensus error ``mean_j ||x_j - mean(x)||`` over all leaves."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    mean_sq = torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        d = (x - x.mean(dim=0, keepdim=True)).reshape(n, -1).float()
        mean_sq = mean_sq + torch.sum(d * d, dim=1)
    return torch.mean(torch.sqrt(mean_sq))
