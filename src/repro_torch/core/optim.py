"""Distributed optimizers CDSGD and CDMSGD (paper Algorithms 1-2).

Every optimizer works on an opaque parameter tree (nested dicts of
agent-stacked tensors) and a :class:`CommOps` bundle of the collective
operations on the agent axis, as in :mod:`repro.core.optim`:

    CDSGD:            x_{k+1} = Pi x_k - a_k g(x_k)
    CDMSGD (Polyak):  w = Pi x_k ; v_{k+1} = mu v_k - a_k g(x_k)
                      x_{k+1} = w + v_{k+1}

``fused=False`` runs :meth:`apply`, the per-leaf reference (a dense ``Pi``
matmul per leaf, plain PyTorch).  ``fused=True`` runs :meth:`apply_fused`:
the whole model is packed into dtype-bucketed ``(rows, 128)`` buffers and
updated by one consensus-update kernel launch per bucket (see
:mod:`repro_torch.kernels.consensus_update`), in place in the packed
gradient and momentum buffers.

Not ported yet: Nesterov, CDAdam (ROADMAP A12), the centralized SGD/MSGD
and FedAvg baselines (A7), gossip and time-varying CDSGD (A12/A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import consensus
from repro_torch.core.schedules import Schedule, fixed
from repro_torch.device import resolve_device
from repro_torch.kernels.consensus_update import ops as kops
from repro_torch.utils.tree import tree_map, tree_zeros_like

PyTree = Any
MixFn = Callable[[PyTree], PyTree]


@dataclasses.dataclass(frozen=True)
class CommOps:
    """Collective operations over the agent population."""

    mix: MixFn                    # w = Pi x  (fixed topology), per leaf
    flat: consensus.FlatComm      # whole-model fused-update support


def stacked_comm_ops(topology, *, exchange: str = "f32", device=None) -> CommOps:
    """CommOps for agent-stacked trees (leading axis = agent) on ``device``
    (``cuda`` unless ``device`` says otherwise)."""
    pi = torch.tensor(topology.pi, dtype=torch.float32,
                      device=resolve_device(device))

    def mix(tree):
        return consensus.mix_pytree_stacked(pi, tree)

    return CommOps(mix=mix, flat=consensus.stacked_flat_comm(
        pi, exchange=exchange))


class OptState(NamedTuple):
    step: int              # optimizer steps taken
    inner: Any             # optimizer-specific (momentum, ...)


class DistributedOptimizer:
    """Base: subclasses implement ``init_inner``, ``apply``, ``apply_fused``.

    ``fused=True`` routes the update through the flat-buffer kernels
    (:meth:`apply_fused`); otherwise the per-leaf reference :meth:`apply`
    runs, with the same semantics.
    """

    def __init__(self, schedule: Schedule | float, *, fused: bool = False):
        self.schedule: Schedule = fixed(schedule) if isinstance(schedule, (int, float)) else schedule
        self.fused = fused

    def init(self, params: PyTree) -> OptState:
        return OptState(step=0, inner=self.init_inner(params))

    def update(self, params: PyTree, grads: PyTree, state: OptState,
               comm: CommOps):
        alpha = self.schedule(state.step)
        if self.fused:
            new_params, new_inner = self.apply_fused(
                params, grads, state.inner, alpha, comm, state.step)
        else:
            new_params, new_inner = self.apply(params, grads, state.inner,
                                               alpha, comm, state.step)
        return new_params, OptState(step=state.step + 1, inner=new_inner)

    def init_inner(self, params: PyTree) -> Any:
        return ()

    def apply(self, params, grads, inner, alpha, comm: CommOps, step):
        raise NotImplementedError

    def apply_fused(self, params, grads, inner, alpha, comm: CommOps, step):
        raise NotImplementedError


def _flat_setup(fl: consensus.FlatComm, params, step, *trees):
    """Pack params (+ same-structured trees) against one shared FlatSpec and
    gather the mixing operands."""
    spec = fl.spec(params)
    bufs = fl.pack(params, spec)
    others = [fl.pack(t, spec) for t in trees]
    nbrs, weights = fl.gather(bufs, step)
    return spec, nbrs, weights, others


class CDSGD(DistributedOptimizer):
    """Algorithm 1: ``x_{k+1} = Pi x_k - alpha g(x_k)``."""

    def apply(self, params, grads, inner, alpha, comm, step):
        mixed = comm.mix(params)
        new_params = tree_map(
            lambda w, g: (w - alpha * g.to(w.dtype)).to(w.dtype), mixed, grads)
        return new_params, inner

    def apply_fused(self, params, grads, inner, alpha, comm, step):
        fl = comm.flat
        spec, nbrs, w, (g,) = _flat_setup(fl, params, step, grads)
        outs = [kops.cdsgd_update_flat(nb, w, gb, alpha)
                for nb, gb in zip(nbrs, g)]
        return fl.unpack(outs, spec), inner


class CDMSGD(DistributedOptimizer):
    """Algorithm 2 (Polyak momentum):
    ``v' = mu v - alpha g(x); x' = Pi x + v'``."""

    def __init__(self, schedule, mu: float = 0.9, **kw):
        super().__init__(schedule, **kw)
        self.mu = mu

    def init_inner(self, params):
        return tree_zeros_like(params)

    def apply(self, params, grads, v, alpha, comm, step):
        mixed = comm.mix(params)
        new_v = tree_map(
            lambda vi, g: (self.mu * vi - alpha * g.to(vi.dtype)).to(vi.dtype),
            v, grads)
        new_params = tree_map(lambda w, nv: (w + nv).to(w.dtype), mixed, new_v)
        return new_params, new_v

    def apply_fused(self, params, grads, v, alpha, comm, step):
        fl = comm.flat
        spec, nbrs, w, (g, vb) = _flat_setup(fl, params, step, grads, v)
        pairs = [kops.cdmsgd_update_flat(nb, w, gb, vi, alpha, self.mu)
                 for nb, gb, vi in zip(nbrs, g, vb)]
        new_params = fl.unpack([p for p, _ in pairs], spec)
        new_v = fl.unpack([nv for _, nv in pairs], spec)
        return new_params, new_v


_NOT_PORTED = {
    "cdmsgd_nesterov": "ROADMAP A12 (CDMSGDNesterov, kernel B4)",
    "cdadam": "ROADMAP A12 (CDAdam, kernel B4)",
    "sgd": "ROADMAP A7 (CentralizedSGD)",
    "msgd": "ROADMAP A7 (CentralizedMSGD)",
    "fedavg": "ROADMAP A7 (FedAvg)",
    "gossip": "ROADMAP A12 (GossipSGD)",
    "cdsgd_tv": "ROADMAP A12/A13 (TimeVaryingCDSGD)",
}


def make_optimizer(name: str, schedule, **kw) -> DistributedOptimizer:
    """Registry used by configs (``"cdsgd"``, ``"cdmsgd"``)."""
    name = name.lower()
    table = {"cdsgd": CDSGD, "cdmsgd": CDMSGD}
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: {_NOT_PORTED[name]}")
    if name not in table:
        raise ValueError(f"unknown optimizer {name!r}; available: {sorted(table)}")
    return table[name](schedule, **kw)
