"""Distributed optimizers CDSGD and CDMSGD (paper Algorithms 1-2).

Every optimizer works on an opaque parameter tree (nested dicts of
agent-stacked tensors) and a :class:`CommOps` bundle of the collective
operations on the agent axis, as in :mod:`repro.core.optim`:

    CDSGD:            x_{k+1} = Pi x_k - a_k g(x_k)
    CDMSGD (Polyak):  w = Pi x_k ; v_{k+1} = mu v_k - a_k g(x_k)
                      x_{k+1} = w + v_{k+1}

``fused=False`` runs :meth:`apply`, the per-leaf reference (a dense ``Pi``
matmul per leaf, plain PyTorch; it ignores the wire precision).
``fused=True`` runs :meth:`apply_fused`: the whole model is packed into
dtype-bucketed ``(rows, 128)`` buffers and updated by one consensus-update
kernel launch per bucket (see :mod:`repro_torch.kernels.consensus_update`),
in place in the packed gradient and momentum buffers.  The mixing operands
come from the comm's ``gather`` (sync) or from the engine's staged
quantize / exchange phases (``exchanged``: error feedback, the overlap
schedule); quantized wires feed the self-separated ``_q`` kernels.

Not ported yet: Nesterov, CDAdam (ROADMAP A12), the centralized SGD/MSGD
and FedAvg baselines (A7), gossip and time-varying CDSGD (A12/A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import consensus
from repro_torch.core.schedules import Schedule, fixed
from repro_torch.kernels.consensus_update import ops as kops
from repro_torch.utils.tree import tree_map, tree_zeros_like

PyTree = Any
MixFn = Callable[[PyTree], PyTree]


@dataclasses.dataclass(frozen=True)
class CommOps:
    """Collective operations over the agent population."""

    mix: MixFn                    # w = Pi x  (fixed topology), per leaf
    flat: consensus.FlatComm      # whole-model fused-update support


def stacked_comm_ops(topology, *, exchange: str = "f32",
                     program: Optional[consensus.MixingProgram] = None,
                     device=None) -> CommOps:
    """CommOps for agent-stacked trees (leading axis = agent) on ``device``
    (``cuda`` unless ``device`` says otherwise); ``program`` defaults to
    the trivial static program over ``topology`` at wire ``exchange``."""
    flat = consensus.stacked_flat_comm(topology, exchange=exchange,
                                       program=program, device=device)
    pi = flat.strategy.pi

    def mix(tree):
        return consensus.mix_pytree_stacked(pi, tree)

    return CommOps(mix=mix, flat=flat)


class OptState(NamedTuple):
    step: int              # optimizer steps taken
    inner: Any             # optimizer-specific (momentum, ...)
    # the overlap schedule's in-flight wire: one (payload, row scales) pair
    # per bucket, quantized from the params of the previous step; () under
    # schedule="sync" (the engine fills and refreshes it)
    wire: Any = ()
    # error-feedback residuals: one f32 buffer per bucket carrying the
    # quantization error of the last wire payload; local state, never on
    # the wire; () without error feedback (the engine owns it)
    residual: Any = ()


@dataclasses.dataclass(frozen=True)
class ExchangeResult:
    """Kernel-ready mixing operands from the engine's staged phases.

    ``DistributedOptimizer.update(..., exchanged=...)`` consumes this
    instead of calling ``comm.flat.gather``: the engine ran pack / quantize
    / exchange itself (possibly against the one-step-stale carried wire).
    ``selfs`` are the fresh native packed params: the self term never
    crosses the wire and never goes stale.
    """

    spec: Any                     # flatbuf.FlatSpec of the param tree
    neighbors: Sequence           # per-bucket wire payload stacks
    weights: torch.Tensor         # self-separated weights (self first)
    scales: Sequence              # per-bucket row-scale stacks
    selfs: Sequence               # per-bucket fresh native self buffers


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
               comm: CommOps, *, exchanged: Optional[ExchangeResult] = None):
        """One optimizer step.  ``exchanged`` carries the engine's mixing
        operands; without it the fused path gathers through ``comm.flat``.
        The wire and residual fields pass through (the engine refreshes
        them)."""
        alpha = self.schedule(state.step)
        if self.fused:
            new_params, new_inner = self.apply_fused(
                params, grads, state.inner, alpha, comm, state.step,
                exchanged=exchanged)
        elif exchanged is not None:
            raise ValueError(
                f"{type(self).__name__} cannot consume exchanged operands: "
                "the engine's exchange phase feeds fused optimizers only")
        else:
            new_params, new_inner = self.apply(params, grads, state.inner,
                                               alpha, comm, state.step)
        return new_params, state._replace(step=state.step + 1, inner=new_inner)

    def init_inner(self, params: PyTree) -> Any:
        return ()

    def apply(self, params, grads, inner, alpha, comm: CommOps, step):
        raise NotImplementedError

    def apply_fused(self, params, grads, inner, alpha, comm: CommOps, step,
                    *, exchanged: Optional[ExchangeResult] = None):
        raise NotImplementedError


def _flat_setup(fl: consensus.FlatComm, params, step, *trees, exchanged=None):
    """Pack params (+ same-structured trees) against one shared FlatSpec and
    gather the mixing operands ``(nbrs, weights, scales, selfs)``; when the
    engine already exchanged, only the extra trees are packed here."""
    if exchanged is not None:
        others = [fl.pack(t, exchanged.spec) for t in trees]
        return (exchanged.spec, exchanged.neighbors, exchanged.weights,
                exchanged.scales, exchanged.selfs, others)
    spec = fl.spec(params)
    bufs = fl.pack(params, spec)
    others = [fl.pack(t, spec) for t in trees]
    nbrs, weights, scales, selfs = fl.gather(bufs, step)
    return spec, nbrs, weights, scales, selfs, others


class CDSGD(DistributedOptimizer):
    """Algorithm 1: ``x_{k+1} = Pi x_k - alpha g(x_k)``."""

    def apply(self, params, grads, inner, alpha, comm, step):
        mixed = comm.mix(params)
        new_params = tree_map(
            lambda w, g: (w - alpha * g.to(w.dtype)).to(w.dtype), mixed, grads)
        return new_params, inner

    def apply_fused(self, params, grads, inner, alpha, comm, step, *,
                    exchanged=None):
        fl = comm.flat
        spec, nbrs, w, scs, sfs, (g,) = _flat_setup(fl, params, step, grads,
                                                    exchanged=exchanged)
        outs = [kops.cdsgd_update_flat(nb, w, gb, alpha, scales=sc,
                                       self_buf=sf)
                for nb, sc, sf, gb in zip(nbrs, scs, sfs, g)]
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

    def apply_fused(self, params, grads, v, alpha, comm, step, *,
                    exchanged=None):
        fl = comm.flat
        spec, nbrs, w, scs, sfs, (g, vb) = _flat_setup(
            fl, params, step, grads, v, exchanged=exchanged)
        pairs = [kops.cdmsgd_update_flat(nb, w, gb, vi, alpha, self.mu,
                                         scales=sc, self_buf=sf)
                 for nb, sc, sf, gb, vi in zip(nbrs, scs, sfs, g, vb)]
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
