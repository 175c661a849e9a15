"""Distributed optimizers: CDSGD, CDMSGD (Polyak and Nesterov), CDAdam and
the baselines.

Every optimizer works on an opaque parameter tree (nested dicts of
agent-stacked tensors) and a :class:`CommOps` bundle of the collective
operations on the agent axis, as in :mod:`repro.core.optim`:

    CDSGD:             x_{k+1} = Pi x_k - a_k g(x_k)
    CDMSGD (Polyak):   w = Pi x_k ; v_{k+1} = mu v_k - a_k g(x_k)
                       x_{k+1} = w + v_{k+1}
    CDMSGD (Nesterov): same, with g evaluated at x_k + mu v_k
    CDAdam:            x_{k+1} = Pi x_k - a_k adam_dir(g), moments local
    FedAvg:            E local SGD(+momentum) steps, then x <- mean(x)
                       (over the present agents, with ``faults=``)
    Centralized SGD:   g <- mean(g) every step; x_{k+1} = x_k - a_k g
    Gossip SGD:        x <- (x + x[perm_k]) / 2 - a_k g, a random partner
    Time-varying:      CDSGD with Pi_k cycling through a list

``fused=False`` runs :meth:`apply`, the per-leaf reference (a dense ``Pi``
matmul per leaf, plain PyTorch; it ignores the wire precision).
``fused=True`` runs :meth:`apply_fused`: the whole model is packed into
dtype-bucketed ``(rows, 128)`` buffers and updated by one consensus-update
kernel launch per bucket (see :mod:`repro_torch.kernels.consensus_update`),
in place in the packed gradient and momentum buffers.  The mixing operands
come from the comm's ``gather`` (sync) or from the engine's staged
quantize / exchange phases (``exchanged``: error feedback, the overlap
schedule, momentum mixing, the compressors); quantized wires feed the
self-separated ``_q`` kernels, a mixed momentum the ``_qm`` kernels, the
top-k wire's compact fields the ``_sparse`` kernels.  The baselines have
no fused path: they run :meth:`apply` whatever ``fused`` says.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import consensus
from repro_torch.core.schedules import Schedule, fixed
from repro_torch.kernels.consensus_update import ops as kops
from repro_torch.utils.tree import tree_leaves, tree_map, tree_zeros_like

PyTree = Any
MixFn = Callable[[PyTree], PyTree]


@dataclasses.dataclass(frozen=True)
class CommOps:
    """Collective operations over the agent population."""

    mix: MixFn                    # w = Pi x  (fixed topology), per leaf
    mean: MixFn                   # exact global average, per leaf
    # whole-model fused-update support (None: per-leaf mixing only)
    flat: Optional[consensus.FlatComm]
    # this process's agent in the sharded mode (its trees carry no agent
    # axis); None in the stacked simulation
    agent: Optional[int] = None


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

    def mean(tree):
        return tree_map(lambda x: x.mean(dim=0, keepdim=True).expand_as(x)
                        .clone(), tree)

    return CommOps(mix=mix, mean=mean, flat=flat)


def sharded_comm_ops(topology, mesh) -> CommOps:
    """CommOps of agent ``mesh.rank`` in the sharded mode (one agent per
    process): the per-leaf permutation (circulant ``Pi``) or all-gather
    mixing and the all-reduce mean, without flat-buffer support (the
    fused path's comm is :func:`repro_torch.launch.steps.
    make_local_fused_comm`)."""
    return CommOps(mix=consensus.make_sharded_mix_fn(topology, mesh),
                   mean=consensus.make_sharded_mean_fn(mesh), flat=None,
                   agent=mesh.rank)


def factored_comm_ops(factored: consensus.FactoredMix, mesh) -> CommOps:
    """CommOps of agent ``mesh.rank`` on a factored ``pod x data`` mesh:
    the per-leaf mixing one factor (axis) after the other and the mean
    over every agent axis."""
    return CommOps(mix=factored.make_mix_fn(mesh),
                   mean=consensus.make_sharded_mean_fn(mesh), flat=None,
                   agent=mesh.rank)


class OptState(NamedTuple):
    step: int              # optimizer steps taken
    inner: Any             # optimizer-specific (momentum, ...)
    # the overlap schedule's in-flight wire: one (payload, row scales) pair
    # per bucket, quantized from the params of the previous step; () under
    # schedule="sync" (the engine fills and refreshes it)
    wire: Any = ()
    # error-feedback residuals: one f32 buffer per bucket carrying the
    # quantization (compression) error of the last wire payload; local
    # state, never on the wire; () without error feedback (the engine owns
    # it)
    residual: Any = ()
    # the rank-r compressor's warm-start basis, one (A, 128, r) stack per
    # bucket; local state like the residual; () for every other program
    qwarm: Any = ()


@dataclasses.dataclass(frozen=True)
class ExchangeResult:
    """Kernel-ready mixing operands from the engine's staged phases.

    ``DistributedOptimizer.update(..., exchanged=...)`` consumes this
    instead of calling ``comm.flat.gather``: the engine ran pack / quantize
    / exchange itself (possibly against the one-step-stale carried wire).
    ``selfs`` are the fresh native packed params (under a multi-round
    program the round ``k-1`` mix): the self term never crosses the wire
    and never goes stale.

    With ``momentum_mixing="mixed"`` the wire carried a second payload
    tree: ``mom_neighbors`` / ``mom_scales`` / ``mom_selfs`` are the
    momentum's operands (same weights as the params), ``None`` otherwise.
    ``mom_selfs`` are the packed momentum buckets the wire was quantized
    from (the round ``k-1`` mix of the momentum under a multi-round
    program); the fused kernels write ``v'`` in place, so the optimizers
    hand them a copy and leave these intact (under an f32 wire they are
    the payload stacks themselves, and the overlap schedule quantizes the
    packed momentum as the next step's wire).

    The sparse operand form of the top-k wire: a bucket's ``neighbors``
    entry is a :class:`~repro_torch.kernels.consensus_update.ops.
    SparseNeighbors` and its ``scales`` entry ``None`` (the row scales ride
    inside); the fused optimizers hand it to ``*_update_flat``, which
    launches the ``*_update_sparse`` kernels.
    """

    spec: Any                     # flatbuf.FlatSpec of the param tree
    neighbors: Sequence           # per-bucket wire payload stacks
    weights: torch.Tensor         # self-separated weights (self first)
    scales: Sequence              # per-bucket row-scale stacks
    selfs: Sequence               # per-bucket fresh native self buffers
    # the mixed momentum payload's operands (momentum_mixing="mixed" only)
    mom_neighbors: Optional[Sequence] = None
    mom_scales: Optional[Sequence] = None
    mom_selfs: Optional[Sequence] = None

    @property
    def momentum_mixed(self) -> bool:
        return self.mom_neighbors is not None


class DistributedOptimizer:
    """Base: subclasses implement ``init_inner``, ``apply``, ``apply_fused``.

    ``fused=True`` routes the update through the flat-buffer kernels
    (:meth:`apply_fused`); otherwise the per-leaf reference :meth:`apply`
    runs, with the same semantics.  An optimizer without a fused path (the
    baselines) runs :meth:`apply` either way.
    """

    #: declared in-place contract of the fused path: how many per-agent
    #: buffers every fused bucket launch updates in place (the packed
    #: gradient, which becomes the new params, always; the momentum-family
    #: optimizers' momentum or moments too), the reference's count of
    #: ``input_output_aliases`` pairs.  ``None``: no fused in-place contract
    #: (the baselines).  :mod:`repro_torch.analysis.staticcheck` holds every
    #: executed launch to it.
    fused_alias_pairs = None

    def __init__(self, schedule: Schedule | float, *, fused: bool = False):
        self.schedule: Schedule = fixed(schedule) if isinstance(schedule, (int, float)) else schedule
        self.fused = fused

    def init(self, params: PyTree) -> OptState:
        return OptState(step=0, inner=self.init_inner(params))

    @property
    def has_fused(self) -> bool:
        """True when the class implements the flat-buffer fast path."""
        return type(self).apply_fused is not DistributedOptimizer.apply_fused

    def grad_params(self, params: PyTree, state: OptState) -> PyTree:
        """Point at which the caller evaluates the gradient."""
        return params

    def update(self, params: PyTree, grads: PyTree, state: OptState,
               comm: CommOps, *, exchanged: Optional[ExchangeResult] = None):
        """One optimizer step.  ``exchanged`` carries the engine's mixing
        operands; without it the fused path gathers through ``comm.flat``.
        The wire and residual fields pass through (the engine refreshes
        them)."""
        alpha = self.schedule(state.step)
        if self.fused and self.has_fused:
            if comm.flat is None:
                raise ValueError(
                    f"{type(self).__name__}(fused=True) needs flat-buffer "
                    "support in its comm (the sharded mode: "
                    "mixing='ppermute_fused')")
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
        raise NotImplementedError(f"{type(self).__name__} has no fused path")

    @property
    def uses_consensus(self) -> bool:
        return True

    # -- momentum mixing (MixingProgram momentum_mixing="mixed") ---------
    @property
    def has_mixable_momentum(self) -> bool:
        """True when the optimizer carries a momentum-like buffer the wire
        can mix next to the params (the CDMSGD family's ``v``, CDAdam's
        first moment)."""
        return False

    def momentum_tree(self, inner) -> Optional[PyTree]:
        """The param-structured momentum tree to put on the wire, or None."""
        return None


def _flat_setup(fl: consensus.FlatComm, params, step, *trees, exchanged=None):
    """Pack params (+ same-structured trees) against one shared FlatSpec and
    gather the mixing operands ``(nbrs, weights, scales, selfs)``; when the
    engine already exchanged, only the extra trees are packed here.  Every
    packed tree is a fresh buffer, so the kernels may write it in place."""
    if exchanged is not None:
        others = [fl.pack(t, exchanged.spec) for t in trees]
        return (exchanged.spec, exchanged.neighbors, exchanged.weights,
                exchanged.scales, exchanged.selfs, others)
    spec = fl.spec(params)
    bufs = fl.pack(params, spec)
    others = [fl.pack(t, spec) for t in trees]
    nbrs, weights, scales, selfs = fl.gather(bufs, step)
    return spec, nbrs, weights, scales, selfs, others


def _mom_bufs(fl: consensus.FlatComm, spec, mom, exchanged):
    """The momentum buffers the kernels update in place: under momentum
    mixing a copy of the engine's ``mom_selfs`` (the packed momentum, or the
    round ``k-1`` mix of a multi-round program; copied, because an f32
    wire's momentum payload is that very buffer), else a fresh pack of the
    local momentum tree ``mom``."""
    if exchanged is not None and exchanged.momentum_mixed:
        return [m.clone() for m in exchanged.mom_selfs]
    return fl.pack(mom, spec)


def _mom_operands(exchanged: Optional[ExchangeResult], n: int):
    """Per-bucket ``(mom_neighbors, mom_scales)``: the mixed momentum's wire
    operands, or ``None`` pairs when the momentum stays local."""
    if exchanged is None or not exchanged.momentum_mixed:
        return [(None, None)] * n
    return list(zip(exchanged.mom_neighbors, exchanged.mom_scales))


class CDSGD(DistributedOptimizer):
    """Algorithm 1: ``x_{k+1} = Pi x_k - alpha g(x_k)``."""

    fused_alias_pairs = 1   # params in place

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
    ``v' = mu v - alpha g(x); x' = Pi x + v'``.

    With ``momentum_mixing="mixed"`` the momentum rides the wire and is
    mixed with the same ``Pi``: ``v' = mu (Pi v) - alpha g``.
    """

    fused_alias_pairs = 2   # params + momentum v in place

    def __init__(self, schedule, mu: float = 0.9, **kw):
        super().__init__(schedule, **kw)
        self.mu = mu

    def init_inner(self, params):
        return tree_zeros_like(params)

    @property
    def has_mixable_momentum(self):
        return True

    def momentum_tree(self, inner):
        return inner

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
        spec, nbrs, w, scs, sfs, (g,) = _flat_setup(
            fl, params, step, grads, exchanged=exchanged)
        vb = _mom_bufs(fl, spec, v, exchanged)
        pairs = [kops.cdmsgd_update_flat(nb, w, gb, vi, alpha, self.mu,
                                         scales=sc, self_buf=sf,
                                         mom_neighbors=mnb, mom_scales=msc)
                 for nb, sc, sf, gb, vi, (mnb, msc) in zip(
                     nbrs, scs, sfs, g, vb, _mom_operands(exchanged, len(g)))]
        new_params = fl.unpack([p for p, _ in pairs], spec)
        new_v = fl.unpack([nv for _, nv in pairs], spec)
        return new_params, new_v


def _axpy(a: float, x: PyTree, y: PyTree) -> PyTree:
    """``a * x + y``, leaf-wise."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


class CDMSGDNesterov(CDMSGD):
    """Algorithm 3: the gradient evaluated at the lookahead ``x + mu v``.

    Unfused, the state is the momentum ``v`` and the lookahead is
    recomputed before every backward.  Fused, the state is ``(v,
    lookahead)``: the kernel emits ``x' + mu v'`` in the same pass as the
    update, so :meth:`grad_params` is a state lookup.
    """

    fused_alias_pairs = 2   # params + momentum v in place (lookahead is new)

    def init_inner(self, params):
        if self.fused:
            # lookahead_0 = x_0 + mu * 0 = x_0, cloned: the packed views the
            # kernels write in place must never be the params themselves
            return (tree_zeros_like(params), tree_map(torch.clone, params))
        return tree_zeros_like(params)

    def grad_params(self, params, state):
        if self.fused:
            return state.inner[1]
        return _axpy(self.mu, state.inner, params)

    def momentum_tree(self, inner):
        return inner[0] if self.fused else inner

    def apply_fused(self, params, grads, inner, alpha, comm, step, *,
                    exchanged=None):
        fl = comm.flat
        spec, nbrs, w, scs, sfs, (g,) = _flat_setup(
            fl, params, step, grads, exchanged=exchanged)
        vb = _mom_bufs(fl, spec, inner[0], exchanged)
        triples = [kops.cdmsgd_nesterov_update_flat(
                       nb, w, gb, vi, alpha, self.mu, scales=sc, self_buf=sf,
                       mom_neighbors=mnb, mom_scales=msc)
                   for nb, sc, sf, gb, vi, (mnb, msc) in zip(
                       nbrs, scs, sfs, g, vb, _mom_operands(exchanged, len(g)))]
        new_params, new_v, look = (fl.unpack([t[i] for t in triples], spec)
                                   for i in range(3))
        return new_params, (new_v, look)


def bias_corrections(b1: float, b2: float, step: int) -> tuple:
    """``(1 - b1^t, 1 - b2^t)`` at ``t = step + 1``, in float32 as the JAX
    step computes them."""
    t = np.float32(step + 1)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t))


class CDAdam(DistributedOptimizer):
    """Consensus mixing of the parameters with local Adam moments
    (``x' = Pi x - alpha adam_dir(g)``), beyond the paper.

    ``momentum_mixing="mixed"`` mixes the FIRST moment over the wire
    (``m' = b1 (Pi m) + (1-b1) g``); the second moment stays local, a
    positive per-coordinate scale rather than a direction.
    """

    fused_alias_pairs = 3   # params + both Adam moments in place

    def __init__(self, schedule, b1=0.9, b2=0.999, eps=1e-8, **kw):
        super().__init__(schedule, **kw)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init_inner(self, params):
        return (tree_zeros_like(params), tree_zeros_like(params))

    @property
    def has_mixable_momentum(self):
        return True

    def momentum_tree(self, inner):
        return inner[0]

    def apply(self, params, grads, inner, alpha, comm, step):
        m, v = inner
        b1, b2, eps = self.b1, self.b2, self.eps
        new_m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g.to(mi.dtype),
                         m, grads)
        new_v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * g.to(vi.dtype) ** 2,
                         v, grads)
        bc1, bc2 = bias_corrections(b1, b2, step)
        mixed = comm.mix(params)
        new_params = tree_map(
            lambda w, mi, vi: w - (alpha * (mi / bc1)
                                   / (torch.sqrt(vi / bc2) + eps)).to(w.dtype),
            mixed, new_m, new_v)
        return new_params, (new_m, new_v)

    def apply_fused(self, params, grads, inner, alpha, comm, step, *,
                    exchanged=None):
        fl = comm.flat
        m, v = inner
        bc1, bc2 = bias_corrections(self.b1, self.b2, step)
        spec, nbrs, w, scs, sfs, (g, vb) = _flat_setup(
            fl, params, step, grads, v, exchanged=exchanged)
        mb = _mom_bufs(fl, spec, m, exchanged)
        triples = [kops.cdadam_update_flat(
                       nb, w, gb, mi, vi, alpha, self.b1, self.b2, self.eps,
                       bc1, bc2, scales=sc, self_buf=sf, mom_neighbors=mnb,
                       mom_scales=msc)
                   for nb, sc, sf, gb, mi, vi, (mnb, msc) in zip(
                       nbrs, scs, sfs, g, mb, vb,
                       _mom_operands(exchanged, len(g)))]
        new_params, new_m, new_v = (fl.unpack([t[i] for t in triples], spec)
                                    for i in range(3))
        return new_params, (new_m, new_v)


# --------------------------------------------------------------------------
# Baselines (plain PyTorch: no kernel)
# --------------------------------------------------------------------------


def _sgd_step(params, grads, alpha):
    return tree_map(lambda x, g: (x - alpha * g.to(x.dtype)).to(x.dtype),
                    params, grads)


def _momentum_step(params, grads, v, alpha, mu):
    new_v = tree_map(
        lambda vi, g: (mu * vi - alpha * g.to(vi.dtype)).to(vi.dtype), v, grads)
    return tree_map(lambda x, nv: (x + nv).to(x.dtype), params, new_v), new_v


class CentralizedSGD(DistributedOptimizer):
    """Data-parallel SGD: gradients averaged across agents every step."""

    def apply(self, params, grads, inner, alpha, comm, step):
        return _sgd_step(params, comm.mean(grads), alpha), inner

    @property
    def uses_consensus(self):
        return False


class CentralizedMSGD(DistributedOptimizer):
    """Data-parallel Polyak-momentum SGD (the paper's MSGD)."""

    def __init__(self, schedule, mu: float = 0.9, **kw):
        super().__init__(schedule, **kw)
        self.mu = mu

    def init_inner(self, params):
        return tree_zeros_like(params)

    def apply(self, params, grads, v, alpha, comm, step):
        return _momentum_step(params, comm.mean(grads), v, alpha, self.mu)

    @property
    def uses_consensus(self):
        return False


class FedAvg(DistributedOptimizer):
    """Federated Averaging [McMahan et al. 2016] with every client.

    Each agent takes local SGD(+momentum) steps; every ``local_steps``
    steps the parameters AND the momentum are replaced by their global
    averages (the momentum only when ``mu != 0``: with ``mu = 0`` it is
    ``-alpha g``, already consumed).

    ``faults`` (a :class:`~repro_torch.core.faults.FaultSchedule`) enables
    partial participation: at a sync step the server averages over the
    ``k`` of ``N`` agents present (not straggling at that step; link drops
    do not apply to the server round-trip), the masked sum renormalized by
    ``N / k``, and broadcasts the result to everyone; the momentum average
    is masked the same way.  A sync step where nobody is present keeps
    every agent's local parameters.  The step is a host int, so the
    presence row and ``k`` are read on the host; the row's device copy is
    made once per device.  In the sharded mode (``comm.agent`` set) each
    process scales its own tree by its presence ``m[agent]`` before the
    all-reduce mean.
    """

    def __init__(self, schedule, local_steps: int = 1, mu: float = 0.0,
                 faults=None, **kw):
        super().__init__(schedule, **kw)
        self.local_steps = int(local_steps)
        self.mu = mu
        self.faults = faults
        if faults is not None:
            faults.validate()
            self._present = (~faults.straggle).astype(np.float32)   # (P, A)
            self._present_on = {}

    def init_inner(self, params):
        return tree_zeros_like(params)

    def _present_row(self, step: int, device) -> tuple:
        """``(m (A,) f32 on device, k)``: who reports in at ``step``."""
        if device not in self._present_on:
            self._present_on[device] = torch.tensor(self._present,
                                                    device=device)
        tp = step % self.faults.period
        return (self._present_on[device][tp],
                float(self._present[tp].sum()))

    def apply(self, params, grads, v, alpha, comm, step):
        local, new_v = _momentum_step(params, grads, v, alpha, self.mu)
        if self.local_steps > 1 and (step + 1) % self.local_steps:
            return local, new_v
        if self.faults is None:
            return comm.mean(local), (comm.mean(new_v) if self.mu else new_v)
        m, k = self._present_row(step, tree_leaves(local)[0].device)
        if k == 0:                  # nobody reported in: no sync happened
            return local, new_v
        scale = m.shape[0] / k
        if comm.agent is None:
            weigh = lambda x: x * m.reshape((-1,) + (1,) * (x.dim() - 1))  # noqa: E731
        else:
            weigh = lambda x: x * m[comm.agent]  # noqa: E731

        def masked_mean(tree):
            wsum = comm.mean(tree_map(weigh, tree))
            return tree_map(lambda mn, x: (mn * scale).to(x.dtype), wsum, tree)

        return masked_mean(local), (masked_mean(new_v) if self.mu else new_v)

    @property
    def uses_consensus(self):
        return False


def gossip_permutation(seed: int, step: int, n_agents: int) -> torch.Tensor:
    """The partner permutation of gossip step ``step``: a uniform random
    permutation of ``n_agents`` from a generator seeded by ``(seed,
    step)`` (CPU, int64).  The JAX package draws
    ``jax.random.permutation(fold_in(PRNGKey(seed), step), n)`` instead;
    the two streams differ."""
    gen = torch.Generator().manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return torch.randperm(n_agents, generator=gen)


class GossipSGD(DistributedOptimizer):
    """Gossip SGD [Jin et al. 2016]: every step each agent averages with a
    random partner, ``W_k = (I + P_k) / 2`` for a random permutation
    ``P_k``, then takes a local SGD step.  Unlike CDSGD the communication
    graph is not fixed.  Stacked simulation only."""

    def __init__(self, schedule, n_agents: int, seed: int = 0, **kw):
        super().__init__(schedule, **kw)
        self.n_agents = n_agents
        self.seed = seed

    def apply(self, params, grads, inner, alpha, comm, step):
        device = tree_leaves(params)[0].device
        perm = gossip_permutation(self.seed, step, self.n_agents).to(device)
        mixed = tree_map(lambda x: 0.5 * (x + x[perm]), params)
        return _sgd_step(mixed, grads, alpha), inner


class TimeVaryingCDSGD(DistributedOptimizer):
    """CDSGD over a time-varying topology: step ``k`` mixes with
    ``Pi_{k mod P}`` of the list ``topologies``.  Stacked simulation."""

    def __init__(self, schedule, topologies, **kw):
        super().__init__(schedule, **kw)
        self.pis = np.stack([t.pi for t in topologies]).astype(np.float32)

    def apply(self, params, grads, inner, alpha, comm, step):
        device = tree_leaves(params)[0].device
        pi = torch.from_numpy(self.pis[step % len(self.pis)]).to(device)
        return _sgd_step(consensus.mix_pytree_stacked(pi, params), grads,
                         alpha), inner


def make_optimizer(name: str, schedule, **kw) -> DistributedOptimizer:
    """Registry used by configs (``--optimizer cdsgd`` etc.)."""
    name = name.lower()
    table = {
        "cdsgd": CDSGD,
        "cdmsgd": CDMSGD,
        "cdmsgd_nesterov": CDMSGDNesterov,
        "cdadam": CDAdam,
        "sgd": CentralizedSGD,
        "msgd": CentralizedMSGD,
        "fedavg": FedAvg,
        "gossip": GossipSGD,
        "cdsgd_tv": TimeVaryingCDSGD,
    }
    if name not in table:
        raise ValueError(f"unknown optimizer {name!r}; available: {sorted(table)}")
    return table[name](schedule, **kw)
