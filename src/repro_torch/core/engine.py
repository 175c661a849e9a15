"""StepProgram: one collaborative training step from named phases.

The stacked-simulation slice of :mod:`repro.core.engine`.  A step is

* ``grad``   — one per-agent value-and-grad over the leading agent axis of
  the stacked params (``torch.func.vmap`` of ``torch.func.grad_and_value``),
  looped over microbatches with float32 accumulation when ``microbatches >
  1`` (:func:`make_grad_phase`);
* ``update`` — pack, quantize, exchange and the fused consensus-update
  kernel per bucket (:func:`make_update_phase`).

The gradient is taken at ``optimizer.grad_params(params, state)``: the
params, or Nesterov's lookahead point.

The sharded mode (one agent per process, :mod:`repro_torch.launch.steps`)
assembles the same phases around one agent's tensors: the grad phase
without ``vmap`` (``make_grad_phase(..., per_agent=False)``), the wire,
residual and warm-start state of its one-agent strategy (the reference's
:func:`make_local_wire_init` / :func:`make_local_residual_init` /
:func:`make_local_qwarm_init`), and
under the overlap schedule the step posts the exchange of the carried
wire (``strategy.post_exchange``) before the grad phase and waits on it
in the update phase, so the transfers run while the gradients are
computed: the exchange reads only carried wire state, never the current
params or batch.

Schedules
---------
``schedule="sync"`` quantizes and exchanges the *current* params inside the
optimizer's ``comm.flat.gather``.  With error feedback or momentum mixing
the sync path is staged here instead: the quantizer threads
``OptState.residual``, and the momentum payload is packed from the
optimizer state (``DistributedOptimizer.momentum_tree``) next to the
params.

``schedule="overlap"`` pipelines the exchange one step deep: the quantized
buckets and row scales live in ``OptState.wire``, so step ``t`` mixes the
payload quantized at step ``t-1``:

    x^i_{t+1} = pi_ii x^i_t + sum_{j != i} pi_ij q(x^j_{t-1}) - alpha g^i_t

with the self term always fresh and native (it never crosses the wire), and
``x_{-1} := x_0`` quantized at seed ``-1``.  The staleness rides entirely in
which buffers feed the self-separated ``_q`` kernels.  Under momentum mixing
the wire carries ``(x_t, v_t)`` (``v_{-1} := v_0 = 0``).  A fault-tolerant
program (``staleness > 1`` or a fault schedule) carries a depth-``S``
:class:`~repro_torch.core.consensus.WireRing` instead, through the
strategy's ``initial_wire`` / ``advance_wire`` hooks; the sync schedule
rejects it.

Both error-feedback sites go through ``strategy.compress_ef``, which
threads ``OptState.qwarm`` (the rank compressor's warm start) and, for a
top-k / rank-r program, carries a :class:`~repro_torch.core.consensus.
TopKWire` / :class:`~repro_torch.core.consensus.RankWire` per bucket.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import consensus
from repro_torch.core.optim import (
    CommOps,
    DistributedOptimizer,
    ExchangeResult,
    OptState,
)
from repro_torch.utils.tree import tree_map

PyTree = Any

SCHEDULES = ("sync", "overlap")


def make_grad_phase(agent_loss: Callable, microbatches: int = 1, *,
                    per_agent: bool = True) -> Callable:
    """The ``grad`` phase: ``(gp, batch) -> ((losses, metrics), grads)``.

    ``agent_loss(params, batch) -> (loss, metrics)`` is the single-agent
    loss; the phase maps its value-and-grad over the leading agent axis of
    both the params and the batch (``per_agent=False``: one agent's params
    and batch, no agent axis and no ``vmap``, the sharded mode).
    ``microbatches = M > 1`` splits every
    batch leaf ``(A, B, ...)`` into ``M`` microbatches ``(A, B/M, ...)``
    (microbatch ``m`` takes rows ``m B/M .. (m+1) B/M - 1``), accumulates
    the gradients in float32 in microbatch order and scales the sum by
    ``float32(1 / M)`` (the reference's ``/ M`` as XLA compiles it); losses
    and metrics keep a leading microbatch axis ``(M, A)``
    (callers reduce with ``torch.mean`` either way), as the reference's
    ``lax.scan`` does.
    """
    value_and_grad = grad_and_value(agent_loss, has_aux=True)
    if per_agent:
        value_and_grad = vmap(value_and_grad)

    def grad_phase(gp, batch):
        grads, (losses, metrics) = value_and_grad(gp, batch)
        return (losses, metrics), grads

    if microbatches == 1:
        return grad_phase
    bdim = 1 if per_agent else 0

    def split(x, m: int):
        b = x.shape[bdim]
        if b % microbatches:
            raise ValueError(f"batch {b} per agent does not split into "
                             f"{microbatches} microbatches")
        n = b // microbatches
        return x.narrow(bdim, m * n, n)

    # the reference divides the float32 sum by M inside its jitted step,
    # where XLA multiplies by the float32 reciprocal instead: so does the port
    inv_m = float(np.float32(1.0) / np.float32(microbatches))

    def accumulated(gp, batch):
        # the sum is accumulated in place: at a 1 B-parameter model on 4
        # agents each float32 copy of the gradients is 16 GB
        gsum, losses, metrics = None, [], []
        for m in range(microbatches):
            (loss, met), g = grad_phase(
                gp, {k: split(v, m) for k, v in batch.items()})
            if gsum is None:     # 0 + g, as the reference's zero-started sum
                gsum = tree_map(lambda t: t.float().add_(0.0), g)
            else:
                tree_map(lambda a, t: a.add_(t), gsum, g)
            del g
            losses.append(loss)
            metrics.append(met)
        grads = tree_map(lambda t: t.mul_(inv_m), gsum)
        stacked = {k: torch.stack([met[k] for met in metrics])
                   for k in metrics[0]}
        return (torch.stack(losses), stacked), grads

    return accumulated


def _check_fused_flat(optimizer: DistributedOptimizer, comm: CommOps,
                      what: str) -> consensus.FlatComm:
    """``what`` needs the staged flat-buffer path; fail with the reason."""
    if not (getattr(optimizer, "fused", False) and optimizer.has_fused):
        raise ValueError(
            f"{what} needs a fused=True consensus optimizer; "
            f"{type(optimizer).__name__}(fused="
            f"{getattr(optimizer, 'fused', False)}) has no fused update to "
            "feed the staged exchange into")
    return comm.flat


def check_overlap_support(optimizer: DistributedOptimizer,
                          comm: CommOps) -> consensus.FlatComm:
    """Overlap needs the staged flat-buffer path; fail with the reason."""
    return _check_fused_flat(optimizer, comm, "schedule='overlap'")


def check_program_support(optimizer: DistributedOptimizer,
                          comm: CommOps) -> consensus.FlatComm:
    """A non-trivial MixingProgram (time-varying, multi-round, error
    feedback, momentum mixing, the staleness ring, a compressor) needs the
    fused path: the reference path would silently mix the fixed dense
    ``Pi`` instead.  Momentum mixing also needs an optimizer with a mixable
    momentum (the CDMSGD family, CDAdam)."""
    fl = comm.flat
    if fl is None:
        return None
    p = fl.program
    if p.is_trivial:
        return fl
    fl = _check_fused_flat(
        optimizer, comm,
        f"mixing strategy {p.strategy!r} (rounds={p.rounds}, "
        f"error_feedback={p.error_feedback}, "
        f"momentum_mixing={p.momentum_mixing})")
    if p.momentum_mixing == "mixed" and not optimizer.has_mixable_momentum:
        raise ValueError(
            f"momentum_mixing='mixed' puts the momentum buffer on the wire, "
            f"but {type(optimizer).__name__} has no mixable momentum state "
            "(use CDMSGD, CDMSGDNesterov, or CDAdam)")
    return fl


def _pack(fl: consensus.FlatComm, params, momentum=None):
    """The wire's bucket list: the params, then (momentum mixing) the
    momentum tree packed against the same spec, or zeros without one."""
    spec = fl.spec(params)
    mom = None if momentum is None else fl.pack(momentum, spec)
    return spec, consensus.widen_with_momentum(fl, fl.pack(params, spec), mom)


def _momentum_payload(optimizer: DistributedOptimizer, state: OptState):
    """The momentum tree a mixed-momentum step puts on the wire."""
    mom = optimizer.momentum_tree(state.inner)
    if mom is None:
        raise ValueError(
            f"momentum_mixing='mixed': {type(optimizer).__name__}."
            "momentum_tree returned None for the current optimizer state; "
            "no momentum payload to put on the wire")
    return mom


def _exchange_result(spec, operands, mixed: bool) -> ExchangeResult:
    """Split the strategy's per-bucket ``(nbrs, weights, scales, selfs)``
    into the params' and the mixed momentum's payload groups."""
    nbrs, w, scales, selfs = operands
    if not mixed:
        return ExchangeResult(spec, nbrs, w, scales, selfs)
    b = len(nbrs) // 2
    return ExchangeResult(spec, nbrs[:b], w, scales[:b], selfs[:b],
                          mom_neighbors=nbrs[b:], mom_scales=scales[b:],
                          mom_selfs=selfs[b:])


def make_update_phase(optimizer: DistributedOptimizer, comm: CommOps,
                      schedule: str = "sync") -> Callable:
    """The update phase group: ``(params, grads, state) -> (params', state')``.

    ``sync``: the optimizer gathers on the current params, running
    whatever strategy the program carries (``Pi_t`` selected by the step,
    ``k`` inner rounds); staged here with error feedback, whose quantizer
    threads ``OptState.residual``, and with momentum mixing, whose momentum
    payload comes from the state.  ``overlap``: exchange the carried
    one-step-stale wire (round 1, the only round off the critical path),
    run rounds ``2..k`` on the partially mixed buffers, update, then
    quantize the current params (and momentum) (EF-compressed when the
    program asks) as the wire of the next step; on the fault path
    ``advance_wire`` pushes that generation into the :class:`~repro_torch.
    core.consensus.WireRing`.  A fault-tolerant program needs ``overlap``.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of "
                         f"{SCHEDULES}")
    fl = comm.flat
    if fl is None:          # per-leaf mixing: no flat buffers, no staging
        if schedule != "sync":
            raise ValueError("schedule='overlap' needs the flat-buffer "
                             "exchange (a FlatComm)")

        def update_plain(params, grads, state):
            return optimizer.update(params, grads, state, comm)
        return update_plain
    if fl.program.fault_tolerant and schedule != "overlap":
        raise ValueError(
            "staleness > 1 / fault injection needs schedule='overlap': the "
            "staleness ring generalizes the overlap wire double-buffer — a "
            "sync exchange has no carried wire state to be stale in")
    fl = check_program_support(optimizer, comm)
    error_feedback = fl.program.error_feedback
    mixed = fl.program.momentum_mixing == "mixed"

    def pack(params, state):
        return _pack(fl, params,
                     _momentum_payload(optimizer, state) if mixed else None)

    if schedule == "sync" and not error_feedback and not mixed:
        def update_sync(params, grads, state):
            return optimizer.update(params, grads, state, comm)
        return update_sync

    strategy = fl.strategy
    if schedule == "sync":
        def update_sync_staged(params, grads, state):
            spec, bufs = pack(params, state)
            if error_feedback:
                wire, new_res, new_qwarm = strategy.compress_ef(
                    bufs, state.step, state.residual, state.qwarm)
            else:
                wire, new_res, new_qwarm = (
                    strategy.quantize_stage(bufs, state.step),
                    state.residual, state.qwarm)
            ex = _exchange_result(spec, strategy.continue_from_wire(
                bufs, wire, state.step), mixed)
            new_params, new_state = optimizer.update(params, grads, state,
                                                     comm, exchanged=ex)
            return new_params, new_state._replace(residual=new_res,
                                                  qwarm=new_qwarm)
        return update_sync_staged

    check_overlap_support(optimizer, comm)

    def update_overlap(params, grads, state):
        spec, bufs = pack(params, state)
        ex = _exchange_result(spec, strategy.continue_from_wire(
            bufs, state.wire, state.step), mixed)
        new_params, new_state = optimizer.update(params, grads, state, comm,
                                                 exchanged=ex)
        # the fused kernels wrote the new params into the packed grads (and
        # v' into a fresh pack of the momentum), so ``bufs`` still holds
        # (x_t, v_t): quantize it as the wire of step t + 1
        if error_feedback:
            new_wire, new_res, new_qwarm = strategy.compress_ef(
                bufs, state.step, state.residual, state.qwarm)
            return new_params, new_state._replace(
                wire=new_wire, residual=new_res, qwarm=new_qwarm)
        return new_params, new_state._replace(
            wire=strategy.advance_wire(bufs, state.wire, state.step))

    return update_overlap


def make_local_wire_init(fl: consensus.FlatComm) -> Callable:
    """One agent's overlap wire initializer, the reference's name for
    :func:`consensus.initial_wire_state` on a sharded ``fl``: its strategy
    packs and quantizes the agent's own params (seed ``-1``), the wire
    keeping its leading agent axis of 1."""
    return functools.partial(consensus.initial_wire_state, fl)


def make_local_residual_init(fl: consensus.FlatComm) -> Callable:
    """One agent's error-feedback residuals, the reference's name for
    :func:`consensus.initial_residual_state` on a sharded ``fl``."""
    return functools.partial(consensus.initial_residual_state, fl)


def make_local_qwarm_init(fl: consensus.FlatComm) -> Callable:
    """One agent's rank-r warm-start bases (``(1, 128, r)`` per bucket),
    the reference's name for :func:`consensus.initial_qwarm_state` on a
    sharded ``fl``."""
    return functools.partial(consensus.initial_qwarm_state, fl)


@dataclasses.dataclass
class StepProgram:
    """One training step assembled from the named phases.

    ``extra_metrics(new_params)`` appends mode-specific diagnostics (the
    stacked trainer's consensus error).
    """

    optimizer: DistributedOptimizer
    comm: CommOps
    grad_phase: Callable          # (gp, batch) -> ((losses, metrics), grads)
    update_phase: Callable        # (params, grads, state) -> (params', state')
    schedule: str = "sync"
    extra_metrics: Optional[Callable[[PyTree], Dict[str, torch.Tensor]]] = None

    def init_state(self, params: PyTree) -> OptState:
        """The optimizer's state, with the overlap wire (``x_{-1} := x_0``
        at seed -1; ``v_{-1} := 0`` under momentum mixing), the zero
        error-feedback residuals and the rank compressor's warm start
        (under both schedules) filled in."""
        state = self.optimizer.init(params)
        fl = self.comm.flat
        if fl is None:
            return state
        if self.schedule == "overlap":
            check_overlap_support(self.optimizer, self.comm)
            state = state._replace(wire=consensus.initial_wire_state(fl, params))
        if fl.program.error_feedback:
            check_program_support(self.optimizer, self.comm)
            state = state._replace(
                residual=consensus.initial_residual_state(fl, params))
        if fl.program.compressed:
            state = state._replace(
                qwarm=consensus.initial_qwarm_state(fl, params))
        return state

    @torch.no_grad()
    def _update(self, params, grads, opt_state):
        new_params, new_state = self.update_phase(params, grads, opt_state)
        extra = self.extra_metrics(new_params) if self.extra_metrics else {}
        return new_params, new_state, extra

    def step_fn(self, params: PyTree, opt_state: OptState, batch):
        if self.schedule == "overlap":
            # the carried wire's exchange starts before the gradients (a
            # no-op in the stacked simulation, whose wire moves nowhere)
            opt_state = opt_state._replace(
                wire=self.comm.flat.strategy.post_exchange(opt_state.wire,
                                                           opt_state.step))
        gp = self.optimizer.grad_params(params, opt_state)
        (losses, metrics), grads = self.grad_phase(gp, batch)
        new_params, new_state, extra = self._update(params, grads, opt_state)
        out = {"loss": torch.mean(losses)}
        out.update(extra)
        for k, v in metrics.items():
            out[k] = torch.mean(v)
        return new_params, new_state, out


def wire_bytes_per_neighbor(wire) -> int:
    """Bytes ONE neighbor transfer of a carried wire state moves, per agent,
    counted from the actual buffers: the payload, plus the row scales for
    quantized (one-byte) payloads.  The unit scales of f32 / bf16 wires are
    synthesized after the exchange, so they cost nothing.  A compressed
    entry (:class:`~repro_torch.core.consensus.TopKWire` /
    :class:`~repro_torch.core.consensus.RankWire`) counts every field: the
    receivers can rebuild none of them.  A :class:`~repro_torch.core.
    consensus.WireRing` counts ONE ring generation — the sender-selected
    slot is all that is exchanged, so the bytes do not depend on the ring
    depth; the stale slots and the age counters are local state."""
    ring = isinstance(wire, consensus.WireRing)
    drop = 2 if ring else 1         # the agent axis, and the ring axis
    total = 0
    for entry in (wire.slots if ring else wire):
        if isinstance(entry, (consensus.TopKWire, consensus.RankWire)):
            fields = list(entry)
        else:
            payload, scales = entry
            fields = [payload, scales] if payload.element_size() == 1 \
                else [payload]
        total += sum(math.prod(x.shape[drop:]) * x.element_size()
                     for x in fields)
    return total
