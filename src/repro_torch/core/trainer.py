"""Multi-agent collaborative trainer (stacked simulation execution mode).

Simulates the paper's N-agent fixed-topology network on one device: every
parameter leaf carries a leading agent axis and the step is assembled from
the :class:`repro_torch.core.engine.StepProgram` phases, as in
:mod:`repro.core.trainer`.  An optimizer built with ``fused=True`` runs the
whole-model flat-buffer update: one consensus-update kernel launch per
parameter dtype bucket per step.

The trainer runs on ``device`` — the CUDA card unless the caller passes
``device="cpu"``; with no card and no device given it raises.  Batches are
numpy dicts (:class:`repro_torch.data.AgentPartitioner`) moved to the
device each step.

The wire knobs are the JAX trainer's and go through
:func:`repro_torch.core.consensus.make_mixing_program`: ``exchange`` (f32 |
bf16 | int8 | fp8, or the ``compressor="int8"|"fp8"`` aliases),
``error_feedback``, ``momentum_mixing`` (none | mixed), ``schedule``
(sync | overlap), and the biased compressors on the error-feedback rail,
``compressor="topk:p" | "topk:auto:B" | "rank:r"`` with ``sparse_update``
(default on for top-k: the update kernels read the compact top-k wire;
``False`` decompresses it for the ``_q`` kernels).  ``mixing_strategy``
(static | time_varying | multi_round) with ``topology_schedule`` (a
:class:`~repro_torch.core.topology.TopologySchedule` or a spec such as
``"alternating:ring:torus"`` / ``"gossip:8"``) and ``consensus_rounds``
select the strategy; ``staleness`` and ``fault_schedule`` (a
:class:`~repro_torch.core.faults.FaultSchedule` or a spec such as
``"stall:1:1:3,drop:0:2"``) engage the bounded-staleness ring under
``schedule="overlap"``.  ``microbatches`` splits each agent's batch and
accumulates the gradients in float32 (:func:`~repro_torch.core.engine.
make_grad_phase`).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import engine, flatbuf
from repro_torch.core.consensus import (
    MixingProgram,
    consensus_error_pytree,
    exchange_bytes_per_step,
    make_mixing_program,
    mean_exchange_bytes_per_step,
)
from repro_torch.core.optim import (
    CommOps,
    DistributedOptimizer,
    FedAvg,
    stacked_comm_ops,
)
from repro_torch.core.faults import make_fault_schedule
from repro_torch.core.topology import Topology, make_topology_schedule
from repro_torch.device import resolve_device
from repro_torch.utils.metrics import MetricHistory
from repro_torch.utils.tree import tree_map

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def broadcast_to_agents(params: PyTree, n_agents: int) -> PyTree:
    """Replicate a single parameter set to all agents (common init)."""
    return tree_map(
        lambda x: x[None].expand((n_agents,) + tuple(x.shape)).clone(), params)


def perturb_per_agent(params: PyTree, gen: torch.Generator,
                      scale: float = 0.01) -> PyTree:
    """De-synchronize agent initializations: ``x + scale * n`` per leaf,
    ``n`` standard normal of the leaf's shape and dtype, drawn from ``gen``
    (on its device) leaf by leaf in tree order.  The JAX package draws from
    split ``jax.random`` keys instead; the two streams differ."""
    return tree_map(lambda x: x + scale * _normal_like(x, gen), params)


def _normal_like(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(x.shape, generator=gen, device=gen.device,
                       dtype=x.dtype).to(x.device)


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@dataclasses.dataclass
class TrainState:
    params: PyTree            # stacked (A, ...)
    opt_state: Any
    step: int = 0


class CollaborativeTrainer:
    """Drives N collaborating agents through a DistributedOptimizer."""

    def __init__(
        self,
        loss_fn: LossFn,
        params: PyTree,                   # single-agent params (will be stacked)
        topology: Topology,
        optimizer: DistributedOptimizer,
        *,
        device=None,
        exchange: str = "f32",
        schedule: str = "sync",
        microbatches: int = 1,
        mixing_strategy: str = "static",
        consensus_rounds: int = 1,
        topology_schedule=None,
        error_feedback: bool = False,
        momentum_mixing: str = "none",
        staleness: int = 1,
        fault_schedule=None,
        compressor: str = "none",
        sparse_update: Optional[bool] = None,
    ):
        if isinstance(topology_schedule, str):
            topology_schedule = make_topology_schedule(topology_schedule,
                                                       topology.n_agents)
        if topology_schedule is not None and \
                topology_schedule.n_agents != topology.n_agents:
            raise ValueError(
                f"topology_schedule spans {topology_schedule.n_agents} agents "
                f"but the topology has {topology.n_agents}")
        if isinstance(fault_schedule, str):
            fault_schedule = make_fault_schedule(fault_schedule,
                                                 topology.n_agents)
        self.program: MixingProgram = make_mixing_program(
            topology_schedule if topology_schedule is not None else topology,
            strategy=mixing_strategy, rounds=consensus_rounds,
            error_feedback=error_feedback, exchange=exchange,
            momentum_mixing=momentum_mixing, staleness=staleness,
            faults=fault_schedule, compressor=compressor,
            sparse_update=sparse_update)
        self.exchange = self.program.exchange
        self.faults = self.program.faults
        self.schedule = schedule
        if self.exchange != "f32" and not getattr(optimizer, "fused", False):
            warnings.warn(
                f"exchange={self.exchange!r} only affects fused optimizers; "
                f"{type(optimizer).__name__}(fused=False) will mix in native "
                "precision", stacklevel=2)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.topology = topology
        self.optimizer = optimizer
        self.comm: CommOps = stacked_comm_ops(topology, program=self.program,
                                              device=self.device)
        # non-trivial programs live on the fused path only: fail here
        engine.check_program_support(optimizer, self.comm)
        params = tree_map(lambda x: torch.as_tensor(x).to(self.device), params)
        stacked = broadcast_to_agents(params, topology.n_agents)
        self._program = engine.StepProgram(
            optimizer=optimizer,
            comm=self.comm,
            grad_phase=engine.make_grad_phase(loss_fn, microbatches),
            update_phase=engine.make_update_phase(optimizer, self.comm, schedule),
            schedule=schedule,
            extra_metrics=lambda p: {"consensus_error": consensus_error_pytree(p)},
        )
        self.state = TrainState(params=stacked,
                                opt_state=self._program.init_state(stacked))
        self.history = MetricHistory()
        # per-step bytes on the wire (estimate): the neighbor exchange of a
        # consensus optimizer (k rounds move k x the bytes, a time-varying
        # schedule its period-mean degree, momentum mixing doubles the
        # payload trees, a compressor prices its carried fields); none for
        # the centralized baselines; FedAvg's whole-model all-reduce once
        # per local_steps, amortized per step
        spec = flatbuf.make_flat_spec(stacked, lead=1)
        self.wire_bytes_per_step = 0
        if optimizer.uses_consensus:
            sched = self.program.schedule
            self.wire_bytes_per_step = exchange_bytes_per_step(
                spec, topology if sched.is_static else sched,
                rounds=self.program.rounds,
                program=self.program)["per_step_bytes"]
        elif isinstance(optimizer, FedAvg):
            self.wire_bytes_per_step = mean_exchange_bytes_per_step(
                spec, topology.n_agents, period=optimizer.local_steps,
                payloads=2 if optimizer.mu else 1)["per_step_bytes"]

    # ------------------------------------------------------------------
    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        p, o, metrics = self._program.step_fn(
            self.state.params, self.state.opt_state,
            _to_device(batch, self.device))
        self.state = TrainState(params=p, opt_state=o, step=self.state.step + 1)
        out = {k: float(v) for k, v in metrics.items()}
        self.history.log(self.state.step, **out)
        return out

    @torch.no_grad()
    def evaluate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Every agent evaluated on the same (global) eval batch."""
        losses, metrics = vmap(self.loss_fn, in_dims=(0, None))(
            self.state.params, _to_device(batch, self.device))
        out = {"loss_mean": losses.mean(), "loss_var": losses.var(correction=0)}
        for k, v in metrics.items():
            out[f"{k}_mean"] = v.mean()
            out[f"{k}_var"] = v.var(correction=0)
        return {k: float(v) for k, v in out.items()}

    def mean_params(self) -> PyTree:
        """The consensus (agent-averaged) model."""
        return tree_map(lambda x: x.mean(dim=0), self.state.params)

    def agent_params(self, j: int) -> PyTree:
        return tree_map(lambda x: x[j], self.state.params)


def train_loop(
    trainer: CollaborativeTrainer,
    batches,
    n_steps: int,
    *,
    eval_batch: Optional[Dict[str, np.ndarray]] = None,
    eval_every: int = 0,
    log_every: int = 0,
    printer: Optional[Callable[[str], None]] = None,
) -> MetricHistory:
    printer = printer or (lambda s: None)
    wire_per_step = getattr(trainer, "wire_bytes_per_step", 0)
    t0 = time.time()
    for i in range(n_steps):
        m = trainer.step(next(batches))
        if log_every and (i + 1) % log_every == 0:
            dt = time.time() - t0
            sps = (i + 1) / dt if dt > 0 else float("inf")
            wire = ""
            if wire_per_step:
                wire = f" wire={wire_per_step * (i + 1) / 1e6:.1f}MB"
            printer(f"step {i+1}/{n_steps} loss={m['loss']:.4f} "
                    f"cons={m['consensus_error']:.3e} {sps:.2f} steps/s"
                    f"{wire} ({dt:.1f}s)")
        if eval_batch is not None and eval_every and (i + 1) % eval_every == 0:
            em = trainer.evaluate(eval_batch)
            trainer.history.log(trainer.state.step, **{f"eval_{k}": v for k, v in em.items()})
    return trainer.history
