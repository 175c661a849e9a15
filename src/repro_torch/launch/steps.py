"""The sharded production step: one agent per process.

The port of :func:`repro.launch.steps.build_train_step`.  The reference
runs every agent on its own slice of a device mesh under ``shard_map``;
the port runs every agent in its own process on ``torch.distributed``
(:mod:`repro_torch.launch.mesh`), and :func:`build_train_step` builds ONE
rank's step: ``step_fn(params, opt_state, batch)`` over that agent's
tensors (its params, without the agent axis, and its slice of the
agent-stacked batch, :func:`repro_torch.launch.sharding.local_batch`).
The step is the same :class:`~repro_torch.core.engine.StepProgram` phase
pipeline as the stacked trainer's (grad -> pack -> quantize -> exchange ->
update), with the consensus mixing as

* ``mixing="dense"``   — an all-gather of every leaf and this agent's row
  of ``Pi`` (the reference's dense einsum, whose all-gathers XLA makes);
* ``mixing="ppermute"`` — per-leaf circulant permutations, every leaf and
  shift posted at once (the reference's one ``collective-permute`` per
  leaf per shift);
* ``mixing="ppermute_fused"`` — the flat-buffer fast path: one transfer
  per circulant shift per bucket (and per row-scale tensor of an int8 /
  fp8 wire) for the whole model, then the fused update kernel in its
  one-agent stencil form, one launch per bucket
  (:func:`repro_torch.core.consensus.sharded_flat_comm`).

The fused path carries the stacked trainer's knobs: ``exchange`` (f32 |
bf16 | int8 | fp8), ``schedule`` (``"overlap"`` posts the carried wire's
exchange before the grad phase and waits on it in the update phase),
``mixing_strategy`` / ``topology_schedule`` / ``consensus_rounds``,
``error_feedback``, ``momentum_mixing``, the staleness ring and fault
schedules (``staleness`` / ``fault_schedule``: each rank carries its own
ring and ships the slot it selects) and the compressors (``topk:p`` /
``topk:auto:B``, with ``sparse_update`` the sparse kernels at one output
agent, and ``rank:r``); ``microbatches`` splits the agent's batch.
``FedAvg(faults=...)`` averages over the present agents.  A mesh with
``pod`` and ``data`` agent axes (:class:`~repro_torch.launch.mesh.
AgentMesh` ``axes``) mixes over the Kronecker product of one circulant
factor per axis (:func:`_agent_factors`: a ring on an axis of more than 2
agents, fully connected otherwise), ``topology_name`` aside, as the
reference does.  ``remat`` (the reference's default, on) recomputes each
block of the loss in the backward pass (:func:`repro_torch.nn.transformer.
forward`).  What the sharded mode does not run yet raises at build time,
before any work: a fused optimizer outside ``ppermute_fused``, and the
non-agent model axes (``train_hier`` / ``serve``, ROADMAP A16.2);
``build_prefill_step`` and ``build_serve_step`` wait for A16.2.

Usage, in each rank (see :func:`repro_torch.launch.mesh.spawn_agents`)::

    bundle = build_train_step(cfg, shape, mesh, make_optimizer("cdmsgd", 0.01,
                              mu=0.9, fused=True), mixing="ppermute_fused")
    params = init_params(model_template(cfg), seed, device=mesh.device)
    opt_state = bundle.init_state(params)
    for batch in lm_agent_batches(...):
        params, opt_state, metrics = bundle.step_fn(
            params, opt_state, local_batch(batch, mesh))
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import consensus as consensus_lib
from repro_torch.core import engine
from repro_torch.core.faults import make_fault_schedule
from repro_torch.core.optim import (CommOps, DistributedOptimizer, FedAvg,
                                    GossipSGD, OptState, TimeVaryingCDSGD,
                                    factored_comm_ops, sharded_comm_ops)
from repro_torch.core.topology import (Topology, make_topology,
                                       make_topology_schedule)
from repro_torch.launch import sharding as shlib
from repro_torch.nn.param import ParamDef, stack_agent_axis
from repro_torch.nn.transformer import loss_fn, model_template
from repro_torch.utils.tree import tree_map

PyTree = Any
MIXINGS = ("dense", "ppermute", "ppermute_fused")


@dataclasses.dataclass
class TrainStepBundle:
    step_fn: Callable             # (params, opt_state, batch) -> (params, opt_state, metrics)
    param_template: PyTree        # ParamDef tree (agent-stacked)
    param_specs: PyTree           # PartitionSpec tree
    batch_specs: Dict[str, shlib.TensorSpec]
    n_agents: int
    topology: Topology
    mesh: Any
    exchange: str = "f32"         # neighbour-exchange wire precision
    schedule: str = "sync"        # exchange schedule: sync | overlap
    # the mixing program of the fused path (None for dense / ppermute)
    mixing_program: Optional[consensus_lib.MixingProgram] = None
    # the StepProgram state initializer (fills the overlap wire and the
    # error-feedback residuals of this agent)
    init_state: Optional[Callable] = None
    optimizer: Optional[DistributedOptimizer] = None
    comm: Optional[CommOps] = None
    # the phases, for callers that drive them apart (teacher forcing)
    grad_phase: Optional[Callable] = None
    update_phase: Optional[Callable] = None

    @property
    def local_template(self) -> PyTree:
        """One agent's ParamDef tree (the agent axis dropped)."""
        return tree_map(lambda pd: ParamDef(pd.shape[1:], pd.axes[1:],
                                            init=pd.init, scale=pd.scale,
                                            dtype=pd.dtype),
                        self.param_template)


def _agent_factors(mesh, agent_axes) -> consensus_lib.FactoredMix:
    """One circulant factor per agent axis of a factored mesh: a ring on an
    axis of more than 2 agents, fully connected otherwise (the
    reference's ``_agent_factors``)."""
    factors = []
    for a in agent_axes:
        n = mesh.shape[a]
        factors.append((a, make_topology("ring" if n > 2 else "fully_connected",
                                         n)))
    return consensus_lib.FactoredMix(tuple(factors))


def make_local_fused_comm(topology: Topology, mesh, *, exchange: str = "f32",
                          program: Optional[consensus_lib.MixingProgram] = None,
                          factored: Optional[consensus_lib.FactoredMix] = None
                          ) -> CommOps:
    """CommOps of this agent for the fused path: the flat-buffer exchange
    (:func:`~repro_torch.core.consensus.sharded_flat_comm`, over the
    factors of ``factored`` on a ``pod x data`` mesh) plus the per-leaf mix
    and mean, so an unfused optimizer runs on the same comm."""
    flat = consensus_lib.sharded_flat_comm(
        topology, mesh, exchange=exchange, program=program,
        factors=None if factored is None else factored.factors)
    return dataclasses.replace(make_mix_comm(topology, mesh, "ppermute",
                                             factored), flat=flat)


def make_mix_comm(topology: Topology, mesh, mixing: str,
                  factored: Optional[consensus_lib.FactoredMix] = None
                  ) -> CommOps:
    """CommOps of this agent for the per-leaf mixings: ``dense`` (all-gather
    and this agent's row of ``Pi``) or ``ppermute`` (circulant permutations,
    one factor per axis on a ``pod x data`` mesh; a general ``Pi``
    all-gathers, as the reference's ``make_sharded_mix_fn``)."""
    if mixing == "dense":
        return CommOps(mix=consensus_lib.make_gathered_mix_fn(topology, mesh),
                       mean=consensus_lib.make_sharded_mean_fn(mesh),
                       flat=None, agent=mesh.rank)
    if mixing != "ppermute":
        raise ValueError(f"unknown mixing {mixing!r}; expected one of {MIXINGS}")
    if factored is not None:
        return factored_comm_ops(factored, mesh)
    return sharded_comm_ops(topology, mesh)


def _check_sharded(optimizer, mixing, schedule, n_agents: int):
    """The knobs the sharded mode does not run (yet), refused before any
    work."""
    if mixing not in MIXINGS:
        raise ValueError(f"unknown mixing {mixing!r}; expected one of {MIXINGS}")
    if schedule not in engine.SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of "
                         f"{engine.SCHEDULES}")
    if isinstance(optimizer, (GossipSGD, TimeVaryingCDSGD)):
        raise ValueError(f"{type(optimizer).__name__} is a stacked-simulation "
                         "optimizer (it indexes the agent stack); the sharded "
                         "mode runs the consensus optimizers and the "
                         "mean baselines")
    if isinstance(optimizer, FedAvg) and optimizer.faults is not None \
            and optimizer.faults.n_agents != n_agents:
        raise ValueError(f"FedAvg's fault schedule covers "
                         f"{optimizer.faults.n_agents} agents, the mesh "
                         f"{n_agents}")
    if mixing != "ppermute_fused" and getattr(optimizer, "fused", False) \
            and optimizer.has_fused:
        raise ValueError(
            f"{type(optimizer).__name__}(fused=True) runs its flat-buffer "
            f"update under mixing='ppermute_fused' only; got "
            f"mixing={mixing!r} (pass fused=False for the per-leaf path)")


def build_train_step(
    cfg: ArchConfig,
    shape: InputShape,
    mesh,
    optimizer: DistributedOptimizer,
    *,
    mode: str = "train",
    topology_name: str = "ring",
    mixing: str = "dense",
    remat: bool = True,
    microbatches: int = 1,
    exchange: str = "f32",
    schedule: str = "sync",
    mixing_strategy: str = "static",
    consensus_rounds: int = 1,
    topology_schedule=None,
    error_feedback: bool = False,
    momentum_mixing: str = "none",
    staleness: int = 1,
    fault_schedule=None,
    compressor: str = "none",
    sparse_update: Optional[bool] = None,
) -> TrainStepBundle:
    """One rank's training step of the sharded mode (see the module
    docstring)."""
    rules = shlib.rules_for_mode(mode, mesh)
    n_agents = shlib.agent_count(mesh, mode)
    _check_sharded(optimizer, mixing, schedule, n_agents)
    factored = None
    if len(rules["agent"]) > 1:
        factored = _agent_factors(mesh, rules["agent"])
        topology = factored.topology()
    else:
        topology = make_topology(topology_name, n_agents)
    sched_obj = None
    if topology_schedule is not None:
        sched_obj = (make_topology_schedule(topology_schedule, n_agents)
                     if isinstance(topology_schedule, str)
                     else topology_schedule)
    if isinstance(fault_schedule, str):
        fault_schedule = make_fault_schedule(fault_schedule, n_agents)
    program = consensus_lib.make_mixing_program(
        sched_obj if sched_obj is not None else topology,
        strategy=mixing_strategy, rounds=consensus_rounds,
        error_feedback=error_feedback, exchange=exchange,
        momentum_mixing=momentum_mixing, staleness=staleness,
        faults=fault_schedule, compressor=compressor,
        sparse_update=sparse_update)
    exchange = program.exchange
    if not program.is_trivial and mixing != "ppermute_fused":
        raise ValueError(
            f"mixing strategy {program.strategy!r} (rounds={program.rounds}, "
            f"error_feedback={program.error_feedback}) lives on the "
            f"flat-buffer path: requires mixing='ppermute_fused', got "
            f"mixing={mixing!r}")
    if schedule == "overlap" and mixing != "ppermute_fused":
        raise ValueError(
            "schedule='overlap' requires mixing='ppermute_fused' (the "
            "one-step-stale wire double-buffer lives on the flat-buffer "
            f"path); got mixing={mixing!r}")

    base_t = model_template(cfg)
    template = stack_agent_axis(base_t, n_agents)
    pspecs = shlib.safe_partition_specs(template, rules, mesh)
    batch_specs = shlib.train_batch_specs(cfg, shape, mesh, mode)
    if mixing == "ppermute_fused":
        if not getattr(optimizer, "fused", False):
            warnings.warn(
                f"mixing='ppermute_fused' with {type(optimizer).__name__}"
                "(fused=False): the update takes the per-leaf reference path "
                "on the same comm; pass fused=True for the flat-buffer fast "
                "path", stacklevel=2)
        comm = make_local_fused_comm(topology, mesh, exchange=exchange,
                                     program=program, factored=factored)
        engine.check_program_support(optimizer, comm)
    else:
        if exchange != "f32":
            warnings.warn(
                f"exchange={exchange!r} only affects mixing='ppermute_fused'; "
                f"mixing={mixing!r} moves native bytes", stacklevel=2)
        comm = make_mix_comm(topology, mesh, mixing, factored)

    if schedule == "overlap":
        engine.check_overlap_support(optimizer, comm)

    grad_phase = engine.make_grad_phase(
        lambda p, b: loss_fn(cfg, p, b, remat=remat), microbatches, per_agent=False)
    update_phase = engine.make_update_phase(optimizer, comm, schedule)
    step_program = engine.StepProgram(
        optimizer=optimizer, comm=comm, grad_phase=grad_phase,
        update_phase=update_phase, schedule=schedule)
    return TrainStepBundle(
        step_fn=step_program.step_fn, param_template=template,
        param_specs=pspecs, batch_specs=batch_specs, n_agents=n_agents,
        topology=topology, mesh=mesh, exchange=exchange, schedule=schedule,
        mixing_program=program if mixing == "ppermute_fused" else None,
        init_state=step_program.init_state, optimizer=optimizer, comm=comm,
        grad_phase=grad_phase, update_phase=update_phase)


def local_train_state(params: PyTree, opt_state: OptState, agent: int):
    """Agent ``agent``'s share of a stacked trainer's state, in the sharded
    mode's layout: each param and optimizer-state leaf's row ``agent``; the
    wire pairs and residuals keep a leading agent axis of 1.  The step
    count carries over."""
    from repro_torch.utils.tree import tree_map

    def row(x):
        return x[agent].clone()

    def lead(x):
        return x[agent:agent + 1].clone()

    return tree_map(row, params), opt_state._replace(
        inner=tree_map(row, opt_state.inner),
        wire=tree_map(lead, opt_state.wire),
        residual=tree_map(lead, opt_state.residual),
        qwarm=tree_map(lead, opt_state.qwarm))


def build_prefill_step(*args, **kwargs):
    raise NotImplementedError("the sharded prefill step waits for the "
                              "non-agent mesh axes, "
                              f"{consensus_lib.SHARDED_LATER}")


def build_serve_step(*args, **kwargs):
    raise NotImplementedError("the sharded serve step waits for the "
                              "non-agent mesh axes, "
                              f"{consensus_lib.SHARDED_LATER}")
