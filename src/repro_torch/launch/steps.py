"""The sharded production steps: one process per device.

The port of :mod:`repro.launch.steps`: :func:`build_train_step` (one agent
per process), :func:`build_prefill_step` and :func:`build_serve_step` (the
serve mode: the dense family's weights over ``data`` and ``model``).

Training is the port of :func:`repro.launch.steps.build_train_step`.  The reference
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
forward`).

On a mesh with a ``model`` axis (``{"data": d, "model": m}``, or with
``pod``) each rank holds its agent's blocks under the ``train`` rules:
the ``tp`` dims over ``model``, ``fsdp`` replicated
(:func:`local_train_state`, :func:`repro_torch.nn.param.local_shard`
with ``stacked=True``, :attr:`TrainStepBundle.local_template`).  The
grad phase runs the dense family's tensor-parallel forward and backward
(:meth:`~repro_torch.nn.tensor_parallel.TensorParallel.for_training`:
Megatron's collectives over ``model`` with their backward passes, a
vocabulary-parallel cross entropy); the update phase packs the rank's
shard into the flat buckets, exchanges them with the ranks of the same
``model`` coordinate (the wire holds the local shard's rows, as the
reference's shard-local layout does) and runs the fused kernel at one
output agent, as on an agent-only mesh.  The means and the dense mixing
run over the agent plane of the rank's ``model`` coordinate.

What the sharded mode does not run yet raises at build time, before any
work: a fused optimizer outside ``ppermute_fused``, ``train_hier``
(ROADMAP A16.2.2), a family other than the dense one on a ``model`` axis
of more than one rank (MoE's expert split and the other families' ``tp``
training, ROADMAP A16.2.3), and a compressor there (the reference's
``ValueError``: top-k's index payload and rank-r's bases do not shard
over ``model``).

Serving runs on a mesh with a ``model`` axis (``{"data": d, "model":
m}``, or with ``pod``), under the serve rules (``fsdp`` over ``data``,
``tp`` over ``model``; :mod:`repro_torch.launch.sharding`).  Each rank
holds its blocks of the params (:func:`repro_torch.nn.param.local_shard`
of the global tree, by :attr:`ServeStepBundle.param_specs`), of the batch
(its rows along :func:`~repro_torch.launch.sharding.serve_batch_count`'s
axes) and of the cache (:meth:`ServeStepBundle.init_cache`), and its
forward and decode run under a
:class:`~repro_torch.nn.tensor_parallel.TensorParallel` context:
``prefill_step(params, batch)`` returns the last position's logits ``(b
local, vocab)``; ``serve_step(params, cache, tokens, cur_index)`` returns
``(next_tok (b local, 1) int32, cache)``, the cache updated in place.
The dense family only (ROADMAP A16.2.3 for the others);
``context_parallel=True`` raises (ROADMAP A16.2.4: the flash kernel takes
no query offset, so a sequence-sharded causal query block needs a kernel
change).

Usage, in each rank (see :func:`repro_torch.launch.mesh.spawn_agents`)::

    bundle = build_train_step(cfg, shape, mesh, make_optimizer("cdmsgd", 0.01,
                              mu=0.9, fused=True), mixing="ppermute_fused")
    params = init_params(model_template(cfg), seed, device=mesh.device)
    opt_state = bundle.init_state(params)
    for batch in lm_agent_batches(...):
        params, opt_state, metrics = bundle.step_fn(
            params, opt_state, local_batch(batch, mesh))

and for serving, in each rank of ``spawn_agents(fn, 4, axes={"data": 2,
"model": 2})``::

    bundle = build_serve_step(cfg, InputShape("d", max_len, batch, "decode"),
                              mesh)
    params = local_shard(global_params, bundle.param_specs, mesh)
    cache = bundle.init_cache()
    tok, cache = bundle.step_fn(params, cache, bundle.local(tokens), 0)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional

import torch

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
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.nn import transformer as tt
from repro_torch.nn.param import (CONTEXT_PARALLEL_ITEM, TRAIN_HIER_ITEM,
                                  ParamDef, PartitionSpec, local_shape,
                                  local_shard, stack_agent_axis)
from repro_torch.nn.tensor_parallel import TensorParallel
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
    # the tensor-parallel context of the grad phase (a model axis of more
    # than one rank), else None
    tp: Optional[TensorParallel] = None

    @property
    def local_specs(self) -> PyTree:
        """The specs of this rank's blocks: :attr:`param_specs` without
        the agent dimension."""
        return tree_map(lambda sp: PartitionSpec(tuple(sp.axes[1:])),
                        self.param_specs)

    @property
    def local_template(self) -> PyTree:
        """This rank's ParamDef tree: one agent's (the agent axis dropped),
        its ``tp`` dims cut to this rank's block on a ``model`` axis."""
        return tree_map(lambda pd, sp: ParamDef(
            local_shape(pd.shape[1:], sp, self.mesh), pd.axes[1:],
            init=pd.init, scale=pd.scale, dtype=pd.dtype),
            self.param_template, self.local_specs)


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
                       flat=None, agent=mesh.agent)
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
    if mode == "serve":
        raise ValueError("mode 'serve' has no agent axis to train over: "
                         "build_prefill_step / build_serve_step serve")
    if mode == "train_hier":
        raise NotImplementedError(f"mode 'train_hier': {TRAIN_HIER_ITEM}")
    split = mesh.shape.get(MODEL_AXIS, 1) > 1
    if split:
        tt._check_family(cfg, sharded=True)
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
    other_axes = tuple(a for a in mesh.axis_names if a not in rules["agent"])
    if program.compressed and any(mesh.shape[a] > 1 for a in other_axes):
        raise ValueError(
            f"compressor={program.compressor!r} supports agent-only sharding: "
            f"the rank factors / warm-start bases ((r, 128) and (128, r)) and "
            f"the top-k index payload do not shard over the non-agent mesh "
            f"axes {other_axes}; use an agent-only mesh or a dense "
            f"compressor (int8/fp8)")
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

    tp = TensorParallel.for_training(mesh, pspecs) if split else None
    grad_phase = engine.make_grad_phase(
        lambda p, b: loss_fn(cfg, p, b, remat=remat, tp=tp), microbatches,
        per_agent=False)
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
        grad_phase=grad_phase, update_phase=update_phase, tp=tp)


def local_blocks(tree: PyTree, bundle: TrainStepBundle, stacked: bool = True) -> PyTree:
    """This rank's blocks of an agent-stacked tree of param-shaped leaves
    (``stacked=False``: of its agent's row) — the params, their gradients,
    or an optimizer state of one or more param trees laid end to end: each
    leaf takes the spec of the param it mirrors."""
    from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

    specs = tree_leaves(bundle.param_specs if stacked else bundle.local_specs)
    leaves, treedef = tree_flatten(tree)
    if len(leaves) % len(specs):
        raise ValueError(f"{len(leaves)} state leaves for {len(specs)} params")
    return tree_unflatten(treedef, [
        local_shard(x, specs[i % len(specs)], bundle.mesh, stacked=stacked)
        for i, x in enumerate(leaves)])


def local_train_state(params: PyTree, opt_state: OptState, agent,
                      bundle: Optional[TrainStepBundle] = None):
    """A rank's share of a stacked trainer's state, in the sharded mode's
    layout; the step count carries over.

    ``agent`` an int (an agent-only mesh): each param and optimizer-state
    leaf's row ``agent``; the wire pairs and residuals keep a leading
    agent axis of 1.  ``agent`` the rank's mesh (with ``bundle``, the
    rank's step): this rank's blocks of the params, the momentum and the
    Adam moments (:func:`local_blocks`: the agent's, cut at the ``model``
    coordinate); the wire pairs, residuals and warm-start bases are no
    blocks of a global tensor (each rank packs its own shard), so they are
    made anew by ``bundle.init_state`` on the rank's blocks of the
    params."""
    if not isinstance(agent, int):
        local = local_blocks(params, bundle)
        fresh = bundle.init_state(local)
        return local, fresh._replace(step=opt_state.step,
                                     inner=local_blocks(opt_state.inner, bundle))

    def row(x):
        return x[agent].clone()

    def lead(x):
        return x[agent:agent + 1].clone()

    return tree_map(row, params), opt_state._replace(
        inner=tree_map(row, opt_state.inner),
        wire=tree_map(lead, opt_state.wire),
        residual=tree_map(lead, opt_state.residual),
        qwarm=tree_map(lead, opt_state.qwarm))


@dataclasses.dataclass
class ServeStepBundle:
    """One rank's serve step (see the module docstring)."""

    step_fn: Callable
    param_template: PyTree        # ParamDef tree (global shapes)
    param_specs: PyTree           # PartitionSpec tree (the serve rules)
    input_structs: tuple          # (batch,) or (cache, tokens, cur_index) TensorSpecs
    kind: str                     # "prefill" | "decode"
    mesh: Any
    cfg: ArchConfig
    shape: InputShape
    tp: TensorParallel
    # decode: (params, cache, tokens, cur_index) -> (logits (b local, vocab), cache)
    logits_fn: Optional[Callable] = None

    def local(self, x, spec: Optional[PartitionSpec] = None):
        """This rank's block of a global input (the prefill batch's dict,
        or the decode's ``tokens``), by its spec in
        :attr:`input_structs`."""
        if spec is None:
            if self.kind == "prefill":
                return {k: self.local(v, self.input_structs[0][k].spec)
                        for k, v in x.items()}
            spec = self.input_structs[1].spec
        return local_shard(x, spec, self.mesh)

    def local_params(self, params: PyTree) -> PyTree:
        """This rank's blocks of the global ``params``."""
        return local_shard(params, self.param_specs, self.mesh)

    def init_cache(self, device=None):
        """This rank's blocks of the zeroed cache of :attr:`shape`."""
        return shlib.local_cache(self.cfg, self.shape, self.mesh,
                                 self.mesh.device if device is None else device)

    def generate(self, params, prompt, new_tokens: int, cache=None):
        """Greedy decoding through :attr:`logits_fn` from an empty cache (or
        ``cache``): ``prompt (b local, p)`` teacher-forced one token a step,
        then ``new_tokens`` argmax tokens.  Returns ``(tokens (b local, p +
        new_tokens), logits of every step (steps, b local, vocab), cache)``,
        as :func:`repro_torch.launch.serve.serve` decodes."""
        cache = self.init_cache() if cache is None else cache
        tok, out, logits = prompt[:, :1], [prompt[:, :1]], []
        for i in range(prompt.shape[1] + new_tokens - 1):
            lg, cache = self.logits_fn(params, cache, tok, i)
            logits.append(lg)
            tok = (prompt[:, i + 1:i + 2] if i + 1 < prompt.shape[1]
                   else torch.argmax(lg, dim=-1)[:, None].to(prompt.dtype))
            out.append(tok)
        return torch.cat(out, dim=1), torch.stack(logits), cache


def _check_serve(cfg: ArchConfig, mesh) -> None:
    """Raise for a mesh without a ``model`` axis and for a family the serve
    mode does not run."""
    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f"the serve mode shards over a 'model' axis; the mesh "
                         f"has {mesh.axis_names}")
    tt._check_family(cfg, sharded=True)


def _serve_context(cfg: ArchConfig, mesh, cache_specs=None):
    """The serve rules' param specs and this rank's tensor-parallel
    context."""
    template = model_template(cfg)
    pspecs = shlib.safe_partition_specs(template,
                                        shlib.rules_for_mode("serve", mesh), mesh)
    return template, pspecs, TensorParallel(mesh, pspecs, cache_specs)


def build_prefill_step(cfg: ArchConfig, shape: InputShape, mesh, *,
                       context_parallel: bool = False) -> ServeStepBundle:
    """One rank's prefill step: ``prefill_step(params, batch)`` -> the last
    position's logits ``(b local, vocab)``, the full-sequence forward on
    this rank's blocks (the flash kernel on its query heads)."""
    if context_parallel:
        raise NotImplementedError(
            "context_parallel=True shards the prefill's query sequence over "
            "model: the flash kernel takes no query offset for a causal "
            f"block; {CONTEXT_PARALLEL_ITEM}")
    _check_serve(cfg, mesh)
    template, pspecs, tp = _serve_context(cfg, mesh)
    batch_specs = shlib.prefill_batch_specs(cfg, shape, mesh)

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = tt.forward(cfg, params, batch, tp=tp, last_only=True)
        return logits[:, -1, :]

    return ServeStepBundle(step_fn=prefill_step, param_template=template,
                           param_specs=pspecs, input_structs=(batch_specs,),
                           kind="prefill", mesh=mesh, cfg=cfg, shape=shape, tp=tp)


def build_serve_step(cfg: ArchConfig, shape: InputShape, mesh) -> ServeStepBundle:
    """One rank's decode step: ``serve_step(params, cache, tokens,
    cur_index)`` -> ``(next_tok (b local, 1) int32, cache)``, one token
    against this rank's block of the cache (updated in place)."""
    _check_serve(cfg, mesh)
    cache, tokens, cur = shlib.decode_input_specs(cfg, shape, mesh)
    template, pspecs, tp = _serve_context(
        cfg, mesh, tree_map(lambda t: t.spec, cache))

    def decode_logits(params, cache, tokens, cur_index):
        with torch.no_grad():
            return tt.decode_step(cfg, params, cache, tokens, int(cur_index), tp=tp)

    def serve_step(params, cache, tokens, cur_index):
        logits, cache = decode_logits(params, cache, tokens, cur_index)
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32), cache

    return ServeStepBundle(step_fn=serve_step, param_template=template,
                           param_specs=pspecs, input_structs=(cache, tokens, cur),
                           kind="decode", mesh=mesh, cfg=cfg, shape=shape, tp=tp,
                           logits_fn=decode_logits)
