"""Rank bodies of ``test_torch_sharded_tp.py``: training over the model
axis, one process per ``(agent, model coordinate)``.

A spawned rank imports its target by module name, so the bodies live in
this helper module on the tests' path; it imports no JAX.  The parent
writes the inputs with ``torch.save``; each rank loads them, runs its
share through :func:`repro_torch.launch.steps.build_train_step` on its
blocks of the params and returns plain results (tensors on the CPU,
numbers, the census of each step).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import collectives, engine
from repro_torch.core import consensus as consensus_lib
from repro_torch.core.flatbuf import make_flat_spec
from repro_torch.launch import check
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import AgentMesh
from repro_torch.launch.sharding import local_batch
from repro_torch.nn import transformer as tt
from repro_torch.nn.param import local_shard
from repro_torch.utils.tree import tree_leaves, tree_map

import torch_sharded_ranks as ranks


def tp_config(arch: str):
    """A reduced dense config in float32 (the reference's sharded tests'
    granite-3-8b; gemma3-1b's one KV head replicates on ``model`` 2)."""
    return dataclasses.replace(get_config(arch).reduced(), param_dtype="float32")


def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu().clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def _build(cfg, mesh, data, opt="cdmsgd", **kw):
    shape = InputShape("tiny_train", data["seq"], data["batch"] * mesh.n_agents,
                       "train")
    return steps_lib.build_train_step(cfg, shape, mesh, ranks.make_opt(opt, True),
                                      topology_name="ring",
                                      mixing="ppermute_fused", **kw)


def _grad_gaps(bundle, cfg, mesh, full, batch) -> dict:
    """This rank's gradient blocks from the tensor-parallel grad phase
    against the blocks of the agent's unsharded gradient (the agent-only
    grad phase, here in the rank): ``{leaf: (max |diff|, max |g|)}``, and
    the losses."""
    (loss, _), g = bundle.grad_phase(local_shard(full, bundle.local_specs, mesh),
                                     batch)
    plain = engine.make_grad_phase(lambda p, b: tt.loss_fn(cfg, p, b),
                                   per_agent=False)
    (want_loss, _), want = plain(full, batch)
    want = local_shard(want, bundle.local_specs, mesh)
    from repro_torch.utils.tree import tree_flatten_with_path

    gaps = {}
    for (path, x), y in zip(tree_flatten_with_path(g), tree_leaves(want)):
        gaps["/".join(map(str, path))] = (float((x - y).abs().max()),
                                          float(y.abs().max()))
    return {"gaps": gaps, "loss": float(loss), "want_loss": float(want_loss),
            "grads": g}


def _plane_collectives(mesh, data) -> dict:
    """The agent collectives on this rank's block of the carried params:
    ``all_reduce_mean`` and the dense mixing's all-gather on the model mesh
    (over this rank's agent plane), and ``all_reduce_mean`` on an
    agent-only mesh of the same plane's processes."""
    cfg = tp_config("gemma3-1b")
    bundle = _build(cfg, mesh, data)
    p0 = data["P0"]["gemma3-1b"]
    block = local_shard(p0, bundle.param_specs, mesh, stacked=True)
    leaves = tree_leaves(block)
    mean = collectives.all_reduce_mean(mesh, leaves)
    gathered = [collectives.all_gather(mesh, x) for x in leaves]
    mixed = consensus_lib.make_gathered_mix_fn(bundle.topology, mesh)(block)
    # an agent-only mesh over the processes of each agent plane (every rank
    # creates every plane's group, in the same order)
    groups = [dist.new_group(plane) for plane in _planes(mesh)]
    alone = AgentMesh(rank=mesh.agent, size=mesh.n_agents, backend="gloo",
                      group=groups[mesh.coord("model")], device=mesh.device)
    return {"mean": mean, "gathered": gathered, "mixed": mixed,
            "mean_agent_only": collectives.all_reduce_mean(alone, leaves)}


def _planes(mesh) -> list:
    from repro_torch.launch.mesh import agent_planes

    return agent_planes(mesh.shape)


def run_tp(mesh, inputs_path: str) -> dict:
    """Training over the model axis on this rank of ``data x model``:

    * per arch, the grad phase's blocks against the agent's unsharded
      gradient, ``remat=False`` against the default ``remat=True``, and
      whole steps from the carried weights (row ``agent`` of ``P0``,
      this rank's blocks) with the census of each;
    * the update phase teacher-forced from the stacked trainer's state and
      gradients (:func:`~repro_torch.launch.steps.local_train_state`);
    * an int8 overlap step's wire and census;
    * the agent collectives on the model mesh;
    * the wire-contract checker over the entries ``data["check"]``
      (:func:`repro_torch.launch.check.sharded_rank`)."""
    data = torch.load(inputs_path, weights_only=False)
    census = mesh.census
    out = {"agent": mesh.agent, "model": mesh.coord("model")}
    for arch in data["archs"]:
        cfg = tp_config(arch)
        p0 = data["P0"][arch]
        bundle = _build(cfg, mesh, data)
        full = tree_map(lambda x: x[mesh.agent].clone(), p0)
        batch = local_batch(data["batches"][0], mesh)
        census.reset()
        res = _grad_gaps(bundle, cfg, mesh, full, batch)
        res["grad_census"] = census.snapshot()
        off = _build(cfg, mesh, data, remat=False)
        (_, _), g_off = off.grad_phase(local_shard(full, bundle.local_specs, mesh),
                                       batch)
        res["remat_bitwise"] = ranks.leaves_equal(res.pop("grads"), g_off)
        params = local_shard(p0, bundle.param_specs, mesh, stacked=True)
        state = bundle.init_state(params)
        steps = []
        for b in data["batches"]:
            census.reset()
            params, state, metrics = bundle.step_fn(params, state,
                                                    local_batch(b, mesh))
            steps.append({"census": census.snapshot(),
                          "loss": float(metrics["loss"])})
        res.update(params=_cpu(params), steps=steps)
        teacher = data["teacher"].get(arch)
        if teacher is not None:
            p1, s1 = steps_lib.local_train_state(teacher["params"],
                                                 teacher["opt_state"], mesh, bundle)
            grads = steps_lib.local_blocks(teacher["grads"], bundle)
            with torch.no_grad():
                res["update"] = _cpu(bundle.update_phase(p1, grads, s1))
        out[arch] = res
    out["more"] = _more_programs(mesh, data)
    # the int8 overlap wire of the local shard, one step
    cfg = tp_config("granite-3-8b")
    bundle = _build(cfg, mesh, data, exchange="int8", schedule="overlap",
                    remat=False)
    params = local_shard(data["P0"]["granite-3-8b"], bundle.param_specs, mesh,
                         stacked=True)
    state = bundle.init_state(params)
    spec = make_flat_spec(params)
    census.reset()
    bundle.step_fn(params, state, local_batch(data["batches"][0], mesh))
    out["int8"] = {"census": census.snapshot(),
                   "rows": [b.rows for b in spec.buckets],
                   "wire_rows": [p.shape[-2] for p, _ in state.wire],
                   "wire_bytes": engine.wire_bytes_per_neighbor(state.wire),
                   "program_bytes": consensus_lib.program_bytes_per_neighbor(
                       spec, bundle.mixing_program),
                   "degree": bundle.topology.degree(),
                   "local_numel": sum(t.numel() for t in tree_leaves(params))}
    out["plane"] = _plane_collectives(mesh, data)
    out["check"] = check.sharded_rank(mesh, data["check"])
    return out


def _more_programs(mesh, data) -> dict:
    """Further programs on granite's blocks: each fused one's update phase
    teacher-forced from the stacked trainer (``data["more_teacher"]``),
    each per-leaf mixing and mean baseline three whole steps from the
    carried weights."""
    from repro_torch.core import make_topology_schedule

    cfg = tp_config("granite-3-8b")
    p0 = data["P0"]["granite-3-8b"]
    out = {}
    for name, spec in data["more"].items():
        knobs = dict(spec["knobs"])
        if "topology_schedule" in knobs:
            knobs["topology_schedule"] = make_topology_schedule(
                knobs["topology_schedule"], mesh.n_agents)
        shape = InputShape("tiny_train", data["seq"],
                           data["batch"] * mesh.n_agents, "train")
        bundle = steps_lib.build_train_step(
            cfg, shape, mesh, ranks.make_opt(spec["optimizer"], spec["fused"]),
            topology_name="ring", mixing=spec["mixing"], remat=False, **knobs)
        teacher = data["more_teacher"].get(name)
        if teacher is not None:
            p1, s1 = steps_lib.local_train_state(teacher["params"],
                                                 teacher["opt_state"], mesh, bundle)
            grads = steps_lib.local_blocks(teacher["grads"], bundle)
            with torch.no_grad():
                out[name] = _cpu(bundle.update_phase(p1, grads, s1))
            continue
        params = local_shard(p0, bundle.param_specs, mesh, stacked=True)
        state = bundle.init_state(params)
        for b in data["batches"]:
            params, state, _ = bundle.step_fn(params, state, local_batch(b, mesh))
        out[name] = _cpu(params)
    return out


def run_factored_tp(mesh, inputs_path: str) -> dict:
    """One rank of ``pod x data x model``: granite's update phase
    teacher-forced from the stacked trainer on ``kron(Pi_pod, Pi_data)``,
    one whole step, this rank's senders, and the agent collectives over
    its agent plane (a group of its own: two agent axes) on its blocks of
    the carried weights."""
    data = torch.load(inputs_path, weights_only=False)
    cfg = tp_config("granite-3-8b")
    bundle = _build(cfg, mesh, data, remat=False)
    teacher = data["teacher"]
    p1, s1 = steps_lib.local_train_state(teacher["params"], teacher["opt_state"],
                                         mesh, bundle)
    grads = steps_lib.local_blocks(teacher["grads"], bundle)
    with torch.no_grad():
        update = bundle.update_phase(p1, grads, s1)
    params = local_shard(data["P0"], bundle.param_specs, mesh, stacked=True)
    state = bundle.init_state(params)
    mesh.census.reset()
    params, state, metrics = bundle.step_fn(
        params, state, local_batch(data["batches"][0], mesh))
    block = local_shard(data["P0"], bundle.param_specs, mesh, stacked=True)
    return {"update": _cpu(update), "step": _cpu(params),
            "census": mesh.census.snapshot(), "loss": float(metrics["loss"]),
            "topology": bundle.topology.name,
            "senders": bundle.comm.flat.strategy.plans[0].senders,
            "mean": collectives.all_reduce_mean(mesh, tree_leaves(block)),
            "gathered": collectives.all_gather(mesh, tree_leaves(block)[0])}


def card_tp_grads(mesh) -> dict:
    """This rank's tensor-parallel gradient blocks of reduced granite-3-8b
    (float32, remat on) on its device, against the agent's unsharded
    gradient computed here, and one whole fused step's census: the gaps
    ``{leaf: (max |diff|, max |g|)}`` and the Census by axis."""
    import numpy as np

    from repro_torch.data import lm_agent_batches, make_lm_tokens
    from repro_torch.nn.param import params_from_numpy

    cfg = tp_config("granite-3-8b")
    data = {"seq": 16, "batch": 2}
    bundle = _build(cfg, mesh, data)
    rng = np.random.default_rng(mesh.agent)
    full = params_from_numpy(tree_map(
        lambda x: x + 0.01 * rng.normal(size=x.shape).astype(np.float32),
        ranks.live_params(tt.model_template(cfg), seed=0)), mesh.device)
    stream = lm_agent_batches(make_lm_tokens(1 << 12, vocab=cfg.vocab_size, seed=0),
                              mesh.n_agents, data["batch"], data["seq"], seed=0)
    batch = local_batch(next(stream), mesh)
    res = _grad_gaps(bundle, cfg, mesh, full, batch)
    params = local_shard(full, bundle.local_specs, mesh)
    mesh.census.reset()
    bundle.step_fn(params, bundle.init_state(params), batch)
    return {"gaps": res["gaps"], "census": mesh.census.snapshot()}
