"""Rank bodies of the sharded-mode tests (``test_torch_sharded*.py``).

A spawned rank imports its target by module name, and a pytest file is
not importable that way: the bodies live here, a helper module on the
tests' path that imports no JAX.  The parent writes the inputs with
``torch.save``; each rank loads them, runs its share through
:func:`repro_torch.launch.steps.build_train_step` and returns plain
results (tensors on the CPU, numbers, the census of each step).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.analysis import staticcheck
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import engine, make_optimizer
from repro_torch.core import consensus as consensus_lib
from repro_torch.core.faults import make_fault_schedule
from repro_torch.kernels.consensus_update import sr_quantize
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.sharding import local_batch
from repro_torch.nn import transformer as tt
from repro_torch.utils.tree import tree_leaves, tree_map

LR, MU, ADAM_LR = 0.01, 0.9, 1e-3
# the sync configuration run_configs also checks as if it claimed overlap
CLAIMED_OVERLAP = "cdmsgd-int8-sync"


def lm_config():
    """Reduced gemma3-1b in float32: 2 layers, d 256, vocab 512."""
    return dataclasses.replace(get_config("gemma3-1b").reduced(),
                               param_dtype="float32")


def live_params(template, seed: int = 0) -> dict:
    """Float32 numpy weights for ``template``, every leaf drawn and well
    conditioned (``test_torch_lm_train.py``'s draw: matrices at variance
    1 / (contraction size), the attention projections contracting over d,
    or heads x hd for ``wo``).  The template's own ``scaled`` init makes
    gemma's attention an argmax that float32 rounding flips."""
    rng = np.random.default_rng(seed)

    def leaf(path, pd):
        if pd.init == "ones":
            x = 1.0 + 0.1 * rng.normal(size=pd.shape)
        elif pd.init == "zeros":
            x = 0.3 * rng.normal(size=pd.shape)
        elif pd.init in ("normal", "embed"):
            x = (0.02 if pd.init == "normal" else 0.05) * rng.normal(size=pd.shape)
        else:
            fan_in = pd.shape[-2]
            if len(path) > 1 and path[-2] == "attn":
                fan_in = pd.shape[-3] * (pd.shape[-2] if path[-1] == "wo" else 1)
            x = pd.scale / math.sqrt(fan_in) * rng.normal(size=pd.shape)
        return x.astype(np.float32)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(t[k], path + (k,)) for k in sorted(t)}
        return leaf(path, t)

    return walk(template, ())


def make_opt(name: str, fused: bool, faults=None, n_agents: int = 4):
    """The optimizer of a configuration; ``faults`` (a spec) gives FedAvg
    its partial participation over ``n_agents``."""
    kw = {}
    if name in ("cdmsgd", "cdmsgd_nesterov", "msgd"):
        kw["mu"] = MU
    if name == "fedavg":
        kw.update(local_steps=2, mu=MU)
        if faults is not None:
            kw["faults"] = make_fault_schedule(faults, n_agents)
    lr = ADAM_LR if name == "cdadam" else LR
    if name in ("cdsgd", "cdmsgd", "cdmsgd_nesterov", "cdadam"):
        kw["fused"] = fused
    return make_optimizer(name, lr, **kw)


def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu().clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def _to(tree, device):
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
                    tree)


def run_configs(mesh, inputs_path: str) -> dict:
    """Every configuration of the inputs file, on this rank: whole steps
    from the shared initial state (``P0``) with the census and event log of
    each step, the wire-contract checker's report of each fused
    configuration (:func:`repro_torch.analysis.staticcheck.check_bundle`),
    and (where given) the update phase teacher-forced from the stacked
    trainer's state and gradients."""
    data = torch.load(inputs_path, weights_only=False)
    cfg = lm_config()
    shape = InputShape("tiny_train", data["seq"], data["batch"] * mesh.size,
                       "train")
    census = mesh.census

    def loss_fn(cfg, p, b, **kw):    # marks the grad phase in the event log
        census.events.append(("grad",))
        return tt.loss_fn(cfg, p, b, **kw)

    steps_lib.loss_fn = loss_fn
    out = {}
    for name, spec in data["configs"].items():
        bundle = steps_lib.build_train_step(
            cfg, shape, mesh, make_opt(spec["optimizer"], spec["fused"],
                                       spec.get("opt_faults"), mesh.size),
            topology_name=spec["topology"], mixing=spec["mixing"], remat=False,
            **spec["knobs"])
        params = _to(tree_map(lambda x: x[mesh.rank].clone(), data["P0"]),
                     mesh.device)
        state = bundle.init_state(params)
        quantized = bundle.exchange in ("int8", "fp8")
        steps = []
        for batch in data["batches"]:
            census.reset()
            overlap = bundle.schedule == "overlap"
            posted = (staticcheck.carried_wire_ptrs(state.wire, quantized)
                      if overlap else None)
            wire_bytes = (engine.wire_bytes_per_neighbor(state.wire)
                          if overlap else None)
            params, state, metrics = bundle.step_fn(
                params, state, local_batch(batch, mesh))
            steps.append({"census": census.snapshot(),
                          "events": list(census.events), "posted": posted,
                          "wire_bytes": wire_bytes,
                          "loss": float(metrics["loss"])})
        res = {"params": _cpu(params), "steps": steps}
        if spec["mixing"] == "ppermute_fused":
            # the wire-contract checker over one more step (a period of a
            # time-varying schedule) from here; a sync program claimed as
            # overlap must fail its critical-path rule
            batch = local_batch(data["batches"][0], mesh)
            res["check"] = staticcheck.check_bundle(
                bundle, params, batch, opt_state=state).as_dict()
            if bundle.schedule == "sync" and name == CLAIMED_OVERLAP:
                res["claimed_overlap"] = staticcheck.check_bundle(
                    bundle, params, batch, opt_state=state,
                    schedule="overlap").as_dict()
        teacher = data["teacher"].get(name)
        if teacher is not None:
            p1, s1 = steps_lib.local_train_state(teacher["params"],
                                                 teacher["opt_state"], mesh.rank)
            grads = tree_map(lambda x: x[mesh.rank].clone(), teacher["grads"])
            with torch.no_grad():
                new_p, new_s = bundle.update_phase(
                    _to(p1, mesh.device), _to(grads, mesh.device),
                    _to(s1, mesh.device))
            res["update"] = _cpu((new_p, new_s))
        out[name] = res
    return out


def run_jax_configs(mesh, inputs_path: str) -> dict:
    """The configurations held against the JAX sharded step: whole steps
    from the carried weights (row ``rank`` of ``P0``), final params; a
    rank-r program starts from the reference's warm-start basis
    (``qwarm``)."""
    data = torch.load(inputs_path, weights_only=False)
    cfg = lm_config()
    shape = InputShape("tiny_train", data["seq"], data["batch"] * mesh.size,
                       "train")
    out = {}
    for name, spec in data["configs"].items():
        mixing = spec.get("mixing", "ppermute_fused")
        bundle = steps_lib.build_train_step(
            cfg, shape, mesh, make_opt(spec["optimizer"], True,
                                       spec.get("opt_faults"), mesh.size),
            topology_name=spec["topology"], mixing=mixing, remat=False,
            **spec["knobs"])
        params = _to(tree_map(lambda x: x[mesh.rank].clone(), data["P0"]),
                     mesh.device)
        state = bundle.init_state(params)
        if state.qwarm:
            q = data["qwarm"].to(mesh.device)[None]
            state = state._replace(qwarm=tuple(q.clone() for _ in state.qwarm))
        losses = []
        for batch in data["batches"]:
            params, state, metrics = bundle.step_fn(params, state,
                                                    local_batch(batch, mesh))
            losses.append(float(metrics["loss"]))
        out[name] = {"params": _cpu(params), "losses": losses}
    return out


def staged_exchange(mesh, rows: int, chunk_bytes: int) -> dict:
    """The card's staged exchange: a ``rows``-row f32 bucket of this rank's
    own seeded values sent around a ring of every rank, its int8 wire
    quantized, exchanged (in ``chunk_bytes`` wire messages) and fed to the
    ``_q`` stencil update.  Returns what arrived and the update (on the
    CPU)."""
    from repro_torch.core import collectives
    from repro_torch.kernels.consensus_update import ops as kops

    collectives.CHUNK_BYTES = chunk_bytes
    dev = mesh.device
    n = mesh.size

    def bucket(agent, salt):
        g = torch.Generator().manual_seed(1000 * salt + agent)
        return torch.randn((rows, 128), generator=g).to(dev)

    x, grad = bucket(mesh.rank, 1), bucket(mesh.rank, 2)
    seed = consensus_lib.wire_seed(5, agent=mesh.rank)
    q, sc = sr_quantize(x[None], seed, "int8")
    shifts = [1, n - 1] if n > 2 else [1]
    got = collectives.ppermute(mesh, [x, q[0], sc[0]], shifts).wait()
    w = torch.full((len(shifts) + 1,), 1.0 / (len(shifts) + 1), device=dev)
    payload = torch.stack(got[1])
    scales = torch.stack(got[2])
    new = kops.cdsgd_update_flat(payload, w, grad.clone(), 0.05,
                                 scales=scales, self_buf=x)
    torch.cuda.synchronize(dev)
    return {"x": x.cpu(), "received": [t.cpu() for t in got[0]],
            "q": q[0].cpu(), "sc": sc[0].cpu(),
            "received_q": [t.cpu() for t in got[1]],
            "received_sc": [t.cpu() for t in got[2]],
            "update": new.cpu(), "grad": grad.cpu(), "weights": w.cpu(),
            "census": mesh.census.snapshot()}


def fail_on(mesh, rank: int) -> int:
    """Raise on ``rank``; the others wait at a barrier (and time out)."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} failed on purpose")
    torch.distributed.barrier()
    return mesh.rank


def leaves_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb)
        if isinstance(x, torch.Tensor))


def run_factored(mesh, inputs_path: str) -> dict:
    """The factored ``pod x data`` mesh on this rank: fused int8 CDMSGD's
    update phase teacher-forced from the stacked trainer's state, one
    whole step with its census, and the per-leaf ``FactoredMix`` mixing of
    this agent's params."""
    data = torch.load(inputs_path, weights_only=False)
    cfg = lm_config()
    shape = InputShape("tiny_train", data["seq"], data["batch"] * mesh.size,
                       "train")
    bundle = steps_lib.build_train_step(
        cfg, shape, mesh, make_opt("cdmsgd", True), mixing="ppermute_fused",
        exchange="int8", remat=False)
    teacher = data["teacher"]
    p1, s1 = steps_lib.local_train_state(teacher["params"],
                                         teacher["opt_state"], mesh.rank)
    grads = tree_map(lambda x: x[mesh.rank].clone(), teacher["grads"])
    with torch.no_grad():
        update = bundle.update_phase(p1, grads, s1)
    params = tree_map(lambda x: x[mesh.rank].clone(), data["P0"])
    state = bundle.init_state(params)
    mesh.census.reset()
    params, state, metrics = bundle.step_fn(params, state,
                                            local_batch(data["batches"][0], mesh))
    census = mesh.census.snapshot()
    fm = steps_lib._agent_factors(mesh, ("pod", "data"))
    mixed = fm.make_mix_fn(mesh)(tree_map(lambda x: x[mesh.rank].clone(),
                                          data["P0"]))
    return {"update": _cpu(update), "step": _cpu(params), "census": census,
            "loss": float(metrics["loss"]),
            "mixed": _cpu(mixed), "topology": bundle.topology.name,
            "senders": bundle.comm.flat.strategy.plans[0].senders}


def run_remat_default(mesh, inputs_path: str) -> dict:
    """The sharded step at its default ``remat=True`` on this rank: the grad
    phase beside a ``remat=False`` build's on the same params and batch
    (bit for bit), then whole fused CDMSGD int8 steps from row ``rank`` of
    ``P0``; the params after them."""
    data = torch.load(inputs_path, weights_only=False)
    cfg = lm_config()
    shape = InputShape("tiny_train", data["seq"], data["batch"] * mesh.size, "train")

    def build(**kw):
        return steps_lib.build_train_step(cfg, shape, mesh, make_opt("cdmsgd", True),
                                          mixing="ppermute_fused", exchange="int8", **kw)

    bundle, plain = build(), build(remat=False)
    params = tree_map(lambda x: x[mesh.rank].clone(), data["P0"])
    batch = local_batch(data["batches"][0], mesh)
    (loss_on, _), g_on = bundle.grad_phase(params, batch)
    (loss_off, _), g_off = plain.grad_phase(params, batch)
    same = leaves_equal(g_on, g_off) and torch.equal(loss_on, loss_off)
    state = bundle.init_state(params)
    for b in data["batches"]:
        params, state, _ = bundle.step_fn(params, state, local_batch(b, mesh))
    return {"grads_bitwise": same, "params": _cpu(params),
            "n_grads": len(tree_leaves(g_on))}


def serve_config(arch: str, vocab: int = 0):
    """A reduced dense config in float32 (``vocab``: another vocabulary)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float32")
    return dataclasses.replace(cfg, vocab_size=vocab) if vocab else cfg


def _axis_value(rank: int, dtype) -> torch.Tensor:
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn((3, 5), generator=g).to(dtype)


AXIS_DTYPES = (torch.float32, torch.bfloat16)


def axis_collectives(mesh) -> dict:
    """The collectives over named axes on this rank's seeded ``(3, 5)``
    value of each dtype: stacked over ``data``, concatenated over
    ``model`` along dimension 1, stacked over every axis, and the sum over
    ``model`` of the value and its double (on the CPU)."""
    from repro_torch.core import collectives

    out = {}
    for dt in AXIS_DTYPES:
        x = _axis_value(mesh.rank, dt).to(mesh.device)
        out[f"data/{dt}"] = collectives.all_gather(mesh, x, "data").cpu()
        out[f"model/{dt}"] = collectives.all_gather(mesh, x, "model", dim=1).cpu()
        out[f"all/{dt}"] = collectives.all_gather(mesh, x, ("data", "model")).cpu()
        out[f"sum/{dt}"] = [t.cpu() for t in collectives.all_reduce_sum(
            mesh, [x, 2 * x], "model")]
    return out


def check_axis_collectives(results: list, axes: dict) -> None:
    """Each rank's :func:`axis_collectives` against the values of the
    ranks of its lines (:func:`repro_torch.launch.mesh.axis_lines`):
    gathers bit for bit, the sums as one float32 sum cast once."""
    from repro_torch.launch.mesh import axis_lines

    def line(axis, r):
        return next(ln for ln in axis_lines(axes, axis) if r in ln)

    for r, got in enumerate(results):
        for dt in AXIS_DTYPES:
            v = {q: _axis_value(q, dt) for q in range(len(results))}
            assert torch.equal(got[f"data/{dt}"],
                               torch.stack([v[q] for q in line("data", r)])), (r, dt)
            assert torch.equal(got[f"model/{dt}"],
                               torch.cat([v[q] for q in line("model", r)], dim=1))
            assert torch.equal(got[f"all/{dt}"], torch.stack(list(v.values())))
            total = sum(v[q].float() for q in line("model", r))
            for k, t in enumerate(got[f"sum/{dt}"]):
                assert t.dtype == dt and torch.equal(t, ((k + 1) * total).to(dt))


def run_serve(mesh, inputs_path: str) -> dict:
    """The sharded serve steps of every configuration of the inputs file,
    on this rank of a ``data x model`` mesh: the prefill's last logits of
    this rank's batch rows, and greedy decode steps from an empty cache
    (the config's ``steps``, from the first token of each row) at each decode
    batch, with the tokens and this rank's blocks of the final cache.  Also
    the ranks of this rank's process group along each axis."""
    import torch.distributed as dist

    from repro_torch.nn.param import params_from_numpy

    data = torch.load(inputs_path, weights_only=False)
    out = {"groups": {a: (dist.get_process_group_ranks(g) if g is not None
                          else [mesh.rank])
                      for a, g in mesh.groups.items()},
           "collectives": axis_collectives(mesh)}
    for name, spec in data["configs"].items():
        cfg = serve_config(spec["arch"], spec["vocab"])
        params = params_from_numpy(data["params"][name], mesh.device)
        toks = torch.as_tensor(data["tokens"][name], device=mesh.device)
        pb = steps_lib.build_prefill_step(
            cfg, InputShape("p", data["seq"], toks.shape[0], "prefill"), mesh)
        local = pb.local_params(params)
        res = {"prefill": _cpu(pb.step_fn(local, pb.local({"inputs": toks,
                                                            "targets": toks})))}
        for b in spec["decode_batches"]:
            sb = steps_lib.build_serve_step(
                cfg, InputShape("d", data["seq"], b, "decode"), mesh)
            cache = sb.init_cache()
            tok = sb.local(toks[:b, :1].to(torch.int32).contiguous())
            got = []
            for i in range(spec["steps"]):
                tok, cache = sb.step_fn(local, cache, tok, i)
                got.append(tok)
            res[f"decode{b}"] = {"tokens": _cpu(torch.cat(got, dim=1)),
                                 "cache": _cpu(cache)}
        out[name] = res
    out["census"] = mesh.census.snapshot()
    return out
