"""Dry-run: trace one rank's training step at full size on ``meta`` and
write its record (the port of :mod:`repro.launch.dryrun`).

The reference lowers and compiles every (arch x input shape x mesh) for
placeholder TPU devices and reads the compiled HLO.  The port traces: it
builds one rank's sharded step (:func:`~repro_torch.launch.steps.
build_train_step`) on the reference's production mesh, ``data 16 x model
16`` (recorded as ``mesh: "16x16"``, 256 ranks, one card a rank: 16
agents, each agent's ``tp`` dims over 16 ranks), or with ``--agents N`` on
an agent-only mesh of ``N`` ranks (``mesh: "dataN"``), gives it ``meta``
blocks of the params and optimizer state and the rank's ``global_batch /
agents`` sequences at full width and depth, and runs the step once under
the op counter (:mod:`repro_torch.analysis.opcount`).  On the production
mesh the collectives over ``model`` (the tensor-parallel forward's and
backward's) are counted by the Census by axis, not made; a family other
than the dense one writes a skip naming its ROADMAP item (A16.2.3), and so
does a compressor (the reference's skip: top-k's index payload and
rank-r's bases do not shard over ``model``).
``meta`` tensors carry shapes only: nothing is allocated, no kernel runs
(each kernel's dispatcher reports its work and the plain version traces
its shapes) and no exchange is made (the Census counts the transfers the
step would post).  Per pair this writes
``results/dryrun_torch/<arch>__<shape>__<mesh>__<mode>_<mixing><tag>.json``
with the reference's schema-2 keys:

* ``status``, ``chips``, ``mesh``, ``trace_s``;
* ``argument_bytes_per_device`` (params, optimizer state, batch) and
  ``peak_bytes_per_device``: the op counter's peak of live tensor bytes
  over the trace (the counter's figure, not the allocator's), with
  ``fits_h100_80gb`` against :data:`~repro_torch.analysis.roofline.HW_H100`;
* ``roofline`` (:func:`~repro_torch.analysis.roofline.roofline_from_stats`
  on the card), ``collective_bytes``, ``collective_count``;
* ``exchange_bytes_per_step``, ``mixing_program``, ``topology_schedule``,
  ``staleness_config`` and ``arrival_accounting`` (a fault-tolerant
  program), ``update_cost`` (a top-k program);
* ``verify``: the wire-contract rules that need no values (the census
  against its prediction, ``bytes.*`` from the traced wire's shapes and the
  Census, ``seeds.*``, ``sparse.shape_contract`` / ``k_rows_clamp``); the
  value rules are marked skipped, with "run `launch.check`".

Prefill and decode shapes trace one rank of the serve mode
(:func:`~repro_torch.launch.steps.build_prefill_step` /
:func:`~repro_torch.launch.steps.build_serve_step`) on the reference's
production serve mesh, ``data 16 x model 16`` (``mesh: "16x16"``, 256
ranks): its blocks of the params, the batch and the cache on ``meta``,
one prefill or one decode step under the op counter, the collectives over
``data`` and ``model`` counted, not made.  That record has no ``verify``
block (the wire-contract rules read the agent exchange).  A family other
than the dense one writes a skip naming its ROADMAP item (A16.2.3), and
``long_500k`` on a full-attention config the reference's skip.  Only the
fused flat-buffer mixing (``ppermute_fused``) traces a training step: the
per-leaf mixings gather or permute every leaf through a process group,
which a trace has none of.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \\
      --exchange int8 --schedule overlap
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \\
      --agents 16 --compressor topk:0.01 --error-feedback   # agent-only
  python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

RESULTS = "results/dryrun_torch"
AGENTS = 16                    # the reference's production data axis
TRAIN_MESH = {"data": 16, "model": 16}    # the reference's production mesh
SERVE_MESH = {"data": 16, "model": 16}    # the reference's production serve mesh
LONG_SKIP = "skip: full-attention arch at 500k decode (DESIGN.md)"


def meta_tree(template):
    """``meta`` tensors shaped like a ParamDef tree's leaves."""
    import torch

    from repro_torch.utils.tree import tree_map

    return tree_map(lambda pd: torch.empty(pd.shape, dtype=pd.dtype,
                                           device="meta"), template)


def meta_mesh(agents: int, axes=None):
    """Rank 0 of a mesh of ``agents`` ranks (agent-only, or ``axes``), on
    ``meta``: no process group (the trace posts no transfer)."""
    import torch

    from repro_torch.launch.mesh import AgentMesh

    return AgentMesh(rank=0, size=agents, backend="gloo", group=None,
                     device=torch.device("meta"), axes=axes)


def _serve_pair(cfg, shape, record: dict, t0: float) -> dict:
    """Trace rank 0's prefill or decode step of the serve mode on
    :data:`SERVE_MESH` into ``record`` (see the module docstring)."""
    import torch

    from repro_torch.analysis import opcount
    from repro_torch.analysis.roofline import (HW_H100, model_flops,
                                               roofline_from_stats)
    from repro_torch.launch import steps as steps_lib
    from repro_torch.nn.param import local_shape
    from repro_torch.utils.tree import tree_leaves, tree_map

    chips = math.prod(SERVE_MESH.values())
    mesh = meta_mesh(chips, SERVE_MESH)

    def meta(t):                     # a TensorSpec's block on meta
        return torch.empty(local_shape(t.shape, t.spec, mesh), dtype=t.dtype,
                           device="meta")

    if shape.kind == "prefill":
        bundle = steps_lib.build_prefill_step(cfg, shape, mesh)
        args = (tree_map(meta, bundle.input_structs[0]),)
    else:
        bundle = steps_lib.build_serve_step(cfg, shape, mesh)
        cache, tokens, _ = bundle.input_structs
        args = (tree_map(meta, cache), meta(tokens), 0)
    params = tree_map(lambda pd, sp: torch.empty(local_shape(pd.shape, sp, mesh),
                                                 dtype=pd.dtype, device="meta"),
                      bundle.param_template, bundle.param_specs)
    roots = (params,) + args[:2]
    counter = opcount.OpCounter(track_live=True, roots=roots)
    with counter:
        bundle.step_fn(params, *args)
    stats = counter.stats()
    peak = stats.peak_live_bytes
    record.update({
        "status": "ok", "mode": "serve", "mixing": None,
        "trace_s": round(time.time() - t0, 1), "chips": chips,
        "argument_bytes_per_device": sum(
            t.numel() * t.element_size() for t in tree_leaves(roots)
            if isinstance(t, torch.Tensor)),
        "peak_bytes_per_device": peak,
        "peak_bytes_source": "op counter: peak of live tensor storage bytes "
                             "over the meta trace (not the allocator's peak)",
        "fits_h100_80gb": bool(peak < HW_H100.hbm_bytes),
        "collective_bytes": stats.collective_bytes,
        "collective_count": stats.collective_count,
        "census_by_axis": mesh.census.snapshot()["by_axis"],
    })
    terms = roofline_from_stats(
        arch=cfg.name, shape=shape.name, mesh=record["mesh"], chips=chips,
        stats=stats, model_flops_total=model_flops(cfg, shape),
        peak_memory_bytes=peak)
    record["roofline"] = terms.as_dict()
    record["roofline"]["mfu_bound"] = terms.mfu_bound
    return record


def _optimizer(name: str):
    from repro_torch.core import make_optimizer

    kw = {"mu": 0.9} if name in ("cdmsgd", "cdmsgd_nesterov", "msgd") else {}
    return make_optimizer(name, 0.01, fused=True, **kw)


def run_pair(arch: str, shape_name: str, *, agents: Optional[int] = None,
             mode: str = "train", optimizer_name: str = "cdmsgd",
             topology: str = "ring", out_dir: str = RESULTS, tag: str = "",
             verbose: bool = True, microbatches: int = 1,
             exchange: str = "f32", schedule: str = "sync",
             mixing_strategy: str = "static", consensus_rounds: int = 1,
             topology_schedule=None, error_feedback: bool = False,
             momentum_mixing: str = "none", staleness: int = 1,
             fault_schedule=None, compressor: str = "none",
             remat: bool = True) -> dict:
    """Trace one pair and write its record; returns the record.
    ``agents`` None: a training shape on :data:`TRAIN_MESH`; an int: on an
    agent-only mesh of that many ranks."""
    from repro_torch.analysis import opcount, staticcheck
    from repro_torch.analysis.records import DRYRUN_SCHEMA_VERSION
    from repro_torch.analysis.roofline import (HW_H100, consensus_update_cost,
                                               model_flops,
                                               roofline_from_stats)
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.core import consensus as consensus_lib
    from repro_torch.core import flatbuf
    from repro_torch.launch import steps as steps_lib
    from repro_torch.utils.tree import tree_leaves

    mixing = "ppermute_fused"
    axes = TRAIN_MESH if agents is None else None
    chips = math.prod(TRAIN_MESH.values()) if agents is None else agents
    mesh_name = "16x16" if agents is None else f"data{agents}"
    label = f"{arch}__{shape_name}__{mesh_name}__{mode}_{mixing}{tag}"
    t0 = time.time()
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    record = {"version": DRYRUN_SCHEMA_VERSION,
              "arch": arch, "shape": shape_name, "mesh": mesh_name,
              "mode": mode, "mixing": mixing, "topology": topology,
              "optimizer": optimizer_name, "microbatches": microbatches,
              "exchange": exchange, "schedule": schedule,
              "staleness": staleness, "compressor": compressor,
              "tag": tag, "verify": None}
    if shape.kind != "train":
        record.update({"mode": "serve", "mixing": None, "mesh": "16x16"})
        label = f"{arch}__{shape_name}__16x16__serve{tag}"
        try:
            if shape.name == "long_500k" and not cfg.supports_long_context:
                record["status"] = LONG_SKIP
            else:
                _serve_pair(cfg, shape, record, t0)
        except NotImplementedError as e:
            record["status"] = f"skip: {e}"
        except Exception as e:
            record["status"] = f"FAIL: {type(e).__name__}: {e}"
            record["traceback"] = traceback.format_exc()[-4000:]
        _dump(out_dir, label, record)
        if verbose:
            print(f"[dryrun] {label}: {record['status']}")
        return record
    try:
        mesh = meta_mesh(chips, axes)
        bundle = steps_lib.build_train_step(
            cfg, shape, mesh, _optimizer(optimizer_name), mode=mode,
            topology_name=topology, mixing=mixing, remat=remat,
            microbatches=microbatches, exchange=exchange, schedule=schedule,
            mixing_strategy=mixing_strategy, consensus_rounds=consensus_rounds,
            topology_schedule=topology_schedule, error_feedback=error_feedback,
            momentum_mixing=momentum_mixing, staleness=staleness,
            fault_schedule=fault_schedule, compressor=compressor)
    except (NotImplementedError, ValueError) as e:
        if isinstance(e, ValueError) and "agent-only sharding" not in str(e):
            raise
        record["status"] = f"skip: {e}"
        _dump(out_dir, label, record)
        if verbose:
            print(f"[dryrun] {label}: {record['status']}")
        return record
    try:
        import torch

        program = bundle.mixing_program
        params = meta_tree(bundle.local_template)
        batch = {k: torch.empty(s.shape[1:], dtype=s.dtype, device="meta")
                 for k, s in bundle.batch_specs.items()}
        state = bundle.init_state(params)
        spec = flatbuf.make_flat_spec(params)
        wire_topo = bundle.topology
        if not program.schedule.is_static:
            wire_topo = program.schedule
            record["topology_schedule"] = program.schedule.diagnostics(
                program.rounds)
        record["mixing_program"] = program.describe()
        if program.fault_tolerant:
            from repro_torch.core.faults import trivial_faults
            f = program.faults or trivial_faults(bundle.n_agents)
            record["staleness_config"] = {"staleness": program.staleness,
                                          "faults": f.describe()}
            record["arrival_accounting"] = f.arrival_accounting(
                program.staleness)
        record["exchange_bytes_per_step"] = consensus_lib.exchange_bytes_per_step(
            spec, wire_topo, program.exchange, program.rounds,
            program.n_payloads, program=program)
        if program.compressor_kind == "topk":
            degree = (wire_topo.mean_degree()
                      if hasattr(wire_topo, "mean_degree")
                      else wire_topo.degree())
            record["update_cost"] = {
                "sparse_update": program.sparse_update,
                **consensus_update_cost(spec, program, int(degree))}
        if verbose:
            xb = record["exchange_bytes_per_step"]
            print(f"[dryrun] {label} exchange={xb['exchange']}: "
                  f"{xb['per_step_bytes']:,} bytes/agent/step on the wire "
                  f"({xb['degree']} neighbors x {xb['per_neighbor_bytes']:,} B "
                  f"x {xb['rounds']} round(s))")
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves((params, state, batch))
                        if isinstance(t, torch.Tensor))
        counter = opcount.OpCounter(track_live=True,
                                    roots=(params, state, batch))
        rep = staticcheck.check_bundle(bundle, params, batch, opt_state=state,
                                       label=label, counter=counter)
        stats = counter.stats()
        steps = staticcheck.schedule_period(program)
        per_step = opcount.StepStats(
            collective_bytes={k: v // steps
                              for k, v in stats.collective_bytes.items()},
            dot_flops=stats.dot_flops // steps,
            traffic_bytes=stats.traffic_bytes // steps,
            collective_count={k: v // steps
                              for k, v in stats.collective_count.items()},
            trip_counts={}, peak_live_bytes=stats.peak_live_bytes)
        peak = per_step.peak_live_bytes
        record.update({
            "status": "ok",
            "trace_s": round(time.time() - t0, 1),
            "chips": chips,
            "argument_bytes_per_device": arg_bytes,
            "peak_bytes_per_device": peak,
            "peak_bytes_source": "op counter: peak of live tensor storage "
                                 "bytes over the meta trace (not the "
                                 "allocator's peak)",
            "fits_h100_80gb": bool(peak < HW_H100.hbm_bytes),
        })
        terms = roofline_from_stats(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            stats=per_step, model_flops_total=model_flops(cfg, shape),
            peak_memory_bytes=peak)
        record["roofline"] = terms.as_dict()
        record["roofline"]["mfu_bound"] = terms.mfu_bound
        record["collective_bytes"] = per_step.collective_bytes
        record["collective_count"] = per_step.collective_count
        record["while_trip_counts"] = per_step.trip_counts
        record["census_by_axis"] = mesh.census.snapshot()["by_axis"]
        record["verify"] = rep.as_dict()
        if verbose:
            print(f"[dryrun] {label} roofline: compute "
                  f"{terms.compute_s:.3e} s, memory {terms.memory_s:.3e} s, "
                  f"collective {terms.collective_s:.3e} s ({terms.dominant}); "
                  f"useful_flops_ratio {terms.useful_flops_ratio:.3f}; peak "
                  f"{peak / 2**30:.2f} GiB live (op counter)")
            print(f"[dryrun] {label} verify: {rep.summary()}")
    except Exception as e:
        record["status"] = f"FAIL: {type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    _dump(out_dir, label, record)
    if verbose:
        print(f"[dryrun] {label}: {record['status']} ({time.time() - t0:.0f}s)")
    return record


def _dump(out_dir: str, label: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, label + ".json"), "w") as f:
        json.dump(record, f, indent=2, default=str)


def main(argv=None) -> int:
    from repro_torch.configs import INPUT_SHAPES, list_archs

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--agents", type=int, default=None,
                    help="trace on an agent-only mesh of this many ranks (one "
                         "card each; the reference's data axis is 16) instead "
                         "of the production data 16 x model 16")
    ap.add_argument("--mode", default="train", choices=["train", "train_hier"])
    ap.add_argument("--optimizer", default="cdmsgd")
    ap.add_argument("--exchange", default="f32",
                    choices=["f32", "bf16", "int8", "fp8"])
    ap.add_argument("--schedule", default="sync", choices=["sync", "overlap"])
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--mixing-strategy", default="static",
                    choices=["static", "time_varying", "multi_round"])
    ap.add_argument("--consensus-rounds", type=int, default=1)
    ap.add_argument("--topology-schedule", default=None)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--momentum-mixing", default="none",
                    choices=["none", "mixed"])
    ap.add_argument("--staleness", type=int, default=1)
    ap.add_argument("--fault-schedule", default=None)
    ap.add_argument("--compressor", default="none")
    ap.add_argument("--no-remat", action="store_true",
                    help="trace the loss without remat (the step's default "
                         "recomputes each block in the backward pass)")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatch", type=int, default=1)
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]
    failures = 0
    for arch, shape in pairs:
        rec = run_pair(arch, shape, agents=args.agents, mode=args.mode,
                       optimizer_name=args.optimizer, topology=args.topology,
                       out_dir=args.out, tag=args.tag,
                       microbatches=args.microbatch, exchange=args.exchange,
                       schedule=args.schedule,
                       mixing_strategy=args.mixing_strategy,
                       consensus_rounds=args.consensus_rounds,
                       topology_schedule=args.topology_schedule,
                       error_feedback=args.error_feedback,
                       momentum_mixing=args.momentum_mixing,
                       staleness=args.staleness,
                       fault_schedule=args.fault_schedule,
                       compressor=args.compressor, remat=not args.no_remat)
        if str(rec.get("status", "")).startswith("FAIL"):
            failures += 1
    print(f"[dryrun] done: {len(pairs)} pairs, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
