"""Certify the wire contract of every supported StepProgram configuration.

``python -m repro_torch.launch.check`` assembles every supported (schedule
x exchange x mixing-strategy x compressor x staleness) configuration of
:data:`MATRIX` (the reference's 17 entries, same labels) in BOTH execution
modes and runs the wire-contract checker
(:mod:`repro_torch.analysis.staticcheck`) over one executed step of each:

* ``stacked`` — the paper's MLP testbed (8 inputs, width 16, depth 2, 4
  classes) in :class:`~repro_torch.core.trainer.CollaborativeTrainer` on a
  4-agent ring;
* ``sharded`` — :func:`~repro_torch.launch.steps.build_train_step` on
  reduced granite-3-8b in float32 (seq 16, 2 sequences an agent), one
  ``gloo`` process per rank (:func:`~repro_torch.launch.mesh.
  spawn_agents`), the checker run in every rank, on the reference's
  meshes: the dense entries on ``data 4 x model 2`` (a 4-agent ring, each
  agent's ``tp`` dims split over 2 ranks, so the byte rules read the
  per-shard padding of the local flat buckets and the collectives over
  ``model`` are counted apart by axis), the :data:`COMPRESSED` entries on
  the agent-only ``8 x 1`` (an 8-agent ring: top-k's index payload and
  rank-r's bases do not shard over ``model``).

The steps run on the card unless ``--device cpu`` is given.  The exit
status is non-zero if and only if a rule fails.  ``--json-out`` writes a
record with one entry per configuration (label, ok, walltime and every
rule's evidence).  The reference's ``--hlo N`` tier has no counterpart:
the byte rule (``bytes.hlo_collective_permute``) always reads the executed
step's Census, so there is no separate compiled tier to opt into.

Usage:
  python -m repro_torch.launch.check                    # both modes
  python -m repro_torch.launch.check --mode stacked --device cpu
  python -m repro_torch.launch.check --only topk        # label substring
  python -m repro_torch.launch.check --json-out check.json
  python -m repro_torch.launch.check --list             # print the matrix
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import functools
import json
import math
import sys
import time

ALT = "alternating:ring:fully_connected"

# (label, optimizer, trainer / build knobs): the reference's matrix
MATRIX = [
    ("sync_f32", "cdsgd", {}),
    ("sync_int8", "cdmsgd", dict(exchange="int8")),
    ("sync_nesterov_f32", "cdmsgd_nesterov", {}),
    ("overlap_f32", "cdsgd", dict(schedule="overlap")),
    ("overlap_int8", "cdmsgd", dict(schedule="overlap", exchange="int8")),
    ("sync_rounds2", "cdsgd",
     dict(exchange="int8", mixing_strategy="multi_round", consensus_rounds=2)),
    ("sync_rounds3_adam", "cdadam",
     dict(exchange="int8", mixing_strategy="multi_round", consensus_rounds=3)),
    ("overlap_rounds3", "cdmsgd",
     dict(schedule="overlap", exchange="int8",
          mixing_strategy="multi_round", consensus_rounds=3)),
    ("sync_tv_int8", "cdmsgd",
     dict(exchange="int8", mixing_strategy="time_varying",
          topology_schedule=ALT)),
    ("overlap_tv_int8", "cdmsgd",
     dict(schedule="overlap", exchange="int8",
          mixing_strategy="time_varying", topology_schedule=ALT)),
    ("overlap_mom_mixed", "cdmsgd",
     dict(schedule="overlap", exchange="int8", momentum_mixing="mixed")),
    ("overlap_S4", "cdsgd",
     dict(schedule="overlap", exchange="int8", staleness=4)),
    ("overlap_S4_faults", "cdsgd",
     dict(schedule="overlap", exchange="int8", staleness=4,
          fault_schedule="stall:1:1:3")),
    ("sync_ef_topk", "cdsgd",
     dict(error_feedback=True, compressor="topk:0.25")),
    ("overlap_ef_topk", "cdsgd",
     dict(schedule="overlap", exchange="int8", error_feedback=True,
          compressor="topk:0.25")),
    ("overlap_ef_topk_auto", "cdmsgd",
     dict(schedule="overlap", error_feedback=True,
          compressor="topk:auto:65536")),
    ("overlap_ef_rank", "cdmsgd_nesterov",
     dict(schedule="overlap", error_feedback=True, compressor="rank:2")),
]

# compressed wires need every bucket row on one shard: those sharded
# entries run on the agent-only 8 x 1 mesh, the dense ones on 4 x 2 (the
# reference's split)
COMPRESSED = {"sync_ef_topk", "overlap_ef_topk", "overlap_ef_topk_auto",
              "overlap_ef_rank"}
MODEL_MESH = {"data": 4, "model": 2}
AGENT_MESH = {"data": 8}

N_AGENTS = 4
SHARDED_SEQ, SHARDED_BATCH = 16, 2          # per agent
LR = 0.05
STALL_S = 120          # a sharded rank running this long prints its stack
JOIN_S = 600           # the sharded matrix's time limit


def testbed(device):
    """The stacked matrix's MLP testbed: ``(loss, params, topology,
    batch)``, the reference's shapes, seeded."""
    import numpy as np

    from repro_torch.core import make_topology
    from repro_torch.nn.paper_models import (classifier_loss,
                                             mlp_classifier_apply,
                                             mlp_classifier_template)
    from repro_torch.nn.param import init_params

    loss = functools.partial(classifier_loss, mlp_classifier_apply)
    params = init_params(mlp_classifier_template(8, 4, width=16, depth=2), 0,
                         device=device)
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((N_AGENTS, 8, 8)).astype(np.float32),
             "y": rng.integers(0, 4, (N_AGENTS, 8)).astype(np.int32)}
    return loss, params, make_topology("ring", N_AGENTS), batch


def stacked_reports(entries, *, device=None, verbose=True):
    """The stacked matrix on the paper's MLP testbed, 4-agent ring."""
    from repro_torch.analysis import staticcheck
    from repro_torch.core import make_optimizer
    from repro_torch.core.trainer import CollaborativeTrainer
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    loss, params, topo, batch = testbed(device)
    reports = []
    for label, opt_name, kw in entries:
        tr = CollaborativeTrainer(loss, params, topo,
                                  make_optimizer(opt_name, LR, fused=True),
                                  device=device, **kw)
        rep = staticcheck.check_trainer(tr, batch, label=f"stacked/{label}")
        reports.append(rep)
        if verbose:
            print(rep.summary(), flush=True)
    return reports


def sharded_config():
    """Reduced granite-3-8b in float32, the reference's sharded testbed."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite-3-8b").reduced(),
                               param_dtype="float32")


def sharded_rank(mesh, entries) -> list:
    """One rank of the sharded matrix: build each entry's step, run the
    checker over one executed step (one per schedule entry), return the
    reports as dicts."""
    from repro_torch.analysis import staticcheck
    from repro_torch.configs.base import InputShape
    from repro_torch.core import make_optimizer
    from repro_torch.data import lm_agent_batches, make_lm_tokens
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.sharding import local_batch
    from repro_torch.nn.param import init_params, local_shard
    from repro_torch.nn.transformer import model_template

    cfg = sharded_config()
    n = mesh.n_agents
    shape = InputShape("tiny_train", SHARDED_SEQ, SHARDED_BATCH * n, "train")
    params = init_params(model_template(cfg), 0, device=mesh.device)
    batch = local_batch(next(lm_agent_batches(
        make_lm_tokens(1 << 12, vocab=cfg.vocab_size, seed=0), n,
        SHARDED_BATCH, SHARDED_SEQ, seed=0)), mesh)
    where = " x ".join(f"{a}{s}" for a, s in mesh.shape.items())
    # a rank that stalls prints where it waits (the parent's time limit
    # then stops every rank)
    faulthandler.dump_traceback_later(STALL_S, repeat=True)
    out = []
    try:
        for label, opt_name, kw in entries:
            bundle = steps_lib.build_train_step(
                cfg, shape, mesh, make_optimizer(opt_name, LR, fused=True),
                topology_name="ring", mixing="ppermute_fused", remat=False,
                **kw)
            rep = staticcheck.check_bundle(
                bundle, local_shard(params, bundle.local_specs, mesh), batch,
                label=f"sharded/{label} {where} rank {mesh.rank}")
            out.append(rep.as_dict())
    finally:
        faulthandler.cancel_dump_traceback_later()
    return out


def sharded_reports(entries, *, device=None, verbose=True):
    """The sharded matrix: 8 gloo ranks (on the card unless ``device`` is
    ``"cpu"``) on :data:`MODEL_MESH` for the dense entries and on
    :data:`AGENT_MESH` for the compressed ones, every rank's reports."""
    from repro_torch.analysis import staticcheck
    from repro_torch.launch.mesh import spawn_agents

    dev = "cpu" if device == "cpu" else "cuda"
    per_rank = []
    for axes, part in ((MODEL_MESH, [e for e in entries if e[0] not in COMPRESSED]),
                       (AGENT_MESH, [e for e in entries if e[0] in COMPRESSED])):
        if part:
            per_rank += spawn_agents(sharded_rank, math.prod(axes.values()),
                                     args=(part,), backend="gloo", device=dev,
                                     timeout=120, join_timeout=JOIN_S,
                                     axes=axes)
    reports = []
    for rank_reports in per_rank:
        for d in rank_reports:
            rep = staticcheck.CheckReport(
                label=d["label"], mode=d["mode"], schedule=d["schedule"],
                results=[staticcheck.RuleResult(
                    r["rule"], r["ok"], r["detail"], r["evidence"],
                    r["skipped"]) for r in d["rules"]],
                walltime_s=d["walltime_s"])
            reports.append(rep)
            if verbose:
                print(rep.summary(), flush=True)
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.check", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=["stacked", "sharded", "all"],
                    default="all")
    ap.add_argument("--only", default="",
                    help="run only configs whose label contains this substring")
    ap.add_argument("--json-out", default="",
                    help="write a JSON record of every report")
    ap.add_argument("--list", action="store_true",
                    help="print the config matrix and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which needs a card)")
    args = ap.parse_args(argv)

    entries = [e for e in MATRIX if args.only in e[0]]
    if args.list:
        for label, opt_name, kw in entries:
            print(f"{label:24s} {opt_name:16s} {kw}")
        return 0
    if not entries:
        print(f"[check] no config label contains {args.only!r}", file=sys.stderr)
        return 2

    t0 = time.time()
    reports = []
    if args.mode in ("stacked", "all"):
        reports += stacked_reports(entries, device=args.device)
    if args.mode in ("sharded", "all"):
        reports += sharded_reports(entries, device=args.device)

    n_rules = sum(len(r.results) for r in reports)
    failures = [(r.label, f) for r in reports for f in r.failures()]
    print(f"\n[check] {len(reports)} configs, {n_rules} rules, "
          f"{len(failures)} failures ({time.time() - t0:.0f}s)")
    for label, f in failures:
        print(f"[check] FAIL {label} :: {f.rule}: {f.detail}")

    if args.json_out:
        record = {
            "bench": "staticcheck",
            "version": 1,
            "mode": args.mode,
            "ok": not failures,
            "n_configs": len(reports),
            "n_rules": n_rules,
            "walltime_s": round(time.time() - t0, 1),
            "configs": [r.as_dict() for r in reports],
        }
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1, default=str)
        print(f"[check] wrote {args.json_out}")

    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
