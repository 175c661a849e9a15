"""Topology study (paper Fig. 2): network size + sparsity trade-offs.

Sweeps agent counts and graph topologies, printing convergence speed,
final accuracy, spectral gap, and consensus stability (the paper's
"interesting relation between convergence and topology of the graph"),
plus a mixing-strategy sweep (static ring vs alternating B-connected vs
multi-round i-CDSGD vs gossip pairs): the spectral-gap-vs-wire-bytes
trade-off from ``TopologySchedule.diagnostics`` that the follow-up paper
(1805.12120) calls the consensus-optimality trade-off.  On the CUDA card by
default:

    PYTHONPATH=src python -m repro_torch.examples.topology_study
    PYTHONPATH=src python -m repro_torch.examples.topology_study --device cpu --steps 20
"""

import argparse
import functools

from repro_torch.core import make_optimizer, make_topology
from repro_torch.core.consensus import exchange_bytes_per_step
from repro_torch.core.flatbuf import make_flat_spec
from repro_torch.core.topology import fixed_schedule, make_topology_schedule
from repro_torch.core.trainer import CollaborativeTrainer, train_loop
from repro_torch.data import AgentPartitioner, make_classification
from repro_torch.nn.paper_models import (
    classifier_loss,
    mlp_classifier_apply,
    mlp_classifier_template,
)
from repro_torch.nn.param import init_params

LOSS = functools.partial(classifier_loss, mlp_classifier_apply)


def run_one(topology_name, n_agents, steps=120, device=None, **mixing_kw):
    train, val = make_classification(4096, n_classes=10, dim=64, seed=0)
    part = AgentPartitioner(train, n_agents, seed=0)
    params = init_params(mlp_classifier_template(64, 10, width=50, depth=6), 0)
    topo = make_topology(topology_name, n_agents)
    tr = CollaborativeTrainer(LOSS, params, topo,
                              make_optimizer("cdmsgd", 0.05, mu=0.9,
                                             **({"fused": True} if mixing_kw
                                                else {})),
                              device=device, **mixing_kw)
    train_loop(tr, part.batches(64), steps)
    ev = tr.evaluate({"x": val.x, "y": val.y})
    half_acc = tr.history.series("acc")[steps // 2 - 1]
    spec = make_flat_spec(tr.state.params, lead=1)
    return {
        "lambda2": topo.lambda2,
        "gap": topo.spectral_gap,
        "half_acc": half_acc,
        "val_acc": ev["acc_mean"],
        "acc_var": ev["acc_var"],
        "consensus": tr.history.last("consensus_error"),
        "degree": topo.degree(),
        "wire_f32": exchange_bytes_per_step(spec, topo, "f32")["per_step_bytes"],
        "wire_int8": exchange_bytes_per_step(spec, topo, "int8")["per_step_bytes"],
        "wire_per_step": tr.wire_bytes_per_step,
    }


# (label, base topology, trainer mixing kwargs, schedule factory)
STRATEGIES = [
    ("static ring", "ring", {},
     lambda n: fixed_schedule(make_topology("ring", n))),
    ("alternating ring/torus", "ring",
     {"mixing_strategy": "time_varying",
      "topology_schedule": "alternating:ring:torus"},
     lambda n: make_topology_schedule("alternating:ring:torus", n)),
    ("2-round ring (i-CDSGD)", "ring",
     {"mixing_strategy": "multi_round", "consensus_rounds": 2},
     lambda n: fixed_schedule(make_topology("ring", n))),
    ("gossip pairs (B-conn)", "ring",
     {"mixing_strategy": "time_varying", "topology_schedule": "gossip:8"},
     lambda n: make_topology_schedule("gossip:8", n)),
]


def strategy_sweep(n_agents=8, steps=120, device=None):
    """Spectral gap vs wire bytes across mixing strategies.

    ``eff gap`` is the schedule's per-step effective spectral gap (the
    period product's, with the round count folded in), the quantity that
    replaces ``1 - lambda_2(Pi)`` in Proposition 1; ``wire/step`` is the
    amortized per-agent bytes the strategy puts on the wire each optimizer
    step.  More gap per byte = better consensus for the bandwidth.
    """
    print(f"{'strategy':>24} {'eff gap':>8} {'deg':>5} {'wire/step':>11} "
          f"{'gap/MB':>8} {'val acc':>8} {'consensus':>11}")
    for label, topo_name, kw, sched_fn in STRATEGIES:
        sched = sched_fn(n_agents)
        rounds = kw.get("consensus_rounds", 1)
        d = sched.diagnostics(rounds)
        r = run_one(topo_name, n_agents, steps=steps, device=device, **kw)
        gap_per_mb = d["effective_gap"] / max(r["wire_per_step"] / 1e6, 1e-12)
        print(f"{label:>24} {d['effective_gap']:>8.4f} "
              f"{d['mean_degree'] * rounds:>5.1f} {r['wire_per_step']:>11,} "
              f"{gap_per_mb:>8.3f} {r['val_acc']:>8.4f} "
              f"{r['consensus']:>11.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="topology study (paper Fig. 2)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    steps, dev = args.steps, args.device

    print("== network size (fully connected, paper Fig 2a) ==")
    print(f"{'N':>4} {'mid-train acc':>14} {'final val':>10} {'consensus':>11}")
    for n in (2, 4, 8, 16):
        r = run_one("fully_connected", n, steps=steps, device=dev)
        print(f"{n:>4} {r['half_acc']:>14.4f} {r['val_acc']:>10.4f} {r['consensus']:>11.3e}")

    print("\n== topology sparsity at N=8 (paper Fig 2b) ==")
    print(f"{'topology':>16} {'deg':>4} {'lambda2':>8} {'val acc':>8} "
          f"{'acc var':>10} {'consensus':>11} {'wire f32':>10} {'int8':>10}")
    for name in ("fully_connected", "torus", "ring", "chain"):
        r = run_one(name, 8, steps=steps, device=dev)
        print(f"{name:>16} {r['degree']:>4} {r['lambda2']:>8.3f} {r['val_acc']:>8.4f} "
              f"{r['acc_var']:>10.2e} {r['consensus']:>11.3e} "
              f"{r['wire_f32']:>10,} {r['wire_int8']:>10,}")
    print("\npaper's claim: sparser graph (higher lambda2) -> faster average "
          "convergence,\nbut less stable consensus (higher accuracy variance).")

    print("\n== mixing strategies at N=8 (1805.12120 consensus-optimality "
          "trade-off) ==")
    strategy_sweep(8, steps=steps, device=dev)
    print("\ntrade-off: multi-round buys spectral gap linearly in wire "
          "bytes; a B-connected\nalternating schedule buys it from the "
          "product matrix at single-round cost; gossip\npairs minimize "
          "per-step wire at the weakest per-step mixing.")


if __name__ == "__main__":
    main()
