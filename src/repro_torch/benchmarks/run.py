"""Benchmark entry point: one function per paper table/figure.

    python -m repro_torch.benchmarks.run                 # everything, on the card
    python -m repro_torch.benchmarks.run fig1b           # one benchmark
    python -m repro_torch.benchmarks.run fig1b --device cpu

Prints ``name,us_per_call,derived`` CSV rows (see
:mod:`repro_torch.benchmarks.common`).  Runs on the CUDA card unless
``--device`` names another device; without a card and without
``--device cpu`` it raises.
"""

import argparse
import time

from repro_torch.benchmarks import (
    consensus_radius,
    fig1a_cdsgd_vs_sgd,
    fig1b_cdmsgd_vs_fedavg,
    fig2a_network_size,
    fig2b_topology,
    fig4_datasets,
    fig5_step_size,
    noniid_ablation,
    table1_methods,
    table1_rates,
)

BENCHES = {
    "fig1a": fig1a_cdsgd_vs_sgd.run,
    "fig1b": fig1b_cdmsgd_vs_fedavg.run,
    "fig2a": fig2a_network_size.run,
    "fig2b": fig2b_topology.run,
    "fig4": fig4_datasets.run,
    "fig5": fig5_step_size.run,
    "table1": table1_rates.run,
    "table1_methods": table1_methods.run,
    "prop1": consensus_radius.run,
    "noniid": noniid_ablation.run,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"any of {sorted(BENCHES)}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which needs a card)")
    args = ap.parse_args(argv)
    names = args.names or list(BENCHES)
    for n in names:
        if n not in BENCHES:
            raise SystemExit(f"unknown benchmark {n!r}; available: {sorted(BENCHES)}")
    print("name,us_per_call,derived")
    t0 = time.time()
    for n in names:
        BENCHES[n](device=args.device)
    print(f"benchmarks/total,{1e6 * (time.time() - t0):.0f},count={len(names)}")


if __name__ == "__main__":
    main()
