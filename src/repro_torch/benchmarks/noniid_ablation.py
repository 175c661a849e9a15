"""Beyond-paper ablation: non-IID (label-skew) data partitions.

The paper lists "collaborative learning with extreme non-IID data" as
future work (§6.i).  This benchmark runs CDSGD/CDMSGD/FedAvg on the
label-sorted partition and reports the accuracy drop vs IID — consensus
mixing is what lets an agent learn classes it never sees locally.
"""

from repro_torch.benchmarks.common import emit, run_experiment


def run(steps: int = 150, *, device=None):
    rows = []
    for opt, kw in [("cdmsgd", {"mu": 0.9}), ("fedavg", {"mu": 0.9, "local_steps": 1}),
                    ("cdsgd", {})]:
        iid = run_experiment(f"noniid/{opt}_iid", opt, steps=steps,
                             device=device, **kw)
        skew = run_experiment(f"noniid/{opt}_skew", opt, steps=steps,
                              non_iid=True, device=device, **kw)
        rows.extend([iid, skew])
    emit(rows)
    return rows


if __name__ == "__main__":
    run()
