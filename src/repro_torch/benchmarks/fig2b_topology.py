"""Fig 2(b): effect of topology sparsity (lambda_2 sweep).

Paper claims: sparser networks (larger second eigenvalue) converge faster
in average accuracy but with *less stable consensus* (higher variance of
accuracy across agents).
"""

from repro_torch.benchmarks.common import emit, run_experiment


def run(steps: int = 150, agents: int = 8, *, device=None):
    rows = []
    for topo in ("fully_connected", "torus", "ring", "chain"):
        r = run_experiment(f"fig2b/{topo}", "cdmsgd", steps=steps, agents=agents,
                           topology=topo, mu=0.9, device=device)
        r["name"] = f"fig2b/{topo}(l2={r['lambda2']:.3f})"
        rows.append(r)
    emit(rows)
    return rows


if __name__ == "__main__":
    run()
