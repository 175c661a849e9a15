"""Fig 2(a): effect of network size (N = 2, 4, 8, 16 agents).

Paper claims: convergence slows as agents grow, but all sizes reach
similar accuracy levels.
"""

from repro_torch.benchmarks.common import emit, run_experiment


def run(steps: int = 150, *, device=None):
    rows = [
        run_experiment(f"fig2a/agents{n}", "cdmsgd", steps=steps, agents=n,
                       mu=0.9, device=device)
        for n in (2, 4, 8, 16)
    ]
    emit(rows)
    return rows


if __name__ == "__main__":
    run()
