"""Fig 5: step-size effects (fixed 1e-1/1e-2/1e-3 + decaying).

Paper claims: large steps converge fastest but with unstable consensus;
tiny steps give stable consensus but very slow convergence (0.01 is the
sweet spot); decaying steps drive consensus error toward zero (Thm 3/4).
"""

from repro_torch.benchmarks.common import emit, run_experiment
from repro_torch.core import schedules


def run(steps: int = 150, *, device=None):
    rows = []
    for lr in (0.1, 0.01, 0.001):
        rows.append(run_experiment(f"fig5/fixed_{lr:g}", "cdmsgd",
                                   steps=steps, lr=lr, mu=0.9, device=device))
    rows.append(run_experiment(
        "fig5/decaying", "cdmsgd", steps=steps, mu=0.9, device=device,
        schedule=schedules.diminishing(theta=2.0, eps=1.0, t=20.0)))
    emit(rows)
    return rows


if __name__ == "__main__":
    run()
