"""Fig 1(a): CDSGD vs centralized SGD — accuracy + generalization gap.

Paper claims: CDSGD converges slower but reaches comparable accuracy, with
a *smaller* generalization gap (train - validation accuracy).
"""

from repro_torch.benchmarks.common import emit, run_experiment


def run(steps: int = 150, *, device=None):
    rows = [
        run_experiment("fig1a/sgd", "sgd", steps=steps, device=device),
        run_experiment("fig1a/cdsgd", "cdsgd", steps=steps, device=device),
    ]
    emit(rows)
    gap = {r["name"]: r["train_acc"] - r["val_acc"] for r in rows}
    print(f"fig1a/generalization_gap,0.0,sgd={gap['fig1a/sgd']:.4f};"
          f"cdsgd={gap['fig1a/cdsgd']:.4f}")
    return rows


if __name__ == "__main__":
    run()
