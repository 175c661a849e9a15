"""Fig 1(b): CDMSGD vs Federated Averaging (the paper's headline result).

Paper claims: CDMSGD is slightly slower to converge than FedAvg (which
brute-force averages on a parameter server every epoch) but performs
better at steady state, approaching centralized-SGD accuracy.
"""

from repro_torch.benchmarks.common import emit, run_experiment


def run(steps: int = 200, *, device=None):
    kw = dict(steps=steps, device=device)
    rows = [
        run_experiment("fig1b/fedavg_e1", "fedavg", mu=0.9, local_steps=1, **kw),
        run_experiment("fig1b/fedavg_e5", "fedavg", mu=0.9, local_steps=5, **kw),
        run_experiment("fig1b/cdmsgd", "cdmsgd", mu=0.9, **kw),
        run_experiment("fig1b/cdmsgd_nesterov", "cdmsgd_nesterov", mu=0.9, **kw),
        run_experiment("fig1b/sgd", "sgd", **kw),
    ]
    emit(rows)
    return rows


if __name__ == "__main__":
    run()
