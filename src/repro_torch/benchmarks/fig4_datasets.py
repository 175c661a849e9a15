"""Fig 4: the MNIST-MLP and CIFAR-CNN analogues of Fig 1.

The paper's MNIST model is a 20x50-unit ReLU MLP; its CIFAR model is the
conv32/32-pool-conv64/64-pool-dense512 CNN.  Both model families run on
the synthetic stand-ins with SGD / CDSGD / CDMSGD / FedAvg, checking the
same orderings hold on a second model family.
"""

from repro_torch.benchmarks.common import emit, run_experiment


def run(steps: int = 80, *, device=None):
    rows = []
    for opt, kw in [("sgd", {}), ("cdsgd", {}), ("cdmsgd", {"mu": 0.9}),
                    ("fedavg", {"mu": 0.9, "local_steps": 1})]:
        rows.append(run_experiment(f"fig4/cnn_{opt}", opt, kind="image",
                                   steps=steps, lr=0.02, device=device, **kw))
    emit(rows)
    return rows


if __name__ == "__main__":
    run()
