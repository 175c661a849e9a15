"""Quickstart: 5 agents collaboratively train a classifier with CDMSGD.

This is the paper's base setting (5 agents, fully-connected topology,
uniform agent-interaction matrix, mini-batches, fixed step) on the
synthetic stand-in dataset, with the fused CDMSGD update (one consensus
update kernel launch per step).  On the CUDA card by default:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

import argparse
import functools

from repro_torch.core import make_optimizer, make_topology
from repro_torch.core.consensus import describe_exchange_cost
from repro_torch.core.trainer import CollaborativeTrainer, train_loop
from repro_torch.data import AgentPartitioner, make_classification
from repro_torch.nn.param import init_params
from repro_torch.nn.paper_models import (
    classifier_loss,
    mlp_classifier_apply,
    mlp_classifier_template,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description="5-agent CDMSGD quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which needs a card)")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)

    # 1. data, distributed across 5 agents (each sees only its shard)
    train, val = make_classification(4096, n_classes=10, dim=64, seed=0)
    part = AgentPartitioner(train, n_agents=5, seed=0)

    # 2. the model (paper's MNIST-style deep MLP, narrowed)
    params = init_params(mlp_classifier_template(64, 10, width=50, depth=6),
                         seed=0)

    # 3. fixed topology + consensus optimizer (paper Algorithm 2)
    topology = make_topology("fully_connected", 5)
    optimizer = make_optimizer("cdmsgd", 0.05, mu=0.9, fused=True)

    loss = functools.partial(classifier_loss, mlp_classifier_apply)
    trainer = CollaborativeTrainer(loss, params, topology, optimizer,
                                   device=args.device)

    # what one consensus step costs on the wire, per exchange precision
    for exch in ("f32", "int8"):
        print(describe_exchange_cost(trainer.state.params, topology, exch))

    # 4. train: each step = local gradient + Pi-mixing with neighbors
    train_loop(trainer, part.batches(64), n_steps=args.steps, log_every=25,
               printer=print)

    # 5. evaluate every agent's model + the consensus (mean) model
    ev = trainer.evaluate({"x": val.x, "y": val.y})
    print(f"\nvalidation accuracy (mean over agents): {ev['acc_mean']:.4f}")
    print(f"accuracy variance across agents:        {ev['acc_var']:.2e}")
    print(f"final consensus error:                  "
          f"{trainer.history.last('consensus_error'):.3e}")


if __name__ == "__main__":
    main()
