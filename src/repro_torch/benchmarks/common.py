"""Shared benchmark harness: paper-experiment runner + CSV emission.

The port of ``benchmarks/common.py``.  Every benchmark prints
``name,us_per_call,derived`` rows (one per variant): ``us_per_call`` is the
mean optimizer-step wall time after the first step; ``derived`` packs the
figure's headline quantity (accuracy / consensus / rate), semicolon-keyed,
in the JAX package's format character for character.

The data is the same synthetic set (numpy, seed 0).  The initial weights
are the port's own draw (:func:`repro_torch.nn.param.init_params`, seed
0): the JAX package draws from ``PRNGKey(0)``, which the port cannot
reproduce, so the two packages' rows agree in kind, not digit for digit,
unless the weights are carried over.  Runs go to the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List

from repro_torch.core import make_optimizer, make_topology
from repro_torch.core.trainer import CollaborativeTrainer, train_loop
from repro_torch.data import AgentPartitioner, make_classification
from repro_torch.nn.param import init_params
from repro_torch.nn.paper_models import (
    classifier_loss,
    cnn_classifier_apply,
    cnn_classifier_template,
    mlp_classifier_apply,
    mlp_classifier_template,
)

MLP_LOSS = functools.partial(classifier_loss, mlp_classifier_apply)
CNN_LOSS = functools.partial(classifier_loss, cnn_classifier_apply)


@functools.lru_cache(maxsize=4)
def dataset(kind: str = "flat", n: int = 4096, n_classes: int = 10):
    if kind == "image":
        return make_classification(n, n_classes=n_classes, image_hw=16, seed=0)
    return make_classification(n, n_classes=n_classes, dim=64, seed=0)


@functools.lru_cache(maxsize=4)
def base_params(kind: str = "flat", n_classes: int = 10):
    """The initial single-agent weights (CPU tensors; the trainer copies
    them to its device): the port's own draw from seed 0."""
    if kind == "image":
        return init_params(cnn_classifier_template(16, 3, n_classes), seed=0)
    return init_params(mlp_classifier_template(64, n_classes, width=50, depth=6),
                       seed=0)


def run_experiment(
    name: str,
    optimizer: str,
    *,
    kind: str = "flat",
    steps: int = 150,
    agents: int = 5,
    topology: str = "fully_connected",
    lr: float = 0.05,
    schedule=None,
    batch: int = 64,
    eval_every: int = 25,
    n_classes: int = 10,
    non_iid: bool = False,
    device=None,
    **opt_kw,
) -> Dict:
    """One paper experiment: ``agents`` agents on ``topology`` train the
    MLP (``kind="flat"``) or the CNN (``"image"``) with ``optimizer`` for
    ``steps`` steps on ``device`` (the card unless given); ``opt_kw`` go to
    the optimizer (``mu``, ``local_steps``, ``fused``, ...)."""
    train, val = dataset(kind, n_classes=n_classes)
    params = base_params(kind, n_classes)
    loss = CNN_LOSS if kind == "image" else MLP_LOSS
    part = AgentPartitioner(train, agents, seed=0, non_iid=non_iid)
    topo = make_topology(topology, agents)
    opt = make_optimizer(optimizer, schedule if schedule is not None else lr, **opt_kw)
    tr = CollaborativeTrainer(loss, params, topo, opt, device=device)
    eval_batch = {"x": val.x, "y": val.y}

    batches = part.batches(batch)
    tr.step(next(batches))          # first step: kernel loads, allocator warm-up
    t0 = time.time()
    train_loop(tr, batches, steps - 1, eval_batch=eval_batch, eval_every=eval_every)
    dt = time.time() - t0
    ev = tr.evaluate(eval_batch)
    last = tr.history.rows[-1]
    return {
        "name": name,
        "us_per_call": 1e6 * dt / max(steps - 1, 1),
        "train_acc": last.get("acc", float("nan")),
        "val_acc": ev["acc_mean"],
        "val_acc_var": ev["acc_var"],
        "consensus": last.get("consensus_error", float("nan")),
        "loss": last.get("loss", float("nan")),
        "history": tr.history,
        "lambda2": topo.lambda2,
    }


def emit(rows: List[Dict]) -> None:
    for r in rows:
        derived = (f"val_acc={r['val_acc']:.4f};train_acc={r['train_acc']:.4f};"
                   f"consensus={r['consensus']:.3e};acc_var={r['val_acc_var']:.2e}")
        print(f"{r['name']},{r['us_per_call']:.1f},{derived}")
