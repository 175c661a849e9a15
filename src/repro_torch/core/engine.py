"""StepProgram: one collaborative training step from named phases (sync).

The sync slice of :mod:`repro.core.engine`.  A step is

* ``grad``   — one per-agent value-and-grad over the leading agent axis of
  the stacked params (``torch.func.vmap`` of ``torch.func.grad_and_value``;
  :func:`make_grad_phase`);
* ``update`` — the optimizer's update on the *current* params: for fused
  optimizers that is pack, gather (dense ``Pi`` on the f32 wire) and one
  consensus-update kernel launch per bucket (:func:`make_update_phase`).

``schedule="overlap"`` (the one-step-stale exchange, ROADMAP A11) and
gradient accumulation over microbatches are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.optim import CommOps, DistributedOptimizer, OptState

PyTree = Any

SCHEDULES = ("sync", "overlap")


def make_grad_phase(agent_loss: Callable, microbatches: int = 1) -> Callable:
    """The ``grad`` phase: ``(gp, batch) -> ((losses, metrics), grads)``.

    ``agent_loss(params, batch) -> (loss, metrics)`` is the single-agent
    loss; the phase maps its value-and-grad over the leading agent axis of
    both the params and the batch.
    """
    if microbatches != 1:
        raise NotImplementedError(
            "microbatches > 1 (gradient accumulation) is not ported yet: "
            "ROADMAP A9")
    per_agent = vmap(grad_and_value(agent_loss, has_aux=True))

    def grad_phase(gp, batch):
        grads, (losses, metrics) = per_agent(gp, batch)
        return (losses, metrics), grads

    return grad_phase


def make_update_phase(optimizer: DistributedOptimizer, comm: CommOps,
                      schedule: str = "sync") -> Callable:
    """The update phase group: ``(params, grads, state) -> (params', state')``.

    ``sync``: the optimizer gathers on the current params and updates.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of "
                         f"{SCHEDULES}")
    if schedule != "sync":
        raise NotImplementedError(
            "schedule='overlap' (one-step-stale wire) is not ported yet: "
            "ROADMAP A11")

    def update_sync(params, grads, state):
        return optimizer.update(params, grads, state, comm)

    return update_sync


@dataclasses.dataclass
class StepProgram:
    """One training step assembled from the named phases.

    ``extra_metrics(new_params)`` appends mode-specific diagnostics (the
    stacked trainer's consensus error).
    """

    optimizer: DistributedOptimizer
    comm: CommOps
    grad_phase: Callable          # (gp, batch) -> ((losses, metrics), grads)
    update_phase: Callable        # (params, grads, state) -> (params', state')
    extra_metrics: Optional[Callable[[PyTree], Dict[str, torch.Tensor]]] = None

    def init_state(self, params: PyTree) -> OptState:
        return self.optimizer.init(params)

    @torch.no_grad()
    def _update(self, params, grads, opt_state):
        new_params, new_state = self.update_phase(params, grads, opt_state)
        extra = self.extra_metrics(new_params) if self.extra_metrics else {}
        return new_params, new_state, extra

    def step_fn(self, params: PyTree, opt_state: OptState, batch):
        (losses, metrics), grads = self.grad_phase(params, batch)
        new_params, new_state, extra = self._update(params, grads, opt_state)
        out = {"loss": torch.mean(losses)}
        out.update(extra)
        for k, v in metrics.items():
            out[k] = torch.mean(v)
        return new_params, new_state, out
