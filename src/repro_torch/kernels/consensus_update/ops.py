"""Bucket-level entry points of the fused consensus update.

``cdsgd_update_flat`` / ``cdmsgd_update_flat`` take already-packed
``(rows, 128)`` buffers (:mod:`repro_torch.core.flatbuf`) and dispatch on
``weights.ndim``, as :mod:`repro.kernels.consensus_update.ops` does:

* ``weights (S,)``   — one agent's stencil: ``neighbors (S, rows, 128)``,
  per-agent operands ``(rows, 128)`` (the sharded one-agent-per-device
  mode);
* ``weights (A, A)`` — the dense stacked simulation: ``neighbors`` is the
  whole agent stack ``(A, rows, 128)`` shared by every agent, per-agent
  operands ``(A, rows, 128)``; **one** kernel launch covers all agents.

The updated parameters are written into ``grad``'s storage and the new
momentum into ``momentum``'s; the returned tensors are those buffers.
CUDA tensors launch the kernel, CPU tensors run the plain version (see
:mod:`.consensus_update`).  The quantized-wire operand form (``scales`` /
``self_buf``) is the next slice of the port (ROADMAP A11, B3).
"""

from __future__ import annotations

from repro_torch.kernels.consensus_update.consensus_update import (
    cdmsgd_update,
    cdsgd_update,
)


def cdsgd_update_flat(neighbors, weights, grad, alpha):
    if weights.dim() == 2:
        return cdsgd_update(weights, neighbors, grad, alpha)
    return cdsgd_update(weights[None], neighbors, grad[None], alpha)[0]


def cdmsgd_update_flat(neighbors, weights, grad, momentum, alpha, mu):
    if weights.dim() == 2:
        return cdmsgd_update(weights, neighbors, grad, momentum, alpha, mu)
    g, v = cdmsgd_update(weights[None], neighbors, grad[None], momentum[None],
                         alpha, mu)
    return g[0], v[0]
