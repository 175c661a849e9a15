"""Bucket-level entry points of the fused consensus update.

``cdsgd_update_flat`` / ``cdmsgd_update_flat`` take already-packed
``(rows, 128)`` buffers (:mod:`repro_torch.core.flatbuf`) and dispatch on
``weights.ndim`` and ``scales``, as :mod:`repro.kernels.consensus_update.ops`
does:

* ``weights (S,)``   — one agent's stencil: ``neighbors (S, rows, 128)``,
  per-agent operands ``(rows, 128)`` (the sharded one-agent-per-device
  mode);
* ``weights (A, A)`` — the dense stacked simulation: ``neighbors`` is the
  whole agent stack ``(A, rows, 128)`` shared by every agent, per-agent
  operands ``(A, rows, 128)``; **one** kernel launch covers all agents.

With ``scales`` (and the native ``self_buf``) the neighbors are wire
payloads and the weights carry the self weight first: ``(S+1,)`` for one
agent, ``(A, A+1)`` = ``[diag(Pi) | zero-diag Pi]`` for the stacked
simulation, again in one launch (the ``_q`` kernels).

The updated parameters are written into ``grad``'s storage and the new
momentum into ``momentum``'s; the returned tensors are those buffers.
CUDA tensors launch the kernel, CPU tensors run the plain version (see
:mod:`.consensus_update`).
"""

from __future__ import annotations

from repro_torch.kernels.consensus_update.consensus_update import (
    cdmsgd_update,
    cdmsgd_update_q,
    cdsgd_update,
    cdsgd_update_q,
)


def cdsgd_update_flat(neighbors, weights, grad, alpha, *, scales=None,
                      self_buf=None):
    stencil = weights.dim() == 1
    if stencil:
        weights, grad = weights[None], grad[None]
        self_buf = None if self_buf is None else self_buf[None]
    if scales is None:
        out = cdsgd_update(weights, neighbors, grad, alpha)
    else:
        out = cdsgd_update_q(weights, self_buf, neighbors, scales, grad, alpha)
    return out[0] if stencil else out


def cdmsgd_update_flat(neighbors, weights, grad, momentum, alpha, mu, *,
                       scales=None, self_buf=None):
    stencil = weights.dim() == 1
    if stencil:
        weights, grad, momentum = weights[None], grad[None], momentum[None]
        self_buf = None if self_buf is None else self_buf[None]
    if scales is None:
        g, v = cdmsgd_update(weights, neighbors, grad, momentum, alpha, mu)
    else:
        g, v = cdmsgd_update_q(weights, self_buf, neighbors, scales, grad,
                               momentum, alpha, mu)
    return (g[0], v[0]) if stencil else (g, v)
