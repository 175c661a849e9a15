"""Bucket-level entry points of the fused consensus update.

``cdsgd_update_flat`` / ``cdmsgd_update_flat`` /
``cdmsgd_nesterov_update_flat`` / ``cdadam_update_flat`` take
already-packed ``(rows, 128)`` buffers (:mod:`repro_torch.core.flatbuf`)
and dispatch on ``weights.ndim``, ``scales`` and ``mom_neighbors``, as
:mod:`repro.kernels.consensus_update.ops` does:

* ``weights (S,)``   — one agent's stencil: ``neighbors (S, rows, 128)``,
  per-agent operands ``(rows, 128)`` (the sharded one-agent-per-device
  mode);
* ``weights (A, A)`` — the dense stacked simulation: ``neighbors`` is the
  whole agent stack ``(A, rows, 128)`` shared by every agent, per-agent
  operands ``(A, rows, 128)``; **one** kernel launch covers all agents.

With ``scales`` (and the native ``self_buf``) the neighbors are wire
payloads and the weights carry the self weight first: ``(S+1,)`` for one
agent, ``(A, A+1)`` = ``[diag(Pi) | zero-diag Pi]`` for the stacked
simulation, again in one launch (the ``_q`` kernels).  With
``mom_neighbors`` / ``mom_scales`` as well, the momentum (CDAdam: the
first moment) crossed the wire as a second payload and the local momentum
operand is its self tile (the ``_qm`` kernels).

A :class:`SparseNeighbors` tuple as ``neighbors`` selects the sparse
operand form of the top-k wire: the compact ``(S, k_rows, 128)`` values,
int32 flat indices and ``(S, k_rows, 1)`` scales, scatter-accumulated by
the ``*_update_sparse`` kernels with the self-separated weights and
``self_buf``; ``scales`` is then ``None`` (the row scales ride inside the
tuple).

The updated parameters are written into ``grad``'s storage and the new
momentum (moments) into ``momentum``'s (``m``'s, ``v``'s); Nesterov's
lookahead is returned in a new buffer.  CUDA tensors launch the kernel,
CPU tensors run the plain version (see :mod:`.consensus_update`).  Under
an open op counter (:mod:`repro_torch.analysis.opcount`) each launch
reports the bytes its kernel moves, and the ops of the plain version are
not counted again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.analysis import opcount
from repro_torch.analysis.roofline import kernel_work
from repro_torch.kernels.consensus_update import consensus_update as cu


class SparseNeighbors(NamedTuple):
    """Top-k compact neighbour operands of one bucket: the ``TopKWire``
    fields stacked over the stencil (the stacked simulation: over every
    agent, shared by all) — ``values (S, k_rows, 128)`` int8, ``indices``
    int32 flat dense positions (sorted, unique per neighbour), ``scales
    (S, k_rows, 1)`` f32."""

    values: torch.Tensor
    indices: torch.Tensor
    scales: torch.Tensor


def _work(kernel, weights, neighbors, grad) -> int:
    """The bytes one launch of ``kernel`` moves
    (:func:`repro_torch.analysis.roofline.kernel_work`)."""
    sparse = isinstance(neighbors, SparseNeighbors)
    payload = neighbors.values if sparse else neighbors
    nbytes, _ = kernel_work(
        kernel.__name__, weights.shape[0], payload.shape[0], grad.shape[-2],
        payload.dtype, payload.shape[-2] if sparse else 0, grad.dtype)
    return nbytes


def _dispatch(dense, q, qm, sparse, neighbors, weights, per_agent, scalars, *,
              scales, self_buf, mom_neighbors, mom_scales):
    """Call the dense, ``_q``, ``_qm`` or sparse kernel with the per-agent
    buffers ``per_agent`` (grad first); strip the stencil form's leading
    axis.  Under an open op counter the launch reports its kernel's bytes
    (the same on the card and in the plain version)."""
    stencil = weights.dim() == 1
    if stencil:
        weights = weights[None]
        per_agent = [t[None] for t in per_agent]
        self_buf = None if self_buf is None else self_buf[None]
    if isinstance(neighbors, SparseNeighbors):
        if scales is not None or mom_neighbors is not None:
            raise ValueError("the sparse operand form carries its scales in "
                             "SparseNeighbors and mixes no momentum payload")
        if self_buf is None:
            raise ValueError("the sparse operand form needs self_buf")
        kernel, args = sparse, (weights, self_buf, *neighbors)
    elif mom_neighbors is not None:
        kernel, args = qm, (weights, self_buf, neighbors, scales,
                            mom_neighbors, mom_scales)
    elif scales is not None:
        kernel, args = q, (weights, self_buf, neighbors, scales)
    else:
        kernel, args = dense, (weights, neighbors)
    if opcount.counting():
        with opcount.reported(traffic_bytes=_work(kernel, weights, neighbors,
                                                  per_agent[0])):
            out = kernel(*args, *per_agent, *scalars)
    else:
        out = kernel(*args, *per_agent, *scalars)
    if isinstance(out, tuple):
        return tuple(t[0] for t in out) if stencil else out
    return out[0] if stencil else out


def cdsgd_update_flat(neighbors, weights, grad, alpha, *, scales=None,
                      self_buf=None):
    return _dispatch(cu.cdsgd_update, cu.cdsgd_update_q, None,
                     cu.cdsgd_update_sparse, neighbors, weights, [grad],
                     (alpha,), scales=scales,
                     self_buf=self_buf, mom_neighbors=None, mom_scales=None)


def cdmsgd_update_flat(neighbors, weights, grad, momentum, alpha, mu, *,
                       scales=None, self_buf=None, mom_neighbors=None,
                       mom_scales=None):
    return _dispatch(cu.cdmsgd_update, cu.cdmsgd_update_q, cu.cdmsgd_update_qm,
                     cu.cdmsgd_update_sparse, neighbors, weights,
                     [grad, momentum], (alpha, mu), scales=scales,
                     self_buf=self_buf,
                     mom_neighbors=mom_neighbors, mom_scales=mom_scales)


def cdmsgd_nesterov_update_flat(neighbors, weights, grad, momentum, alpha, mu,
                                *, scales=None, self_buf=None,
                                mom_neighbors=None, mom_scales=None):
    """Returns ``(x', v', x' + mu v')``."""
    return _dispatch(cu.cdmsgd_nesterov_update, cu.cdmsgd_nesterov_update_q,
                     cu.cdmsgd_nesterov_update_qm,
                     cu.cdmsgd_nesterov_update_sparse, neighbors, weights,
                     [grad, momentum], (alpha, mu), scales=scales,
                     self_buf=self_buf, mom_neighbors=mom_neighbors,
                     mom_scales=mom_scales)


def cdadam_update_flat(neighbors, weights, grad, m, v, alpha, b1, b2, eps,
                       bc1, bc2, *, scales=None, self_buf=None,
                       mom_neighbors=None, mom_scales=None):
    """Returns ``(x', m', v')``; ``bc1 = 1 - b1^t``, ``bc2 = 1 - b2^t``."""
    return _dispatch(cu.cdadam_update, cu.cdadam_update_q, cu.cdadam_update_qm,
                     cu.cdadam_update_sparse, neighbors, weights, [grad, m, v],
                     (alpha, b1, b2, eps, bc1, bc2), scales=scales,
                     self_buf=self_buf, mom_neighbors=mom_neighbors,
                     mom_scales=mom_scales)
