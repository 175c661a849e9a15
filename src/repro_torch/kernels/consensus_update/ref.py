"""Plain PyTorch versions of the fused consensus-update kernels.

Same operand form as the CUDA kernels (``csrc/consensus_update.cu``):
``weights (A_out, S)``, ``neighbors (S, rows, 128)``, and per-output
``grad`` / ``momentum`` of shape ``(A_out, rows, 128)``.  The mixing sum is
taken in float32 in stencil order ``s = 0 .. S-1`` starting from zero, one
multiply and one add per term, exactly as the Pallas kernels
(``_mix_stencil``) and the CUDA kernels accumulate, so the three agree to
the last bit up to the JAX backend's own contraction choices.

These are pure: they return new tensors.  The wrappers in
:mod:`repro_torch.kernels.consensus_update.consensus_update` call them for
CPU tensors and copy the results into the in-place outputs; the CUDA path
never calls them.
"""

from __future__ import annotations

import torch


def _mix(weights: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """``acc[a] = sum_s w[a, s] * x[s]`` in f32, stencil order."""
    w = weights.float()
    x = neighbors.float()
    acc = torch.zeros((w.shape[0],) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    for s in range(x.shape[0]):
        acc = acc + w[:, s, None, None] * x[s]
    return acc


def cdsgd_update_ref(weights, neighbors, grad, alpha: float) -> torch.Tensor:
    """``out[a] = sum_s W[a,s] X[s] - alpha G[a]`` (paper eq. 5, Algorithm 1)."""
    out = _mix(weights, neighbors) - alpha * grad.float()
    return out.to(grad.dtype)


def cdmsgd_update_ref(weights, neighbors, grad, momentum, alpha: float,
                      mu: float):
    """``v' = mu V[a] - alpha G[a]``; ``out[a] = sum_s W[a,s] X[s] + v'``."""
    v = mu * momentum.float() - alpha * grad.float()
    out = _mix(weights, neighbors) + v
    return out.to(grad.dtype), v.to(momentum.dtype)
