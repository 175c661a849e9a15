"""Step-size schedules: ``step -> alpha`` as a float32-rounded Python float.

The paper analyses a *fixed* step size (Theorems 1-2) and a *diminishing*
one, ``a_k = Theta/(k^eps + t)`` with ``eps in (0.5, 1]`` (Remark 4).
Exponential decay and warmup-cosine serve the LM configs, and
:func:`paper_step_size_bound` is the paper's fixed-step bound.  The
arithmetic is done in float32, as the JAX package does it, so both packages
hand the update the same ``alpha``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]


def fixed(alpha: float) -> Schedule:
    a = float(np.float32(alpha))

    def sched(step):
        return a

    return sched


def diminishing(theta: float = 1.0, eps: float = 1.0, t: float = 1.0) -> Schedule:
    """``a_k = Theta / (k^eps + t)`` — paper Remark 4; requires eps in (0.5, 1]."""
    if not (0.5 < eps <= 1.0):
        raise ValueError("eps must lie in (0.5, 1] for Theorem 3/4 to apply")
    theta32, eps32, t32 = np.float32(theta), np.float32(eps), np.float32(t)

    def sched(step):
        k = np.float32(step) + np.float32(1.0)
        return float(theta32 / (k ** eps32 + t32))

    return sched


def exponential_decay(alpha0: float, decay: float, every: int = 1) -> Schedule:
    """``alpha0 * decay^(k / every)``, in float32."""
    a32, d32, e32 = np.float32(alpha0), np.float32(decay), np.float32(every)

    def sched(step):
        return float(a32 * d32 ** (np.float32(step) / e32))

    return sched


def warmup_cosine(alpha_peak: float, warmup: int, total: int,
                  alpha_min: float = 0.0) -> Schedule:
    """Linear warmup to ``alpha_peak`` over ``warmup`` steps, then a cosine
    to ``alpha_min`` at ``total``, in float32."""
    f32 = np.float32
    peak, low = f32(alpha_peak), f32(alpha_min)
    half_span = f32(0.5 * (alpha_peak - alpha_min))    # a Python float, as JAX's
    wdiv, cdiv = f32(max(warmup, 1)), f32(max(total - warmup, 1))

    def sched(step):
        k = f32(step)
        if k < warmup:
            return float(peak * (k + f32(1.0)) / wdiv)
        prog = np.clip((k - f32(warmup)) / cdiv, f32(0.0), f32(1.0))
        cos = np.cos(f32(np.pi) * prog, dtype=np.float32)
        return float(low + half_span * (f32(1.0) + cos))

    return sched


def paper_step_size_bound(zeta1: float, qm: float, gamma_m: float,
                          lambda_n: float) -> float:
    """Sufficient fixed-step bound (eq. 15 expanded):
    ``0 < alpha <= (zeta1 - (1 - lambda_N(Pi)) Qm) / (gamma_m Qm)``.

    Returns the upper bound; non-positive means the topology is too
    ill-conditioned for the theory to admit a fixed step.
    """
    return (zeta1 - (1.0 - lambda_n) * qm) / (gamma_m * qm)
