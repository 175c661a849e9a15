"""Step-size schedules: ``step -> alpha`` as a float32-rounded Python float.

The paper analyses a *fixed* step size (Theorems 1-2) and a *diminishing*
one, ``a_k = Theta/(k^eps + t)`` with ``eps in (0.5, 1]`` (Remark 4).  The
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
