"""Table 1: convergence-rate regimes of CDSGD on a strongly convex problem.

Measures the empirical per-step contraction of V(x_k) - V* on the known
quadratic and compares against the paper's regimes:

* fixed step, no gradient noise      -> linear rate O(gamma^k) (Thm 1)
* fixed step, stochastic gradients   -> linear to a noise floor (Thm 1)
* diminishing step, stochastic       -> sublinear O(1/k^eps) to zero (Thm 3)

The problem and the gradient noise come from numpy (seeds 0 and 1), as in
the JAX package; the iteration runs in float32 on ``device`` (the card
unless given).
"""

import time

import numpy as np
import torch

from repro_torch.core import lyapunov, schedules
from repro_torch.core.topology import make_topology
from repro_torch.device import resolve_device

N, D = 5, 8


def _setup(dev, seed=0):
    rng = np.random.default_rng(seed)
    eigs = torch.tensor(rng.uniform(0.5, 2.0, size=(N, D)), dtype=torch.float32,
                        device=dev)
    centers = torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32,
                           device=dev)
    t = make_topology("ring", N, lazy_beta=0.5)
    pi = torch.tensor(t.pi, dtype=torch.float32, device=dev)
    return eigs, centers, t, pi


def _f32(rng, dev):
    return torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32, device=dev)


def _run(noise: float, sched, dev, steps: int = 800, seed: int = 0):
    eigs, centers, t, pi = _setup(dev)
    rng = np.random.default_rng(seed + 1)
    x = _f32(rng, dev)

    def v_value(x, alpha):
        fsum = torch.sum(0.5 * eigs * (x - centers) ** 2)
        return float(lyapunov.lyapunov_value(fsum, x, pi, alpha))

    # V* from a long noiseless run at the final step size
    xs = torch.zeros((N, D), device=dev)
    a_inf = float(sched(steps))
    for _ in range(6000):
        xs = pi @ xs - a_inf * eigs * (xs - centers)
    v_star = v_value(xs, a_inf)

    vals = []
    for k in range(steps):
        a = float(sched(k))
        g = eigs * (x - centers)
        if noise:
            g = g + noise * _f32(rng, dev)
        x = pi @ x - a * g
        vals.append(max(v_value(x, a_inf) - v_star, 1e-12))
    return np.array(vals)


def run(*, device=None):
    dev = resolve_device(device)
    t0 = time.time()
    rows = []

    v = _run(0.0, schedules.fixed(0.05), dev)
    # empirical contraction over the clean-decay region
    head = v[: np.argmax(v < 1e-8) or 200]
    rate = float(np.exp(np.mean(np.diff(np.log(head[:100])))))
    rows.append(("table1/fixed_noiseless", f"rate_per_step={rate:.4f};final={v[-1]:.2e};regime=linear"))

    v = _run(0.5, schedules.fixed(0.05), dev)
    floor = float(np.mean(v[-100:]))
    rows.append(("table1/fixed_noisy", f"noise_floor={floor:.3e};regime=linear_to_floor"))

    v = _run(0.5, schedules.diminishing(theta=2.0, eps=1.0, t=10.0), dev)
    tail_ratio = float(np.mean(v[-50:]) / np.mean(v[200:250]))
    rows.append(("table1/diminishing_noisy",
                 f"final={float(np.mean(v[-50:])):.3e};tail_ratio={tail_ratio:.3f};regime=sublinear_to_zero"))

    us = 1e6 * (time.time() - t0) / 3
    for name, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    run()
