"""Proposition 1: measured consensus error vs the bound alpha L/(1-lambda_2).

One row per (topology, alpha); derived reports measured/bound — values
<= 1 mean the paper's bound holds (it should, with slack).  The quadratic
problem's eigenvalues and centers come from numpy (seed 0), as in the JAX
package; the iteration runs in float32 on ``device`` (the card unless
given).
"""

import time

import numpy as np
import torch

from repro_torch.core import lyapunov
from repro_torch.core.consensus import consensus_error_stacked
from repro_torch.core.topology import make_topology
from repro_torch.device import resolve_device

N, D = 8, 8


def measure(*, device=None):
    """``[(name, measured, bound), ...]`` unrounded: one per (topology,
    alpha), the steady-state consensus error after 600 steps of CDSGD on
    the quadratic and Proposition 1's bound with the empirical ``L``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    eigs = torch.tensor(rng.uniform(0.5, 2.0, size=(N, D)), dtype=torch.float32,
                        device=dev)
    centers = torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32,
                           device=dev)
    out = []
    for topo in ("ring", "torus", "erdos_renyi"):
        t = make_topology(topo, N)
        pi = torch.tensor(t.pi, dtype=torch.float32, device=dev)
        for alpha in (0.1, 0.05, 0.01):
            x = torch.zeros((N, D), device=dev)
            l_emp = 0.0
            for k in range(600):
                g = eigs * (x - centers)
                if k > 300:
                    l_emp = max(l_emp, float(torch.max(
                        torch.linalg.vector_norm(g, dim=1))))
                x = pi @ x - alpha * g
            err = float(consensus_error_stacked(x))
            out.append((f"prop1/{topo}_a{alpha:g}", err,
                        lyapunov.consensus_bound(alpha, l_emp, t)))
    return out


def run(*, device=None):
    t0 = time.time()
    rows = [(name, f"measured={err:.3e};bound={bound:.3e};ratio={err/max(bound,1e-12):.3f}")
            for name, err, bound in measure(device=device)]
    us = 1e6 * (time.time() - t0) / len(rows)
    for name, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    run()
