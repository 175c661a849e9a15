"""Fixed communication topologies and agent-interaction matrices.

The paper (§2, Assumption 2) requires the agent-interaction matrix ``Pi`` to
be doubly stochastic with ``null{I - Pi} = span{1}`` (connected graph) and
``I >= Pi > 0`` (positive definite).  This module provides:

* standard graph constructions (fully-connected, ring, chain, 2-D torus,
  star, Erdos-Renyi) as adjacency matrices,
* ``Pi`` constructions: *uniform* (paper's default for fully-connected) and
  *Metropolis-Hastings* weights for arbitrary graphs, with a *lazy* blend
  ``Pi <- (1-beta) I + beta Pi`` to enforce positive-definiteness,
* spectral utilities: ``lambda_2``, ``lambda_N``, spectral gap — the
  quantities that appear in Proposition 1 / Theorems 1-4,
* a *circulant* view (neighbor shift offsets + weights), the form a
  sharded one-agent-per-device mode turns into point-to-point transfers.

Numpy only: a copy of the fixed-topology half of :mod:`repro.core.topology`
(``TopologySchedule`` is not ported yet), so ``Pi`` and its spectra are
identical in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Adjacency constructions
# --------------------------------------------------------------------------


def fully_connected_adjacency(n: int) -> np.ndarray:
    a = np.ones((n, n), dtype=np.float64)
    np.fill_diagonal(a, 0.0)
    return a


def ring_adjacency(n: int) -> np.ndarray:
    a = np.zeros((n, n), dtype=np.float64)
    for j in range(n):
        a[j, (j + 1) % n] = 1.0
        a[j, (j - 1) % n] = 1.0
    if n <= 2:  # ring of 2 collapses to a single edge
        a = np.minimum(a, 1.0)
    return a


def chain_adjacency(n: int) -> np.ndarray:
    a = np.zeros((n, n), dtype=np.float64)
    for j in range(n - 1):
        a[j, j + 1] = 1.0
        a[j + 1, j] = 1.0
    return a


def star_adjacency(n: int) -> np.ndarray:
    a = np.zeros((n, n), dtype=np.float64)
    a[0, 1:] = 1.0
    a[1:, 0] = 1.0
    return a


def torus2d_adjacency(rows: int, cols: int) -> np.ndarray:
    """2-D torus — matches the physical ICI mesh of a TPU pod slice."""
    n = rows * cols
    a = np.zeros((n, n), dtype=np.float64)

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            j = idx(r, c)
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                a[j, idx(r + dr, c + dc)] = 1.0
    np.fill_diagonal(a, 0.0)
    return a


def erdos_renyi_adjacency(n: int, p: float, seed: int = 0) -> np.ndarray:
    """Random connected graph (resamples until connected)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        u = rng.random((n, n)) < p
        a = np.triu(u, 1).astype(np.float64)
        a = a + a.T
        if _is_connected(a):
            return a
    raise RuntimeError(f"could not sample a connected G({n},{p}) graph")


def _is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        j = frontier.pop()
        for l in np.nonzero(adj[j])[0]:
            if l not in seen:
                seen.add(int(l))
                frontier.append(int(l))
    return len(seen) == n


# --------------------------------------------------------------------------
# Pi constructions (Assumption 2)
# --------------------------------------------------------------------------


def uniform_pi(n: int) -> np.ndarray:
    """Uniform fully-connected Pi = (1/N) 11^T — the paper's default.

    Note: eigenvalues are {1, 0, ..., 0}, so Assumption 2(d) ``Pi > 0`` is
    met only in the lazy form; the paper's experiments use this matrix
    regardless, and so do we (mixing with it reproduces exact averaging).
    """
    return np.full((n, n), 1.0 / n, dtype=np.float64)


def metropolis_pi(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights: doubly stochastic for any graph."""
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    pi = np.zeros_like(adj)
    for j in range(n):
        for l in np.nonzero(adj[j])[0]:
            pi[j, l] = 1.0 / (1.0 + max(deg[j], deg[l]))
    for j in range(n):
        pi[j, j] = 1.0 - pi[j].sum()
    return pi


def lazy(pi: np.ndarray, beta: float = 0.5) -> np.ndarray:
    """Blend with identity: guarantees ``Pi > 0`` (Assumption 2d)."""
    n = pi.shape[0]
    return (1.0 - beta) * np.eye(n) + beta * pi


def validate_pi(pi: np.ndarray, *, require_positive: bool = False, atol: float = 1e-8) -> None:
    """Check Assumption 2; raises ValueError on violation."""
    n = pi.shape[0]
    if pi.shape != (n, n):
        raise ValueError("Pi must be square")
    if not np.allclose(pi.sum(axis=0), 1.0, atol=atol):
        raise ValueError("Pi columns must sum to 1 (1^T Pi = 1^T)")
    if not np.allclose(pi.sum(axis=1), 1.0, atol=atol):
        raise ValueError("Pi rows must sum to 1 (Pi 1 = 1)")
    if not np.allclose(pi, pi.T, atol=atol):
        raise ValueError("Pi must be symmetric (undirected graph)")
    ev = np.linalg.eigvalsh(pi)
    if ev[-1] > 1.0 + 1e-6:
        raise ValueError(f"lambda_1(Pi) = {ev[-1]} > 1")
    # connectivity: eigenvalue 1 must be simple
    if n > 1 and ev[-2] > 1.0 - 1e-10:
        raise ValueError("graph disconnected: lambda_2(Pi) == 1")
    if require_positive and ev[0] <= 0.0:
        raise ValueError(f"lambda_N(Pi) = {ev[0]} <= 0 violates Assumption 2(d)")


# --------------------------------------------------------------------------
# Spectral quantities (Proposition 1 / Theorems 1-4)
# --------------------------------------------------------------------------


def eigenvalues(pi: np.ndarray) -> np.ndarray:
    """Eigenvalues sorted descending: lambda_1 >= ... >= lambda_N."""
    return np.linalg.eigvalsh(pi)[::-1]


def lambda_2(pi: np.ndarray) -> float:
    return float(eigenvalues(pi)[1])


def lambda_n(pi: np.ndarray) -> float:
    return float(eigenvalues(pi)[-1])


def spectral_gap(pi: np.ndarray) -> float:
    """1 - lambda_2(Pi): controls consensus (Prop. 1) and rate (Thm 1)."""
    return 1.0 - lambda_2(pi)


# --------------------------------------------------------------------------
# Topology object
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Topology:
    """A fixed communication topology over ``n_agents``.

    ``pi`` is the dense agent-interaction matrix (Assumption 2).  When the
    matrix is *circulant* (ring/torus/fully-connected with uniform weights),
    ``shift_weights`` gives the {offset: weight} decomposition
    ``Pi = sum_s w_s P^s`` with ``P`` the cyclic shift — the form consumed
    by the ``lax.ppermute`` mixing path in :mod:`repro.core.consensus`.
    """

    name: str
    pi: np.ndarray  # (n, n) float64

    @property
    def n_agents(self) -> int:
        return self.pi.shape[0]

    @property
    def lambda2(self) -> float:
        return lambda_2(self.pi)

    @property
    def lambdan(self) -> float:
        return lambda_n(self.pi)

    @property
    def spectral_gap(self) -> float:
        return spectral_gap(self.pi)

    def shift_weights(self, atol: float = 1e-12) -> Optional[Dict[int, float]]:
        """Return {offset: weight} if Pi is circulant, else None."""
        n = self.n_agents
        row0 = self.pi[0]
        for j in range(1, n):
            if not np.allclose(self.pi[j], np.roll(row0, j), atol=atol):
                return None
        return {s: float(row0[s]) for s in range(n) if abs(row0[s]) > atol}

    def neighbor_lists(self, atol: float = 1e-12) -> List[List[Tuple[int, float]]]:
        """Per-agent [(neighbor, weight)] including self."""
        out = []
        for j in range(self.n_agents):
            out.append([(int(l), float(w)) for l, w in enumerate(self.pi[j]) if abs(w) > atol])
        return out

    def degree(self) -> int:
        """Max number of non-self neighbors (communication cost proxy)."""
        return int(max((np.abs(self.pi[j]) > 1e-12).sum() - 1 for j in range(self.n_agents)))


def make_topology(
    name: str,
    n_agents: int,
    *,
    lazy_beta: Optional[float] = None,
    seed: int = 0,
    er_prob: float = 0.4,
    torus_shape: Optional[Tuple[int, int]] = None,
) -> Topology:
    """Factory for the topologies used across the paper's experiments.

    Names: ``fully_connected`` (uniform Pi, paper default), ``ring``,
    ``chain``, ``star``, ``torus`` (2-D, TPU-ICI-shaped), ``erdos_renyi``,
    ``disconnected_self`` (Pi = I; degenerate control).
    """
    if n_agents < 1:
        raise ValueError("n_agents must be >= 1")
    if name == "fully_connected":
        pi = uniform_pi(n_agents)
    elif name == "ring":
        pi = metropolis_pi(ring_adjacency(n_agents))
    elif name == "chain":
        pi = metropolis_pi(chain_adjacency(n_agents))
    elif name == "star":
        pi = metropolis_pi(star_adjacency(n_agents))
    elif name == "torus":
        if torus_shape is None:
            r = int(np.sqrt(n_agents))
            while n_agents % r:
                r -= 1
            torus_shape = (r, n_agents // r)
        if torus_shape[0] * torus_shape[1] != n_agents:
            raise ValueError("torus_shape must multiply to n_agents")
        pi = metropolis_pi(torus2d_adjacency(*torus_shape))
    elif name == "erdos_renyi":
        pi = metropolis_pi(erdos_renyi_adjacency(n_agents, er_prob, seed))
    elif name == "disconnected_self":
        pi = np.eye(n_agents)
    else:
        raise ValueError(f"unknown topology {name!r}")
    if lazy_beta is not None:
        pi = lazy(pi, lazy_beta)
    if name not in ("disconnected_self",):
        validate_pi(pi)
    return Topology(name=name, pi=pi)
