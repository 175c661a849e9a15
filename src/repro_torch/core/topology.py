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
  sharded one-agent-per-device mode turns into point-to-point transfers,
* time-varying schedules (:class:`TopologySchedule`,
  :func:`make_topology_schedule`): periodic sequences ``Pi_t`` whose
  product over one period contracts the disagreement (B-connectivity),
  including single-pair gossip matrices (:func:`gossip_pair_pi`).

Numpy only: a copy of :mod:`repro.core.topology`, so ``Pi``, the schedules'
gossip draws and the spectra are identical in both packages.
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
    by a sharded mode's point-to-point transfers.
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


def gossip_pair_pi(n: int, i: int, j: int) -> np.ndarray:
    """Single-pair gossip matrix ``W = I - (e_i - e_j)(e_i - e_j)^T / 2``.

    Doubly stochastic, symmetric, PSD; agents ``i`` and ``j`` average,
    everyone else keeps their value.  One of these alone is *disconnected*
    for ``n > 2`` — only the union over a schedule period mixes globally
    (B-connectivity), which :meth:`TopologySchedule.validate` checks.
    """
    pi = np.eye(n)
    pi[i, i] = pi[j, j] = 0.5
    pi[i, j] = pi[j, i] = 0.5
    return pi


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


# --------------------------------------------------------------------------
# Time-varying topology schedules (B-connected sequences of Pi_t)
# --------------------------------------------------------------------------

# step-strided PRNG seeding, matching the stochastic-rounding seed pattern
# in repro_torch.core.consensus (_SEED_STEP_STRIDE there): schedule entry t draws
# from an rng seeded `user_seed + stride * t`, so two schedules built with
# different seeds never share a per-step stream.
_SCHEDULE_SEED_STRIDE = 1000003


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A static-shape periodic sequence of agent-interaction matrices.

    ``Pi_t = topologies[t % period]`` — the mixing matrix consumed at
    optimizer step ``t`` by the ``TimeVaryingMixing`` strategy
    (:mod:`repro_torch.core.consensus`).  ``period == 1`` is the paper's fixed
    topology.  Individual entries need NOT be connected (a gossip pair
    mixes only two agents); consensus requires only the *product over one
    period* to contract the disagreement subspace — B-connectivity in the
    sense of Jiang et al. (1805.12120) — which :meth:`validate` checks and
    :meth:`effective_lambda2` quantifies.

    Spectral diagnostics: the disagreement contraction over one period is
    ``sigma_max((Pi_{T-1}^k ... Pi_0^k)(I - 11^T/n))`` for ``k`` consensus
    rounds per step, and :meth:`effective_lambda2` is its per-step
    geometric mean — the quantity that replaces ``lambda_2(Pi)`` in
    Proposition 1 / Theorem 1 (see ``repro_torch.core.lyapunov``'s
    schedule-aware bounds).
    """

    name: str
    topologies: Tuple[Topology, ...]

    def __post_init__(self):
        if not self.topologies:
            raise ValueError("TopologySchedule needs at least one topology")
        n = self.topologies[0].n_agents
        if any(t.n_agents != n for t in self.topologies):
            raise ValueError("all schedule entries must share n_agents")

    @property
    def period(self) -> int:
        return len(self.topologies)

    @property
    def n_agents(self) -> int:
        return self.topologies[0].n_agents

    @property
    def is_static(self) -> bool:
        return self.period == 1

    def topology_at(self, step: int) -> Topology:
        return self.topologies[step % self.period]

    def pi_stack(self) -> np.ndarray:
        """(period, n, n) float64 stack of the per-step mixing matrices."""
        return np.stack([t.pi for t in self.topologies])

    def product_pi(self, rounds: int = 1) -> np.ndarray:
        """``Pi_{T-1}^k @ ... @ Pi_0^k`` — one period of k-round mixing."""
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        prod = np.eye(self.n_agents)
        for t in self.topologies:
            prod = np.linalg.matrix_power(t.pi, rounds) @ prod
        return prod

    def effective_lambda2(self, rounds: int = 1) -> float:
        """Per-step disagreement contraction factor of the schedule.

        ``sigma_max(P (I - 11^T/n)) ** (1/period)`` for the one-period
        product ``P`` — equals ``lambda_2(Pi)^rounds`` for a static
        symmetric-PSD schedule, and is < 1 iff the schedule is B-connected
        over its period.  (The product of symmetric matrices is generally
        non-symmetric, hence the singular value, not an eigenvalue.)
        """
        n = self.n_agents
        if n == 1:
            return 0.0
        proj = np.eye(n) - np.ones((n, n)) / n
        sig = float(np.linalg.norm(self.product_pi(rounds) @ proj, ord=2))
        return sig ** (1.0 / self.period)

    def effective_spectral_gap(self, rounds: int = 1) -> float:
        """``1 - effective_lambda2`` — the schedule's per-step consensus
        rate (Prop. 1 with the product matrix)."""
        return 1.0 - self.effective_lambda2(rounds)

    def max_degree(self) -> int:
        """Worst per-step neighbor count — sizes the wire double-buffers."""
        return max(t.degree() for t in self.topologies)

    def mean_degree(self) -> float:
        """Period-averaged neighbor count — the amortized per-step wire
        cost multiplier (a gossip-pair schedule pays ~2/n of a ring)."""
        return float(np.mean([t.degree() for t in self.topologies]))

    def validate(self) -> None:
        """Per-entry Assumption 2 (minus connectivity) + B-connectivity of
        the period product.  Raises ValueError on violation."""
        for i, t in enumerate(self.topologies):
            pi = t.pi
            if not np.allclose(pi.sum(axis=0), 1.0, atol=1e-8) or \
               not np.allclose(pi.sum(axis=1), 1.0, atol=1e-8):
                raise ValueError(f"schedule entry {i} is not doubly stochastic")
            if not np.allclose(pi, pi.T, atol=1e-8):
                raise ValueError(f"schedule entry {i} is not symmetric")
        if self.n_agents > 1 and self.effective_lambda2() >= 1.0 - 1e-10:
            raise ValueError(
                f"schedule {self.name!r} is not B-connected over its period "
                f"(product disagreement norm >= 1): the union graph of "
                f"{[t.name for t in self.topologies]} does not mix")

    def diagnostics(self, rounds: int = 1) -> dict:
        """The spectral-gap-vs-wire-cost record printed by the examples and
        the dryrun: per-entry gaps, the product's effective gap (tighter
        than any single entry for rounds > 1 / alternating schedules), and
        the degree-based wire multipliers."""
        return {
            "name": self.name,
            "period": self.period,
            "n_agents": self.n_agents,
            "rounds": rounds,
            "per_matrix_lambda2": [t.lambda2 for t in self.topologies],
            "per_matrix_gap": [t.spectral_gap for t in self.topologies],
            "effective_lambda2": self.effective_lambda2(rounds),
            "effective_gap": self.effective_spectral_gap(rounds),
            "max_degree": self.max_degree(),
            "mean_degree": self.mean_degree(),
            # neighbor transfers per step, amortized over the period
            "transfers_per_step": self.mean_degree() * rounds,
        }


def fixed_schedule(topology: Topology) -> TopologySchedule:
    """The degenerate period-1 schedule (the paper's fixed topology)."""
    return TopologySchedule(name=f"fixed:{topology.name}",
                            topologies=(topology,))


def make_topology_schedule(
    spec: str,
    n_agents: int,
    *,
    period: int = 8,
    seed: int = 0,
) -> TopologySchedule:
    """Factory for the schedules used by the ``TimeVaryingMixing`` strategy.

    ``spec`` grammar:

    * a plain topology name (``"ring"``, ``"torus"``, ...) — fixed schedule;
    * ``"alternating"`` — ring/torus alternation (each entry connected, so
      the pair is trivially B-connected; the product gap beats either);
    * ``"alternating:<a>:<b>[:<c>...]"`` — cycle through named topologies;
    * ``"gossip"`` / ``"gossip:<T>"`` — ``T`` (default ``period``)
      randomized gossip-pair matrices drawn with the step-strided PRNG
      pattern of the int8 exchange seeds; individual steps mix only one
      pair (degree 1 — minimal wire), resampled until the union over the
      period is connected.
    """
    if ":" in spec:
        kind, _, rest = spec.partition(":")
    else:
        kind, rest = spec, ""
    if kind == "alternating":
        names = rest.split(":") if rest else ["ring", "torus"]
        if len(names) < 2:
            raise ValueError("alternating schedule needs >= 2 topology names")
        topos = tuple(make_topology(n, n_agents) for n in names)
        sched = TopologySchedule(name=spec, topologies=topos)
    elif kind == "gossip":
        t_period = int(rest) if rest else period
        if n_agents < 2:
            raise ValueError("gossip schedule needs >= 2 agents")
        if t_period < n_agents - 1:
            # connectivity needs a spanning tree: >= n-1 distinct edges,
            # one pair per step — shorter periods can NEVER be B-connected
            raise ValueError(
                f"gossip period {t_period} cannot connect {n_agents} agents "
                f"(union of {t_period} pair edges < the {n_agents - 1} a "
                f"spanning tree needs); use 'gossip:{n_agents - 1}' or more")
        for attempt in range(1000):
            rng_base = seed + attempt * 7919
            pairs = []
            for t in range(t_period):
                rng = np.random.default_rng(rng_base + _SCHEDULE_SEED_STRIDE * t)
                i, j = map(int, rng.choice(n_agents, size=2, replace=False))
                pairs.append((i, j))
            union = np.zeros((n_agents, n_agents))
            for i, j in pairs:
                union[i, j] = union[j, i] = 1.0
            if _is_connected(union):
                break
        else:
            raise RuntimeError(
                f"could not sample a connected {t_period}-step gossip "
                f"schedule over {n_agents} agents")
        topos = tuple(
            Topology(name=f"gossip_pair_{i}_{j}", pi=gossip_pair_pi(n_agents, i, j))
            for i, j in pairs)
        sched = TopologySchedule(name=spec, topologies=topos)
    else:
        sched = fixed_schedule(make_topology(spec, n_agents, seed=seed))
    sched.validate()
    return sched
