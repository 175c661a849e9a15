"""Lyapunov-function machinery from the paper's analysis (§3.2, §4).

The paper rewrites CDSGD as plain SGD on the Lyapunov function

    V(x, a) = (N/n) 1^T F(x) + (1/2a) ||x||^2_{I-Pi}          (eq. 9)

with the *Stochastic Lyapunov Gradient*

    grad J(x) = g(x) + a^{-1} (I - Pi) x                       (eq. 7)

so that ``x_{k+1} = x_k - a grad J(x_k)`` (eq. 8).  This module implements
V, grad J, the derived constants (gamma_hat, H_hat), and the closed-form
bounds of Proposition 1 / Theorem 1 and their time-varying, multi-round,
bounded-staleness, momentum-mixing and error-feedback extensions, so tests
and benchmarks can check the *numbers*, not just the trends.

The array functions take agent-stacked torch tensors ``x`` of shape (N, d)
(the simulation mode: the theory is stated in exactly that space) and
compute in float32; the constants and bounds are numpy, a copy of
:mod:`repro.core.lyapunov`'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.consensus import parse_compressor
from repro_torch.core.faults import arrival_masked_pi, trivial_faults
from repro_torch.core.topology import (Topology, TopologySchedule,
                                      fixed_schedule)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).float()


def quadratic_norm(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """||x||^2_M = <x, M x> with x (N, d), M (N, N)."""
    xf = _f32(x).reshape(x.shape[0], -1)
    return torch.sum(xf * (_f32(m).to(xf.device) @ xf))


def lyapunov_value(sum_f, x: torch.Tensor, pi, alpha) -> torch.Tensor:
    """V(x, a) given the already-evaluated objective term (N/n) 1^T F(x)."""
    n_agents = x.shape[0]
    i_minus_pi = torch.eye(n_agents, dtype=torch.float32, device=x.device) \
        - _f32(pi).to(x.device)
    return sum_f + quadratic_norm(x, i_minus_pi) / (2.0 * alpha)


def stochastic_lyapunov_gradient(g: torch.Tensor, x: torch.Tensor, pi,
                                 alpha) -> torch.Tensor:
    """grad J(x) = g(x) + a^{-1} (I - Pi) x  (eq. 7)."""
    n_agents = x.shape[0]
    xf = _f32(x).reshape(n_agents, -1)
    i_minus_pi = torch.eye(n_agents, dtype=torch.float32, device=x.device) \
        - _f32(pi).to(x.device)
    corr = (i_minus_pi @ xf).reshape(x.shape) / alpha
    return g + corr.to(g.dtype)


def cdsgd_step_via_lyapunov(x: torch.Tensor, g: torch.Tensor, pi,
                            alpha) -> torch.Tensor:
    """x - a grad J(x): must equal ``Pi x - a g`` (eq. 7 == eq. 5)."""
    return x - alpha * stochastic_lyapunov_gradient(g, x, pi, alpha)


@dataclasses.dataclass(frozen=True)
class TheoryConstants:
    """Constants of Theorems 1-2 for a given problem + topology + step."""

    gamma_m: float   # max_j smoothness of f_j
    h_m: float       # min_j strong-convexity of f_j
    alpha: float
    lambda2: float
    lambdan: float
    zeta1: float = 1.0   # Assumption 3(a) lower bound (exact gradients: 1)
    q: float = 0.0       # gradient-noise second moment (Assumption 3b)
    qm: float = 1.0      # Q_V + zeta2^2

    @property
    def gamma_hat(self) -> float:
        """gamma_m + a^{-1} (1 - lambda_N(Pi)) — smoothness of V."""
        return self.gamma_m + (1.0 - self.lambdan) / self.alpha

    @property
    def h_hat(self) -> float:
        """H_m + (2a)^{-1} (1 - lambda_2(Pi)) — strong convexity of V."""
        return self.h_m + (1.0 - self.lambda2) / (2.0 * self.alpha)

    @property
    def contraction(self) -> float:
        """Theorem 1 per-step factor ``1 - a H_hat zeta1``."""
        return 1.0 - self.alpha * self.h_hat * self.zeta1

    @property
    def noise_radius(self) -> float:
        """Theorem 1 asymptotic radius ``a gamma_hat Q / (2 H_hat zeta1)``."""
        if self.q == 0.0:
            return 0.0
        return self.alpha * self.gamma_hat * self.q / (2.0 * self.h_hat * self.zeta1)

    @property
    def max_step_size(self) -> float:
        """Sufficient condition (eq. 15 expanded)."""
        return (self.zeta1 - (1.0 - self.lambdan) * self.qm) / (self.gamma_m * self.qm)


def consensus_bound(alpha: float, grad_norm_bound: float, topology: Topology) -> float:
    """Proposition 1 RHS: ``a L / (1 - lambda_2(Pi))``."""
    gap = 1.0 - topology.lambda2
    if gap <= 0:
        return float("inf")
    return alpha * grad_norm_bound / gap


def theorem1_envelope(v1_minus_vstar: float, const: TheoryConstants, steps: int) -> np.ndarray:
    """The full Theorem-1 upper envelope E[V(x_k) - V*] for k = 1..steps."""
    rho = const.contraction
    noise = const.alpha**2 * const.gamma_hat * const.q / 2.0
    out = np.empty(steps)
    acc = v1_minus_vstar
    out[0] = acc
    for k in range(1, steps):
        acc = rho * acc + noise
        out[k] = acc
    return out


# --------------------------------------------------------------------------
# Time-varying / multi-round extensions (Jiang et al. 1805.12120)
# --------------------------------------------------------------------------


def schedule_consensus_bound(alpha: float, grad_norm_bound: float,
                             schedule, rounds: int = 1) -> float:
    """Proposition 1 generalized to a mixing schedule with k inner rounds.

    For time-varying B-connected ``Pi_t`` (and/or ``k`` consensus rounds
    per gradient step) the per-step disagreement contraction is the
    schedule's *effective* ``lambda_2`` — the period-geometric-mean
    disagreement norm of ``prod_t Pi_t^k``
    (:meth:`repro_torch.core.topology.TopologySchedule.effective_lambda2`) —
    so the steady-state consensus radius is

        a L / (1 - lambda_eff(schedule, k))

    which reduces to ``a L / (1 - lambda_2(Pi))`` for the static
    single-round case and is monotonically non-increasing in ``k``
    (more rounds -> smaller lambda_eff -> tighter consensus), the
    consensus side of the consensus-optimality trade-off: each extra round
    costs one more full exchange of wire bytes per step.
    """
    lam = schedule.effective_lambda2(rounds)
    gap = 1.0 - lam
    if gap <= 0:
        return float("inf")
    return alpha * grad_norm_bound / gap


def schedule_theory_constants(alpha: float, gamma_m: float, h_m: float,
                              schedule, rounds: int = 1,
                              **kw) -> TheoryConstants:
    """Theorem-1 constants with the schedule's effective spectrum.

    Substitutes ``lambda_2 -> lambda_eff`` and, for the smoothness side,
    ``lambda_N -> lambda_N(prod)^(1/period)`` lower-bounded at
    ``min_t lambda_N(Pi_t)^rounds`` (the product of symmetric PSD factors
    need not be symmetric; the conservative bound keeps ``gamma_hat`` an
    upper bound).
    """
    lam2 = schedule.effective_lambda2(rounds)
    # eigenvalues of Pi^k are the k-th powers of Pi's, so the floor is the
    # min over POWERED eigenvalues — min(lambda)^k alone is wrong for
    # indefinite Pi at even k ((-0.8)^2 > 0.25^1 etc.)
    lamn = min(float(np.min(np.linalg.eigvalsh(t.pi) ** rounds))
               for t in schedule.topologies)
    return TheoryConstants(gamma_m=gamma_m, h_m=h_m, alpha=alpha,
                           lambda2=lam2, lambdan=lamn, **kw)


# --------------------------------------------------------------------------
# Bounded-staleness / fault-masked consensus (Lian et al. 1705.09056)
# --------------------------------------------------------------------------


def masked_effective_lambda2(topology_or_schedule, faults=None,
                             staleness: int = 1) -> float:
    """Effective disagreement norm of the arrival-masked mixing schedule.

    Builds the per-step *masked* agent-interaction matrices — each
    schedule entry's ``Pi`` with the non-arrived off-diagonal mass folded
    into the self weights, exactly the renormalization the runtime applies
    (:func:`repro_torch.core.faults.arrival_masked_pi` over the fault schedule's
    arrival table at ring depth ``staleness``) — and returns the
    period-geometric-mean disagreement norm of their product, the
    :meth:`~repro_torch.core.topology.TopologySchedule.effective_lambda2`
    construction applied to the faulted sequence.  With no faults this IS
    ``effective_lambda2`` (the mask is all-arrive and the masked ``Pi``
    equals ``Pi``).
    """

    if isinstance(topology_or_schedule, Topology):
        schedule = fixed_schedule(topology_or_schedule)
    elif isinstance(topology_or_schedule, TopologySchedule):
        schedule = topology_or_schedule
    else:
        raise TypeError(f"expected Topology or TopologySchedule, got "
                        f"{type(topology_or_schedule).__name__}")
    f = faults or trivial_faults(schedule.n_agents)
    tb = f.tables(staleness)
    period = int(np.lcm(schedule.period, f.period))
    n = schedule.n_agents
    prod = np.eye(n)
    for t in range(period):
        pi = np.asarray(schedule.topologies[t % schedule.period].pi,
                        np.float64)
        prod = arrival_masked_pi(pi, tb["arrive"][t % f.period]) @ prod
    proj = prod @ (np.eye(n) - np.ones((n, n)) / n)
    sigma = float(np.linalg.norm(proj, 2))
    return sigma ** (1.0 / period)


def bounded_staleness_consensus_bound(alpha: float, grad_norm_bound: float,
                                      topology_or_schedule, *,
                                      staleness: int = 1,
                                      faults=None) -> float:
    """Proposition 1 under bounded-staleness arrival-masked mixing.

    With a depth-``S`` staleness ring a consumed neighbor payload lags by
    up to ``S`` steps, so the disagreement a step can inject grows to the
    ``S``-step gradient drift ``a L S``, while the per-step contraction
    degrades to the arrival-masked schedule product — the asynchronous
    decentralized-SGD picture of Lian et al. (1705.09056) specialized to
    this deterministic fault model:

        radius(S) = a L S / (1 - max_{s <= S} lambda_mask(s))

    The contraction takes the worst masked spectrum over ring depths
    ``s <= S`` (an adversary within depth ``S`` may realize any shallower
    arrival pattern), which makes the bound **monotone non-decreasing in
    S** by construction — deeper tolerated staleness never claims a
    tighter radius.  ``staleness=1`` with no faults reduces exactly to
    :func:`schedule_consensus_bound` (``a L / (1 - lambda_eff)``); infinite
    when the masked gap closes (e.g. a fault schedule that disconnects the
    union graph for the whole period).
    """
    if not isinstance(staleness, int) or staleness < 1:
        raise ValueError(f"staleness must be an int >= 1, got {staleness!r}")
    lam = max(masked_effective_lambda2(topology_or_schedule, faults, s)
              for s in range(1, staleness + 1))
    gap = 1.0 - lam
    if gap <= 0:
        return float("inf")
    return alpha * grad_norm_bound * staleness / gap


# --------------------------------------------------------------------------
# Momentum-consensus mixing (Gao & Huang 2010.11166)
# --------------------------------------------------------------------------


def _disagreement_radius(topology_or_schedule, rounds: int = 1) -> float:
    """Modulus of the largest non-principal ``Pi``-mode: the per-step
    disagreement contraction of plain (momentum-free) consensus.

    A :class:`repro_torch.core.topology.TopologySchedule` contributes its
    effective disagreement norm (a spectral-norm upper bound on the
    radius); a fixed :class:`Topology` the exact
    ``max(|lambda_2|, |lambda_N|)`` — ``lambda_N`` can be negative with
    ``|lambda_N| > lambda_2`` (e.g. short rings), and the momentum
    coupling amplifies whichever mode decays slowest.
    """
    if isinstance(topology_or_schedule, Topology):
        lams = np.linalg.eigvalsh(np.asarray(topology_or_schedule.pi,
                                             np.float64))
        return float(np.max(np.abs(lams[:-1])) ** rounds)
    return float(topology_or_schedule.effective_lambda2(rounds))


def momentum_consensus_contraction(topology_or_schedule, mu: float,
                                   momentum_mixing: str = "none",
                                   rounds: int = 1) -> float:
    """Per-step disagreement contraction of the joint ``(x, v)`` dynamics.

    CDMSGD's disagreement subsystem (gradients exogenous) is, per
    ``Pi``-eigenmode ``lam``:

        unmixed (``v' = mu v - a g``):      [[lam, mu ], [0, mu ]]
        mixed   (``v' = mu Pi v - a g``):   [[lam, mu lam], [0, mu lam]]

    both upper triangular, so the spectral radii are ``max(|lam|, mu)``
    and ``max(|lam|, mu |lam|) = |lam|``.  Over the disagreement modes:

    * ``momentum_mixing="none"``  -> ``max(rho_Pi, mu)`` — at large
      momentum (``mu > rho_Pi``) the *momentum* mode gates the rate, and
      the ``mu I`` coupling is non-normal: per-step wire noise injected
      into ``v`` persists ``~1/(1-mu)`` steps while leaking into ``x`` —
      the documented large-lr momentum/quantization instability;
    * ``momentum_mixing="mixed"`` -> ``rho_Pi`` — the momentum buffer
      contracts WITH the consensus (2010.11166), restoring the
      momentum-free CDSGD rate and damping injected noise geometrically
      at the topology's own gap.

    ``rho_Pi`` is :func:`_disagreement_radius` (schedule-aware; ``rounds``
    inner consensus rounds power it).
    """
    if momentum_mixing not in ("none", "mixed"):
        raise ValueError(f"unknown momentum_mixing {momentum_mixing!r}")
    if not 0.0 <= mu < 1.0:
        raise ValueError(f"momentum mu must be in [0, 1), got {mu}")
    rho = _disagreement_radius(topology_or_schedule, rounds)
    if momentum_mixing == "mixed":
        return rho
    return max(rho, float(mu))


def momentum_consensus_bound(alpha: float, grad_norm_bound: float,
                             topology_or_schedule, mu: float,
                             momentum_mixing: str = "none",
                             rounds: int = 1) -> float:
    """Proposition-1-style steady-state consensus radius for CDMSGD:
    ``a L / (1 - rho)`` with the joint-dynamics contraction ``rho`` of
    :func:`momentum_consensus_contraction` — the gap-vs-rate framing of
    1805.12120 extended to the momentum state.  Mixing the momentum can
    only tighten it (``rho_mixed <= rho_unmixed``), strictly whenever
    ``mu > rho_Pi``.
    """
    rho = momentum_consensus_contraction(topology_or_schedule, mu,
                                         momentum_mixing, rounds)
    gap = 1.0 - rho
    if gap <= 0:
        return float("inf")
    return alpha * grad_norm_bound / gap


# --------------------------------------------------------------------------
# Error-feedback compressed consensus (Karimireddy et al. 1901.09847)
# --------------------------------------------------------------------------


def compressor_delta(compressor: str) -> float:
    """Worst-case contraction defect ``delta`` of a wire compressor ``C``:
    the smallest constant with ``||C(x) - x||^2 <= delta ||x||^2``.

    * ``none`` / ``int8`` / ``fp8`` — 0.  The SR quantizers are unbiased
      and their (bounded, scale-relative) noise is already carried by the
      Theorem-1 variance terms, not the EF contraction; in the
      delta-contractive EF framing they sit at ``delta = 0``.
    * ``topk:p`` — ``1 - p``: keeping the top ``k = p d`` magnitudes of a
      ``d``-vector retains at least fraction ``p`` of the energy in the
      worst (flat) case, the classical top-k bound.
    * ``rank:r`` — ``1 - r/128``: a rank-``r`` projection of a
      ``(rows, 128)`` bucket retains at least ``r/128`` of the Frobenius
      energy in the worst (isotropic-spectrum) case; one warm-started
      power iteration only does better on decaying spectra.
    """
    kind, param = parse_compressor(compressor)
    if kind in ("none", "int8", "fp8"):
        return 0.0
    if kind == "topk":
        return 1.0 - float(param)
    assert kind == "rank", kind
    return max(0.0, 1.0 - float(param) / 128.0)


def ef_compressed_consensus_bound(alpha: float, grad_norm_bound: float,
                                  topology_or_schedule, *,
                                  compressor: str = "none",
                                  rounds: int = 1) -> float:
    """Proposition 1 under a delta-contractive EF-compressed wire.

    With error feedback, a biased compressor of contraction defect
    ``delta`` (:func:`compressor_delta`) behaves like the exact exchange
    plus a telescoping residual whose steady-state norm is at most
    ``2 delta / (1 - delta)`` times the per-step update magnitude
    (Karimireddy et al. 1901.09847, Lemma 3 applied to the consensus
    recursion): the residual re-enters the next step's payload, so the
    disagreement radius inflates by exactly that carried mass —

        radius(delta) = [a L / (1 - lambda_eff)] * (1 + 2 delta/(1-delta))

    which reduces **exactly** to :func:`schedule_consensus_bound` at
    ``delta = 0``, grows mildly for ``topk:0.1`` (``delta = 0.9`` -> 19x)
    and steeply as ``p -> 0`` — the bytes-vs-drift frontier.  Infinite
    when the mixing gap closes or ``delta = 1`` (a compressor that may drop
    everything).
    """
    delta = compressor_delta(compressor)
    if delta >= 1.0:
        return float("inf")
    sched = (fixed_schedule(topology_or_schedule)
             if isinstance(topology_or_schedule, Topology)
             else topology_or_schedule)
    base = schedule_consensus_bound(alpha, grad_norm_bound, sched, rounds)
    return base * (1.0 + 2.0 * delta / (1.0 - delta))
