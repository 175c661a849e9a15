"""Port parity: the Lyapunov machinery and the consensus bounds.

The four array functions (``quadratic_norm``, ``lyapunov_value``,
``stochastic_lyapunov_gradient``, ``cdsgd_step_via_lyapunov``) are torch in
the port: held against the JAX functions on the same numpy inputs within
1e-6 (the step absolute; ``V``, the norm and ``grad J`` relative to their
magnitude, since ``grad J`` carries ``(I - Pi) x / alpha``; printed with
``pytest -s``).  The constants and
every bound are numpy in both packages and must be equal bit for bit, on
the values ``tests/test_theory.py`` and ``tests/test_faults.py::
test_bounded_staleness_bound_monotone_and_reduces`` check.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core import lyapunov as JL  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import lyapunov as TL  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402

TOL = 1e-6
N, D = 8, 16
FAULT_SPEC = "stall:1:1:3,drop:0:2"


def _inputs(seed=0, topo="ring"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    g = rng.normal(size=(N, D)).astype(np.float32)
    pi = jtopo.make_topology(topo, N).pi.astype(np.float32)
    return x, g, pi


@pytest.mark.parametrize("topo", ["ring", "fully_connected", "torus", "star"])
@pytest.mark.parametrize("alpha", [0.05, 0.5])
def test_array_functions_match_jax(topo, alpha):
    x, g, pi = _inputs(topo=topo)
    tx, tg, tpi = (torch.from_numpy(a) for a in (x, g, pi))
    m = np.eye(N, dtype=np.float32) - pi
    jgrad = np.asarray(JL.stochastic_lyapunov_gradient(g, x, pi, alpha))
    gaps = {
        "quadratic_norm": abs(float(TL.quadratic_norm(tx, torch.from_numpy(m)))
                              - float(JL.quadratic_norm(jnp.asarray(x), jnp.asarray(m)))),
        # grad J carries (I - Pi) x / alpha: relative to its largest entry
        "grad_J_rel": float(np.max(np.abs(
            TL.stochastic_lyapunov_gradient(tg, tx, tpi, alpha).numpy() - jgrad))
            / np.max(np.abs(jgrad))),
        "step": float(np.max(np.abs(
            TL.cdsgd_step_via_lyapunov(tx, tg, tpi, alpha).numpy()
            - np.asarray(JL.cdsgd_step_via_lyapunov(x, g, pi, alpha))))),
    }
    tv = float(TL.lyapunov_value(torch.tensor(1.5), tx, tpi, alpha))
    jv = float(JL.lyapunov_value(jnp.float32(1.5), x, pi, alpha))
    gaps["V_rel"] = abs(tv - jv) / max(abs(jv), 1.0)
    print(f"{topo} alpha={alpha}: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    # quadratic_norm is a sum of N*D products: relative, like V
    gaps["quadratic_norm"] /= max(abs(float(JL.quadratic_norm(x, m))), 1.0)
    assert max(gaps.values()) <= TOL, gaps
    # paper eq. 7 == eq. 5: x - a grad J(x) is Pi x - a g
    np.testing.assert_allclose(TL.cdsgd_step_via_lyapunov(tx, tg, tpi, alpha).numpy(),
                               (tpi @ tx - alpha * tg).numpy(), rtol=1e-5, atol=1e-6)


def test_theory_constants_equal():
    for kw in (dict(gamma_m=2.0, h_m=0.5, alpha=0.01, lambda2=0.8, lambdan=-0.2),
               dict(gamma_m=2.0, h_m=0.5, alpha=0.05, lambda2=0.6, lambdan=0.1,
                    zeta1=0.9, q=0.3, qm=1.2)):
        t, j = TL.TheoryConstants(**kw), JL.TheoryConstants(**kw)
        for k in ("gamma_hat", "h_hat", "contraction", "noise_radius",
                  "max_step_size"):
            assert getattr(t, k) == getattr(j, k), k
        np.testing.assert_array_equal(TL.theorem1_envelope(3.0, t, 50),
                                      JL.theorem1_envelope(3.0, j, 50))


@pytest.mark.parametrize("topo", ["ring", "fully_connected", "torus", "chain",
                                  "disconnected_self"])
def test_consensus_bound_equal(topo):
    for alpha in (0.1, 0.05, 0.01):
        assert TL.consensus_bound(alpha, 1.7, ttopo.make_topology(topo, N)) == \
            JL.consensus_bound(alpha, 1.7, jtopo.make_topology(topo, N))


SCHEDS = [("ring", 8), ("alternating", 8), ("alternating:ring:star", 6),
          ("gossip:8", 5), ("gossip:12", 9)]


@pytest.mark.parametrize("spec,n", SCHEDS, ids=[f"{s}-{n}" for s, n in SCHEDS])
def test_schedule_bounds_equal(spec, n):
    ts = ttopo.make_topology_schedule(spec, n)
    js = jtopo.make_topology_schedule(spec, n)
    for k in (1, 2, 3):
        assert TL.schedule_consensus_bound(0.05, 1.3, ts, k) == \
            JL.schedule_consensus_bound(0.05, 1.3, js, k)
        tc = TL.schedule_theory_constants(0.05, 2.0, 0.5, ts, k, q=0.1)
        jc = JL.schedule_theory_constants(0.05, 2.0, 0.5, js, k, q=0.1)
        assert dataclass_values(tc) == dataclass_values(jc)
        for comp in ("none", "int8", "topk:0.1", "topk:0.01", "rank:4"):
            assert TL.ef_compressed_consensus_bound(
                0.05, 1.3, ts, compressor=comp, rounds=k) == \
                JL.ef_compressed_consensus_bound(0.05, 1.3, js, compressor=comp,
                                                 rounds=k)
        for mu in (0.0, 0.5, 0.9):
            for mm in ("none", "mixed"):
                assert TL.momentum_consensus_contraction(ts, mu, mm, k) == \
                    JL.momentum_consensus_contraction(js, mu, mm, k)
                assert TL.momentum_consensus_bound(0.05, 1.3, ts, mu, mm, k) == \
                    JL.momentum_consensus_bound(0.05, 1.3, js, mu, mm, k)


def dataclass_values(c):
    return tuple(getattr(c, f) for f in ("gamma_m", "h_m", "alpha", "lambda2",
                                         "lambdan", "zeta1", "q", "qm"))


@pytest.mark.parametrize("topo", ["ring", "fully_connected", "star", "chain"])
def test_fixed_topology_bounds_equal(topo):
    t, j = ttopo.make_topology(topo, 5), jtopo.make_topology(topo, 5)
    for k in (1, 2):
        assert TL._disagreement_radius(t, k) == JL._disagreement_radius(j, k)
        for mu in (0.0, 0.9):
            for mm in ("none", "mixed"):
                assert TL.momentum_consensus_bound(0.01, 1.0, t, mu, mm, k) == \
                    JL.momentum_consensus_bound(0.01, 1.0, j, mu, mm, k)
        assert TL.ef_compressed_consensus_bound(0.01, 1.0, t, compressor="rank:2",
                                                rounds=k) == \
            JL.ef_compressed_consensus_bound(0.01, 1.0, j, compressor="rank:2",
                                             rounds=k)
    for comp in ("none", "fp8", "topk:0.5", "topk:auto:4096", "rank:128", "rank:200"):
        if comp == "topk:auto:4096":
            continue    # an auto budget has no fixed density
        assert TL.compressor_delta(comp) == JL.compressor_delta(comp)


def test_bounded_staleness_bounds_equal():
    """The values of tests/test_faults.py::test_bounded_staleness_bound_
    monotone_and_reduces, through both packages."""
    t, j = ttopo.make_topology("ring", 4), jtopo.make_topology("ring", 4)
    tf = tfaults.make_fault_schedule(FAULT_SPEC, 4)
    jf = jfaults.make_fault_schedule(FAULT_SPEC, 4)
    assert TL.bounded_staleness_consensus_bound(0.01, 1.0, t) == \
        JL.bounded_staleness_consensus_bound(0.01, 1.0, j)
    assert TL.bounded_staleness_consensus_bound(0.01, 1.0, t) == \
        pytest.approx(TL.schedule_consensus_bound(0.01, 1.0,
                                                  ttopo.fixed_schedule(t)))
    bounds = []
    for s in (1, 2, 4, 8):
        b = TL.bounded_staleness_consensus_bound(0.01, 1.0, t, staleness=s,
                                                 faults=tf)
        assert b == JL.bounded_staleness_consensus_bound(0.01, 1.0, j,
                                                         staleness=s, faults=jf)
        bounds.append(b)
        assert TL.masked_effective_lambda2(t, tf, s) == \
            JL.masked_effective_lambda2(j, jf, s)
    assert all(b1 >= b0 for b0, b1 in zip(bounds, bounds[1:])), bounds
    assert TL.masked_effective_lambda2(t, tf, 1) > TL.masked_effective_lambda2(t, None, 1)
    sched_t = ttopo.make_topology_schedule("alternating:ring:chain", 4)
    sched_j = jtopo.make_topology_schedule("alternating:ring:chain", 4)
    assert TL.masked_effective_lambda2(sched_t, tf, 2) == \
        JL.masked_effective_lambda2(sched_j, jf, 2)


@pytest.mark.parametrize("case", ["staleness-0", "mu-1", "mixing-bogus",
                                  "not-a-topology", "compressor-bogus"])
def test_rejections_match(case):
    def attempt(L, topo):
        t = topo.make_topology("ring", 4)
        if case == "staleness-0":
            return L.bounded_staleness_consensus_bound(0.01, 1.0, t, staleness=0)
        if case == "mu-1":
            return L.momentum_consensus_contraction(t, 1.0)
        if case == "mixing-bogus":
            return L.momentum_consensus_contraction(t, 0.5, "both")
        if case == "not-a-topology":
            return L.masked_effective_lambda2(t.pi)
        return L.compressor_delta("topk:2")

    with pytest.raises(Exception) as j:
        attempt(JL, jtopo)
    with pytest.raises(type(j.value)):
        attempt(TL, ttopo)
