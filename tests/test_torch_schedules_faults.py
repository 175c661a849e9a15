"""Port parity: topology schedules and fault schedules against the JAX package.

Both packages build these tables in numpy on the host, so the port must
produce the reference's tables exactly: integer and boolean tables (gossip
pairs, degrees, straggle / link masks, ``send_age``, arrivals, ring ages)
bit for bit, float tables (``Pi_t`` stacks, period products, spectra,
arrival-masked weights) within 1e-12 (measured: equal).  The rejections
raise the reference's exception class.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402

FLOAT_TOL = 1e-12
SCHEDULES = [("alternating", 8), ("alternating:ring:star", 5),
             ("alternating:ring:torus:fully_connected", 6), ("gossip:8", 5),
             ("gossip", 8), ("gossip:12", 9), ("ring", 5), ("torus", 8)]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind in "biu" or b.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL)


def _same_dict(t, j):
    assert set(t) == set(j)
    for k in j:
        if isinstance(j[k], (str, int, bool)) or j[k] is None:
            assert t[k] == j[k], k
        else:
            _close(t[k], j[k])


@pytest.mark.parametrize("spec,n", SCHEDULES, ids=[f"{s}-{n}" for s, n in SCHEDULES])
def test_schedule_tables_match_reference(spec, n):
    js = jtopo.make_topology_schedule(spec, n, seed=3)
    ts = ttopo.make_topology_schedule(spec, n, seed=3)
    assert (ts.name, ts.period, ts.n_agents, ts.is_static) == \
        (js.name, js.period, js.n_agents, js.is_static)
    # the gossip pairs (and every entry's name) drawn identically
    assert [t.name for t in ts.topologies] == [t.name for t in js.topologies]
    np.testing.assert_array_equal(ts.pi_stack(), js.pi_stack())
    assert ts.max_degree() == js.max_degree()
    assert ts.mean_degree() == js.mean_degree()
    for k in (1, 2, 3):
        _close(ts.product_pi(k), js.product_pi(k))
        _close(ts.effective_lambda2(k), js.effective_lambda2(k))
        _close(ts.effective_spectral_gap(k), js.effective_spectral_gap(k))
        _same_dict(ts.diagnostics(k), js.diagnostics(k))
    for step in (0, 1, 7, 13):
        assert ts.topology_at(step).name == js.topology_at(step).name
    ts.validate()


def test_fixed_schedule_matches_reference():
    for name in ("ring", "star", "fully_connected"):
        ts = ttopo.fixed_schedule(ttopo.make_topology(name, 6))
        js = jtopo.fixed_schedule(jtopo.make_topology(name, 6))
        assert ts.name == js.name == f"fixed:{name}" and ts.period == 1
        _same_dict(ts.diagnostics(2), js.diagnostics(2))
    np.testing.assert_array_equal(ttopo.gossip_pair_pi(5, 1, 3),
                                  jtopo.gossip_pair_pi(5, 1, 3))


@pytest.mark.parametrize("case", [
    "short_gossip", "one_agent_gossip", "agent_mismatch", "empty",
    "not_b_connected", "one_name", "bad_rounds"])
def test_schedule_rejections_match_reference(case):
    def attempt(mod):
        if case == "short_gossip":        # period 3 < n - 1 = 5
            return mod.make_topology_schedule("gossip:3", 6)
        if case == "one_agent_gossip":
            return mod.make_topology_schedule("gossip:4", 1)
        if case == "agent_mismatch":
            return mod.TopologySchedule("mix", (mod.make_topology("ring", 4),
                                                mod.make_topology("ring", 5)))
        if case == "empty":
            return mod.TopologySchedule("none", ())
        if case == "not_b_connected":
            return mod.make_topology_schedule(
                "alternating:disconnected_self:disconnected_self", 4)
        if case == "one_name":
            return mod.make_topology_schedule("alternating:ring", 4)
        return mod.make_topology_schedule("ring", 4).product_pi(0)

    with pytest.raises(Exception) as j:
        attempt(jtopo)
    with pytest.raises(type(j.value)):
        attempt(ttopo)


FAULT_SPECS = [
    ("straggler:1:2", 5), ("stall:2:1:3", 5), ("drop:0:2", 4),
    ("droplink:1:3:2:2", 4), ("random:0.3:4", 5),
    ("straggler:1:1,drop:0:2", 5), ("stall:2:1:3,droplink:0:1:1:2", 5),
    ("straggler:0:3,random:0.2:2", 6),
]


@pytest.mark.parametrize("spec,n", FAULT_SPECS, ids=[s for s, _ in FAULT_SPECS])
def test_fault_schedule_tables_match_reference(spec, n):
    jf = jfaults.make_fault_schedule(spec, n, seed=5)
    tf = tfaults.make_fault_schedule(spec, n, seed=5)
    assert (tf.name, tf.n_agents, tf.period, tf.seed, tf.is_trivial) == \
        (jf.name, jf.n_agents, jf.period, jf.seed, jf.is_trivial)
    np.testing.assert_array_equal(tf.straggle, jf.straggle)
    np.testing.assert_array_equal(tf.linkup, jf.linkup)
    assert tf.describe() == jf.describe()
    for s in (1, 2, 4):
        tt, jt = tf.tables(s), jf.tables(s)
        assert set(tt) == set(jt)
        for k in jt:
            assert tt[k].dtype == jt[k].dtype
            np.testing.assert_array_equal(tt[k], jt[k])
        assert tf.arrival_accounting(s, steps=2 * tf.period + 1) == \
            jf.arrival_accounting(s, steps=2 * jf.period + 1)


@pytest.mark.parametrize("spec", [
    "straggler:1:0", "stall:1:0:2", "drop:1:1", "drop:0:7", "bogus:1",
    "random:2:3", "random:x:3", "straggler:9:1", "straggler:a:1",
    "stall:1:1:8192"])
def test_fault_spec_rejections_match_reference(spec):
    with pytest.raises(Exception) as j:
        jfaults.make_fault_schedule(spec, 5)
    with pytest.raises(type(j.value)):
        tfaults.make_fault_schedule(spec, 5)


def test_fault_schedule_none_and_trivial():
    for spec in (None, "", "none"):
        assert tfaults.make_fault_schedule(spec, 5) is None
    tr = tfaults.trivial_faults(5, period=3)
    assert tr.is_trivial and tr.describe() == jfaults.trivial_faults(
        5, period=3).describe()
    bad = tfaults.FaultSchedule("x", 3, 2, np.ones((2, 3), bool),
                                np.ones((2, 3, 3), bool))
    with pytest.raises(ValueError, match="straggle\\[0\\]"):
        bad.validate()


@pytest.mark.parametrize("staleness", [1, 2, 4])
@pytest.mark.parametrize("sched,faults", [
    ("ring", "straggler:1:1,drop:0:2"), ("alternating:ring:star", "stall:2:1:3"),
    ("gossip:6", "droplink:1:3:2:2,straggler:4:2"),
    ("fully_connected", None)])
def test_arrival_masked_weights_and_fault_tables_match(staleness, sched, faults):
    n = 5
    progs = []
    for topo, fmod, cons in ((jtopo, jfaults, jcons), (ttopo, tfaults, tcons)):
        s = topo.make_topology_schedule(sched, n)
        f = fmod.make_fault_schedule(faults, n)
        kw = {"strategy": "time_varying"} if s.period > 1 else {}
        p = cons.make_mixing_program(s, staleness=staleness, faults=f,
                                     exchange="int8", **kw)
        progs.append((fmod, cons, s, f, p))
    (jf_mod, jc, js, jfs, jp), (tf_mod, tc, ts, tfs, tp) = progs
    assert tp.fault_tolerant == jp.fault_tolerant
    assert tp.describe() == jp.describe()
    if not jp.fault_tolerant:
        return
    jt, tt = jc._fault_tables(jp), tc._fault_tables(tp)
    assert set(tt) == set(jt)
    for k in jt:
        if isinstance(jt[k], np.ndarray):
            assert tt[k].dtype == jt[k].dtype, k
            np.testing.assert_array_equal(tt[k], jt[k])
        else:
            assert tt[k] == jt[k], k
    f = jfs or jf_mod.trivial_faults(n)
    arrive = f.tables(staleness)["arrive"]
    for t in range(f.period):
        pi = js.topologies[t % js.period].pi
        np.testing.assert_array_equal(tf_mod.arrival_masked_pi(pi, arrive[t]),
                                      jf_mod.arrival_masked_pi(pi, arrive[t]))
        # row sums preserved: the dropped mass folds into the self weight
        np.testing.assert_allclose(
            tf_mod.arrival_masked_pi(pi, arrive[t]).sum(1), 1.0, atol=1e-12)
