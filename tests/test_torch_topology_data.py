"""Port parity: topologies, step-size schedules, synthetic data, metrics.

The numpy modules are copies, so every comparison here is exact (equal
arrays, equal floats).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import schedules as jsched  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.utils.metrics import MetricHistory as JHistory  # noqa: E402
from repro_torch.core import schedules as tsched  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.utils.metrics import MetricHistory  # noqa: E402

NAMES = ["fully_connected", "ring", "chain", "star", "torus", "erdos_renyi",
         "disconnected_self"]


@pytest.mark.parametrize("n", [2, 5, 8])
@pytest.mark.parametrize("name", NAMES)
def test_topology_pi_and_spectra_equal(name, n):
    a = jtopo.make_topology(name, n, seed=3)
    b = ttopo.make_topology(name, n, seed=3)
    np.testing.assert_array_equal(a.pi, b.pi)           # exact: same numpy code
    assert a.lambda2 == b.lambda2 and a.lambdan == b.lambdan
    assert a.spectral_gap == b.spectral_gap
    assert a.degree() == b.degree()
    assert a.shift_weights() == b.shift_weights()
    assert a.neighbor_lists() == b.neighbor_lists()


def test_topology_lazy_and_validation_equal():
    a = jtopo.make_topology("ring", 6, lazy_beta=0.5)
    b = ttopo.make_topology("ring", 6, lazy_beta=0.5)
    np.testing.assert_array_equal(a.pi, b.pi)
    ttopo.validate_pi(b.pi, require_positive=True)
    bad = np.eye(4)
    for mod in (jtopo, ttopo):
        with pytest.raises(ValueError, match="disconnected"):
            mod.validate_pi(bad)
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.make_topology("hypercube", 4)


@pytest.mark.parametrize("step", [0, 1, 7, 123, 10_000])
def test_schedules_equal(step):
    assert tsched.fixed(0.05)(step) == float(jsched.fixed(0.05)(step))
    d_j = jsched.diminishing(theta=0.3, eps=0.75, t=2.0)
    d_t = tsched.diminishing(theta=0.3, eps=0.75, t=2.0)
    assert d_t(step) == float(d_j(step))                # both float32 arithmetic
    with pytest.raises(ValueError):
        tsched.diminishing(eps=0.4)


@pytest.mark.parametrize("image_hw", [None, 8])
def test_make_classification_equal(image_hw):
    a_tr, a_va = jdata.make_classification(512, image_hw=image_hw, seed=4)
    b_tr, b_va = tdata.make_classification(512, image_hw=image_hw, seed=4)
    for a, b in ((a_tr, b_tr), (a_va, b_va)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype


@pytest.mark.parametrize("non_iid", [False, True])
def test_agent_partitioner_batches_equal(non_iid):
    train, _ = tdata.make_classification(600, dim=16, seed=1)
    a = jdata.AgentPartitioner(train, 5, non_iid=non_iid, seed=2)
    b = tdata.AgentPartitioner(train, 5, non_iid=non_iid, seed=2)
    assert a.shard_size == b.shard_size
    np.testing.assert_array_equal(a.label_histograms(), b.label_histograms())
    for k in ("x", "y"):
        np.testing.assert_array_equal(a.full_shards()[k], b.full_shards()[k])
    ia, ib = a.batches(64), b.batches(64)
    for _ in range(4):
        ba, bb = next(ia), next(ib)
        for k in ("x", "y"):
            np.testing.assert_array_equal(ba[k], bb[k])


def test_metric_history_matches_reference():
    a, b = JHistory(), MetricHistory()
    for step, loss in enumerate([3.0, 2.0, 1.5, 1.0]):
        a.log(step, loss=loss, acc=0.1 * step)
        b.log(step, loss=loss, acc=0.1 * step)
    assert a.rows == b.rows
    assert a.moving_average("loss", 2) == b.moving_average("loss", 2)
    assert b.last("acc") == a.last("acc") and b.last("missing") is None
