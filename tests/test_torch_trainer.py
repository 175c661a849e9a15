"""Port parity: the whole slice — 20 trainer steps against the JAX package.

The ``benchmarks/common.py`` MLP setup (6x50 ReLU MLP on 64-dim synthetic
data, 5 agents, fully connected, lr 0.05, batch 64) trained by fused
CDSGD / CDMSGD for 20 steps in both packages from the same parameters and
batches: the JAX trainer with the Pallas kernels in interpret mode, the
port's trainer on the CPU (plain kernel versions).

Tolerance 1e-5 abs on every parameter after 20 steps.  Measured gap on
this setup (printed with ``pytest -s``): 6.0e-7 (CDSGD) and 5.4e-7
(CDMSGD), from float32 matmul summation order inside the backward passes
(XLA vs PyTorch); the bound leaves ~15x headroom for BLAS differences
between machines.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_topology as jmake_topology  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.data import AgentPartitioner as JPartitioner  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.core import make_optimizer, make_topology, stacked_comm_ops  # noqa: E402
from repro_torch.core.faults import make_fault_schedule  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, train_loop  # noqa: E402
from repro_torch.data import AgentPartitioner, make_classification  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TRAJ_ATOL = 1e-5
STEPS = 20


@pytest.fixture(scope="module")
def setup():
    train, val = make_classification(4096, n_classes=10, dim=64, seed=0)
    jp = jinit(jpm.mlp_classifier_template(64, 10, width=50, depth=6),
               jax.random.PRNGKey(0))
    return train, val, jp


def _port_trainer(jp, name, topology="fully_connected", **kw):
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    opt = make_optimizer(name, 0.05, **kw)
    return CollaborativeTrainer(functools.partial(tpm.classifier_loss,
                                                  tpm.mlp_classifier_apply),
                                tp, make_topology(topology, 5), opt,
                                device="cpu")


@pytest.mark.parametrize("name,kw", [("cdsgd", {}), ("cdmsgd", {"mu": 0.9})])
def test_fused_trajectory_tracks_jax(setup, name, kw):
    train, val, jp = setup
    jt = JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                  jp, jmake_topology("fully_connected", 5),
                  jmake_optimizer(name, 0.05, fused=True, **kw))
    tt = _port_trainer(jp, name, fused=True, **kw)
    jb = JPartitioner(train, 5, seed=0).batches(64)
    tb = AgentPartitioner(train, 5, seed=0).batches(64)
    for i in range(STEPS):
        mj, mt = jt.step(next(jb)), tt.step(next(tb))
        assert abs(mj["loss"] - mt["loss"]) <= 1e-4, (i, mj, mt)
        # same correct count; the f32 mean over agents rounds differently
        assert abs(mj["acc"] - mt["acc"]) <= 1e-6
    gap = max(float(np.max(np.abs(np.asarray(a) - b.numpy())))
              for a, b in zip(jax.tree.leaves(jt.state.params),
                              tree_leaves(tt.state.params)))
    print(f"{name}: max parameter gap after {STEPS} steps {gap:.2e}")
    assert gap <= TRAJ_ATOL, gap
    ev_j = jt.evaluate({"x": val.x, "y": val.y})
    ev_t = tt.evaluate({"x": val.x, "y": val.y})
    assert set(ev_j) == set(ev_t)
    for k in ev_j:
        assert abs(ev_j[k] - ev_t[k]) <= 1e-4, (k, ev_j[k], ev_t[k])
    assert tt.wire_bytes_per_step == jt.wire_bytes_per_step


@pytest.mark.parametrize("name,kw", [("cdsgd", {}), ("cdmsgd", {"mu": 0.9})])
def test_fused_equals_unfused_reference_on_ring(setup, name, kw):
    """The kernel path against the per-leaf dense-Pi reference ``apply``."""
    train, _, jp = setup
    fused = _port_trainer(jp, name, "ring", fused=True, **kw)
    plain = _port_trainer(jp, name, "ring", fused=False, **kw)
    b1 = AgentPartitioner(train, 5, seed=3).batches(64)
    b2 = AgentPartitioner(train, 5, seed=3).batches(64)
    h = train_loop(fused, b1, 5)
    train_loop(plain, b2, 5)
    assert len(h.series("loss")) == 5 and h.last("consensus_error") > 0
    for a, b in zip(tree_leaves(fused.state.params), tree_leaves(plain.state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    mean = fused.mean_params()
    assert tuple(mean["h0"]["w"].shape) == (64, 50)
    assert torch.equal(fused.agent_params(2)["out"]["b"],
                       fused.state.params["out"]["b"][2])


def test_trainer_without_device_raises_without_cuda(setup, monkeypatch):
    train, _, jp = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CollaborativeTrainer(functools.partial(tpm.classifier_loss,
                                               tpm.mlp_classifier_apply),
                             tp, make_topology("ring", 5),
                             make_optimizer("cdsgd", 0.05, fused=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stacked_comm_ops(make_topology("ring", 5))


@pytest.mark.parametrize("knob,err,item", [
    ({"microbatches": 2}, NotImplementedError, "A9"),
    ({"consensus_rounds": 2}, NotImplementedError, "A13"),
    ({"exchange": "int8", "consensus_rounds": 2}, NotImplementedError, "A13"),
    ({"compressor": "topk:0.1"}, ValueError, "needs --error-feedback"),
    ({"staleness": 2}, NotImplementedError, "A13"),
    ({"momentum_mixing": "mixed"}, ValueError, "mixable momentum"),
    ({"error_feedback": True}, ValueError, "lossy wire"),
])
def test_unported_knobs_raise(setup, knob, err, item):
    """Knobs outside the port raise; the ``A13`` rows name the refusal
    these knobs raised before ROADMAP A13 was ported (``A9``: microbatches,
    before ROADMAP A17.1): now each builds, or raises the JAX trainer's own
    ``ValueError`` (``staleness=2`` under the sync schedule)."""
    _, _, jp = setup
    build = functools.partial(
        CollaborativeTrainer,
        functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        make_topology("ring", 5), make_optimizer("cdsgd", 0.05, fused=True),
        device="cpu", **knob)
    if item not in ("A13", "A9"):
        with pytest.raises(err, match=item):
            build()
        return
    try:
        JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                 jp, jmake_topology("ring", 5),
                 jmake_optimizer("cdsgd", 0.05, fused=True), **knob)
    except ValueError as e:
        with pytest.raises(ValueError, match="schedule='overlap'"):
            build()
        assert "schedule='overlap'" in str(e)
        return
    tr = build()
    assert tr.program.rounds == knob.get("consensus_rounds", 1)
    if item == "A9":              # microbatches: the grad phase accumulates
        assert tr.program.strategy == "static"
        return
    assert tr.program.strategy == "multi_round"


def test_make_optimizer_names():
    assert type(make_optimizer("CDSGD", 0.1)).__name__ == "CDSGD"
    assert type(make_optimizer("cdadam", 0.1)).__name__ == "CDAdam"
    # partial participation (ROADMAP A13): a fault schedule is taken
    fed = make_optimizer("fedavg", 0.1, faults=make_fault_schedule(
        "straggler:1:1", 5))
    assert type(fed).__name__ == "FedAvg" and fed.faults.period == 2
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adamw", 0.1)
