"""Port parity: the rest of the optimizer family against the JAX package.

CDMSGD-Nesterov (the lookahead point, fused and unfused), CDAdam (local
moments, float32 bias corrections), the gossip, time-varying CDSGD,
centralized SGD / MSGD and FedAvg baselines and the ``make_optimizer``
table.  The same numpy inputs go through both packages' optimizers on the
agent-stacked setup of ``tests/test_optim.py`` (5 agents on a ring, a
7-wide parameter) and their values are compared; the fused forms run the
port's plain kernel versions on the CPU and the JAX kernels in Pallas
interpret mode.  Tolerance 1e-6 abs for one update (the same float32
operations; XLA may contract a multiply-add), 1e-5 over several steps
and against the hand-rolled references of ``tests/test_optim.py`` /
``tests/test_mixing.py``.  Gossip draws its partners from the port's own
generator; the parity test patches the JAX package's permutation in.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import optim as joptim  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.core import make_topology  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import optim as toptim  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, train_loop  # noqa: E402
from repro_torch.data import AgentPartitioner, make_classification  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

N, D = 5, 7
ALPHA = 0.05
ATOL = 1e-6
TRAJ_ATOL = 1e-5


@pytest.fixture
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    g = rng.standard_normal((N, D)).astype(np.float32)
    jcomm = joptim.stacked_comm_ops(jtopo.make_topology("ring", N))
    tcomm = toptim.stacked_comm_ops(make_topology("ring", N), device="cpu")
    return jcomm, tcomm, x, g


def _t(a):
    return {"w": torch.from_numpy(np.array(a, np.float32))}


def _j(a):
    return {"w": jnp.asarray(a)}


def _gap(t, j) -> float:
    return max(float(np.max(np.abs(np.asarray(b) - a.numpy())))
               for a, b in zip(tree_leaves(t), jax.tree.leaves(j)))


def _run(jopt, topt, jcomm, tcomm, x, g, steps=1, grads=None):
    """``steps`` updates of both optimizers from ``x``; ``grads(p)`` gives
    each step's gradient (``g`` when None).  Returns both final
    ``(params, state)`` pairs."""
    jp, tp = _j(x), _t(x)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(steps):
        jg = _j(g if grads is None else grads(np.asarray(jp["w"])))
        tg = _t(np.asarray(jg["w"]))
        jp, js = jopt.update(jp, jg, js, jcomm)
        tp, ts = topt.update(tp, tg, ts, tcomm)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("fused", [False, True])
def test_nesterov_lookahead_point(setup, fused):
    """Mirrors ``tests/test_optim.py::test_nesterov_lookahead_point``:
    the lookahead is the params at init and ``x + mu v`` after a step;
    params, momentum and lookahead equal JAX's."""
    jcomm, tcomm, x, g = setup
    jopt = joptim.CDMSGDNesterov(ALPHA, mu=0.9, fused=fused)
    topt = toptim.CDMSGDNesterov(ALPHA, mu=0.9, fused=fused)
    tp = _t(x)
    st = topt.init(tp)
    np.testing.assert_array_equal(topt.grad_params(tp, st)["w"].numpy(), x)
    if fused:       # cloned, not aliased: the kernels write packed views
        assert st.inner[1]["w"].data_ptr() != tp["w"].data_ptr()
    (jp, js), (tp, ts) = _run(jopt, topt, jcomm, tcomm, x, g, steps=3)
    jv = js.inner[0] if fused else js.inner
    tv = ts.inner[0] if fused else ts.inner
    look = topt.grad_params(tp, ts)
    want = tp["w"] + np.float32(0.9) * tv["w"]
    gaps = [_gap(tp, jp), _gap(tv, jv),
            _gap(look, jopt.grad_params(jp, js))]
    print(f"nesterov fused={fused}: 3 steps, gaps params/momentum/lookahead "
          f"{gaps}")
    assert max(gaps) <= ATOL
    assert float((look["w"] - want).abs().max()) <= ATOL
    assert topt.momentum_tree(ts.inner) is tv


@pytest.mark.parametrize("fused", [False, True])
def test_cdadam_moments_stay_local(setup, fused):
    """Mirrors ``tests/test_optim.py::test_cdadam_moments_stay_local``
    (``m = 0.1 g`` after one step from zero moments), then 4 steps against
    JAX's CDAdam."""
    jcomm, tcomm, x, g = setup
    topt = toptim.CDAdam(1e-3, fused=fused)
    (_, _), (tp, ts) = _run(joptim.CDAdam(1e-3, fused=fused), topt, jcomm,
                            tcomm, x, g)
    np.testing.assert_allclose(ts.inner[0]["w"].numpy(), 0.1 * g, rtol=1e-5)
    assert tuple(tp["w"].shape) == (N, D)
    rng = np.random.default_rng(1)
    (jp, js), (tp, ts) = _run(
        joptim.CDAdam(1e-3, fused=fused), toptim.CDAdam(1e-3, fused=fused),
        jcomm, tcomm, x, g, steps=4,
        grads=lambda p: rng.standard_normal(p.shape).astype(np.float32))
    gaps = [_gap(tp, jp), _gap(ts.inner[0], js.inner[0]),
            _gap(ts.inner[1], js.inner[1])]
    print(f"cdadam fused={fused}: 4 steps, gaps params/m/v {gaps}")
    assert max(gaps) <= TRAJ_ATOL
    assert topt.momentum_tree(ts.inner) is ts.inner[0]


def test_bias_corrections_match_jax_float32():
    """``1 - b^t`` in float32 for t = 1..1000: the port's numpy ``powf``
    against XLA's ``pow`` inside a jitted step.  The count of bitwise-equal
    values prints; every value is within 1 ulp."""
    ts = np.arange(1000, dtype=np.int32)
    jfn = jax.jit(jax.vmap(lambda s: (1.0 - 0.9 ** (s + 1).astype(jnp.float32),
                                      1.0 - 0.999 ** (s + 1).astype(jnp.float32))))
    j1, j2 = (np.asarray(a) for a in jfn(jnp.asarray(ts)))
    t1, t2 = (np.asarray(a, np.float32) for a in zip(
        *[toptim.bias_corrections(0.9, 0.999, int(s)) for s in ts]))
    for name, t, j in (("bc1", t1, j1), ("bc2", t2, j2)):
        ulps = np.abs(t.view(np.int32).astype(np.int64)
                      - j.view(np.int32).astype(np.int64))
        print(f"{name}: {int((ulps == 0).sum())} of 1000 bit for bit, max "
              f"{int(ulps.max())} ulp")
        assert int(ulps.max()) <= 1


def _jax_perm(seed, step, n_agents):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return torch.from_numpy(np.array(jax.random.permutation(key, n_agents)))


def test_gossip_matches_jax_with_its_permutation(setup, monkeypatch):
    jcomm, tcomm, x, g = setup
    own = toptim.gossip_permutation(3, 5, N)
    assert sorted(own.tolist()) == list(range(N))
    assert torch.equal(own, toptim.gossip_permutation(3, 5, N))
    monkeypatch.setattr(toptim, "gossip_permutation", _jax_perm)
    (jp, _), (tp, _) = _run(joptim.GossipSGD(ALPHA, n_agents=N, seed=3),
                            toptim.GossipSGD(ALPHA, n_agents=N, seed=3),
                            jcomm, tcomm, x, g, steps=5)
    gap = _gap(tp, jp)
    print(f"gossip: 5 steps with JAX's permutations, gap {gap:.2e}")
    assert gap <= TRAJ_ATOL


def test_time_varying_cdsgd_matches_per_step_dense_reference():
    """Mirrors ``tests/test_mixing.py::test_time_varying_matches_per_step_
    dense_reference`` with the optimizer's own schedule: ``x_{t+1} =
    Pi_{t mod 2} x_t - alpha x_t`` (the loss ``|x|^2 / 2``), alternating
    the ring and the fully connected graph, through the trainer; and
    equal to JAX's ``TimeVaryingCDSGD``."""
    a, d = 4, 200
    topos = [make_topology("ring", a), make_topology("fully_connected", a)]
    x0 = np.random.default_rng(1).standard_normal((a, d)).astype(np.float32)

    def loss(p, b):
        return 0.5 * torch.sum(p["w"] ** 2), {}

    tr = CollaborativeTrainer(loss, {"w": torch.from_numpy(x0[0])},
                              topos[0], toptim.TimeVaryingCDSGD(0.05, topos),
                              device="cpu")
    tr.state = tr.state.__class__(params={"w": torch.from_numpy(x0.copy())},
                                  opt_state=tr.state.opt_state)
    x = x0.astype(np.float64)
    for t in range(4):
        tr.step({"x": np.zeros((a, 1), np.float32)})
        x = topos[t % 2].pi @ x - 0.05 * x
        np.testing.assert_allclose(tr.state.params["w"].numpy(), x, rtol=0,
                                   atol=TRAJ_ATOL)
    jtopos = [jtopo.make_topology("ring", a),
              jtopo.make_topology("fully_connected", a)]
    jcomm = joptim.stacked_comm_ops(jtopos[0])
    tcomm = toptim.stacked_comm_ops(topos[0], device="cpu")
    g = np.random.default_rng(2).standard_normal((a, d)).astype(np.float32)
    (jp, _), (tp, _) = _run(joptim.TimeVaryingCDSGD(0.05, jtopos),
                            toptim.TimeVaryingCDSGD(0.05, topos), jcomm, tcomm,
                            x0, g, steps=3)
    assert _gap(tp, jp) <= TRAJ_ATOL


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("msgd", {"mu": 0.9}),
                                     ("fedavg", {"local_steps": 2, "mu": 0.9}),
                                     ("fedavg", {})])
def test_baselines_match_jax(setup, name, kw):
    jcomm, tcomm, x, g = setup
    rng = np.random.default_rng(4)
    topt = toptim.make_optimizer(name, ALPHA, **kw)
    (jp, js), (tp, ts) = _run(
        joptim.make_optimizer(name, ALPHA, **kw), topt, jcomm, tcomm, x, g,
        steps=5, grads=lambda p: rng.standard_normal(p.shape).astype(np.float32))
    gaps = [_gap(tp, jp)] + ([_gap(ts.inner, js.inner)] if ts.inner != () else [])
    print(f"{name} {kw}: 5 steps, gaps {gaps}")
    assert max(gaps) <= TRAJ_ATOL
    assert not topt.uses_consensus
    if name == "sgd":       # the mean gradient: every agent moves alike
        d = tp["w"].numpy() - x
        assert float(np.abs(d - d[0:1]).max()) <= ATOL


def test_fedavg_matches_handrolled_e_step_reference(setup):
    """Mirrors ``tests/test_optim.py::test_fedavg_matches_handrolled_e_step_
    reference``: E = 3, mu = 0.9 over 7 steps; E local momentum steps, then
    both x and v replaced by their global means."""
    _, tcomm, x0, g0 = setup
    mu, e = 0.9, 3
    opt = toptim.FedAvg(ALPHA, local_steps=e, mu=mu)
    p = _t(x0)
    st = opt.init(p)
    x = x0.astype(np.float64)
    v = np.zeros_like(x)
    g = g0.astype(np.float64)
    for t in range(7):
        p, st = opt.update(p, _t(g0), st, tcomm)
        v = mu * v - ALPHA * g
        x = x + v
        if (t + 1) % e == 0:
            x = np.broadcast_to(x.mean(0, keepdims=True), x.shape).copy()
            v = np.broadcast_to(v.mean(0, keepdims=True), v.shape).copy()
        np.testing.assert_allclose(p["w"].numpy(), x, rtol=0, atol=TRAJ_ATOL)
        np.testing.assert_allclose(st.inner["w"].numpy(), v, rtol=0,
                                   atol=TRAJ_ATOL)
    # partial participation (ROADMAP A13, ported): with every agent present
    # the masked mean is the plain one
    full = toptim.FedAvg(ALPHA, local_steps=e, mu=mu,
                         faults=tfaults.trivial_faults(N))
    pf, sf = _t(x0), full.init(_t(x0))
    pp, sp = _t(x0), opt.init(_t(x0))
    for t in range(e):
        pf, sf = full.update(pf, _t(g0), sf, tcomm)
        pp, sp = opt.update(pp, _t(g0), sp, tcomm)
    np.testing.assert_allclose(pf["w"].numpy(), pp["w"].numpy(), rtol=0,
                               atol=TRAJ_ATOL)


def test_make_optimizer_table():
    topos = [make_topology("ring", N), make_topology("fully_connected", N)]
    extra = {"gossip": {"n_agents": N}, "cdsgd_tv": {"topologies": topos}}
    jextra = {"gossip": {"n_agents": N},
              "cdsgd_tv": {"topologies": [jtopo.make_topology("ring", N)]}}
    names = ["cdsgd", "cdmsgd", "cdmsgd_nesterov", "cdadam", "sgd", "msgd",
             "fedavg", "gossip", "cdsgd_tv"]
    for name in names:
        t = toptim.make_optimizer(name.upper(), 0.01, **extra.get(name, {}))
        j = joptim.make_optimizer(name, 0.01, **jextra.get(name, {}))
        assert type(t).__name__ == type(j).__name__
        assert t.uses_consensus == j.uses_consensus
        assert t.has_mixable_momentum == j.has_mixable_momentum
        assert t.has_fused == (type(j).apply_fused
                               is not joptim.DistributedOptimizer.apply_fused)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer("adamw", 0.01)


@pytest.fixture(scope="module")
def mlp():
    train, _ = make_classification(4096, n_classes=10, dim=64, seed=0)
    jp = jinit(jpm.mlp_classifier_template(64, 10, width=50, depth=6),
               jax.random.PRNGKey(0))
    return train, jp


def _trainer(jp, opt, topology="ring"):
    return CollaborativeTrainer(
        functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        make_topology(topology, 5), opt, device="cpu")


@pytest.mark.parametrize("name,kw", [("cdmsgd_nesterov", {"mu": 0.9}),
                                     ("cdadam", {})])
def test_fused_equals_unfused_reference_on_ring(mlp, name, kw):
    """The kernel path (plain versions on the CPU) against the per-leaf
    dense-Pi reference ``apply``, 5 trainer steps on the MLP."""
    train, jp = mlp
    lr = 0.05 if name == "cdmsgd_nesterov" else 1e-3
    fused = _trainer(jp, toptim.make_optimizer(name, lr, fused=True, **kw))
    plain = _trainer(jp, toptim.make_optimizer(name, lr, fused=False, **kw))
    train_loop(fused, AgentPartitioner(train, 5, seed=3).batches(64), 5)
    train_loop(plain, AgentPartitioner(train, 5, seed=3).batches(64), 5)
    gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(fused.state.params), tree_leaves(plain.state.params)))
    print(f"{name}: fused vs unfused after 5 steps, gap {gap:.2e}")
    assert gap <= TRAJ_ATOL


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("fedavg", {"local_steps": 2,
                                                              "mu": 0.9}),
                                     ("fedavg", {}), ("cdmsgd_nesterov", {})])
def test_trainer_wire_bytes_match_jax(mlp, name, kw):
    """0 for the centralized baselines, FedAvg's amortized all-reduce, the
    neighbor exchange otherwise: the JAX trainer's figures."""
    _, jp = mlp
    t = _trainer(jp, toptim.make_optimizer(name, 0.05, **kw), "fully_connected")
    j = JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                 jp, jtopo.make_topology("fully_connected", 5),
                 joptim.make_optimizer(name, 0.05, **kw))
    assert t.wire_bytes_per_step == j.wire_bytes_per_step
    assert (t.wire_bytes_per_step == 0) == (name == "sgd")
