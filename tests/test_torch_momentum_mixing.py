"""Port parity: momentum mixing (``momentum_mixing="mixed"``) with CDMSGD,
CDMSGD-Nesterov and CDAdam, one step at a time, against the JAX trainer.

The ``benchmarks/common.py`` MLP setup (6x50 ReLU MLP on 64-dim synthetic
data, 5 agents, fully connected, lr 0.05, batch 64), fused, with the
momentum (CDAdam: the first moment) riding the wire next to the params,
over {int8 sync, int8 sync + error feedback, fp8 overlap, f32 overlap};
the JAX package's uniforms are patched into the port for int8
(``ref.uniforms``).

Teacher-forced, as ``test_torch_wire_trainer.py``: at every step the JAX
trainer's state (params, momentum / moments / lookahead, both payloads'
wire, both payloads' residuals) is loaded into the port, both take one step
from it, and

* both payload wires are equal bit for bit (the wire the sync step
  quantizes from the loaded params and momentum, and the new carried wire
  of overlap);
* the new error-feedback residuals are within 1e-6, per payload;
* params, momentum and lookahead are within 1e-5.

CDMSGD and Nesterov take whole trainer steps (Nesterov's gradient at the
loaded lookahead).  CDAdam's step direction ``(m/bc1) / (sqrt(v/bc2) +
eps)`` is about ``g / (|g| + eps)`` early on, so a 1e-8 difference between
the two frameworks' backward passes at a near-zero gradient moves a
parameter by O(alpha); its update phase is therefore fed the same numpy
gradients in both packages and held to the same bounds (its whole-step
gap is printed, not asserted).  ``pytest -s`` prints the gaps, and the
mixed-vs-plain int8 drift figures of ``tests/test_mixing.py`` on the port.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_topology as jmake_topology  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainState as JTrainState  # noqa: E402
from repro.data import AgentPartitioner as JPartitioner  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import flatbuf as tfb  # noqa: E402
from repro_torch.core import make_optimizer, make_topology  # noqa: E402
from repro_torch.core.optim import CDMSGD, CDSGD, OptState  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import AgentPartitioner, make_classification  # noqa: E402
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

PARAM_ATOL = 1e-5
RESIDUAL_ATOL = 1e-6
STEPS = 3
CONFIGS = [("int8", "sync", False), ("int8", "sync", True),
           ("fp8", "overlap", False), ("f32", "overlap", False)]
OPTIMIZERS = [("cdmsgd", {"mu": 0.9}), ("cdmsgd_nesterov", {"mu": 0.9}),
              ("cdadam", {"b1": 0.9, "b2": 0.999, "eps": 1e-8})]
JLOSS = functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply)
TLOSS = functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply)


def _to_torch(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bytes(t) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _wire_to_torch(wire):
    return tuple((_to_torch(p), _to_torch(s)) for p, s in wire)


def _assert_wire_equal(tw, jw):
    assert len(tw) == len(jw)
    for (tp, ts), (jp, js) in zip(tw, _wire_to_torch(jw)):
        assert tp.dtype == jp.dtype and tp.shape == jp.shape
        np.testing.assert_array_equal(_bytes(tp), _bytes(jp))
        np.testing.assert_array_equal(_bytes(ts), _bytes(js))


def _tree_gap(ttree, jtree) -> float:
    return max(float(np.max(np.abs(np.asarray(j, np.float32)
                                   - t.float().numpy())))
               for j, t in zip(jax.tree.leaves(jtree), tree_leaves(ttree)))


def _residual_gaps(tres, jres):
    """Max residual gap of the params half and of the momentum half."""
    b = len(tres) // 2
    gaps = [float((t - _to_torch(j)).abs().max()) for t, j in zip(tres, jres)]
    return max(gaps[:b], default=0.0), max(gaps[b:], default=0.0)


@functools.lru_cache(maxsize=None)
def _jax_uniform_fn(shape):
    return jax.jit(lambda s: jax.random.uniform(jax.random.PRNGKey(s), shape,
                                                jnp.float32))


def jax_uniforms(seed, shape, device=None):
    """The uniforms the JAX package draws on the CPU for one agent's bucket."""
    return _to_torch(_jax_uniform_fn(tuple(shape))(jnp.int32(seed)))


@pytest.fixture(scope="module")
def setup():
    train, _ = make_classification(4096, n_classes=10, dim=64, seed=0)
    jp = jinit(jpm.mlp_classifier_template(64, 10, width=50, depth=6),
               jax.random.PRNGKey(0))
    return train, jp


def _trainers(jp, name, kw, **knobs):
    jt = JTrainer(JLOSS, jp, jmake_topology("fully_connected", 5),
                  jmake_optimizer(name, 0.05, fused=True, **kw), **knobs)
    tt = CollaborativeTrainer(
        TLOSS, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        make_topology("fully_connected", 5),
        make_optimizer(name, 0.05, fused=True, **kw), device="cpu", **knobs)
    return jt, tt


def _load_jax_state(tt, jparams, jstate, step):
    """A JAX trainer state, copied into the port's trainer."""
    tt.state = TrainState(
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        opt_state=OptState(
            step=int(jstate.step),
            inner=params_from_numpy(jax.tree.map(np.asarray, jstate.inner),
                                    "cpu"),
            wire=_wire_to_torch(jstate.wire),
            residual=tuple(_to_torch(r) for r in jstate.residual)),
        step=step)


def _sync_wire(jt, tt, ef, gaps):
    """The wire (both payloads) a sync step quantizes from the loaded
    params and momentum: bitwise, and the EF residuals within bound."""
    jfl, tfl = jt.comm.flat, tt.comm.flat
    jo, to = jt.state.opt_state, tt.state.opt_state
    jspec = jfl.spec(jt.state.params)
    jbufs = jcons.widen_with_momentum(
        jfl, jfl.pack(jt.state.params, jspec),
        jfl.pack(jt.optimizer.momentum_tree(jo.inner), jspec))
    _, tbufs = engine._pack(tt.comm.flat, tt.state.params,
                            tt.optimizer.momentum_tree(to.inner))
    step = int(jo.step)
    if ef:
        jw, jr = jax.jit(jfl.strategy.quantize_ef)(jbufs, jnp.int32(step),
                                                   jo.residual)
        tw, tr = tfl.strategy.quantize_ef(tbufs, step, to.residual)
        gp, gm = _residual_gaps(tr, jr)
        gaps["res_p"], gaps["res_m"] = max(gaps["res_p"], gp), max(gaps["res_m"], gm)
    else:
        jw = jax.jit(jfl.strategy.quantize_stage)(jbufs, jnp.int32(step))
        tw = tfl.strategy.quantize_stage(tbufs, step)
    assert len(tw) == len(jbufs) == 2 * jspec.n_buckets
    _assert_wire_equal(tw, jw)


def _grads(rng, jparams):
    """Seeded numpy gradients shaped like the agent-stacked params, with
    exact zeros at the same coordinates of every agent (there ``m`` and
    ``v`` stay 0 and Adam's step is ``0 / (0 + eps)``).  A zero at one
    agent only would leave ``v = 0`` under a mixed, nonzero ``m``: a step
    of ``alpha m / eps`` that turns a 1e-9 rounding gap into O(1)."""
    def leaf(x):
        g = (0.05 * rng.standard_normal(np.shape(x))).astype(np.float32)
        g.reshape(g.shape[0], -1)[:, ::97] = 0.0
        return g
    return jax.tree.map(leaf, jparams)


def _inner_gap(name, tinner, jinner):
    if name == "cdmsgd":
        return {"momentum": _tree_gap(tinner, jinner)}
    a, b = ("momentum", "lookahead") if name == "cdmsgd_nesterov" else ("m", "v")
    return {a: _tree_gap(tinner[0], jinner[0]), b: _tree_gap(tinner[1], jinner[1])}


@pytest.mark.parametrize("exchange,schedule,ef", CONFIGS,
                         ids=[f"{e}-{s}{'-ef' if f else ''}"
                              for e, s, f in CONFIGS])
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=[n for n, _ in OPTIMIZERS])
def test_mixed_teacher_forced_steps_match_jax(setup, monkeypatch, name, kw,
                                              exchange, schedule, ef):
    train, jp = setup
    if exchange == "int8":
        monkeypatch.setattr(ref, "uniforms", jax_uniforms)
    knobs = dict(exchange=exchange, schedule=schedule, error_feedback=ef,
                 momentum_mixing="mixed")
    jt, tt = _trainers(jp, name, kw, **knobs)
    assert tt.wire_bytes_per_step == jt.wire_bytes_per_step
    if schedule == "overlap":
        # x_0 and v_0 = 0 quantized at seed -1, held against the compiled
        # form of the JAX stage (see test_torch_wire_trainer.py)
        jfl, j0 = jt.comm.flat, jt.state.params
        jbufs = jcons.widen_with_momentum(jfl, jfl.pack(j0, jfl.spec(j0)))
        _assert_wire_equal(tt.state.opt_state.wire,
                           jax.jit(jfl.strategy.initial_wire)(jbufs))
    jb = JPartitioner(train, 5, seed=0).batches(64)
    rng = np.random.default_rng(7)
    j_update = jax.jit(jt._program.update_phase)
    gaps = {"param": 0.0, "res_p": 0.0, "res_m": 0.0}
    full_step = 0.0
    for i in range(STEPS):
        _load_jax_state(tt, jt.state.params, jt.state.opt_state, i)
        if schedule == "sync":
            _sync_wire(jt, tt, ef, gaps)
        if name == "cdadam":
            # the update phase on the same gradients in both packages
            jg = _grads(rng, jt.state.params)
            jnew, jstate = j_update(jt.state.params, jg, jt.state.opt_state)
            with torch.no_grad():
                tnew, tstate = tt._program.update_phase(
                    tt.state.params, params_from_numpy(jg, "cpu"),
                    tt.state.opt_state)
            tt.state = TrainState(params=tnew, opt_state=tstate, step=i + 1)
            jt.state = JTrainState(params=jnew, opt_state=jstate, step=i + 1)
        else:
            batch = next(jb)
            mj, mt = jt.step(batch), tt.step(batch)
            assert abs(mj["loss"] - mt["loss"]) <= 1e-4, (i, mj, mt)
        jo, to = jt.state.opt_state, tt.state.opt_state
        gaps["param"] = max(gaps["param"],
                            _tree_gap(tt.state.params, jt.state.params))
        for k, v in _inner_gap(name, to.inner, jo.inner).items():
            gaps[k] = max(gaps.get(k, 0.0), v)
        _assert_wire_equal(to.wire, jo.wire)
        gp, gm = _residual_gaps(to.residual, jo.residual)
        gaps["res_p"], gaps["res_m"] = max(gaps["res_p"], gp), max(gaps["res_m"], gm)
    if name == "cdadam":
        # for the record: one whole trainer step from the same state
        _load_jax_state(tt, jt.state.params, jt.state.opt_state, STEPS)
        batch = next(jb)
        jt.step(batch)
        tt.step(batch)
        full_step = _tree_gap(tt.state.params, jt.state.params)
    print(f"{name} mixed {exchange} {schedule}{' EF' if ef else ''}: {STEPS} "
          f"teacher-forced {'update phases' if name == 'cdadam' else 'steps'}, "
          f"both wires bitwise, gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + (f"; whole-step param gap {full_step:.2e} (not asserted)"
             if name == "cdadam" else ""))
    for k, v in gaps.items():
        assert v <= (RESIDUAL_ATOL if k.startswith("res") else PARAM_ATOL), (k, v)


def test_mixed_launch_counts_and_payload_seeds(setup):
    """One mixed int8 step: one ``sr_quantize`` launch per payload would run
    on the card (the CPU launches nothing); the momentum half of the wire
    draws its stream at payload stride 2750161."""
    _, jp = setup
    jt, tt = _trainers(jp, "cdmsgd", {"mu": 0.9}, exchange="int8",
                       momentum_mixing="mixed")
    fl = tt.comm.flat
    p = tt.state.params
    spec = fl.spec(p)
    bufs = tcons.widen_with_momentum(fl, fl.pack(p, spec), fl.pack(p, spec))
    seen = []
    orig = ref.sr_quantize_ref

    def spy(x, seed, exchange, agent_stride=0):
        seen.append(seed)
        return orig(x, seed, exchange, agent_stride)

    before = cu.launch_counts()
    ref.sr_quantize_ref = spy
    try:
        wire = fl.strategy.quantize_stage(bufs, 3)
    finally:
        ref.sr_quantize_ref = orig
    assert cu.launch_counts() == before
    assert seen == [tcons.wire_seed(3), tcons.wire_seed(3, payload=1)]
    assert seen[1] - seen[0] == 2750161
    # the same buckets, two streams: the halves' codes differ
    assert not torch.equal(wire[0][0], wire[1][0])
    np.testing.assert_array_equal(
        [tcons.wire_seed(s, agent=a, bucket=b, payload=1)
         for s in (-1, 0, 2148) for a in (0, 4) for b in (0, 1)],
        [int(jcons.wire_seed(s, agent=a, bucket=b, payload=1))
         for s in (-1, 0, 2148) for a in (0, 4) for b in (0, 1)])


def _testbed(seed=0):
    """The JAX package's paper testbed of ``tests/test_mixing.py``: MLP
    8-16-16-4, 4 agents on a ring, one shared batch."""
    params = jinit(jpm.mlp_classifier_template(8, 4, width=16, depth=2),
                   jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    batch = {"x": rng.standard_normal((4, 8, 8)).astype(np.float32),
             "y": rng.integers(0, 4, (4, 8)).astype(np.int32)}
    return (params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            make_topology("ring", 4), batch)


def test_momentum_mixing_validation():
    params, topo, _ = _testbed()
    with pytest.raises(ValueError, match="momentum_mixing"):
        tcons.make_mixing_program(topo, momentum_mixing="both")
    with pytest.raises(ValueError, match="mixable momentum"):
        CollaborativeTrainer(TLOSS, params, topo, CDSGD(5e-3, fused=True),
                             device="cpu", momentum_mixing="mixed")
    with pytest.raises(ValueError, match="fused"):
        CollaborativeTrainer(TLOSS, params, topo, CDMSGD(5e-3, fused=False),
                             device="cpu", momentum_mixing="mixed")
    with pytest.raises(ValueError, match="fused"):
        CollaborativeTrainer(TLOSS, params, topo,
                             make_optimizer("fedavg", 5e-3, fused=True),
                             device="cpu", momentum_mixing="mixed")
    p = tcons.make_mixing_program(topo, momentum_mixing="mixed")
    assert not p.is_trivial and p.n_payloads == 2
    # the one-shot gather cannot see the momentum payload
    fl = tcons.stacked_flat_comm(topo, program=p, device="cpu")
    with pytest.raises(ValueError, match="staged exchange"):
        fl.gather([torch.zeros(4, 2, 128)], 0)


def test_momentum_mixed_wire_doubles_and_ef_adds_zero():
    """The momentum payload doubles the bytes at equal precision (the
    accounting and the carried overlap buffers); error feedback adds
    zero; one wire pair and one residual per bucket per payload."""
    params, topo, _ = _testbed()

    def mk(**kw):
        return CollaborativeTrainer(TLOSS, params, topo,
                                    CDMSGD(5e-3, mu=0.9, fused=True),
                                    device="cpu", exchange="int8", **kw)

    base = mk().wire_bytes_per_step
    mixed = mk(momentum_mixing="mixed").wire_bytes_per_step
    assert mixed == 2 * base
    assert mk(momentum_mixing="mixed", error_feedback=True
              ).wire_bytes_per_step == mixed
    tr = mk(momentum_mixing="mixed", schedule="overlap")
    spec = tfb.make_flat_spec(tr.state.params, lead=1)
    assert engine.wire_bytes_per_neighbor(tr.state.opt_state.wire) == \
        2 * spec.exchange_bytes("int8")
    assert len(tr.state.opt_state.wire) == 2 * spec.n_buckets
    tr_ef = mk(momentum_mixing="mixed", error_feedback=True)
    assert len(tr_ef.state.opt_state.residual) == 2 * spec.n_buckets
    bytes_ = tcons.exchange_bytes_per_step(spec, topo, "int8", payloads=2)
    assert bytes_["per_step_bytes"] == mixed and bytes_["payloads"] == 2


def test_momentum_mixed_drift_figures_on_the_port():
    """``tests/test_mixing.py``'s caveat-lr comparison (lr 0.01, mu 0.9, 20
    steps): drift of int8 from f32, mixed against plain.  The JAX package's
    "mixed strictly below plain" inverts on this tree (ROADMAP §C), so the
    port's figures are printed, not ordered; only the mixed drift's bound
    of that test (5e-2) and finite losses are asserted."""
    params, topo, batch = _testbed()
    out = {}
    for schedule in ("sync", "overlap"):
        runs = {}
        for label, kw in (("f32_plain", {}),
                          ("f32_mixed", {"momentum_mixing": "mixed"}),
                          ("int8_plain", {"exchange": "int8"}),
                          ("int8_mixed", {"exchange": "int8",
                                          "momentum_mixing": "mixed"})):
            tr = CollaborativeTrainer(TLOSS, params, topo,
                                      CDMSGD(0.01, mu=0.9, fused=True),
                                      device="cpu", schedule=schedule, **kw)
            for _ in range(20):
                m = tr.step(batch)
            assert np.isfinite(m["loss"])
            runs[label] = tree_leaves(tr.state.params)

        def drift(a, b):
            return max(float((x - y).abs().max())
                       for x, y in zip(runs[a], runs[b]))

        out[schedule] = (drift("f32_plain", "int8_plain"),
                         drift("f32_mixed", "int8_mixed"))
        print(f"momentum mixing drift {schedule}: plain int8 "
              f"{out[schedule][0]:.5f}, mixed int8 {out[schedule][1]:.5f}")
        assert out[schedule][1] < 5e-2
