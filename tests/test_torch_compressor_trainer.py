"""Port parity: the compressor axis (top-k and rank-r on the error-feedback
rail) in the trainer, one update phase at a time, against the JAX trainer.

Two setups: the JAX package's sparse-update testbed (``_testbed`` of
``tests/test_sparse_update.py``: a (40, 128) and a (70,) leaf, 4 agents on
a ring, lr 0.01) and the ``benchmarks/common.py`` MLP of
``tests/test_torch_wire_trainer.py`` (6x50 ReLU MLP on 64-dim inputs, 5
agents fully connected, lr 0.05).  CDSGD, CDMSGD, Nesterov and CDAdam,
each on ``topk:0.1`` sync and overlap with ``sparse_update`` on and off,
``topk:auto:6500``, and ``rank:2`` sync and overlap.

Teacher-forced: top-k selection flips on ULP-level differences (the
docstring of ``tests/test_sparse_update.py::test_trainer_sparse_dense_
parity``), so at every step the JAX trainer's state (params, momentum /
lookahead / moments, carried wire, residual, warm start) is loaded into the
port and both run the update phase on the same numpy gradients.  The JAX
package's uniforms are patched into the port (``ref.uniforms``), and its
``(128, r)`` warm-start basis (``topk.rank_init_q``).  Checked:

* the wire each step compresses (the sync step's, from the loaded state;
  the overlap step's new carried wire): values, indices and scales bit for
  bit for top-k, ``p`` and ``qt`` within 1e-5 for rank;
* the residual within 1e-6; params, momentum, lookahead and moments within
  1e-5; the warm start within 1e-5;
* ``program_bytes_per_neighbor``, ``exchange_bytes_per_step``, the
  trainer's ``wire_bytes_per_step`` and ``wire_bytes_per_neighbor`` of the
  carried wire equal to the JAX package's figures.

Also: the port's own sparse-vs-dense parity over 3 free-running steps
(the reference's acceptance test, run on the port), and the validation
errors of ``make_mixing_program`` for every rejected compressor
combination.  ``pytest -s`` prints the gaps.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import flatbuf as jfb  # noqa: E402
from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_topology as jmake_topology  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainState as JTrainState  # noqa: E402
from repro.kernels.consensus_update import topk as jtk  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import flatbuf as tfb  # noqa: E402
from repro_torch.core import make_optimizer, make_topology  # noqa: E402
from repro_torch.core.optim import OptState  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.kernels.consensus_update import topk as ttk  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

PARAM_ATOL = 1e-5
RESIDUAL_ATOL = 1e-6
RANK_ATOL = 1e-5
STEPS = 3
FAMILIES = {"cdsgd": {}, "cdmsgd": {"mu": 0.9},
            "cdmsgd_nesterov": {"mu": 0.9},
            "cdadam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8}}
# (compressor, schedule, sparse_update)
CONFIGS = [("topk:0.1", "sync", True), ("topk:0.1", "sync", False),
           ("topk:0.1", "overlap", True), ("topk:0.1", "overlap", False),
           ("topk:auto:6500", "overlap", True), ("rank:2", "sync", None),
           ("rank:2", "overlap", None)]
IDS = [f"{c}-{s}{'' if sp is None else '-sparse' if sp else '-dense'}"
       for c, s, sp in CONFIGS]


def _to_torch(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bytes(t) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@functools.lru_cache(maxsize=None)
def _jax_uniform_fn(shape):
    return jax.jit(lambda s: jax.random.uniform(jax.random.PRNGKey(s), shape,
                                                jnp.float32))


def jax_uniforms(seed, shape, device=None):
    """The uniforms the JAX package draws on the CPU for one agent's tile."""
    return _to_torch(_jax_uniform_fn(tuple(shape))(jnp.int32(seed)))


def jax_rank_init_q(r, seed=0, device=None):
    """The JAX package's warm-start basis, for the port."""
    return _to_torch(jtk.rank_init_q(r, seed)).to(device)


def _wire_to_torch(wire):
    out = []
    for e in wire:
        if isinstance(e, jcons.TopKWire):
            out.append(tcons.TopKWire(*(_to_torch(f) for f in e)))
        elif isinstance(e, jcons.RankWire):
            out.append(tcons.RankWire(*(_to_torch(f) for f in e)))
        else:
            out.append(tuple(_to_torch(f) for f in e))
    return tuple(out)


def _wire_gap(tw, jw) -> float:
    """Top-k fields bit for bit (asserted); the largest rank-factor gap."""
    assert len(tw) == len(jw)
    gap = 0.0
    for te, je in zip(tw, _wire_to_torch(jw)):
        assert type(te) is type(je)
        for tf, jf in zip(te, je):
            assert tf.dtype == jf.dtype and tf.shape == jf.shape
            if isinstance(te, tcons.TopKWire):
                np.testing.assert_array_equal(_bytes(tf), _bytes(jf))
            else:
                gap = max(gap, float((tf - jf).abs().max()))
    return gap


def _tree_gap(ttree, jtree) -> float:
    return max([float(np.max(np.abs(np.asarray(j, np.float32)
                                    - t.float().numpy())))
                for j, t in zip(jax.tree.leaves(jtree), tree_leaves(ttree))],
               default=0.0)


def _list_gap(ts, js) -> float:
    return max([float((t - _to_torch(j)).abs().max())
                for t, j in zip(ts, js)], default=0.0)


# --------------------------------------------------------------------------
# the two setups
# --------------------------------------------------------------------------


def _testbed_loss_jax(p, b):
    return 0.5 * (jnp.sum(p["w"] ** 2) + jnp.sum(p["b"] ** 2)), {}


def _testbed_loss_torch(p, b):
    return 0.5 * (torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)), {}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jax params, jax loss, torch loss, topology name, agents, lr)."""
    if name == "testbed":
        rng = np.random.default_rng(0)
        params = {"w": jnp.asarray(rng.standard_normal((40, 128)), jnp.float32),
                  "b": jnp.asarray(rng.standard_normal((70,)), jnp.float32)}
        return (params, _testbed_loss_jax, _testbed_loss_torch, "ring", 4,
                0.01)
    params = jinit(jpm.mlp_classifier_template(64, 10, width=50, depth=6),
                   jax.random.PRNGKey(0))
    return (params, functools.partial(jpm.classifier_loss,
                                      jpm.mlp_classifier_apply),
            functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
            "fully_connected", 5, 0.05)


def _trainers(setup, name, **knobs):
    jp, jloss, tloss, topo, n, lr = _setup(setup)
    kw = FAMILIES[name]
    jt = JTrainer(jloss, jp, jmake_topology(topo, n),
                  jmake_optimizer(name, lr, fused=True, **kw), donate=False,
                  **knobs)
    tt = CollaborativeTrainer(
        tloss, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        make_topology(topo, n), make_optimizer(name, lr, fused=True, **kw),
        device="cpu", **knobs)
    return jt, tt


def _load(tt, jparams, jstate, step):
    """A JAX trainer state, copied into the port's trainer."""
    tt.state = TrainState(
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        opt_state=OptState(
            step=int(jstate.step),
            inner=params_from_numpy(jax.tree.map(np.asarray, jstate.inner),
                                    "cpu"),
            wire=_wire_to_torch(jstate.wire),
            residual=tuple(_to_torch(r) for r in jstate.residual),
            qwarm=tuple(_to_torch(q) for q in jstate.qwarm)),
        step=step)


def _grads(rng, jparams):
    return jax.tree.map(lambda x: (0.5 * rng.standard_normal(np.shape(x)))
                        .astype(np.float32), jparams)


def _inner_gaps(name, tinner, jinner) -> dict:
    if name == "cdsgd":
        return {}
    if name == "cdmsgd":
        return {"momentum": _tree_gap(tinner, jinner)}
    a, b = ("momentum", "lookahead") if name == "cdmsgd_nesterov" else ("m", "v")
    return {a: _tree_gap(tinner[0], jinner[0]),
            b: _tree_gap(tinner[1], jinner[1])}


def _check_accounting(jt, tt):
    jspec = jfb.make_flat_spec(jt.state.params, lead=1)
    tspec = tfb.make_flat_spec(tt.state.params, lead=1)
    jbytes = jcons.program_bytes_per_neighbor(jspec, jt.program)
    assert tcons.program_bytes_per_neighbor(tspec, tt.program) == jbytes
    assert tcons.exchange_bytes_per_step(tspec, tt.topology,
                                         program=tt.program) == \
        jcons.exchange_bytes_per_step(jspec, jt.topology, program=jt.program)
    assert tt.wire_bytes_per_step == jt.wire_bytes_per_step
    return jbytes


@pytest.mark.parametrize("compressor,schedule,sparse", CONFIGS, ids=IDS)
@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("setup", ["testbed", "mlp"])
def test_teacher_forced_update_phases_match_jax(setup, name, compressor,
                                                schedule, sparse,
                                                monkeypatch):
    monkeypatch.setattr(ref, "uniforms", jax_uniforms)
    monkeypatch.setattr(ttk, "rank_init_q", jax_rank_init_q)
    knobs = dict(schedule=schedule, error_feedback=True,
                 compressor=compressor, sparse_update=sparse)
    jt, tt = _trainers(setup, name, **knobs)
    assert tt.program.sparse_update == jt.program.sparse_update
    assert tt.program.describe() == jt.program.describe()
    per_neighbor = _check_accounting(jt, tt)
    gaps = {"wire": 0.0, "param": 0.0, "residual": 0.0, "qwarm": 0.0}
    jo, to = jt.state.opt_state, tt.state.opt_state
    gaps["qwarm"] = _list_gap(to.qwarm, jo.qwarm)
    if schedule == "overlap":
        # x_0 compressed at seed -1, against the compiled JAX stage
        jfl, j0 = jt.comm.flat, jt.state.params
        jw0 = jax.jit(jfl.strategy.initial_wire)(jfl.pack(j0, jfl.spec(j0)))
        gaps["wire"] = _wire_gap(to.wire, jw0)
    jfl, tfl = jt.comm.flat, tt.comm.flat
    j_update = jax.jit(jt._program.update_phase)
    j_compress = jax.jit(jfl.strategy.compress_ef)
    rng = np.random.default_rng(3)
    for i in range(STEPS):
        _load(tt, jt.state.params, jt.state.opt_state, i)
        jo, to = jt.state.opt_state, tt.state.opt_state
        if schedule == "sync":
            # the wire this step compresses from the loaded state
            jbufs = jfl.pack(jt.state.params, jfl.spec(jt.state.params))
            tbufs = tfl.pack(tt.state.params, tfl.spec(tt.state.params))
            jw, jr, jq = j_compress(jbufs, jnp.int32(i), jo.residual,
                                    jo.qwarm)
            tw, tr, tq = tfl.strategy.compress_ef(tbufs, i, to.residual,
                                                  to.qwarm)
            gaps["wire"] = max(gaps["wire"], _wire_gap(tw, jw))
            gaps["residual"] = max(gaps["residual"], _list_gap(tr, jr))
            gaps["qwarm"] = max(gaps["qwarm"], _list_gap(tq, jq))
            assert tengine.wire_bytes_per_neighbor(tw) == per_neighbor \
                == jengine.wire_bytes_per_neighbor(jw)
        jg = _grads(rng, jt.state.params)
        jnew, jstate = j_update(jt.state.params, jg, jo)
        with torch.no_grad():
            tnew, tstate = tt._program.update_phase(
                tt.state.params, params_from_numpy(jg, "cpu"), to)
        gaps["param"] = max(gaps["param"], _tree_gap(tnew, jnew))
        for k, v in _inner_gaps(name, tstate.inner, jstate.inner).items():
            gaps[k] = max(gaps.get(k, 0.0), v)
        gaps["residual"] = max(gaps["residual"],
                               _list_gap(tstate.residual, jstate.residual))
        gaps["qwarm"] = max(gaps["qwarm"],
                            _list_gap(tstate.qwarm, jstate.qwarm))
        if schedule == "overlap":
            gaps["wire"] = max(gaps["wire"],
                               _wire_gap(tstate.wire, jstate.wire))
            assert tengine.wire_bytes_per_neighbor(tstate.wire) == \
                per_neighbor == jengine.wire_bytes_per_neighbor(jstate.wire)
        assert int(tstate.step) == int(jstate.step) == i + 1
        jt.state = JTrainState(params=jnew, opt_state=jstate, step=i + 1)
    print(f"{setup} {name} {compressor} {schedule}"
          f"{'' if sparse is None else ' sparse' if sparse else ' dense'}: "
          f"{STEPS} teacher-forced update phases, "
          f"{'top-k wire bitwise' if compressor.startswith('topk') else 'rank wire'}"
          f", {per_neighbor} B per neighbour, gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert gaps["wire"] <= RANK_ATOL
    assert gaps["residual"] <= RESIDUAL_ATOL
    assert gaps["qwarm"] <= RANK_ATOL
    for k in set(gaps) - {"wire", "residual", "qwarm"}:
        assert gaps[k] <= PARAM_ATOL, (k, gaps[k])


@pytest.mark.parametrize("schedule", ["sync", "overlap"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_port_sparse_dense_parity(name, schedule):
    """The reference's acceptance test on the port: ``sparse_update`` on
    and off, 3 free-running steps, params within 1e-5 (both forms add the
    same products in the same order, so the port's gap is 0.0)."""
    _, _, tloss, _, n, lr = _setup("testbed")
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((40, 128))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((70,))
                                    .astype(np.float32))}
    batch = {"x": np.zeros((n, 1), np.float32)}

    def run(sparse):
        tr = CollaborativeTrainer(
            tloss, params, make_topology("ring", n),
            make_optimizer(name, lr, fused=True, **FAMILIES[name]),
            device="cpu", schedule=schedule, error_feedback=True,
            compressor="topk:0.1", sparse_update=sparse)
        assert tr.program.sparse_update is sparse
        for _ in range(3):
            m = tr.step(batch)
        return tr.state.params, m["loss"]

    (ps, ls), (pd, ld) = run(True), run(False)
    gap = max(float((ps[k] - pd[k]).abs().max()) for k in ps)
    print(f"port {name} topk:0.1 {schedule}: sparse vs dense after 3 steps "
          f"{gap:.2e}")
    assert np.isclose(ls, ld, rtol=1e-5) and gap <= PARAM_ATOL


REJECTED = [
    dict(compressor="topk:0.1"),                              # no EF
    dict(compressor="rank:2"),
    dict(compressor="topk:0.1", error_feedback=True, staleness=2),
    dict(compressor="rank:2", error_feedback=True, faults=object()),
    dict(compressor="topk:0.1", error_feedback=True, rounds=3),
    dict(compressor="rank:2", error_feedback=True, strategy="multi_round"),
    dict(compressor="topk:0.1", error_feedback=True, momentum_mixing="mixed"),
    dict(compressor="topk:0.1", error_feedback=True, exchange="fp8"),
    dict(compressor="topk:0.1", error_feedback=True, exchange="bf16"),
    dict(compressor="rank:2", error_feedback=True, exchange="int8"),
    dict(compressor="rank:2", error_feedback=True, sparse_update=True),
    dict(compressor="int8", sparse_update=True),
    dict(compressor="topk:auto:10", error_feedback=True),    # parses; the
]                                                             # budget fails later


@pytest.mark.parametrize("kw", REJECTED[:-1], ids=[str(i) for i in
                                                  range(len(REJECTED) - 1)])
def test_make_mixing_program_rejects_like_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jcons.make_mixing_program(jmake_topology("ring", 4), **kw)
    with pytest.raises(ValueError) as terr:
        tcons.make_mixing_program(make_topology("ring", 4), **kw)
    assert str(terr.value) == str(jerr.value)


def test_compressed_program_normalizations():
    topo = make_topology("ring", 4)
    p = tcons.make_mixing_program(topo, compressor="topk:0.1",
                                  error_feedback=True)
    assert (p.exchange, p.sparse_update, p.compressed, p.is_trivial) == \
        ("int8", True, True, False)
    assert p.compressor_kind == "topk" and p.compressor_param == 0.1
    r = tcons.make_mixing_program(topo, compressor="rank:2",
                                  error_feedback=True)
    assert (r.exchange, r.sparse_update, r.compressor_param) == ("f32", False, 2)
    a = tcons.make_mixing_program(topo, compressor="topk:auto:6500",
                                  error_feedback=True, sparse_update=False)
    assert a.compressor_param == ("auto", 6500) and not a.sparse_update
    # the budget floor fails when the trainer prices the buckets
    with pytest.raises(ValueError, match="bucket"):
        CollaborativeTrainer(
            _testbed_loss_torch, {"w": torch.zeros(40, 128),
                                  "b": torch.zeros(70)}, topo,
            make_optimizer("cdsgd", 0.01, fused=True), device="cpu",
            **REJECTED[-1])
