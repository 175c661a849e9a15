"""Port parity: the MixingProgram strategies and the staleness ring (A13).

The ``benchmarks/common.py`` MLP (6x50 ReLU on 64-dim synthetic data,
batch 64, lr 0.05) trained by fused CDSGD / CDMSGD in both packages from
the JAX package's ``PRNGKey(0)`` weights, carried with
``params_from_numpy``: the JAX trainer with the Pallas kernels in
interpret mode, the port's trainer on the CPU (plain kernel versions).

* f32 wires run free: time-varying CDSGD over ``alternating:ring:torus``
  at 8 agents, ``gossip:8`` CDMSGD, multi-round k = 2 and 3, params within
  1e-5 after 10 steps (measured 0.9e-7 to 4.2e-7, printed with ``-s``).
* int8 wires are teacher-forced, as in ``test_torch_wire_trainer.py``:
  each step loads the JAX trainer's state into the port, both draw the
  JAX package's uniforms (``ref.uniforms`` patched), and every round's
  wire, quantized from the same input, is equal bit for bit; the round
  mixes (``combine``) within 1e-6 (printed); the params within 1e-5 after
  the step, which for k > 1 runs with the JAX mix patched in: XLA's einsum
  and the port's ordered sum round differently, and re-quantizing a mix
  that differs in its last bit flips an int8 code now and then (one code
  moved a parameter by 1.5e-3 at k = 3).
  Covered: multi-round k = 2 and 3, error feedback with k = 2 (the
  residual within 1e-6), momentum mixing with k = 2 on the overlap
  schedule (both payload wires), and the staleness ring at S = 2 and 4
  under a straggler, a stall and dropped links (ring slots bit for bit,
  ``send_age`` and ``ages`` equal after every step).
* FedAvg with partial participation against the JAX FedAvg; the byte
  accounting (``rounds=``, a schedule's mean degree, the ring's one
  generation); the reference's rejections, one case each.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import flatbuf as jfb  # noqa: E402
from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_topology as jmake_topology  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.data import AgentPartitioner as JPartitioner  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import flatbuf as tfb  # noqa: E402
from repro_torch.core import make_optimizer, make_topology  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.optim import OptState, stacked_comm_ops  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import make_classification  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

PARAM_ATOL = 1e-5
MIX_ATOL = 1e-6
RESIDUAL_ATOL = 1e-6
ROUND = 611953


@pytest.fixture(scope="module")
def setup():
    train, _ = make_classification(4096, n_classes=10, dim=64, seed=0)
    jp = jinit(jpm.mlp_classifier_template(64, 10, width=50, depth=6),
               jax.random.PRNGKey(0))
    return train, jp


def _to_torch(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bytes(t) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _assert_same_bits(tw, jw):
    tl, jl = tree_leaves(tw), jax.tree.leaves(jw)
    assert len(tl) == len(jl) and tl
    for t, j in zip(tl, jl):
        j = _to_torch(j)
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(_bytes(t), _bytes(j))


def _gap(ts, js) -> float:
    return max([float((t.float() - _to_torch(j).float()).abs().max())
                for t, j in zip(tree_leaves(ts), jax.tree.leaves(js))],
               default=0.0)


@functools.lru_cache(maxsize=None)
def _jax_uniform_fn(shape):
    return jax.jit(lambda s: jax.random.uniform(jax.random.PRNGKey(s), shape,
                                                jnp.float32))


def jax_uniforms(seed, shape, device=None):
    """The uniforms the JAX package draws on the CPU for one agent's bucket."""
    return _to_torch(_jax_uniform_fn(tuple(shape))(jnp.int32(seed)))


def _wire_to_torch(wire):
    if isinstance(wire, jcons.WireRing):
        return tcons.WireRing(
            slots=tuple((_to_torch(p), _to_torch(s)) for p, s in wire.slots),
            send_age=_to_torch(wire.send_age), ages=_to_torch(wire.ages))
    return tuple((_to_torch(p), _to_torch(s)) for p, s in wire)


def _load_jax_state(tt, jt):
    """The JAX trainer's state, copied into the port's trainer."""
    js, o = jt.state, jt.state.opt_state
    tt.state = TrainState(
        params=params_from_numpy(jax.tree.map(np.asarray, js.params), "cpu"),
        opt_state=OptState(
            step=int(o.step),
            inner=params_from_numpy(jax.tree.map(np.asarray, o.inner), "cpu"),
            wire=_wire_to_torch(o.wire),
            residual=tuple(_to_torch(r) for r in o.residual)),
        step=js.step)


def _trainers(jp, name, n, topo="fully_connected", mu=None, **knobs):
    kw = {} if mu is None else {"mu": mu}
    jt = JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                  jp, jmake_topology(topo, n),
                  jmake_optimizer(name, 0.05, fused=True, **kw), **knobs)
    tt = CollaborativeTrainer(
        functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        make_topology(topo, n), make_optimizer(name, 0.05, fused=True, **kw),
        device="cpu", **knobs)
    assert tt.program.describe() == jt.program.describe()
    assert tt.wire_bytes_per_step == jt.wire_bytes_per_step
    return jt, tt


def _param_gap(jt, tt) -> float:
    return max(float(np.max(np.abs(np.asarray(a) - b.numpy())))
               for a, b in zip(jax.tree.leaves(jt.state.params),
                               tree_leaves(tt.state.params)))


FREE = [
    ("cdsgd", None, 8, "ring", {"mixing_strategy": "time_varying",
                                "topology_schedule": "alternating:ring:torus"}),
    ("cdmsgd", 0.9, 8, "ring", {"mixing_strategy": "time_varying",
                                "topology_schedule": "gossip:8"}),
    ("cdsgd", None, 5, "ring", {"consensus_rounds": 2}),
    ("cdsgd", None, 5, "ring", {"consensus_rounds": 3}),
    ("cdmsgd", 0.9, 5, "fully_connected", {"consensus_rounds": 2,
                                           "schedule": "overlap"}),
    ("cdmsgd", 0.9, 8, "ring", {"mixing_strategy": "time_varying",
                                "topology_schedule": "alternating:ring:star",
                                "consensus_rounds": 2}),
]


@pytest.mark.parametrize("name,mu,n,topo,knobs", FREE,
                         ids=["tv-alternating", "tv-gossip8", "rounds2",
                              "rounds3", "rounds2-overlap", "tv-rounds2"])
def test_f32_strategies_track_jax(setup, name, mu, n, topo, knobs):
    train, jp = setup
    jt, tt = _trainers(jp, name, n, topo, mu, **knobs)
    batches = JPartitioner(train, n, seed=0).batches(64)
    for i in range(10):
        b = next(batches)
        mj, mt = jt.step(b), tt.step(b)
        assert abs(mj["loss"] - mt["loss"]) <= 1e-4, (i, mj, mt)
        assert abs(mj["consensus_error"] - mt["consensus_error"]) <= 1e-4
    gap = _param_gap(jt, tt)
    print(f"{name} {knobs}: max param gap after 10 steps {gap:.2e}")
    assert gap <= PARAM_ATOL


def _check_round_wires(jt, tt, step: int, gaps: dict) -> None:
    """Every round's wire of this sync step, from the same input, bit for
    bit; each round's full-precision mix within MIX_ATOL."""
    jfl, tfl = jt.comm.flat, tt.comm.flat
    js, ts = jfl.strategy, tfl.strategy
    jbufs = jfl.pack(jt.state.params, jfl.spec(jt.state.params))
    tbufs = tfl.pack(tt.state.params, tfl.spec(tt.state.params))
    ef = tt.program.error_feedback
    if ef:
        jw, jr = jax.jit(js.quantize_ef)(jbufs, jnp.int32(step),
                                         jt.state.opt_state.residual)
        tw, tr = ts.quantize_ef(tbufs, step, tt.state.opt_state.residual)
        gaps["residual"] = max(gaps["residual"], _gap(tr, jr))
    else:
        jw = jax.jit(js._quantize_payloads)(jbufs, jnp.int32(step))
        tw = ts._quantize_payloads(tbufs, step)
    _assert_same_bits(tw, jw)
    jb, tb = jbufs, tbufs
    for r in range(1, tt.program.rounds):
        jn, jwq, jsc = js.exchange_stage(jw, jnp.int32(step))
        jb = jax.jit(js.combine)(jn, jwq, jsc, list(jb))
        tn, twq, tsc = ts.exchange_stage(_wire_to_torch(jw), step)
        # the port's own mix (the instance may carry the JAX one, below)
        tb = tcons.MixingStrategy.combine(
            ts, tn, twq, tsc, [_to_torch(b) for b in
                               (jbufs if r == 1 else jb_prev)])
        gaps["mix"] = max(gaps["mix"], _gap(tb, jb))
        jb_prev = jb
        jw = jax.jit(lambda b, s: js._quantize_payloads(b, s))(
            list(jb), jnp.int32(step + ROUND * r))
        tw = ts._quantize_payloads([_to_torch(b) for b in jb], step, rnd=r)
        _assert_same_bits(tw, jw)
        gaps["rounds"] += 1


def _teacher_forced(setup, monkeypatch, name, mu, n, topo, steps, knobs):
    train, jp = setup
    monkeypatch.setattr(ref, "uniforms", jax_uniforms)
    jt, tt = _trainers(jp, name, n, topo, mu, **knobs)
    if tt.program.rounds > 1:
        # inner rounds re-quantize each package's own f32 mix, and the two
        # mixes differ in summation order (XLA's einsum against the port's
        # ordered sum, held within MIX_ATOL per round below), which flips an
        # int8 code now and then; so inside the step the port mixes with the
        # JAX function, and every other operation of the step is the port's
        jcomb = jax.jit(jt.comm.flat.strategy.combine)
        monkeypatch.setattr(tt.comm.flat.strategy, "combine", lambda *a: [
            _to_torch(o) for o in jcomb(*jax.tree.map(np.asarray, a))])
    batches = JPartitioner(train, n, seed=0).batches(64)
    gaps = {"param": 0.0, "residual": 0.0, "mix": 0.0, "rounds": 0}
    overlap = knobs.get("schedule") == "overlap"
    if overlap:       # the init wire, against the compiled JAX stage
        jfl = jt.comm.flat
        _assert_same_bits(tt.state.opt_state.wire, jax.jit(
            lambda p: jcons.initial_wire_state(jfl, p))(jt.state.params))
    for i in range(steps):
        _load_jax_state(tt, jt)
        if not overlap:
            _check_round_wires(jt, tt, i, gaps)
        b = next(batches)
        mj, mt = jt.step(b), tt.step(b)
        assert abs(mj["loss"] - mt["loss"]) <= 1e-4, (i, mj, mt)
        gaps["param"] = max(gaps["param"], _param_gap(jt, tt))
        jw, tw = jt.state.opt_state.wire, tt.state.opt_state.wire
        if isinstance(jw, jcons.WireRing):
            _assert_same_bits(tw.slots, jw.slots)
            np.testing.assert_array_equal(tw.send_age.numpy(),
                                          np.asarray(jw.send_age))
            np.testing.assert_array_equal(tw.ages.numpy(), np.asarray(jw.ages))
        elif overlap:
            _assert_same_bits(tw, jw)
        gaps["residual"] = max(gaps["residual"], _gap(
            tt.state.opt_state.residual, jt.state.opt_state.residual))
    print(f"{name} {knobs}: {steps} teacher-forced steps, wires bitwise "
          f"({gaps['rounds']} inner-round wires), max mix gap "
          f"{gaps['mix']:.2e}, param gap {gaps['param']:.2e}, residual gap "
          f"{gaps['residual']:.2e}")
    assert gaps["param"] <= PARAM_ATOL
    assert gaps["mix"] <= MIX_ATOL
    assert gaps["residual"] <= RESIDUAL_ATOL
    return jt, tt


FORCED = [
    ("cdsgd", None, 5, "ring", 4, {"exchange": "int8", "consensus_rounds": 2}),
    ("cdmsgd", 0.9, 5, "ring", 4, {"exchange": "int8", "consensus_rounds": 3}),
    ("cdsgd", None, 5, "fully_connected", 4,
     {"exchange": "int8", "consensus_rounds": 2, "error_feedback": True}),
    ("cdmsgd", 0.9, 5, "ring", 4,
     {"exchange": "int8", "consensus_rounds": 2, "momentum_mixing": "mixed",
      "schedule": "overlap"}),
    ("cdmsgd", 0.9, 8, "ring", 4,
     {"exchange": "int8", "mixing_strategy": "time_varying",
      "topology_schedule": "gossip:8", "consensus_rounds": 2}),
]


@pytest.mark.parametrize("name,mu,n,topo,steps,knobs", FORCED,
                         ids=["int8-rounds2", "int8-rounds3", "int8-ef-rounds2",
                              "int8-mixed-rounds2-overlap", "int8-gossip-rounds2"])
def test_int8_multi_round_wires_bitwise(setup, monkeypatch, name, mu, n, topo,
                                        steps, knobs):
    _teacher_forced(setup, monkeypatch, name, mu, n, topo, steps, knobs)


RINGS = [
    (2, "straggler:1:1"), (4, "stall:2:1:3"), (2, "drop:0:2"),
    (2, "straggler:1:2,droplink:3:1:1:2"), (4, "straggler:1:1,drop:0:2"),
]


@pytest.mark.parametrize("staleness,faults", RINGS,
                         ids=[f"S{s}-{f}" for s, f in RINGS])
def test_staleness_ring_bitwise(setup, monkeypatch, staleness, faults):
    jt, tt = _teacher_forced(
        setup, monkeypatch, "cdmsgd", 0.9, 5, "fully_connected", 6,
        {"exchange": "int8", "schedule": "overlap", "staleness": staleness,
         "fault_schedule": faults})
    ring = tt.state.opt_state.wire
    assert isinstance(ring, tcons.WireRing)
    assert ring.slots[0][0].shape[1] == staleness
    # the carried counter recurrence sits on the host table's steady state
    tb = tt.program.faults.tables(staleness)
    t = tt.state.opt_state.step % tt.program.faults.period
    np.testing.assert_array_equal(ring.send_age.numpy(), tb["send_age"][t])


def test_staleness_ring_f32_free_running(setup):
    train, jp = setup
    jt, tt = _trainers(jp, "cdsgd", 5, "ring", None, schedule="overlap",
                       staleness=4, fault_schedule="stall:2:1:3,drop:0:1")
    batches = JPartitioner(train, 5, seed=0).batches(64)
    for _ in range(8):
        b = next(batches)
        jt.step(b), tt.step(b)
    gap = _param_gap(jt, tt)
    print(f"f32 ring S=4: max param gap after 8 steps {gap:.2e}")
    assert gap <= PARAM_ATOL


def test_fedavg_partial_participation_tracks_jax(setup):
    train, jp = setup
    spec = "straggler:1:1,stall:3:1:2"
    for mu, e in ((0.9, 2), (0.0, 1)):
        jt = JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                      jp, jmake_topology("fully_connected", 5),
                      jmake_optimizer("fedavg", 0.05, local_steps=e, mu=mu,
                                      faults=jfaults.make_fault_schedule(spec, 5)))
        tt = CollaborativeTrainer(
            functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            make_topology("fully_connected", 5),
            make_optimizer("fedavg", 0.05, local_steps=e, mu=mu,
                           faults=tfaults.make_fault_schedule(spec, 5)),
            device="cpu")
        batches = JPartitioner(train, 5, seed=0).batches(64)
        for _ in range(6):
            b = next(batches)
            jt.step(b), tt.step(b)
        gap = _param_gap(jt, tt)
        print(f"fedavg E={e} mu={mu} faults {spec}: max param gap {gap:.2e}")
        assert gap <= PARAM_ATOL
        assert tt.wire_bytes_per_step == jt.wire_bytes_per_step


def test_fedavg_with_nobody_present_keeps_local_params():
    """A sync step where every agent straggles: no sync happens."""
    a = 3
    f = tfaults.FaultSchedule("all", a, 2, np.array([[False] * a, [True] * a]),
                              np.ones((2, a, a), bool))
    opt = make_optimizer("fedavg", 0.1, faults=f)
    comm = stacked_comm_ops(make_topology("fully_connected", a), device="cpu")
    p = {"w": torch.arange(6, dtype=torch.float32).reshape(a, 2)}
    g = {"w": torch.ones(a, 2)}
    st = opt.init(p)
    p1, st = opt.update(p, g, st, comm)          # step 0: everyone present
    assert torch.allclose(p1["w"], p1["w"].mean(0, keepdim=True).expand(a, 2))
    p2, st = opt.update(p, g, st, comm)          # step 1: nobody present
    assert torch.equal(p2["w"], p["w"] - 0.1)


@pytest.mark.parametrize("spec,n,rounds", [("gossip:8", 5, 1), ("alternating", 8, 2),
                                           ("ring", 5, 3), ("alternating:ring:star", 6, 2)])
def test_exchange_bytes_rounds_and_schedule_degree(spec, n, rounds):
    params = {"w": np.zeros((n, 300, 7), np.float32), "b": np.zeros((n, 33), np.float32)}
    js = jfb.make_flat_spec(params, lead=1)
    ts = tfb.make_flat_spec({k: torch.from_numpy(v) for k, v in params.items()},
                            lead=1)
    jsched = jtopo.make_topology_schedule(spec, n)
    tsched = ttopo.make_topology_schedule(spec, n)
    for exchange in ("f32", "bf16", "int8"):
        for payloads in (1, 2):
            assert tcons.exchange_bytes_per_step(ts, tsched, exchange, rounds,
                                                 payloads) == \
                jcons.exchange_bytes_per_step(js, jsched, exchange, rounds,
                                              payloads)
    kw = {"strategy": "time_varying"} if jsched.period > 1 else {}
    jprog = jcons.make_mixing_program(jsched, rounds=rounds, exchange="int8", **kw)
    tprog = tcons.make_mixing_program(tsched, rounds=rounds, exchange="int8", **kw)
    assert tcons.exchange_bytes_per_step(ts, tsched, rounds=rounds, program=tprog) \
        == jcons.exchange_bytes_per_step(js, jsched, rounds=rounds, program=jprog)
    assert tsched.mean_degree() == jsched.mean_degree()
    jtp = {k: jnp.asarray(v) for k, v in params.items()}
    ttp = {k: torch.from_numpy(v) for k, v in params.items()}
    assert tcons.describe_exchange_cost(ttp, tsched, "int8", rounds=rounds) == \
        jcons.describe_exchange_cost(jtp, jsched, "int8", rounds=rounds)


@pytest.mark.parametrize("exchange", ["int8", "f32"])
def test_ring_wire_bytes_are_one_generation(setup, exchange):
    _, jp = setup
    out = {}
    for s in (1, 2, 4):
        knobs = dict(exchange=exchange, schedule="overlap", staleness=s,
                     fault_schedule="straggler:1:1" if s > 1 else None)
        jt, tt = _trainers(jp, "cdmsgd", 5, "ring", 0.9, **knobs)
        tw, jw = tt.state.opt_state.wire, jt.state.opt_state.wire
        assert isinstance(tw, tcons.WireRing) == (s > 1)
        out[s] = tengine.wire_bytes_per_neighbor(tw)
        assert out[s] == jengine.wire_bytes_per_neighbor(jw)
        spec = tfb.make_flat_spec(tt.state.params, lead=1)
        assert out[s] * 2 == tt.wire_bytes_per_step == \
            spec.exchange_bytes(exchange) * 2
    assert out[1] == out[2] == out[4]


REJECT = {
    "static-with-period-2": ("sched", {"strategy": "static"}),
    "multi-round-with-period-2": ("sched", {"strategy": "multi_round", "rounds": 2}),
    "rounds-0": ("topo", {"rounds": 0}),
    "rounds-float": ("topo", {"rounds": 1.5}),
    "unknown-strategy": ("topo", {"strategy": "bogus"}),
    "staleness-0": ("topo", {"staleness": 0}),
    "faults-not-a-schedule": ("topo", {"faults": "straggler:1:1"}),
    "faults-wrong-agents": ("topo", {"faults": ("straggler:1:1", 4)}),
    "ef-with-staleness": ("topo", {"exchange": "int8", "error_feedback": True,
                                   "staleness": 2}),
    "ef-with-faults": ("topo", {"exchange": "int8", "error_feedback": True,
                                "faults": ("drop:0:1", 5)}),
    "topk-with-staleness": ("topo", {"compressor": "topk:0.1",
                                     "error_feedback": True, "staleness": 2}),
    "rank-with-rounds": ("topo", {"compressor": "rank:2", "error_feedback": True,
                                  "rounds": 2}),
    "topk-multi-round": ("topo", {"compressor": "topk:0.1", "error_feedback": True,
                                  "strategy": "multi_round"}),
    "not-a-topology": ("str", {}),
    "ef-on-f32-rounds": ("topo", {"error_feedback": True, "rounds": 3}),
}


@pytest.mark.parametrize("case", list(REJECT))
def test_program_rejections_match_reference(case):
    first, kw = REJECT[case]

    def attempt(topo, faults, cons):
        args = dict(kw)
        if isinstance(args.get("faults"), tuple):
            spec, n = args["faults"]
            args["faults"] = faults.make_fault_schedule(spec, n)
        x = {"sched": topo.make_topology_schedule("alternating:ring:star", 5),
             "topo": topo.make_topology("ring", 5), "str": "ring"}[first]
        return cons.make_mixing_program(x, **args)

    with pytest.raises(Exception) as j:
        attempt(jtopo, jfaults, jcons)
    with pytest.raises(type(j.value)):
        attempt(ttopo, tfaults, tcons)


@pytest.mark.parametrize("case", ["staleness-sync", "faults-sync", "unfused-rounds",
                                  "mixed-cdsgd-rounds", "schedule-agents"])
def test_trainer_rejections_match_reference(setup, case):
    _, jp = setup
    name, fused, knobs = {
        "staleness-sync": ("cdmsgd", True, {"exchange": "int8", "staleness": 2}),
        "faults-sync": ("cdmsgd", True, {"fault_schedule": "drop:0:1"}),
        "unfused-rounds": ("cdsgd", False, {"consensus_rounds": 2}),
        "mixed-cdsgd-rounds": ("cdsgd", True, {"consensus_rounds": 2,
                                               "momentum_mixing": "mixed"}),
        "schedule-agents": ("cdsgd", True, {"mixing_strategy": "time_varying",
                                            "topology_schedule": "gossip:4"}),
    }[case]
    kw = {"mu": 0.9} if name == "cdmsgd" else {}
    topo = 5
    if case == "schedule-agents":      # a 4-agent schedule on 5 agents
        knobs = dict(knobs, topology_schedule=None)
        jknobs = dict(knobs, topology_schedule=jtopo.make_topology_schedule(
            "gossip:4", 4))
        tknobs = dict(knobs, topology_schedule=ttopo.make_topology_schedule(
            "gossip:4", 4))
    else:
        jknobs = tknobs = knobs
    with pytest.raises(Exception) as j:
        JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                 jp, jmake_topology("ring", topo),
                 jmake_optimizer(name, 0.05, fused=fused, **kw), **jknobs)
    with pytest.raises(type(j.value)):
        CollaborativeTrainer(
            functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            make_topology("ring", topo),
            make_optimizer(name, 0.05, fused=fused, **kw), device="cpu", **tknobs)


def test_time_varying_exchange_needs_the_step():
    prog = tcons.make_mixing_program(ttopo.make_topology_schedule("gossip:4", 4),
                                     strategy="time_varying")
    fl = tcons.stacked_flat_comm(None, program=prog, device="cpu")
    assert type(fl.strategy).__name__ == "TimeVaryingMixing"
    wire = fl.strategy.quantize_stage([torch.zeros(4, 2, 128)], 0)
    with pytest.raises(ValueError, match="optimizer step"):
        fl.strategy.exchange_stage(wire, None)
    for step in range(6):      # the weights row of step t is Pi_{t % 4}
        _, w, _ = fl.strategy.exchange_stage(wire, step)
        assert w.is_contiguous() and w.data_ptr() % 16 == 0   # the kernels' rule
        np.testing.assert_array_equal(
            w.numpy(), tcons._self_separated_weights(
                prog.schedule.topology_at(step).pi).astype(np.float32))
