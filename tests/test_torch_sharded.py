"""The sharded mode (one agent per process, ``repro_torch.launch.steps``)
against the port's stacked trainer, on the CPU.

Four ``gloo`` ranks (a ``FileStore``, spawned once for the module) train
reduced gemma3-1b in float32 through ``build_train_step`` from the same
de-synchronized initial state and ``lm_agent_batches`` as the stacked
``CollaborativeTrainer``, for every configuration of :data:`CONFIGS`:

* the update phase teacher-forced from the stacked trainer's state after
  one step and its gradients of the next, bit for bit (``torch.equal``)
  in every fused configuration: the ranks order their received stencil by
  sender, so the kernels sum the stacked row's non-zero terms in the same
  order;
* three whole steps within 1e-5 (the grad phase without ``vmap`` rounds
  differently from the stacked one);
* per step, the exchange's census against the closed form: one send per
  non-identity shift per bucket per payload per wire field (the payload;
  x2 with the row scales of an int8 / fp8 wire; the three compact fields
  of a top-k wire, the two factors of a rank-r wire; x rounds), the bytes
  ``program_bytes_per_neighbor`` times the neighbours (the top-k wire's
  compact bytes; the staleness ring's those of the plain overlap wire, one
  generation, also counted from the carried ring);
* under overlap, the tensors posted are the carried wire's (by
  ``data_ptr``: the ring's selected slot, the compact fields), posted
  before the grad phase;
* the per-leaf ``ppermute`` / ``dense`` mixings and the mean baselines
  (FedAvg with partial participation too) within 1e-6 of the stacked
  ones.

The rank-r compressor's update phase is bit for bit too: its power
iteration is a float64 product per agent, and the stacked trainer's
batched product computes each agent's alone, as one agent's here.

The knobs the sharded mode does not run yet raise at build time, naming
their ROADMAP items; a failing rank fails the spawn with its traceback.
"""

import concurrent.futures
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, InputShape, RunConfig  # noqa: E402
from repro_torch.core import consensus as consensus_lib  # noqa: E402
from repro_torch.core import engine, make_topology, make_topology_schedule  # noqa: E402
from repro_torch.core.flatbuf import make_flat_spec  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import lm_agent_batches, make_lm_tokens  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as shlib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import partition_specs, stack_agent_axis  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

AGENTS, BATCH, SEQ, STEPS = 4, 2, 16, 3
STEP_TOL = 1e-5          # abs, whole fused steps against the stacked trainer
PLAIN_TOL = 1e-6         # abs, per-leaf mixings and mean baselines
JOIN_S = 300             # the spawn's time limit (the ranks' collectives: 60 s)
TOPK_AUTO = "topk:auto:65536"    # 101 of the bucket's 9,738 rows a neighbour


def _cfg(optimizer, topology="ring", mixing="ppermute_fused", fused=True,
         teacher=True, opt_faults=None, **knobs):
    return {"optimizer": optimizer, "topology": topology, "mixing": mixing,
            "fused": fused, "teacher": teacher, "opt_faults": opt_faults,
            "knobs": knobs}


CONFIGS = {
    "cdsgd-f32-sync": _cfg("cdsgd"),
    "cdsgd-f32-sync-fc": _cfg("cdsgd", "fully_connected"),
    "cdmsgd-int8-sync": _cfg("cdmsgd", exchange="int8"),
    "cdmsgd-int8-overlap": _cfg("cdmsgd", exchange="int8", schedule="overlap"),
    "cdmsgd-int8-overlap-fc": _cfg("cdmsgd", "fully_connected", exchange="int8",
                                   schedule="overlap"),
    "nesterov-int8-ef": _cfg("cdmsgd_nesterov", exchange="int8",
                             error_feedback=True),
    "cdadam-fp8-overlap": _cfg("cdadam", exchange="fp8", schedule="overlap"),
    "cdsgd-int8-rounds2": _cfg("cdsgd", exchange="int8", consensus_rounds=2),
    "cdsgd-time-varying": _cfg("cdsgd", mixing_strategy="time_varying",
                               topology_schedule="alternating:ring:fully_connected"),
    "cdmsgd-int8-mixed": _cfg("cdmsgd", exchange="int8", momentum_mixing="mixed"),
    "cdmsgd-bf16-overlap-mixed": _cfg("cdmsgd", exchange="bf16", schedule="overlap",
                                      momentum_mixing="mixed"),
    "cdsgd-ppermute": _cfg("cdsgd", mixing="ppermute", fused=False, teacher=False),
    "cdsgd-dense": _cfg("cdsgd", mixing="dense", fused=False, teacher=False),
    "sgd": _cfg("sgd", mixing="dense", fused=False, teacher=False),
    "msgd": _cfg("msgd", mixing="ppermute", fused=False, teacher=False),
    "fedavg": _cfg("fedavg", mixing="dense", fused=False, teacher=False),
    # the staleness ring under faults: the drop hits a ring neighbour
    # (agent 0's link from agent 1; drop:0:2 would be vacuous on 4)
    "cdsgd-int8-overlap-ring2-faults": _cfg(
        "cdsgd", exchange="int8", schedule="overlap", staleness=2,
        fault_schedule="straggler:1:1,drop:0:1"),
    "cdmsgd-int8-overlap-stall": _cfg("cdmsgd", exchange="int8",
                                      schedule="overlap", staleness=4,
                                      fault_schedule="stall:2:1:3"),
    "cdsgd-topk-ef-overlap": _cfg("cdsgd", compressor="topk:0.1",
                                  error_feedback=True, schedule="overlap"),
    "nesterov-topk-ef-sync-dense": _cfg("cdmsgd_nesterov", compressor="topk:0.1",
                                        error_feedback=True, sparse_update=False),
    "cdadam-topk-auto-ef-sync": _cfg("cdadam", compressor=TOPK_AUTO,
                                     error_feedback=True),
    "cdmsgd-rank4-ef-sync": _cfg("cdmsgd", compressor="rank:4",
                                 error_feedback=True),
    "fedavg-faults": _cfg("fedavg", mixing="dense", fused=False, teacher=False,
                          opt_faults="straggler:1:1"),
}
FUSED = [k for k, v in CONFIGS.items() if v["mixing"] == "ppermute_fused"]
PLAIN = [k for k, v in CONFIGS.items() if v["mixing"] != "ppermute_fused"]


def _stacked_trainer(name, p0):
    spec = CONFIGS[name]
    cfg = ranks.lm_config()
    knobs = dict(spec["knobs"])
    if "topology_schedule" in knobs:
        knobs["topology_schedule"] = make_topology_schedule(
            knobs["topology_schedule"], AGENTS)
    tr = CollaborativeTrainer(
        lambda p, b: tt.loss_fn(cfg, p, b), tree_map(lambda x: x[0], p0),
        make_topology(spec["topology"], AGENTS),
        ranks.make_opt(spec["optimizer"], spec["fused"], spec["opt_faults"],
                       AGENTS), device="cpu", **knobs)
    tr.state = TrainState(params=tree_map(torch.clone, p0),
                          opt_state=tr._program.init_state(
                              tree_map(torch.clone, p0)))
    return tr


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The stacked trainer's runs (expected) and the four ranks' (got).

    The parent takes one thread (``torch``'s default of one per core, beside
    other test processes, stalls at every parallel region) and finishes the
    stacked runs while the ranks run: it writes the first step's teachers,
    starts the spawn, then takes the stacked trainers through the rest."""
    cfg = ranks.lm_config()
    rng = np.random.default_rng(1)
    base = ranks.live_params(tt.model_template(cfg), seed=0)
    p0 = tree_map(lambda x: torch.from_numpy(np.stack([
        x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
        for _ in range(AGENTS)])), base)
    stream = lm_agent_batches(make_lm_tokens(1 << 13, vocab=cfg.vocab_size,
                                             seed=0), AGENTS, BATCH, SEQ, seed=0)
    batches = [next(stream) for _ in range(STEPS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        expected, teacher, trainers = {}, {}, {}
        for name, spec in CONFIGS.items():
            tr = trainers[name] = _stacked_trainer(name, p0)
            tr.step(batches[0])
            if spec["teacher"]:
                st = _clone(tr.state)
                prog = tr._program
                gp = tr.optimizer.grad_params(st.params, st.opt_state)
                _, grads = prog.grad_phase(gp, {k: torch.as_tensor(v)
                                                for k, v in batches[1].items()})
                teacher[name] = {"params": _clone(st.params),
                                 "opt_state": _clone(st.opt_state),
                                 "grads": _clone(grads)}
                with torch.no_grad():
                    want = prog.update_phase(st.params, grads, st.opt_state)
                expected[name + "/update"] = _clone(want)
        path = str(tmp_path_factory.mktemp("sharded") / "inputs.pt")
        torch.save({"configs": CONFIGS, "P0": p0, "batches": batches,
                    "teacher": teacher, "seq": SEQ, "batch": BATCH}, path)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            got = pool.submit(mesh_lib.spawn_agents, ranks.run_configs, AGENTS,
                              args=(path,), backend="gloo", device="cpu",
                              timeout=60, join_timeout=JOIN_S)
            for name, tr in trainers.items():
                for b in batches[1:]:
                    tr.step(b)
                expected[name] = {"params": _clone(tr.state.params),
                                  "spec": make_flat_spec(tr.state.params, lead=1),
                                  "program": tr.program}
            got = got.result()
    finally:
        torch.set_num_threads(threads)
    return expected, got


def _max_gap(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("name", [k for k in FUSED if CONFIGS[k]["teacher"]])
def test_update_phase_bitwise(runs, name):
    expected, got = runs
    want_p, want_s = expected[name + "/update"]
    for r in range(AGENTS):
        p, s = got[r][name]["update"]
        wp, ws = steps_lib.local_train_state(want_p, want_s, r)
        assert ranks.leaves_equal(p, wp), f"{name}: rank {r} params differ"
        assert ranks.leaves_equal(s.inner, ws.inner), f"{name}: rank {r} state"
        assert ranks.leaves_equal(s.wire, ws.wire), f"{name}: rank {r} wire"
        assert ranks.leaves_equal(s.residual, ws.residual), \
            f"{name}: rank {r} residual"
        assert ranks.leaves_equal(s.qwarm, ws.qwarm), f"{name}: rank {r} qwarm"
        assert s.step == ws.step


@pytest.mark.parametrize("name", FUSED)
def test_whole_steps_match_stacked(runs, name):
    expected, got = runs
    want = expected[name]["params"]
    gaps = [_max_gap(got[r][name]["params"], tree_map(lambda x: x[r], want))
            for r in range(AGENTS)]
    print(f"{name}: sharded vs stacked after {STEPS} steps, max gap {max(gaps):.3e}")
    assert max(gaps) <= STEP_TOL
    for r in range(AGENTS):
        assert all(np.isfinite(s["loss"]) for s in got[r][name]["steps"])


@pytest.mark.parametrize("name", PLAIN)
def test_plain_mixings_and_means_match_stacked(runs, name):
    expected, got = runs
    want = expected[name]["params"]
    gaps = [_max_gap(got[r][name]["params"], tree_map(lambda x: x[r], want))
            for r in range(AGENTS)]
    print(f"{name}: per-leaf / mean path vs stacked, max gap {max(gaps):.3e}")
    assert max(gaps) <= PLAIN_TOL


@pytest.mark.parametrize("name", FUSED)
def test_census_equals_closed_form(runs, name):
    expected, got = runs
    spec, program = expected[name]["spec"], expected[name]["program"]
    fields = {"topk": 3, "rank": 2, "int8": 2, "fp8": 2}.get(
        program.compressor_kind if program.compressed else program.exchange, 1)
    per_neighbor = consensus_lib.program_bytes_per_neighbor(spec, program)
    if program.fault_tolerant:      # the ring moves what plain overlap moves
        plain = consensus_lib.make_mixing_program(
            program.schedule, exchange=program.exchange)
        assert consensus_lib.program_bytes_per_neighbor(spec, plain) \
            == per_neighbor
    for step in range(STEPS):
        topo = program.schedule.topologies[step % program.schedule.period]
        n_shifts = sum(1 for s in topo.shift_weights() if s % AGENTS)
        sends = (n_shifts * spec.n_buckets * program.n_payloads * fields
                 * program.rounds)
        want_bytes = per_neighbor * n_shifts * program.rounds
        for r in range(AGENTS):
            got_step = got[r][name]["steps"][step]
            if got_step["wire_bytes"] is not None:
                assert got_step["wire_bytes"] == per_neighbor, (name, step)
            c = got_step["census"]
            assert c["sends"] == sends and c["recvs"] == sends, (name, step, c)
            assert c["bytes_sent"] == want_bytes == c["bytes_received"], \
                (name, step, c, want_bytes)
            assert c["posts"] == program.rounds
            assert c["staged_bytes"] == 0          # CPU tensors go straight


@pytest.mark.parametrize("name", [k for k in FUSED
                                  if CONFIGS[k]["knobs"].get("schedule") == "overlap"])
def test_overlap_posts_the_carried_wire_before_the_grad_phase(runs, name):
    _, got = runs
    for r in range(AGENTS):
        for step in got[r][name]["steps"]:
            events = step["events"]
            assert events[0] == ("post", step["posted"]), (name, events[:2])
            assert events[1][0] == "grad"
            waits = [i for i, e in enumerate(events) if e[0] == "wait"]
            grads = [i for i, e in enumerate(events) if e[0] == "grad"]
            assert waits and waits[0] > max(grads)


@pytest.mark.parametrize("name", FUSED)
def test_every_rank_certifies_the_wire_contract(runs, name):
    """``check_bundle`` over one more step (a period of a time-varying
    schedule) on every rank: every rule passes, the census equals its
    closed form, the in-place contract holds launch by launch."""
    _, got = runs
    for r in range(AGENTS):
        rep = got[r][name]["check"]
        bad = [(x["rule"], x["detail"]) for x in rep["rules"] if not x["ok"]]
        assert rep["ok"], (name, r, bad)
        rules = {x["rule"]: x for x in rep["rules"]}
        assert not rules["census.ppermute_count"]["skipped"]
        assert not rules["bytes.hlo_collective_permute"]["skipped"]
        assert not rules["alias.fused_coverage"]["skipped"]
        assert rules["census.critical_path"]["evidence"]["actual_carried"] == (
            rules["census.critical_path"]["evidence"]["predicted_carried"])


def test_a_sync_program_claimed_as_overlap_fails_the_critical_path(runs):
    """The deliberate breakage of the sharded census: the sync step's
    transfers follow the grad phase and send fresh buckets, so the carried
    transfers the overlap claim predicts are missing."""
    _, got = runs
    for r in range(AGENTS):
        rep = got[r][ranks.CLAIMED_OVERLAP]["claimed_overlap"]
        rules = {x["rule"]: x for x in rep["rules"]}
        cp = rules["census.critical_path"]
        assert not rep["ok"] and not cp["ok"], cp
        assert cp["evidence"]["actual_carried"] == 0
        assert cp["evidence"]["predicted_carried"] > 0
        assert "critical path" in cp["detail"]
        assert rules["census.ppermute_count"]["ok"]


def test_sync_exchange_follows_the_grad_phase(runs):
    _, got = runs
    events = got[0]["cdmsgd-int8-sync"]["steps"][1]["events"]
    assert [e[0] for e in events] == ["grad", "post", "wait"]


def _mesh(rank=0, size=AGENTS, axes=None):
    return mesh_lib.AgentMesh(rank=rank, size=size, backend="gloo", group=None,
                              device=torch.device("cpu"), axes=axes)


def _build(**kw):
    cfg = ranks.lm_config()
    opt = kw.pop("opt", None) or ranks.make_opt("cdmsgd", True)
    return steps_lib.build_train_step(
        cfg, InputShape("t", SEQ, BATCH * AGENTS, "train"), _mesh(), opt,
        mixing=kw.pop("mixing", "ppermute_fused"), **kw)


@pytest.mark.parametrize("kw,err,item", [
    ({"remat": True}, None, "A17.3"),
    ({"mode": "train_hier"}, NotImplementedError, "A16.2.2"),
    ({"mode": "serve"}, ValueError, "no agent axis"),
], ids=["remat", "train_hier", "serve"])
def test_later_knobs_raise_at_build(kw, err, item):
    """What the sharded mode does not run raises its queue item at build
    time; ``remat=True`` (ROADMAP A17.3, refused before it was ported) now
    builds, and is the default (``test_torch_remat.py`` holds its steps).
    ``mode="serve"`` has no agent axis to train over: it serves through
    ``build_prefill_step`` / ``build_serve_step``
    (``test_torch_sharded_serve.py``)."""
    if err is None:
        assert _build(**kw).grad_phase is not None
        return
    with pytest.raises(err, match=item):
        _build(**kw)


_MODEL_MESH = {"data": 2, "model": 2}


def _serve_step():
    """A family whose serve mode over the model axis is queued."""
    steps_lib.build_serve_step(get_config("rwkv6-1.6b").reduced(),
                               InputShape("d", SEQ, 4, "decode"),
                               _mesh(axes=_MODEL_MESH))


def _prefill_step():
    """``context_parallel``: the flash kernel takes no query offset."""
    steps_lib.build_prefill_step(ranks.lm_config(),
                                 InputShape("p", SEQ, 4, "prefill"),
                                 _mesh(axes=_MODEL_MESH), context_parallel=True)


def _model_axes():
    """Training over a model axis of more than one rank: the dense family
    builds (``tp`` over ``model``); MoE's ``expert`` split raises its item
    (ROADMAP A16.2.3)."""
    shape = InputShape("t", SEQ, BATCH * AGENTS, "train")
    b = steps_lib.build_train_step(ranks.lm_config(), shape, _mesh(axes=_MODEL_MESH),
                                   ranks.make_opt("cdmsgd", True),
                                   mixing="ppermute_fused")
    assert b.tp is not None and b.tp.heads and b.n_agents == 2
    steps_lib.build_train_step(get_config("kimi-k2-1t-a32b").reduced(), shape,
                               _mesh(axes=_MODEL_MESH), ranks.make_opt("cdmsgd", True),
                               mixing="ppermute_fused")


@pytest.mark.parametrize("kw,want", [
    ({"staleness": 2, "schedule": "overlap", "exchange": "int8"}, "ring"),
    ({"fault_schedule": "straggler:1:2", "schedule": "overlap",
      "exchange": "int8"}, "ring"),
    ({"compressor": "topk:0.01", "error_feedback": True}, "topk"),
    ({"compressor": "topk:0.01", "error_feedback": True,
      "sparse_update": False}, "topk"),
    ({"compressor": "rank:4", "error_feedback": True}, "rank"),
    ({"opt": ranks.make_opt("fedavg", False, "straggler:1:1", AGENTS),
      "mixing": "dense"}, "fedavg"),
    ({"mode": "train_hier"}, None),
    ({"mode": "serve"}, "no agent axis"),
    (_model_axes, None),
    (_serve_step, None),
    (_prefill_step, None),
], ids=["staleness", "faults", "topk", "topk-dense", "rank", "fedavg-faults",
        "train_hier", "serve", "model-axes", "serve-step", "prefill-step"])
def test_agent_axis_knobs_build_and_model_axes_raise(kw, want):
    """The agent-axis knobs of ROADMAP A16.2 build; what stays A16.2's
    (MoE's expert split and the other families on the model axis, which
    the dense family trains over, ``train_hier``, the other families'
    serve steps, ``context_parallel``) still raises it; a training step in
    serve mode is refused (the serve steps are in
    ``test_torch_sharded_serve.py``, training over ``model`` in
    ``test_torch_sharded_tp.py``)."""
    if want is None:
        with pytest.raises(NotImplementedError, match="A16.2"):
            kw() if callable(kw) else _build(**kw)
        return
    if want == "no agent axis":
        with pytest.raises(ValueError, match=want):
            _build(**kw)
        return
    b = _build(**kw)
    p = b.mixing_program
    if want == "ring":
        assert p.fault_tolerant and b.comm.flat.strategy.fault_ops is not None
    elif want == "fedavg":
        assert p is None and b.comm.agent == 0 and b.optimizer.faults is not None
    else:
        assert p.compressor_kind == want and p.error_feedback


def test_model_axis_raises():
    """The logical model axes resolve (as the reference's
    ``partition_specs``); training over a model axis of more than one rank
    builds for the dense family and raises MoE's queue item (ROADMAP
    A16.2.3), and the serve steps need a mesh with a model axis."""
    tmpl = stack_agent_axis(tt.model_template(ranks.lm_config()), AGENTS)
    specs = partition_specs(tmpl, {"agent": "data", "tp": "model", "fsdp": None})
    assert specs["embed"]["table"].axes == ("data", "model")
    specs = partition_specs(tmpl, {"agent": "data"})
    assert all(s.axes == ("data",) for s in tree_leaves(specs))
    with pytest.raises(NotImplementedError, match="A16.2.3"):
        _model_axes()
    with pytest.raises(ValueError, match="model"):
        steps_lib.build_serve_step(ranks.lm_config(),
                                   InputShape("d", SEQ, 4, "decode"), _mesh())
    with pytest.raises(ValueError, match="model"):
        steps_lib.build_prefill_step(ranks.lm_config(),
                                     InputShape("p", SEQ, 4, "prefill"), _mesh())


@pytest.mark.parametrize("kw,msg", [
    ({"mixing": "dense", "opt": None}, "ppermute_fused"),
    ({"mixing": "ppermute", "schedule": "overlap",
      "opt": ranks.make_opt("cdsgd", False)}, "overlap"),
    ({"mixing": "dense", "exchange": "int8", "error_feedback": True,
      "opt": ranks.make_opt("cdsgd", False)}, "flat-buffer"),
    ({"topology_name": "star"}, "circulant"),
    ({"mixing": "wire"}, "unknown mixing"),
], ids=["fused-dense", "overlap-unfused", "ef-unfused", "star", "mixing"])
def test_build_refuses_what_it_cannot_run(kw, msg):
    with pytest.raises(ValueError, match=msg):
        _build(**kw)


def test_bundle_shapes_and_specs():
    b = _build(exchange="int8", schedule="overlap")
    cfg = ranks.lm_config()
    assert b.n_agents == AGENTS and b.exchange == "int8"
    assert b.schedule == "overlap" and b.mixing_program.exchange == "int8"
    lt = tree_leaves(b.local_template)
    st = tree_leaves(b.param_template)
    assert all(s.shape == (AGENTS,) + l.shape for s, l in zip(st, lt))
    bs = b.batch_specs["inputs"]
    assert bs.shape == (AGENTS, BATCH, SEQ) and bs.dtype == torch.int32
    assert bs.spec.axes == (("data",), None, None)
    assert shlib.agent_count(_mesh(), "train") == AGENTS
    assert all(s.axes == (("data",),) for s in tree_leaves(b.param_specs))
    with pytest.raises(ValueError, match="divisible"):
        shlib.train_batch_specs(cfg, InputShape("t", 8, 6, "train"), _mesh(),
                                "train")
    assert INPUT_SHAPES["train_4k"].global_batch == 256
    assert RunConfig().n_agents == 5


@pytest.mark.parametrize("exchange", ["int8", "fp8"])
def test_local_initializers_build_the_bundles_state(exchange):
    b = _build(exchange=exchange, schedule="overlap", error_feedback=True)
    rng = np.random.default_rng(3)
    params = tree_map(lambda pd: torch.from_numpy(
        rng.normal(size=pd.shape).astype(np.float32)), b.local_template)
    state = b.init_state(params)
    wire = engine.make_local_wire_init(b.comm.flat)(params)
    residual = engine.make_local_residual_init(b.comm.flat)(params)
    assert ranks.leaves_equal(wire, state.wire)
    assert ranks.leaves_equal(residual, state.residual)
    assert all(t.shape[0] == 1 for t in tree_leaves(state.wire))
    assert all(t.shape[0] == 1 for t in tree_leaves(state.residual))


def test_local_batch_and_state_rows():
    batch = {"inputs": np.arange(24).reshape(4, 2, 3)}
    got = shlib.local_batch(batch, _mesh(rank=2))
    assert torch.equal(got["inputs"], torch.as_tensor(batch["inputs"][2]))
    with pytest.raises(ValueError, match="agents"):
        shlib.local_batch(batch, _mesh(rank=0, size=3))


def test_a_failing_rank_fails_the_spawn():
    with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
        mesh_lib.spawn_agents(ranks.fail_on, 2, args=(1,), backend="gloo",
                              device="cpu", timeout=30, join_timeout=120)


def test_nccl_needs_a_card_per_rank():
    with pytest.raises((ValueError, RuntimeError)):
        mesh_lib.init_agent_mesh(0, 2, backend="nccl", init_method="file:///x",
                                 device="cpu")
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.init_agent_mesh(0, 2, backend="mpi", init_method="file:///x",
                                 device="cpu")
