"""The sharded mode on a factored ``pod x data`` agent mesh, on the CPU.

Four ``gloo`` ranks on ``pod 2 x data 2`` (rank ``pod * 2 + data``, one
spawn for the module) against the port's stacked trainer on
``Topology(pi = kron(Pi_pod, Pi_data))``, the factors the reference's
``_agent_factors`` picks (fully connected on an axis of 2 agents):

* fused int8 CDMSGD's update phase teacher-forced bit for bit: every
  factor weight is 1/2, so each product of factor weights is the dense
  Kronecker entry 1/4 exactly, and the received stencil is ordered by
  sender as the stacked row's terms;
* one whole step within 1e-5 and its census: one transfer per non-identity
  shift combination (3) per wire field (int8 payload and row scales);
* the per-leaf ``FactoredMix.make_mix_fn`` mixing (one factor, one axis,
  after the other) within 1e-6 of ``Pi x``;
* ``lambda2`` / ``lambdan`` equal to the reference's ``FactoredMix`` on
  the same factors.

Without a spawn: the stencil plans of a ``pod 2 x data 3`` mesh (a ring
on ``data``) against the rows of its Kronecker product, and the
time-varying and fault-tolerant programs on a factored mesh refused with
the reference's words.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks  # noqa: E402

from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import consensus as consensus_lib  # noqa: E402
from repro_torch.core import make_topology  # noqa: E402
from repro_torch.core.flatbuf import make_flat_spec  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import lm_agent_batches, make_lm_tokens  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as shlib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

AXES = {"pod": 2, "data": 2}
AGENTS, BATCH, SEQ = 4, 2, 16
STEP_TOL = 1e-5          # abs, a whole step against the stacked trainer
MIX_TOL = 1e-6           # abs, the per-leaf factored mixing against Pi x


def _kron() -> np.ndarray:
    fc = make_topology("fully_connected", 2).pi
    return np.kron(fc, fc)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = ranks.lm_config()
    rng = np.random.default_rng(2)
    base = ranks.live_params(tt.model_template(cfg), seed=0)
    p0 = tree_map(lambda x: torch.from_numpy(np.stack([
        x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
        for _ in range(AGENTS)])), base)
    stream = lm_agent_batches(make_lm_tokens(1 << 13, vocab=cfg.vocab_size,
                                             seed=0), AGENTS, BATCH, SEQ, seed=0)
    batches = [next(stream) for _ in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = CollaborativeTrainer(
            lambda p, b: tt.loss_fn(cfg, p, b), tree_map(lambda x: x[0], p0),
            Topology(name="kron", pi=_kron()), ranks.make_opt("cdmsgd", True),
            device="cpu", exchange="int8")
        prog = tr._program

        def fresh():
            return TrainState(params=_clone(p0),
                              opt_state=prog.init_state(_clone(p0)))

        tr.state = fresh()
        tr.step(batches[0])
        st = _clone(tr.state)
        gp = tr.optimizer.grad_params(st.params, st.opt_state)
        _, grads = prog.grad_phase(gp, {k: torch.as_tensor(v)
                                        for k, v in batches[1].items()})
        teacher = {"params": _clone(st.params),
                   "opt_state": _clone(st.opt_state), "grads": _clone(grads)}
        with torch.no_grad():
            want_update = _clone(prog.update_phase(st.params, grads,
                                                   st.opt_state))
        tr.state = fresh()
        tr.step(batches[0])
        want_step = _clone(tr.state.params)
        path = str(tmp_path_factory.mktemp("factored") / "inputs.pt")
        torch.save({"P0": p0, "batches": batches, "teacher": teacher,
                    "seq": SEQ, "batch": BATCH}, path)
        got = mesh_lib.spawn_agents(ranks.run_factored, AGENTS, args=(path,),
                                    backend="gloo", device="cpu", timeout=60,
                                    join_timeout=300, axes=AXES)
    finally:
        torch.set_num_threads(threads)
    return {"update": want_update, "step": want_step, "p0": p0,
            "spec": make_flat_spec(p0, lead=1), "program": tr.program}, got


def test_factored_update_phase_bitwise(runs):
    want, got = runs
    wp, ws = want["update"]
    for r in range(AGENTS):
        p, s = got[r]["update"]
        lp, ls = steps_lib.local_train_state(wp, ws, r)
        assert ranks.leaves_equal(p, lp), f"rank {r}: params"
        assert ranks.leaves_equal(s.inner, ls.inner), f"rank {r}: momentum"
        assert s.step == ls.step


def test_factored_step_and_census(runs):
    want, got = runs
    spec, program = want["spec"], want["program"]
    per_neighbor = consensus_lib.program_bytes_per_neighbor(spec, program)
    shifts = 3                           # (0, 1), (1, 0), (1, 1)
    for r in range(AGENTS):
        gap = max(float((x - y[r]).abs().max()) for x, y in
                  zip(tree_leaves(got[r]["step"]), tree_leaves(want["step"])))
        assert gap <= STEP_TOL, (r, gap)
        c = got[r]["census"]
        assert c["sends"] == c["recvs"] == shifts * spec.n_buckets * 2
        assert c["bytes_sent"] == c["bytes_received"] == per_neighbor * shifts
        assert got[r]["senders"] == tuple(j for j in range(AGENTS) if j != r)
        assert np.isfinite(got[r]["loss"])
        assert got[r]["topology"].startswith("factored(pod:fully_connected")


def test_factored_mix_fn_matches_kron(runs):
    want, got = runs
    pi = torch.tensor(_kron(), dtype=torch.float32)
    mixed = consensus_lib.mix_pytree_stacked(pi, want["p0"])
    gap = max(float((x - y[r]).abs().max()) for r in range(AGENTS)
              for x, y in zip(tree_leaves(got[r]["mixed"]), tree_leaves(mixed)))
    print(f"factored per-leaf mix vs kron(Pi) x: max gap {gap:.3e}")
    assert gap <= MIX_TOL


@pytest.mark.parametrize("pod,data", [(2, 2), (2, 3), (3, 4)])
def test_factored_spectrum_matches_the_reference(pod, data):
    from repro.core.consensus import FactoredMix as JaxFactoredMix
    from repro.core.topology import make_topology as jax_topology

    def name(n):
        return "ring" if n > 2 else "fully_connected"

    fm = steps_lib._agent_factors(_mesh(0, pod, data), ("pod", "data"))
    ref = JaxFactoredMix((("pod", jax_topology(name(pod), pod)),
                          ("data", jax_topology(name(data), data))))
    assert fm.n_agents == ref.n_agents == pod * data
    assert np.array_equal(fm.dense_pi(), ref.dense_pi())
    assert fm.lambda2 == pytest.approx(ref.lambda2, abs=1e-12)
    assert fm.lambdan == pytest.approx(ref.lambdan, abs=1e-12)


def _mesh(rank, pod, data):
    return mesh_lib.AgentMesh(rank=rank, size=pod * data, backend="gloo",
                              group=None, device=torch.device("cpu"),
                              axes={"pod": pod, "data": data})


def test_factored_stencil_plans_follow_the_kron_rows():
    pod, data = 2, 3
    fm = steps_lib._agent_factors(_mesh(0, pod, data), ("pod", "data"))
    pi = fm.dense_pi()
    for r in range(pod * data):
        mesh = _mesh(r, pod, data)
        plan = consensus_lib._stencil_plan(pi, fm.factors, mesh, "f")
        assert list(plan.senders) == sorted(plan.senders)
        assert set(plan.senders) == {j for j in range(pod * data)
                                     if j != r and pi[r, j] > 0}
        for s, j in zip(plan.shifts, plan.senders):
            assert mesh.peers(s)[1] == j
            pc, dc = mesh.coords(r)
            assert mesh.peers(s)[0] == mesh.rank_of((pc - s[0], dc - s[1]))
        want = np.float32([pi[r, r]] + [pi[r, j] for j in plan.senders])
        assert np.array_equal(plan.weights_q.numpy(), want)


def test_factored_mesh_rules_and_count():
    mesh = _mesh(3, 2, 2)
    assert mesh.shape == AXES and mesh.coords(3) == (1, 1)
    assert shlib.rules_for_mode("train", mesh)["agent"] == ("pod", "data")
    assert shlib.agent_count(mesh, "train") == AGENTS
    with pytest.raises(ValueError, match="cover"):
        mesh_lib.AgentMesh(rank=0, size=4, backend="gloo", group=None,
                           device=torch.device("cpu"), axes={"pod": 3, "data": 2})


@pytest.mark.parametrize("kw", [
    {"mixing_strategy": "time_varying",
     "topology_schedule": "alternating:ring:fully_connected"},
    {"schedule": "overlap", "exchange": "int8", "staleness": 2},
], ids=["time-varying", "faults"])
def test_factored_mesh_refuses_per_axis_schedules(kw):
    with pytest.raises(ValueError, match="single agent mesh axis"):
        steps_lib.build_train_step(
            ranks.lm_config(), InputShape("t", SEQ, BATCH * AGENTS, "train"),
            _mesh(0, 2, 2), ranks.make_opt("cdmsgd", True),
            mixing="ppermute_fused", **kw)
