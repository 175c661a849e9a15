"""Training over the model axis (``tp`` over ``model``, the dense family)
against the JAX package's sharded step and against the port's own
agent-only and stacked paths, on the CPU.

One JAX subprocess runs the reference's ``build_train_step(...,
mixing="ppermute_fused")`` on ``make_debug_mesh(4, 2)`` (8 host devices,
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, the idiom of
``tests/test_sharded.py::run_sub``, XLA's intra-op threads off) over
reduced granite-3-8b and reduced gemma3-1b in float32 (gemma's one KV
head replicates on ``model`` 2, its vocabulary shards and is tied), fused
CDMSGD on a ring, the f32 wire, sync, at the default ``remat=True``, three
steps from carried weights; beside it one spawn of 8 ``gloo`` ranks on
``{"data": 4, "model": 2}`` runs the same steps through the port's
``build_train_step`` on each rank's blocks:

* each rank's params within 1e-5 of max |param| of the reference's block
  ``(agent, model coordinate)``, the agents' mean loss within 1e-5
  relative;
* each leaf's gradient block against the agent's unsharded gradient,
  computed in the same rank (the replicated ``wk``, ``wv`` and norms
  included), at :data:`GRAD_TOL` of the leaf's max |g|;
* the gradients at ``remat=True`` equal to ``remat=False``'s, bit for bit;
* the update phase teacher-forced from the stacked trainer's state and
  gradients (:func:`repro_torch.launch.steps.local_train_state`), bit for
  bit against the stacked result's blocks on the f32 wire;
* the collectives over ``model`` of a grad phase, by axis, forward and
  backward, against their closed form; the int8 overlap wire's rows and
  the Census's bytes against the closed form of the local shard;
* ``all_reduce_mean`` and the dense mixing's all-gather over the agent
  plane of each rank's ``model`` coordinate: the gathers the blocks of
  that coordinate only, the mean the same bits as on an agent-only mesh of
  the plane's processes, the mixing ``Pi``'s row over the gathered blocks;
* time-varying mixing, two consensus rounds and momentum mixing
  teacher-forced bit for bit on granite's blocks, and the per-leaf
  ``ppermute`` / ``dense`` mixings and FedAvg's mean over three whole steps
  within 1e-6 of the stacked trainer;
* the wire-contract checker certifies ``overlap_int8``, ``overlap_S4_faults``
  and ``sync_tv_int8`` of the check matrix and int8 overlap with error
  feedback on ``data 4 x model 2``
  (:func:`repro_torch.launch.check.sharded_rank`).

A second spawn of 8 ranks on ``{"pod": 2, "data": 2, "model": 2}`` holds
granite's update phase bit for bit against the stacked trainer on
``kron(Pi_pod, Pi_data)``, one whole step within 1e-5, and the agent
all-gather and mean over each agent plane (a group of its own there).  Without a spawn:
what a model mesh does not train raises at build time, naming its item
(a compressor with the reference's words, MoE and the other families
A16.2.3, ``train_hier`` A16.2.2).  ``pytest -s`` prints the gaps.
"""

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks  # noqa: E402
import torch_sharded_tp_ranks as tp_ranks  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import make_topology, make_topology_schedule  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import lm_agent_batches, make_lm_tokens  # noqa: E402
from repro_torch.launch import check  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import local_shard  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"data": 4, "model": 2}
FACTORED = {"pod": 2, "data": 2, "model": 2}
ARCHS = ("granite-3-8b", "gemma3-1b")
AGENTS, BATCH, SEQ, STEPS = 4, 2, 16, 3
RANKS = AGENTS * 2
STEP_TOL = 1e-5       # of max |param|: three steps against the JAX sharded step
LOSS_TOL = 1e-5       # relative
# of each leaf's max |g|: the tensor-parallel gradient against the agent's
# unsharded one, both float32, at twice float32's own noise on these
# leaves: the unsharded float32 gradient is 1.9e-6-2.0e-6 of max |g| from
# the float64 one on the same inputs (reduced granite-3-8b and gemma3-1b,
# every leaf, CPU), and splitting a contraction over two ranks sums the
# same products in another order; the split's faults (a partial gradient
# not summed over model) are of the order of the gradient
GRAD_TOL = 4e-6
WHOLE_TOL = 1e-5      # abs, a whole step against the stacked trainer
PLAIN_TOL = 1e-6      # abs, three steps of a per-leaf mixing or mean baseline
# the wire-contract checker on data 4 x model 2: entries of the check
# matrix (the staleness ring under faults, time-varying mixing) and int8
# overlap with error feedback, whose residuals are the local shard's
CHECK_ENTRIES = [e for e in check.MATRIX if e[0] in ("overlap_int8",
                                                     "overlap_S4_faults",
                                                     "sync_tv_int8")] + [
    ("overlap_int8_ef", "cdsgd", dict(schedule="overlap", exchange="int8",
                                      error_feedback=True))]


def _prog(optimizer, mixing="ppermute_fused", fused=True, **knobs):
    return {"optimizer": optimizer, "mixing": mixing, "fused": fused,
            "knobs": knobs}


# further programs on granite's blocks: the fused ones teacher-forced (the
# f32 wire, sync: each update element is its stacked row's, so bit for
# bit), the per-leaf mixings and the mean baselines over three whole steps
MORE = {
    "cdsgd-time-varying": _prog("cdsgd", mixing_strategy="time_varying",
                                topology_schedule="alternating:ring:fully_connected"),
    "cdsgd-rounds2": _prog("cdsgd", consensus_rounds=2),
    "cdmsgd-mixed": _prog("cdmsgd", momentum_mixing="mixed"),
    "cdsgd-ppermute": _prog("cdsgd", mixing="ppermute", fused=False),
    "cdsgd-dense": _prog("cdsgd", mixing="dense", fused=False),
    "fedavg": _prog("fedavg", mixing="dense", fused=False),
}
MORE_FUSED = [k for k, v in MORE.items() if v["mixing"] == "ppermute_fused"]
MORE_PLAIN = [k for k, v in MORE.items() if v["mixing"] != "ppermute_fused"]
JOIN_S = 300

JAX_STEP = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.core.optim import make_optimizer
    from repro.launch.mesh import make_debug_mesh
    from repro.launch import steps as steps_lib

    src, out = sys.argv[1], sys.argv[2]
    data = np.load(src)
    spec = json.loads(str(data["spec"]))
    mesh = make_debug_mesh(4, 2)
    results = {}
    for arch in spec["archs"]:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  param_dtype="float32")
        shape = InputShape("tiny_train", spec["seq"], spec["batch"] * 4, "train")
        opt = make_optimizer("cdmsgd", spec["lr"], mu=spec["mu"], fused=True)
        b = steps_lib.build_train_step(cfg, shape, mesh, opt, mode="train",
                                       topology_name="ring",
                                       mixing="ppermute_fused")
        keys = spec["keys"][arch]
        leaves, treedef = jax.tree.flatten(b.param_template,
            is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "init"))
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(data[f"{arch}/p0/{k}"]) for k in keys])
        with mesh:
            state = b.init_state(params)
            step = jax.jit(b.step_fn)
            losses = []
            for i in range(spec["steps"]):
                batch = {"inputs": jnp.asarray(data[f"b{i}/inputs"]),
                         "targets": jnp.asarray(data[f"b{i}/targets"])}
                params, state, metrics = step(params, state, batch)
                losses.append(float(metrics["loss"]))
        for k, x in zip(keys, jax.tree.leaves(params)):
            results[f"{arch}/{k}"] = np.asarray(x)
        results[f"{arch}/losses"] = np.asarray(losses)
    np.savez(out, **results)
""")


def _keys(tree):
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out.append("/".join(path))

    walk(tree, ())
    return out


def _p0(arch, seed=1):
    cfg = tp_ranks.tp_config(arch)
    rng = np.random.default_rng(seed)
    base = ranks.live_params(tt.model_template(cfg), seed=0)
    return tree_map(lambda x: np.stack([
        x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
        for _ in range(AGENTS)]), base)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


def _stacked(cfg, p0, topology, spec=None):
    """The stacked trainer from ``p0`` (fused CDMSGD on the f32 wire, sync,
    or the program ``spec`` of :data:`MORE`)."""
    spec = spec or _prog("cdmsgd")
    knobs = dict(spec["knobs"])
    if "topology_schedule" in knobs:
        knobs["topology_schedule"] = make_topology_schedule(
            knobs["topology_schedule"], AGENTS)
    tr = CollaborativeTrainer(lambda p, b: tt.loss_fn(cfg, p, b),
                              tree_map(lambda x: x[0], p0), topology,
                              ranks.make_opt(spec["optimizer"], spec["fused"]),
                              device="cpu", **knobs)
    tr.state = TrainState(params=_clone(p0),
                          opt_state=tr._program.init_state(_clone(p0)))
    return tr


def _teacher(cfg, p0, batches, topology, spec=None):
    """The stacked trainer after one step from ``p0``: its state, the next
    batch's gradients and the update phase from them; and the whole first
    step."""
    tr = _stacked(cfg, p0, topology, spec)
    prog = tr._program
    tr.step(batches[0])
    first = _clone(tr.state.params)
    st = _clone(tr.state)
    gp = tr.optimizer.grad_params(st.params, st.opt_state)
    _, grads = prog.grad_phase(gp, {k: torch.as_tensor(v)
                                    for k, v in batches[1].items()})
    teacher = {"params": _clone(st.params), "opt_state": _clone(st.opt_state),
               "grads": _clone(grads)}
    with torch.no_grad():
        want = _clone(prog.update_phase(st.params, grads, st.opt_state))
    return teacher, want, first


def _batches(n=STEPS):
    stream = lm_agent_batches(make_lm_tokens(1 << 13, vocab=512, seed=0), AGENTS,
                              BATCH, SEQ, seed=0)
    return [next(stream) for _ in range(n)]


def _rank_mesh(rank, axes=AXES):
    """An unjoined view of rank ``rank`` (its blocks' slices)."""
    return mesh_lib.AgentMesh(rank=rank, size=RANKS, backend="gloo", group=None,
                              device=torch.device("cpu"), axes=axes)


def _bundle(arch, rank=0, axes=AXES, **kw):
    return steps_lib.build_train_step(
        tp_ranks.tp_config(arch), InputShape("t", SEQ, BATCH * AGENTS, "train"),
        _rank_mesh(rank, axes), ranks.make_opt("cdmsgd", True),
        topology_name="ring", mixing="ppermute_fused", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sharded step (expected), the stacked teachers and the 8
    ranks' results (got).  The parent runs on one thread beside the ranks
    (torch's thread per core stalls the suite's other processes)."""
    d = tmp_path_factory.mktemp("sharded_tp")
    p0 = {a: _p0(a) for a in ARCHS}
    batches = _batches()
    keys = {a: _keys(p0[a]) for a in ARCHS}
    arrays = {}
    for a in ARCHS:
        leaves, _ = tree_flatten(p0[a])
        arrays.update({f"{a}/p0/{k}": x for k, x in zip(keys[a], leaves)})
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    spec = {"archs": ARCHS, "keys": keys, "seq": SEQ, "batch": BATCH,
            "steps": STEPS, "lr": ranks.LR, "mu": ranks.MU}
    src, out = str(d / "inputs.npz"), str(d / "jax.npz")
    np.savez(src, spec=json.dumps(spec), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.Popen([sys.executable, "-c", JAX_STEP, src, out], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        P0 = {a: tree_map(torch.from_numpy, p0[a]) for a in ARCHS}
        teachers, want = {}, {}
        ring = make_topology("ring", AGENTS)
        for a in ARCHS:
            teachers[a], want[a], _ = _teacher(tp_ranks.tp_config(a), P0[a],
                                               batches, ring)
        granite = tp_ranks.tp_config("granite-3-8b")
        more_teacher = {}
        for name in MORE_FUSED:
            more_teacher[name], want[name], _ = _teacher(
                granite, P0["granite-3-8b"], batches, ring, MORE[name])
        path = str(d / "port.pt")
        torch.save({"archs": ARCHS, "P0": P0, "batches": batches, "seq": SEQ,
                    "batch": BATCH, "teacher": teachers, "check": CHECK_ENTRIES,
                    "more": MORE, "more_teacher": more_teacher}, path)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            got = pool.submit(mesh_lib.spawn_agents, tp_ranks.run_tp, RANKS,
                              args=(path,), backend="gloo", device="cpu",
                              timeout=60, join_timeout=JOIN_S, axes=AXES)
            for name in MORE_PLAIN:       # the stacked runs, beside the ranks
                tr = _stacked(granite, P0["granite-3-8b"], ring, MORE[name])
                for b in batches:
                    tr.step(b)
                want[name] = _clone(tr.state.params)
            got = got.result()
        _, err = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"JAX sharded step failed:\n{err[-4000:]}"
    jax_out = dict(np.load(out))
    ref = {a: {"losses": jax_out[f"{a}/losses"],
               "params": _unflatten(P0[a], [torch.from_numpy(jax_out[f"{a}/{k}"])
                                            for k in keys[a]])}
           for a in ARCHS}
    return {"P0": P0, "jax": ref, "update": want}, got


def _unflatten(like, leaves):
    from repro_torch.utils.tree import tree_unflatten

    return tree_unflatten(tree_flatten(like)[1], leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_match_the_jax_sharded_step(runs, arch):
    expected, got = runs
    ref = expected["jax"][arch]
    top = max(float(x.abs().max()) for x in tree_leaves(ref["params"]))
    gaps = []
    for r in range(RANKS):
        b = _bundle(arch, r)
        want = local_shard(ref["params"], b.param_specs, b.mesh, stacked=True)
        gaps.append(max(float((x - y).abs().max()) for x, y in
                        zip(tree_leaves(got[r][arch]["params"]), tree_leaves(want))))
    mean = np.mean([[s["loss"] for s in got[r][arch]["steps"]]
                    for r in range(0, RANKS, 2)], axis=0)
    loss_gap = float(np.max(np.abs(mean - ref["losses"]) / np.abs(ref["losses"])))
    print(f"{arch}: 8 ranks on data 4 x model 2 vs the JAX sharded step on "
          f"make_debug_mesh(4, 2) after {STEPS} steps (remat on): max gap "
          f"{max(gaps):.3e} of max |param| {top:.3e}; mean loss {loss_gap:.2e} "
          "relative")
    assert max(gaps) <= STEP_TOL * top
    assert loss_gap <= LOSS_TOL
    for r in range(0, RANKS, 2):       # a model pair computes one agent's loss
        assert [s["loss"] for s in got[r][arch]["steps"]] == \
            [s["loss"] for s in got[r + 1][arch]["steps"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_blocks_match_the_agent_only_gradient(runs, arch):
    _, got = runs
    worst = {}
    for r in range(RANKS):
        res = got[r][arch]
        assert abs(res["loss"] - res["want_loss"]) <= 1e-6 * abs(res["want_loss"])
        for leaf, (gap, top) in res["gaps"].items():
            worst[leaf] = max(worst.get(leaf, 0.0), gap / top)
    print(f"{arch}: gradient blocks vs the agent-only gradient, worst leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items(),
                                                        key=lambda kv: -kv[1])[:4]))
    assert len(worst) == len(tree_leaves(tt.model_template(tp_ranks.tp_config(arch))))
    assert max(worst.values()) <= GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise(runs, arch):
    _, got = runs
    assert all(got[r][arch]["remat_bitwise"] for r in range(RANKS))


@pytest.mark.parametrize("arch", ARCHS)
def test_update_phase_bitwise_against_the_stacked_trainer(runs, arch):
    expected, got = runs
    want_p, want_s = expected["update"][arch]
    for r in range(RANKS):
        b = _bundle(arch, r)
        p, s = got[r][arch]["update"]
        assert ranks.leaves_equal(p, local_shard(want_p, b.param_specs, b.mesh,
                                                 stacked=True)), r
        assert ranks.leaves_equal(s.inner, steps_lib.local_blocks(want_s.inner, b)), r
        assert s.step == want_s.step


@pytest.mark.parametrize("name", MORE_FUSED)
def test_more_programs_update_phase_bitwise(runs, name):
    """Time-varying mixing, two consensus rounds and momentum mixing on the
    local shard: the update phase bit for bit against the stacked
    trainer's blocks."""
    expected, got = runs
    want_p, want_s = expected["update"][name]
    for r in range(RANKS):
        b = _bundle("granite-3-8b", r)
        p, s = got[r]["more"][name]
        assert ranks.leaves_equal(p, local_shard(want_p, b.param_specs, b.mesh,
                                                 stacked=True)), (name, r)
        assert ranks.leaves_equal(s.inner, steps_lib.local_blocks(want_s.inner, b)), \
            (name, r)


@pytest.mark.parametrize("name", MORE_PLAIN)
def test_per_leaf_mixings_and_means_match_stacked(runs, name):
    """The per-leaf ``ppermute`` / ``dense`` mixings and FedAvg's mean over
    each rank's agent plane: three whole steps against the stacked
    trainer's blocks."""
    expected, got = runs
    gaps = []
    for r in range(RANKS):
        b = _bundle("granite-3-8b", r)
        want = local_shard(expected["update"][name], b.param_specs, b.mesh,
                           stacked=True)
        gaps.append(max(float((x - y).abs().max()) for x, y in
                        zip(tree_leaves(got[r]["more"][name]), tree_leaves(want))))
    print(f"{name} on data 4 x model 2: vs stacked after {STEPS} steps, max gap "
          f"{max(gaps):.3e}")
    assert max(gaps) <= PLAIN_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_collectives_equal_their_closed_form(runs, arch):
    """One grad phase at remat on: forward, each block's two row-parallel
    sums (twice: remat reruns them), the embedding's sum, the cross
    entropy's maximum and its (sum of exponentials, gold) pair; backward,
    each block's two copies (gemma's with its replicated ``wk`` / ``wv``)
    and the head's.  The logits never cross."""
    _, got = runs
    cfg = tp_ranks.tp_config(arch)
    tokens = BATCH * SEQ
    act = 4 * tokens * cfg.d_model
    kv = 0 if cfg.n_kv_heads % 2 == 0 else 2 * 4 * cfg.d_model * cfg.n_kv_heads \
        * cfg.head_dim_
    layers = cfg.n_layers
    want = {"model": {"calls": 4 * layers + 3,
                      "bytes": 4 * layers * act + act + 4 * tokens * 3},
            "model:grad": {"calls": 2 * layers + 1,
                           "bytes": (2 * layers + 1) * act + layers * kv}}
    for r in range(RANKS):
        by = got[r][arch]["grad_census"]["by_axis"]
        assert {k: {f: v[f] for f in ("calls", "bytes")} for k, v in by.items()} \
            == want, (r, by)
        assert got[r][arch]["grad_census"]["sends"] == 0
        for s in got[r][arch]["steps"]:
            c = s["census"]
            assert c["sends"] == 2 and c["bytes_sent"] == 2 * 4 * 128 * \
                -(-sum(t.numel() for t in tree_leaves(got[r][arch]["params"])) // 128)


def test_int8_wire_rows_and_census_of_the_local_shard(runs):
    _, got = runs
    numel = sum(math.prod(pd.shape)
                for pd in tree_leaves(_bundle("granite-3-8b").local_template))
    rows = -(-numel // 128)
    for r in range(RANKS):
        w = got[r]["int8"]
        assert w["local_numel"] == numel
        assert w["rows"] == [rows] == w["wire_rows"]
        assert w["wire_bytes"] == w["program_bytes"] == rows * 128 + rows * 4
        c = w["census"]
        assert c["bytes_sent"] == w["program_bytes"] * w["degree"] == c["bytes_received"]
        assert c["sends"] == 2 * w["degree"]          # payload and row scales
    print(f"granite-3-8b reduced, a rank's int8 wire on data 4 x model 2: {rows} "
          f"rows of its {numel:,} params ({got[0]['int8']['census']['bytes_sent']:,} "
          "B a step to 2 neighbours)")


def test_agent_collectives_stay_on_the_plane(runs):
    expected, got = runs
    p0 = expected["P0"]["gemma3-1b"]
    b0 = _bundle("gemma3-1b")
    row = torch.tensor(b0.topology.pi, dtype=torch.float32)
    for r in range(RANKS):
        b = _bundle("gemma3-1b", r)
        plane = [q for q in range(RANKS) if q % 2 == r % 2]
        blocks = [tree_leaves(local_shard(p0, _bundle("gemma3-1b", q).param_specs,
                                          _rank_mesh(q), stacked=True))
                  for q in plane]
        res = got[r]["plane"]
        for i, g in enumerate(res["gathered"]):
            assert torch.equal(g, torch.stack([bl[i] for bl in blocks])), (r, i)
        for x, y in zip(res["mean"], res["mean_agent_only"]):
            assert torch.equal(x, y), r
        for i, x in enumerate(res["mean"]):
            exact = torch.stack([bl[i] for bl in blocks]).double().mean(0)
            assert float((x.double() - exact).abs().max()) <= 1e-6
        a = b.mesh.agent
        for x, g in zip(tree_leaves(res["mixed"]), res["gathered"]):
            want = (row[a] @ g.reshape(g.shape[0], -1).float()).to(x.dtype)
            assert torch.equal(x, want.reshape(x.shape)), r


@pytest.mark.parametrize("i", range(len(CHECK_ENTRIES)),
                         ids=[e[0] for e in CHECK_ENTRIES])
def test_a_check_matrix_entry_certifies_on_the_model_mesh(runs, i):
    _, got = runs
    for r in range(RANKS):
        rep = got[r]["check"][i]
        bad = [(x["rule"], x["detail"]) for x in rep["rules"] if not x["ok"]]
        assert rep["ok"] and f"{CHECK_ENTRIES[i][0]} data4 x model2" in rep["label"], \
            (r, bad)
        rules = {x["rule"]: x for x in rep["rules"]}
        for rule in ("census.ppermute_count", "bytes.hlo_collective_permute",
                     "bytes.wire_vs_program", "census.clean_collectives"):
            assert not rules[rule]["skipped"], rule
        assert set(rules["census.clean_collectives"]["evidence"]["by_axis"]) \
            == {"model", "model:grad"}


@pytest.fixture(scope="module")
def factored(tmp_path_factory):
    """``pod 2 x data 2 x model 2``: the stacked trainer on ``kron(Pi_pod,
    Pi_data)`` (fully connected factors) and the 8 ranks."""
    cfg = tp_ranks.tp_config("granite-3-8b")
    P0 = tree_map(torch.from_numpy, _p0("granite-3-8b", seed=2))
    batches = _batches(2)
    fc = make_topology("fully_connected", 2).pi
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        teacher, want, first = _teacher(cfg, P0, batches,
                                        Topology(name="kron", pi=np.kron(fc, fc)))
        path = str(tmp_path_factory.mktemp("factored_tp") / "inputs.pt")
        torch.save({"P0": P0, "batches": batches, "teacher": teacher,
                    "seq": SEQ, "batch": BATCH}, path)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            got = pool.submit(mesh_lib.spawn_agents, tp_ranks.run_factored_tp,
                              RANKS, args=(path,), backend="gloo", device="cpu",
                              timeout=60, join_timeout=JOIN_S, axes=FACTORED)
            got = got.result()
    finally:
        torch.set_num_threads(threads)
    return {"update": want, "step": first, "p0": P0}, got


def test_pod_data_model_mesh_trains(factored):
    want, got = factored
    wp, ws = want["update"]
    gaps = []
    for r in range(RANKS):
        b = _bundle("granite-3-8b", r, FACTORED, remat=False)
        p, s = got[r]["update"]
        assert ranks.leaves_equal(p, local_shard(wp, b.param_specs, b.mesh,
                                                 stacked=True)), r
        assert ranks.leaves_equal(s.inner, steps_lib.local_blocks(ws.inner, b)), r
        step = local_shard(want["step"], b.param_specs, b.mesh, stacked=True)
        gaps.append(max(float((x - y).abs().max()) for x, y in
                        zip(tree_leaves(got[r]["step"]), tree_leaves(step))))
        # the three other agents of the rank's model coordinate
        assert sorted(got[r]["senders"]) == [q for q in range(AGENTS)
                                             if q != b.mesh.agent]
        assert got[r]["census"]["sends"] == 3
        assert set(got[r]["census"]["by_axis"]) == {"model", "model:grad"}
    p0 = want["p0"]
    for r in range(RANKS):               # the agent plane of each model coordinate
        plane = [local_shard(p0, _bundle("granite-3-8b", q, FACTORED).param_specs,
                             _rank_mesh(q, FACTORED), stacked=True)
                 for q in range(RANKS) if q % 2 == r % 2]
        first = torch.stack([tree_leaves(bl)[0] for bl in plane])
        assert torch.equal(got[r]["gathered"], first), r
        for i, x in enumerate(got[r]["mean"]):
            exact = torch.stack([tree_leaves(bl)[i] for bl in plane]).double().mean(0)
            assert float((x.double() - exact).abs().max()) <= 1e-6, (r, i)
    print(f"granite-3-8b on pod 2 x data 2 x model 2: update phase bit for bit, "
          f"whole step max gap {max(gaps):.3e} against the stacked trainer")
    assert max(gaps) <= WHOLE_TOL


@pytest.mark.parametrize("what,err,words", [
    ("topk", ValueError, "supports agent-only sharding"),
    ("rank", ValueError, "supports agent-only sharding"),
    ("moe", NotImplementedError, "A16.2.3"),
    ("rwkv6", NotImplementedError, "A16.2.3"),
    ("train_hier", NotImplementedError, "A16.2.2"),
])
def test_what_a_model_mesh_does_not_train_raises(what, err, words):
    shape = InputShape("t", SEQ, BATCH * AGENTS, "train")
    cfg = tp_ranks.tp_config("granite-3-8b")
    kw = {}
    if what in ("topk", "rank"):
        kw = {"compressor": "topk:0.1" if what == "topk" else "rank:4",
              "error_feedback": True}
    elif what == "moe":
        cfg = get_config("kimi-k2-1t-a32b").reduced()
    elif what == "rwkv6":
        cfg = get_config("rwkv6-1.6b").reduced()
    else:
        kw = {"mode": "train_hier"}
    with pytest.raises(err, match=words):
        steps_lib.build_train_step(cfg, shape, _rank_mesh(0),
                                   ranks.make_opt("cdmsgd", True),
                                   mixing="ppermute_fused", **kw)


def test_agent_identity_and_a_ranks_blocks():
    """``agent`` / ``n_agents`` on each mesh; a shift moves along the agent
    axes only (the peers keep the ``model`` coordinate); a rank's blocks of
    a train template: the agent dimension dropped, the ``tp`` dims cut."""
    for r in range(RANKS):
        m = _rank_mesh(r)
        assert (m.agent, m.n_agents, m.coord("model")) == (r // 2, AGENTS, r % 2)
        a, c = divmod(r, 2)
        assert m.peers(1) == (((a - 1) % AGENTS) * 2 + c, ((a + 1) % AGENTS) * 2 + c)
        assert m.agent_of(m.peers(1)[1]) == (a + 1) % AGENTS
        f = _rank_mesh(r, FACTORED)
        assert f.agent == r // 2 and f.n_agents == AGENTS
    a = mesh_lib.AgentMesh(rank=3, size=4, backend="gloo", group=None,
                           device=torch.device("cpu"))
    assert (a.agent, a.n_agents) == (3, 4)
    assert mesh_lib.agent_planes(FACTORED) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    b = _bundle("gemma3-1b", 3)
    cfg = tp_ranks.tp_config("gemma3-1b")
    lt = b.local_template
    blk = lt["groups"]["lg_super"]
    assert blk["attn"]["wq"].shape == (1, 2, cfg.d_model, 2, cfg.head_dim_)
    assert blk["attn"]["wk"].shape == (1, 2, cfg.d_model, 1, cfg.head_dim_)
    assert blk["mlp"]["wo"].shape == (1, 2, cfg.d_ff // 2, cfg.d_model)
    assert lt["embed"]["table"].shape == (cfg.vocab_size // 2, cfg.d_model)
    assert b.tp is not None and b.tp.heads and not b.tp.kv and b.tp.vocab
    x = torch.arange(4 * cfg.vocab_size * 2, dtype=torch.float32).reshape(
        4, cfg.vocab_size, 2)
    got = local_shard({"t": x}, {"t": b.param_specs["embed"]["table"]}, b.mesh,
                      stacked=True)["t"]
    assert torch.equal(got, x[1, cfg.vocab_size // 2:])
