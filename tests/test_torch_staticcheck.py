"""The wire-contract checker (``repro_torch.analysis.staticcheck``) against
the reference's (``repro.analysis.staticcheck``), on the CPU.

* the report's shape and its rule ids, in order, equal the reference's;
* ``predict_collectives``' factors (``entry_shifts``, ``fields``,
  ``n_buckets``, ``n_payloads``) equal the reference's for all 17 entries
  of the check matrix, and so do the totals where ``rounds <= 2`` (beyond,
  the reference counts a ``lax.scan`` body once, the port every executed
  round);
* ``_seed_grid`` bit for bit;
* all 17 stacked entries certify on the MLP testbed
  (``launch.check --mode stacked --device cpu``, exit 0);
* each deliberate breakage fails its named rule: a colliding seed stride,
  a fused update returning a fresh tensor, two leaves sharing storage,
  ``k_rows`` out of its clamp (the sharded claimed-overlap breakage runs
  in the ranks of ``test_torch_sharded.py``);
* a one-leaf float32 bucket (an MoE model's routers) whose f32 wire is a
  view of its leaf passes, declared.
"""

import functools
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# one torch thread: under the suite's -n 6, torch's thread per core stalls
from torch_zoo_carry import one_torch_thread  # noqa: E402, F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import staticcheck as jsc  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import flatbuf as jflat  # noqa: E402
from repro.core.faults import make_fault_schedule as jfaults  # noqa: E402
from repro.core.optim import make_optimizer as jopt  # noqa: E402
from repro.core.topology import make_topology as jtopo  # noqa: E402
from repro.core.topology import make_topology_schedule as jsched  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.nn.paper_models import (classifier_loss as jloss,  # noqa: E402
                                   mlp_classifier_apply as japply,
                                   mlp_classifier_template as jmlp)
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.analysis import staticcheck  # noqa: E402
from repro_torch.core import consensus, flatbuf, make_optimizer  # noqa: E402
from repro_torch.core.faults import make_fault_schedule  # noqa: E402
from repro_torch.core.optim import CDMSGDNesterov, CDSGD, _flat_setup  # noqa: E402
from repro_torch.core.topology import make_topology, make_topology_schedule  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer  # noqa: E402
from repro_torch.kernels.consensus_update import ref as cref  # noqa: E402
from repro_torch.kernels.consensus_update import topk as tk  # noqa: E402
from repro_torch.launch import check  # noqa: E402
from repro_torch.utils.tree import tree_map, tree_zeros_like  # noqa: E402

N = 4


def _port(label, opt="cdsgd", **kw):
    loss, params, topo, batch = check.testbed("cpu")
    tr = CollaborativeTrainer(loss, params, topo, opt if not isinstance(opt, str)
                              else make_optimizer(opt, 0.05, fused=True),
                              device="cpu", **kw)
    return tr, batch


def _program_kw(kw, sched, faults):
    out = {"strategy": kw.get("mixing_strategy", "static"),
           "rounds": kw.get("consensus_rounds", 1),
           "error_feedback": kw.get("error_feedback", False),
           "exchange": kw.get("exchange", "f32"),
           "momentum_mixing": kw.get("momentum_mixing", "none"),
           "staleness": kw.get("staleness", 1),
           "compressor": kw.get("compressor", "none")}
    if "fault_schedule" in kw:
        out["faults"] = faults(kw["fault_schedule"], N)
    return out, (sched(kw["topology_schedule"], N)
                 if "topology_schedule" in kw else None)


def _catalog(doc: str) -> list:
    """The rule ids of a checker module's docstring catalog."""
    return [m.group(1) for m in re.finditer(r"^    ([a-z]+\.[a-z_]+)\s", doc, re.M)]


def _reference_rules(jtr, jbatch, label) -> list:
    """The rule ids, in order, of the reference's passes over its trainer's
    step.  Its ``assemble`` and alias pass read ``jax.core.Literal`` /
    ``ClosedJaxpr``, which JAX 0.9 removed (ROADMAP "Reference caveats"):
    the collective walk's result for a stacked step (no collective, an
    empty list) is given here, and the alias pass's ids come from its
    source order."""
    st = jtr.state
    ctx = jsc.CheckContext(
        label=label, mode="stacked", schedule=jtr.schedule,
        program=jtr.program, optimizer=jtr.optimizer,
        spec=jflat.make_flat_spec(st.params, lead=1), n_agents=N,
        step_fn=jtr._program.step_fn, params=st.params,
        opt_state=st.opt_state, batch=jbatch)
    ctx.hits = []
    wire = getattr(st.opt_state, "wire", ())
    if isinstance(wire, jcons.WireRing) or (
            isinstance(wire, (tuple, list)) and len(wire)):
        ctx.wire_carried = wire
    ctx.wire_global = ctx._synthesize_global_wire()
    ids = []
    for name, p in jsc.PASSES.items():
        if name == "alias":
            ids += ["alias.fused_coverage", "alias.donation_declared",
                    "alias.double_donation", "alias.dropped_donations"]
        else:
            ids += [r.rule for r in p(ctx)]
    return ids


def test_report_shape_and_rule_ids_equal_the_reference():
    assert _catalog(staticcheck.__doc__) == _catalog(jsc.__doc__)
    assert list(staticcheck.PASSES) == list(jsc.PASSES)
    jparams = jinit(jmlp(8, 4, width=16, depth=2), jax.random.PRNGKey(0))
    _, _, _, batch = check.testbed("cpu")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for label, opt, kw in check.MATRIX:
        if label not in ("sync_int8", "sync_ef_topk", "overlap_S4"):
            continue
        jtr = JTrainer(functools.partial(jloss, japply), jparams,
                       jtopo("ring", N), jopt(opt, 0.05, fused=True), **kw)
        tr, _ = _port(label, opt, **kw)
        rep = staticcheck.check_trainer(tr, batch, label=label)
        assert [r.rule for r in rep.results] \
            == _reference_rules(jtr, jbatch, label), label
        assert rep.ok, rep.summary()
        # the same report in the reference's classes serializes identically
        jrep = jsc.CheckReport(
            label=rep.label, mode=rep.mode, schedule=rep.schedule,
            results=[jsc.RuleResult(r.rule, r.ok, r.detail, r.evidence,
                                    r.skipped) for r in rep.results],
            walltime_s=rep.walltime_s)
        assert rep.as_dict() == jrep.as_dict()
        assert rep.summary() == jrep.summary()
    assert staticcheck.SCHEMA_VERSION == jsc.SCHEMA_VERSION


@pytest.mark.parametrize("label,opt,kw", check.MATRIX, ids=[m[0] for m in check.MATRIX])
def test_census_prediction_equals_the_reference(label, opt, kw):
    loss, params, topo, _ = check.testbed("cpu")
    spec = flatbuf.make_flat_spec(tree_map(lambda x: x[None].expand(
        (N,) + tuple(x.shape)), params), lead=1)
    jspec = jflat.make_flat_spec(jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((N,) + tuple(x.shape), jnp.float32),
        params), lead=1)
    pkw, sched = _program_kw(kw, make_topology_schedule, make_fault_schedule)
    prog = consensus.make_mixing_program(sched or make_topology("ring", N), **pkw)
    jkw, jschedule = _program_kw(kw, jsched, jfaults)
    jprog = jcons.make_mixing_program(jschedule or jtopo("ring", N), **jkw)
    schedule = kw.get("schedule", "sync")
    got = staticcheck.predict_collectives(prog, spec, schedule, "sharded")
    want = jsc.predict_collectives(jprog, jspec, schedule, "sharded")
    for k in ("entry_shifts", "fields", "n_buckets", "n_payloads", "rounds",
              "staleness"):
        assert got["breakdown"][k] == want["breakdown"][k], k
    if prog.rounds <= 2:
        assert (got["total"], got["carried"], got["fresh"]) \
            == (want["total"], want["carried"], want["fresh"])
    else:     # the reference's scan body counts once: callsites = 3
        assert got["total"] == want["total"] // 3 * prog.rounds
    assert staticcheck.predict_collectives(prog, spec, schedule, "stacked")["total"] == 0
    assert staticcheck.predict_collectives(prog, spec, schedule, "sharded",
                                           factored=True)["total"] is None


def test_seed_grid_bit_for_bit():
    for steps in (np.arange(128), (np.arange(997) * 1003 + 13) % 1_000_000,
                  (np.arange(64) + 4)[:, None] - np.arange(5)):
        for dims in ((1, 4, 1, 1), (3, 5, 2, 2)):
            assert np.array_equal(
                staticcheck._seed_grid(np.asarray(steps, np.int64), *dims),
                jsc._seed_grid(np.asarray(steps, np.int64), *dims))


def test_the_stacked_matrix_certifies(capsys):
    assert check.main(["--mode", "stacked", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "17 configs" in out and "0 failures" in out
    tr, batch = _port("overlap_mom_mixed", "cdmsgd", schedule="overlap",
                      exchange="int8", momentum_mixing="mixed")
    rep = staticcheck.check_trainer(tr, batch)
    cov = rep.rule("alias.fused_coverage")
    assert cov.ok and cov.evidence["pairs_per_launch"] == [2]
    assert rep.rule("census.ppermute_count").evidence["actual"] == 0
    for r in rep.results:
        if not r.skipped:
            assert r.detail, f"{r.rule} certified without evidence"


def test_seed_stride_collision_fails_its_rule(monkeypatch):
    monkeypatch.setattr(consensus, "_SEED_AGENT_STRIDE",
                        consensus._SEED_BUCKET_STRIDE)
    tr, batch = _port("x", "cdmsgd", schedule="overlap", exchange="int8")
    assert not staticcheck.check_trainer(tr, batch).rule(
        "seeds.strides_distinct").ok


class FreshCDSGD(CDSGD):
    """Fused CDSGD whose update writes a fresh tensor instead of updating
    its bucket in place."""

    def apply_fused(self, params, grads, inner, alpha, comm, step, *,
                    exchanged=None):
        fl = comm.flat
        spec, nbrs, w, scs, sfs, (g,) = _flat_setup(fl, params, step, grads,
                                                    exchanged=exchanged)
        from repro_torch.kernels.consensus_update import ops as kops

        outs = [kops._dispatch(lambda wt, nb, gb, a: cref.cdsgd_update_ref(
                    wt, nb, gb, a), None, None, None, nb, w, [gb], (alpha,),
                    scales=None, self_buf=None, mom_neighbors=None,
                    mom_scales=None) for nb, gb in zip(nbrs, g)]
        return fl.unpack(outs, spec), inner


class SharedNesterov(CDMSGDNesterov):
    """The lookahead IS the params tree: two leaves on one storage."""

    def init_inner(self, params):
        return (tree_zeros_like(params), params)


def test_breakages_fail_their_rules(monkeypatch):
    tr, batch = _port("fresh", FreshCDSGD(0.05, fused=True))
    rep = staticcheck.check_trainer(tr, batch)
    assert not rep.rule("alias.fused_coverage").ok
    assert "fresh tensor" in rep.rule("alias.fused_coverage").detail
    assert not rep.rule("alias.donation_declared").ok

    tr, batch = _port("shared", SharedNesterov(0.05, mu=0.9, fused=True))
    r = staticcheck.check_trainer(tr, batch).rule("alias.double_donation")
    assert not r.ok
    flat = " ".join(p for paths in r.evidence["duplicates"] for p in paths)
    assert "arg0" in flat and "arg1.inner" in flat

    # the step runs as configured; the pass then reads a k_rows past the
    # bucket's rows (an unclamped density)
    tr, batch = _port("clamp", "cdsgd", error_feedback=True,
                      compressor="topk:0.25")
    ctx = staticcheck.CheckContext(
        label="clamp", mode="stacked", schedule="sync", program=tr.program,
        optimizer=tr.optimizer,
        spec=flatbuf.make_flat_spec(tr.state.params, lead=1), n_agents=N,
        step_program=tr._program, params=tr.state.params,
        opt_state=tr.state.opt_state,
        batch={k: torch.as_tensor(v) for k, v in batch.items()}).assemble()
    assert all(r.ok for r in staticcheck.pass_sparse_wire(ctx))
    monkeypatch.setattr(tk, "topk_k_rows_for",
                        lambda rows, param: [r + 1 for r in rows])
    rules = {r.rule: r for r in staticcheck.pass_sparse_wire(ctx)}
    assert not rules["sparse.k_rows_clamp"].ok
    assert not rules["sparse.shape_contract"].ok


def test_a_one_leaf_bucket_view_is_declared():
    """An MoE model's float32 routers beside its bf16 weights: the f32
    bucket holds one 128-aligned leaf, packed as a view of it, so the
    overlap f32 wire's payload shares the router leaf's storage."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=gen).to(torch.bfloat16),
              "router": torch.randn((32, 8), generator=gen)}

    def loss(p, b):
        return ((p["w"].float() ** 2).sum() + (p["router"] ** 2).sum(), {})

    tr = CollaborativeTrainer(loss, params, make_topology("ring", N),
                              CDSGD(0.05, fused=True), device="cpu",
                              schedule="overlap")
    rep = staticcheck.check_trainer(tr, {"x": np.zeros((N, 1), np.float32)})
    r = rep.rule("alias.double_donation")
    assert r.ok, rep.summary()
    assert r.evidence["one_leaf_bucket_views"], "the view was not exercised"
    assert rep.ok, rep.summary()
