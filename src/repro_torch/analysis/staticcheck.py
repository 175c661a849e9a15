"""The wire-contract checker: certify that one executed step implements
its configured wire contract (the port of :mod:`repro.analysis.staticcheck`).

CDSGD's guarantees hold only if the step does what its
:class:`~repro_torch.core.consensus.MixingProgram` says, across the
schedule x strategy x compressor x staleness x momentum-mixing x faults
product.  The reference traces the step to a jaxpr and runs named passes
over it; the port has no jaxpr, so it keeps the report and the rule ids and
takes its evidence from ONE EXECUTED STEP (one per schedule entry of a
time-varying program): the sharded :class:`~repro_torch.core.collectives.
Census` (sends, bytes, the ``("post", [data_ptr...])`` event log), every
transfer and collective the step posts, every fused launch's in-place
buffers (``data_ptr`` before and after, values before and after) and the
wire buffers themselves.  Without values (``meta`` tensors: the dry-run)
the rules that need them are skipped.

Rule catalog (the reference's ids)::

    census.ppermute_count      executed point-to-point transfers == the
                               closed-form prediction from the program
    census.critical_path       under overlap a step's first post sends
                               only the carried wire (by data_ptr), before
                               the grad phase; the rest are fresh
    census.clean_collectives   no all-gather / all-reduce in the step
                               (the fused path's only callers mix params)
    alias.fused_coverage       every fused launch updates
                               ``optimizer.fused_alias_pairs`` buffers in
                               place: data_ptr unchanged, values changed
    alias.donation_declared    the step returns the buffers its launches
                               updated in place as the new params and
                               optimizer state (no output copy)
    alias.double_donation      no bytes are reachable from two leaves of
                               params / optimizer state (except a one-leaf
                               bucket's wire field, a view of its leaf)
    alias.dropped_donations    skipped: PyTorch has no buffer donation
    bytes.wire_vs_program      program_bytes_per_neighbor == bytes of the
                               carried (or primed) wire buffers
    bytes.hlo_collective_permute  the Census's bytes_sent == the accounting
    seeds.strides_distinct     the five wire_seed strides are distinct
    seeds.window_collision_free  SR seed streams are disjoint over a dense
                               and a strided window
    seeds.ring_window          ...and over the depth-S staleness ring
    sparse.shape_contract      TopKWire / RankWire field shapes and dtypes
    sparse.k_rows_clamp        1 <= k_rows <= rows (and the auto budget)
    sparse.index_bounds        every top-k index in range (checked on the
                               concrete wire)

The closed-form census counts what the step executes, one call site per
round (the reference counts a ``lax.scan`` body once, so its call sites
stop at 3)::

    transfers = sum_entries(non-identity circulant shifts)
                x fields x n_buckets x n_payloads x rounds
    fields    = 3 (topk) | 2 (rank) | 2 (int8 / fp8) | 1 (f32 / bf16)
    carried   = transfers / rounds under "overlap", 0 under "sync";
                the stacked mode 0; a factored pod x data mesh: no
                prediction (as the reference)

summed over one period of a time-varying schedule (one step a schedule
entry); staleness never changes the count.  :func:`check_trainer`
certifies a stacked :class:`~repro_torch.core.trainer.
CollaborativeTrainer`, :func:`check_bundle` one rank of the sharded step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import collectives, consensus, flatbuf
from repro_torch.core.engine import wire_bytes_per_neighbor
from repro_torch.kernels.consensus_update import ops as kops
from repro_torch.utils.tree import tree_flatten, tree_map

PyTree = Any

SCHEMA_VERSION = 1
#: how a value rule says it was skipped on a shapes-only (meta) trace
NEEDS_VALUES = "needs values: run `python -m repro_torch.launch.check`"
# elements of each in-place buffer compared before / after a launch
_SAMPLE = 1 << 16


# --------------------------------------------------------------------------
# report types
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RuleResult:
    """One named rule's verdict: pass/fail/skip plus evidence."""

    rule: str
    ok: bool
    detail: str = ""
    evidence: Dict[str, Any] = dataclasses.field(default_factory=dict)
    skipped: bool = False          # not applicable / not provable here

    def as_dict(self) -> dict:
        return {"rule": self.rule, "ok": bool(self.ok),
                "skipped": bool(self.skipped), "detail": self.detail,
                "evidence": _jsonable(self.evidence)}


@dataclasses.dataclass
class CheckReport:
    """Machine-readable verdict of every pass over one program config."""

    label: str
    mode: str                      # "stacked" | "sharded"
    schedule: str
    results: List[RuleResult] = dataclasses.field(default_factory=list)
    walltime_s: float = 0.0

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def failures(self) -> List[RuleResult]:
        return [r for r in self.results if not r.ok]

    def rule(self, rule_id: str) -> RuleResult:
        for r in self.results:
            if r.rule == rule_id:
                return r
        raise KeyError(rule_id)

    def as_dict(self) -> dict:
        return {"version": SCHEMA_VERSION, "label": self.label,
                "mode": self.mode, "schedule": self.schedule,
                "ok": self.ok, "walltime_s": round(self.walltime_s, 3),
                "rules": [r.as_dict() for r in self.results]}

    def summary(self) -> str:
        lines = [f"[{'OK' if self.ok else 'FAIL'}] {self.label} "
                 f"({self.mode}/{self.schedule})"]
        for r in self.results:
            mark = "skip" if r.skipped else ("ok" if r.ok else "FAIL")
            line = f"  {mark:>4}  {r.rule}"
            if r.detail and (not r.ok or r.skipped):
                line += f" — {r.detail}"
            lines.append(line)
        return "\n".join(lines)


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return str(x)


# --------------------------------------------------------------------------
# the executed step and what it did
# --------------------------------------------------------------------------


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _sample(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    step = max(1, flat.numel() // _SAMPLE)
    return flat[::step].clone()


def carried_wire_ptrs(wire, quantized: bool) -> list:
    """The ``data_ptr`` of every tensor a carried wire puts on the wire: a
    ring's selected slot ``min(send_age, S - 1)``, every field of a
    compressed entry, a dense pair's payload (and int8 / fp8 scales)."""
    if isinstance(wire, consensus.WireRing):
        sel = min(int(wire.send_age[0]), wire.slots[0][0].shape[1] - 1)
        wire = tuple((p[:, sel], sc[:, sel]) for p, sc in wire.slots)
    out = []
    for e in wire:
        if isinstance(e, (consensus.TopKWire, consensus.RankWire)):
            out.extend(f.data_ptr() for f in e)
            continue
        p, sc = e
        out.append(p.data_ptr())
        if quantized:
            out.append(sc.data_ptr())
    return out


@dataclasses.dataclass
class CheckContext:
    """Everything the passes consume, gathered from one execution."""

    label: str
    mode: str                           # "stacked" | "sharded"
    schedule: str                       # "sync" | "overlap" (as claimed)
    program: Optional[consensus.MixingProgram]
    optimizer: Any
    spec: flatbuf.FlatSpec              # the params' flat layout
    n_agents: int
    step_program: Any                   # the engine's StepProgram
    params: PyTree
    opt_state: Any
    batch: Any
    mesh: Any = None                    # the sharded mode's AgentMesh
    steps: int = 1                      # steps executed (a period)
    factored: bool = False              # a pod x data agent mesh
    values: bool = True                 # False: meta tensors, shapes only
    counter: Any = None                 # an OpCounter open over the steps
    # filled by assemble():
    launches: List[dict] = dataclasses.field(default_factory=list)
    posts: List[dict] = dataclasses.field(default_factory=list)
    others: List[dict] = dataclasses.field(default_factory=list)
    census: Optional[dict] = None
    wire_carried: Any = None            # the carried wire before step 0
    wire_template: Any = None           # carried, else primed from params
    after: Any = None                   # (params, opt_state) after the steps

    @property
    def quantized(self) -> bool:
        return self.program is not None and \
            self.program.exchange in ("int8", "fp8")

    def assemble(self) -> "CheckContext":
        # the steps run on copies (meta tensors hold no data to protect)
        params, state = self.params, self.opt_state
        if self.values:
            params, state = _clone(params), _clone(state)
        wire = getattr(state, "wire", ())
        if isinstance(wire, consensus.WireRing) or (
                isinstance(wire, (tuple, list)) and len(wire)):
            self.wire_carried = wire
        self.wire_template = self.wire_carried
        fl = self.step_program.comm.flat
        if self.wire_template is None and fl is not None:
            self.wire_template = consensus.initial_wire_state(fl, params)
        if self.mesh is not None:
            self.mesh.census.reset()
        with self._watch(), (self.counter or contextlib.nullcontext()):
            for t in range(self.steps):
                self._step = t
                self._grad_seen = False
                self._carried = (
                    carried_wire_ptrs(state.wire, self.quantized)
                    if self.values and self.schedule == "overlap"
                    and isinstance(state.wire, (tuple, consensus.WireRing))
                    and len(state.wire) else None)
                params, state, _ = self.step_program.step_fn(params, state,
                                                             self.batch)
        if self.mesh is not None:
            self.census = self.mesh.census.snapshot()
        self.after = (params, state)
        return self

    @contextlib.contextmanager
    def _watch(self):
        """Observe the step: every fused launch (the bucket dispatcher of
        :mod:`repro_torch.kernels.consensus_update.ops`), every transfer and
        collective, and the grad phase's start."""
        prog = self.step_program
        saved = (kops._dispatch, collectives.ppermute, collectives.all_gather,
                 collectives.all_reduce_mean, prog.grad_phase)
        dispatch, ppermute, all_gather, all_reduce, grad_phase = saved
        ctx = self

        def watched_dispatch(dense, q, qm, sparse, neighbors, weights,
                             per_agent, scalars, **kw):
            before = [(t.data_ptr(), _sample(t) if ctx.values else None)
                      for t in per_agent]
            out = dispatch(dense, q, qm, sparse, neighbors, weights,
                           per_agent, scalars, **kw)
            outs = list(out) if isinstance(out, tuple) else [out]
            inplace, changed = [], []
            for (ptr, was), t_out in zip(before, outs):
                inplace.append(t_out.data_ptr() == ptr)
                changed.append(ctx.values and not torch.equal(was, _sample(t_out)))
            ctx.launches.append({
                "step": ctx._step, "n_buffers": len(per_agent),
                "in_place": inplace, "changed": changed,
                "in_place_storages": [_storage(t) for t, ok in
                                      zip(outs, inplace) if ok],
                "out_storages": [_storage(t) for t in outs]})
            return out

        def watched_ppermute(mesh, tensors, shifts, **kw):
            ctx.posts.append({
                "step": ctx._step, "sends": len(tensors) * len(shifts),
                "bytes": sum(x.numel() * x.element_size() for x in tensors)
                * len(shifts),
                "ptrs": [x.data_ptr() for x in tensors],
                "before_grad": not ctx._grad_seen,
                "carried": ctx._carried})
            return ppermute(mesh, tensors, shifts, **kw)

        def watched(kind, fn):
            def call(mesh, *args, **kw):
                ctx.others.append({"step": ctx._step, "kind": kind})
                return fn(mesh, *args, **kw)
            return call

        def watched_grad(*args, **kw):
            ctx._grad_seen = True
            return grad_phase(*args, **kw)

        kops._dispatch = watched_dispatch
        collectives.ppermute = watched_ppermute
        collectives.all_gather = watched("all-gather", all_gather)
        collectives.all_reduce_mean = watched("all-reduce", all_reduce)
        prog.grad_phase = watched_grad
        try:
            yield
        finally:
            (kops._dispatch, collectives.ppermute, collectives.all_gather,
             collectives.all_reduce_mean, prog.grad_phase) = saved


# --------------------------------------------------------------------------
# closed-form collective prediction
# --------------------------------------------------------------------------


def _fields(program) -> int:
    kind = program.compressor_kind
    if kind == "topk":
        return 3                       # values + indices + scales
    if kind == "rank":
        return 2                       # p + qt factors
    if program.exchange in ("int8", "fp8"):
        return 2                       # payload + row scales
    return 1                           # f32/bf16 payload only


def predict_collectives(program: Optional[consensus.MixingProgram],
                        spec: flatbuf.FlatSpec, schedule: str, mode: str,
                        *, factored: bool = False) -> dict:
    """Closed-form census of the transfers one period of steps executes.

    Returns ``{total, carried, fresh, breakdown}``; ``total`` is None when
    the config is outside the model (a non-circulant topology, a factored
    multi-axis mesh, no program)."""
    if mode == "stacked":
        return {"total": 0, "carried": 0, "fresh": 0,
                "breakdown": {"mode": "stacked — dense Pi over the agent "
                                      "stack, no transfers"}}
    if program is None:
        return {"total": None, "carried": None, "fresh": None,
                "breakdown": {"reason": "no MixingProgram (dense/ppermute "
                                        "per-leaf mixing)"}}
    if factored:
        return {"total": None, "carried": None, "fresh": None,
                "breakdown": {"reason": "factored pod x data agent mesh "
                                        "(one transfer per shift "
                                        "combination)"}}
    entry_shifts = []
    for topo in program.schedule.topologies:
        sw = topo.shift_weights()
        if sw is None:
            return {"total": None, "carried": None, "fresh": None,
                    "breakdown": {"reason": f"topology {topo.name!r} is "
                                            "not circulant"}}
        n = topo.n_agents
        entry_shifts.append(len([s for s in sw if s % n != 0]))
    fields = _fields(program)
    rounds = program.rounds
    per_site = sum(entry_shifts) * fields * spec.n_buckets \
        * program.n_payloads
    total = per_site * rounds
    carried = per_site if schedule == "overlap" else 0
    return {
        "total": total, "carried": carried, "fresh": total - carried,
        "breakdown": {
            "entry_shifts": entry_shifts, "fields": fields,
            "n_buckets": spec.n_buckets, "n_payloads": program.n_payloads,
            "rounds": rounds, "callsites": rounds,
            "staleness": program.staleness,
        },
    }


# --------------------------------------------------------------------------
# pass 1: collective census
# --------------------------------------------------------------------------


def _is_carried(post) -> bool:
    return (post["before_grad"] and post["carried"] is not None
            and post["ptrs"] == post["carried"])


def pass_collective_census(ctx: CheckContext) -> List[RuleResult]:
    pred = predict_collectives(ctx.program, ctx.spec, ctx.schedule, ctx.mode,
                               factored=ctx.factored)
    actual = sum(p["sends"] for p in ctx.posts)
    carried = sum(p["sends"] for p in ctx.posts if _is_carried(p))
    fresh = actual - carried
    ev = {
        "actual": actual, "actual_carried": carried, "actual_fresh": fresh,
        "predicted": pred["total"], "predicted_carried": pred["carried"],
        "predicted_fresh": pred["fresh"], "breakdown": pred["breakdown"],
        "steps": ctx.steps, "census": ctx.census,
    }
    out = []
    if pred["total"] is None:
        out.append(RuleResult(
            "census.ppermute_count", ok=True, skipped=True,
            detail=f"no closed-form prediction: "
                   f"{pred['breakdown'].get('reason')}", evidence=ev))
        out.append(RuleResult("census.critical_path", ok=True, skipped=True,
                              detail="prediction unavailable", evidence=ev))
    else:
        census_ok = ctx.census is None or ctx.census["sends"] == actual
        b = pred["breakdown"]
        out.append(RuleResult(
            "census.ppermute_count", ok=actual == pred["total"] and census_ok,
            detail=(f"{actual} transfers in {ctx.steps} step(s), predicted "
                    f"{pred['total']} = sum(shifts)"
                    f"{b.get('entry_shifts', '')} x {b.get('fields')} fields "
                    f"x {b.get('n_buckets')} buckets x {b.get('n_payloads')} "
                    f"payloads x {b.get('callsites')} round(s)"
                    + ("" if census_ok else
                       f"; the Census counted {ctx.census['sends']}")),
            evidence=ev))
        if not ctx.values:
            out.append(RuleResult("census.critical_path", ok=True,
                                  skipped=True, detail=NEEDS_VALUES,
                                  evidence=ev))
        else:
            ok = carried == pred["carried"] and fresh == pred["fresh"]
            detail = (f"{carried} carried-only / {fresh} fresh; predicted "
                      f"{pred['carried']}/{pred['fresh']} under "
                      f"schedule={ctx.schedule!r}")
            if not ok and ctx.schedule == "overlap" \
                    and carried < (pred["carried"] or 0):
                detail += (" — a transfer the overlap contract requires to "
                           "send only the carried wire, posted before the "
                           "grad phase, sends fresh data or waits for the "
                           "gradients: the exchange is back on the "
                           "grad->update critical path")
            out.append(RuleResult("census.critical_path", ok=ok,
                                  detail=detail, evidence=ev))
    kinds = [o["kind"] for o in ctx.others]
    if ctx.census is not None and ctx.census.get("collectives"):
        kinds += ["census"] * (ctx.census["collectives"] - len(kinds))
    out.append(RuleResult(
        "census.clean_collectives", ok=not kinds,
        detail=("no all-gather / all-reduce in the step" if not kinds else
                f"{len(kinds)} collective(s) over param data in a fused "
                f"step: {kinds}"),
        evidence={"collectives": kinds}))
    return out


# --------------------------------------------------------------------------
# pass 2: in-place coverage
# --------------------------------------------------------------------------


def _state_leaves(params, state) -> List[tuple]:
    """``(path, tensor, kind)`` of every tensor leaf of the step's params
    and optimizer state; ``kind`` is ``"leaf"`` (params, inner) or
    ``"wire"`` (wire, residual, warm start)."""
    out = []
    groups = [("arg0", params, "leaf")]
    for f in ("inner", "wire", "residual", "qwarm"):
        groups.append((f"arg1.{f}", getattr(state, f, ()),
                       "leaf" if f == "inner" else "wire"))
    for name, tree, kind in groups:
        leaves, _ = tree_flatten(tree)
        for i, t in enumerate(leaves):
            if isinstance(t, torch.Tensor) and t.numel():
                out.append((f"{name}[{i}]", t, kind))
    return out


def _span(t: torch.Tensor) -> tuple:
    """The bytes ``[start, end)`` a tensor's elements occupy."""
    extent = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + extent * t.element_size()


def _overlapping(leaves) -> tuple:
    """``(duplicates, declared)``: pairs of leaves whose bytes overlap,
    split into the declared exception (a wire field on exactly one param /
    state leaf's bytes: a one-leaf bucket packed as a view of its leaf)
    and the rest.  Leaves at disjoint ranges of one storage (the params as
    views of their flat bucket after a fused step) do not overlap."""
    spans = sorted((_span(t), path, kind) for path, t, kind in leaves)
    dups, declared = [], []
    for i, ((a0, a1), pa, ka) in enumerate(spans):
        for (b0, b1), pb, kb in spans[i + 1:]:
            if b0 >= a1:
                break
            view = (a0, a1) == (b0, b1) and {ka, kb} == {"leaf", "wire"}
            (declared if view else dups).append([pa, pb])
    return dups, declared


def pass_alias_donation(ctx: CheckContext) -> List[RuleResult]:
    out = []
    expected = getattr(ctx.optimizer, "fused_alias_pairs", None)
    fused = bool(getattr(ctx.optimizer, "fused", False))
    if expected is None or not fused:
        out.append(RuleResult(
            "alias.fused_coverage", ok=True, skipped=True,
            detail="optimizer declares no fused in-place contract"))
    elif not ctx.values:
        out.append(RuleResult("alias.fused_coverage", ok=True, skipped=True,
                              detail=NEEDS_VALUES))
        out.append(RuleResult("alias.donation_declared", ok=True,
                              skipped=True, detail=NEEDS_VALUES))
    else:
        pairs = [sum(1 for p, c in zip(L["in_place"], L["changed"]) if p and c)
                 for L in ctx.launches]
        want_launches = ctx.spec.n_buckets * ctx.steps
        bad = [n for n in pairs if n != expected]
        ok = len(pairs) == want_launches and not bad
        detail = (f"{len(pairs) - len(bad)}/{want_launches} fused launches "
                  f"update {expected} buffer(s) in place, as "
                  f"{type(ctx.optimizer).__name__} declares")
        if bad:
            detail += (f" — launches updating {bad} buffer(s) in place: a "
                       "fused update wrote a fresh tensor (or left its "
                       "buffer unchanged) instead of updating in place")
        elif len(pairs) != want_launches:
            detail += f" — {len(pairs)} fused launches ran"
        out.append(RuleResult(
            "alias.fused_coverage", ok=ok, detail=detail,
            evidence={"pairs_per_launch": pairs, "expected_pairs": expected,
                      "n_buckets": ctx.spec.n_buckets, "steps": ctx.steps}))
        last = [L for L in ctx.launches if L["step"] == ctx.steps - 1]
        in_place = {s for L in last for s in L["in_place_storages"]}
        written = {s for L in last for s in L["out_storages"]}
        params, state = ctx.after
        stray = [f"arg0[{i}]" for i, t in enumerate(tree_flatten(params)[0])
                 if isinstance(t, torch.Tensor) and _storage(t) not in in_place]
        stray += [f"arg1.inner[{i}]" for i, t in
                  enumerate(tree_flatten(state.inner)[0])
                  if isinstance(t, torch.Tensor) and t.numel()
                  and _storage(t) not in written]
        out.append(RuleResult(
            "alias.donation_declared", ok=not stray,
            detail=("the new params and optimizer state are the buffers the "
                    "fused launches updated in place (no output copy)"
                    if not stray else
                    f"{len(stray)} leaves of the new state lie outside every "
                    "buffer the fused launches wrote: the step copies its "
                    "outputs"),
            evidence={"stray": stray}))
    if not ctx.values:
        out.append(RuleResult("alias.double_donation", ok=True, skipped=True,
                              detail=NEEDS_VALUES))
    else:
        dups, declared = _overlapping(_state_leaves(ctx.params,
                                                    ctx.opt_state))
        out.append(RuleResult(
            "alias.double_donation", ok=not dups,
            detail=("no bytes are reachable from two leaves" if not dups else
                    f"{len(dups)} pair(s) of leaves share bytes: an in-place "
                    "update of one clobbers the other (copy at init instead, "
                    "like CDMSGDNesterov.init_inner's lookahead)"),
            evidence={"duplicates": dups, "one_leaf_bucket_views": declared}))
    out.append(RuleResult(
        "alias.dropped_donations", ok=True, skipped=True,
        detail="PyTorch has no buffer donation: nothing can be dropped"))
    return out


# --------------------------------------------------------------------------
# pass 3: byte accounting
# --------------------------------------------------------------------------


def pass_byte_accounting(ctx: CheckContext) -> List[RuleResult]:
    out = []
    if ctx.program is None:
        return [RuleResult("bytes.wire_vs_program", ok=True, skipped=True,
                           detail="no MixingProgram to price")]
    per_nbr = consensus.program_bytes_per_neighbor(ctx.spec, ctx.program)
    if ctx.wire_template is None:
        out.append(RuleResult(
            "bytes.wire_vs_program", ok=True, skipped=True,
            detail="no carried or primed wire",
            evidence={"program_bytes_per_neighbor": per_nbr}))
    else:
        actual = wire_bytes_per_neighbor(ctx.wire_template)
        src = "carried" if ctx.wire_carried is not None else "primed"
        out.append(RuleResult(
            "bytes.wire_vs_program", ok=actual == per_nbr,
            detail=(f"the {src} wire moves {actual} B/neighbor, the "
                    f"accounting prices {per_nbr} B"),
            evidence={"wire_bytes_per_neighbor": actual,
                      "program_bytes_per_neighbor": per_nbr,
                      "wire": src}))
    pred = predict_collectives(ctx.program, ctx.spec, ctx.schedule, ctx.mode,
                               factored=ctx.factored)
    sent = sum(p["bytes"] for p in ctx.posts)
    census_sent = None if ctx.census is None else ctx.census["bytes_sent"]
    if ctx.mode == "stacked":
        out.append(RuleResult(
            "bytes.hlo_collective_permute", ok=sent == 0,
            detail=(f"the stacked mode must send 0 bytes; the step posted "
                    f"{sent} (evidence: the posted transfers, no Census: "
                    "the stacked trainer holds no mesh)"),
            evidence={"sent_bytes": sent}))
        return out
    shifts = pred["breakdown"].get("entry_shifts")
    if shifts is None:
        out.append(RuleResult(
            "bytes.hlo_collective_permute", ok=True, skipped=True,
            detail="no closed-form shift count: "
                   f"{pred['breakdown'].get('reason')}",
            evidence={"census_bytes_sent": census_sent,
                      "program_bytes_per_neighbor": per_nbr}))
        return out
    expect = per_nbr * sum(shifts) * ctx.program.rounds
    got = census_sent if census_sent is not None else sent
    out.append(RuleResult(
        "bytes.hlo_collective_permute", ok=got == expect == sent,
        detail=(f"the Census counts {got} B sent in {ctx.steps} step(s); "
                f"the accounting predicts {expect} = {per_nbr} B/neighbor x "
                f"sum(shifts){shifts} x {ctx.program.rounds} round(s)"),
        evidence={"census_bytes_sent": census_sent, "posted_bytes": sent,
                  "expected": expect, "per_neighbor": per_nbr,
                  "entry_shifts": shifts, "rounds": ctx.program.rounds}))
    return out


# --------------------------------------------------------------------------
# pass 4: seed-stream lint
# --------------------------------------------------------------------------


def _seed_grid(steps: np.ndarray, rounds: int, agents: int, buckets: int,
               payloads: int) -> np.ndarray:
    """Vectorized wire_seed over the full index grid, wrapped to uint32.
    ``steps`` may be any broadcastable integer array (dense windows, the
    staleness ring's ``t - s`` plane, strided probes)."""
    st = np.int64(consensus._SEED_STEP_STRIDE)
    ag = np.int64(consensus._SEED_AGENT_STRIDE)
    bu = np.int64(consensus._SEED_BUCKET_STRIDE)
    ro = np.int64(consensus._SEED_ROUND_STRIDE)
    pa = np.int64(consensus._SEED_PAYLOAD_STRIDE)
    s = (st * (steps[..., None, None, None, None]
               + ro * np.arange(rounds)[:, None, None, None])
         + ag * np.arange(agents)[:, None, None]
         + bu * np.arange(buckets)[:, None]
         + pa * np.arange(payloads))
    return (s & 0xFFFFFFFF).ravel()


def pass_seed_streams(ctx: CheckContext) -> List[RuleResult]:
    prog = ctx.program
    quantized = prog is not None and (
        prog.exchange in ("int8", "fp8") or prog.compressor_kind == "topk")
    strides = {
        "step": consensus._SEED_STEP_STRIDE,
        "agent": consensus._SEED_AGENT_STRIDE,
        "bucket": consensus._SEED_BUCKET_STRIDE,
        "round": consensus._SEED_ROUND_STRIDE,
        "payload": consensus._SEED_PAYLOAD_STRIDE,
    }
    out = [RuleResult(
        "seeds.strides_distinct",
        ok=len(set(strides.values())) == len(strides)
        and all(v != 0 for v in strides.values()),
        detail="the five wire_seed strides are distinct and nonzero",
        evidence={"strides": strides})]
    if not quantized:
        out.append(RuleResult(
            "seeds.window_collision_free", ok=True, skipped=True,
            detail="no stochastic rounding on this wire "
                   f"(exchange={getattr(prog, 'exchange', 'f32')!r})"))
        return out

    rounds, agents = prog.rounds, ctx.n_agents
    buckets, payloads = ctx.spec.n_buckets, prog.n_payloads

    def _distinct(steps):
        seeds = _seed_grid(np.asarray(steps, np.int64), rounds, agents,
                           buckets, payloads)
        return len(np.unique(seeds)) == seeds.size, seeds.size

    dense_ok, dense_n = _distinct(np.arange(128))
    probe_ok, probe_n = _distinct((np.arange(997) * 1003 + 13) % 1_000_000)
    # spot-check the vectorized grid against the canonical wire_seed
    rng = np.random.default_rng(0)
    spot_ok = True
    for _ in range(8):
        t = int(rng.integers(0, 1_000_000))
        a = int(rng.integers(0, agents))
        b = int(rng.integers(0, buckets))
        r = int(rng.integers(0, rounds))
        p = int(rng.integers(0, payloads))
        want = consensus.wire_seed(t, a, b, r, p) & 0xFFFFFFFF
        got = int(_seed_grid(np.asarray([t], np.int64), r + 1, a + 1,
                             b + 1, p + 1)[-1])
        spot_ok = spot_ok and got == want
    out.append(RuleResult(
        "seeds.window_collision_free",
        ok=dense_ok and probe_ok and spot_ok,
        detail=(f"SR streams disjoint over a dense 128-step window "
                f"({dense_n} seeds) and a 997-step strided probe "
                f"({probe_n} seeds) at {agents} agents x {buckets} "
                f"buckets x {rounds} round(s) x {payloads} payload(s)"
                + ("" if spot_ok else
                   " — grid disagrees with wire_seed()")),
        evidence={"dense_window_ok": dense_ok, "probe_ok": probe_ok,
                  "matches_wire_seed": spot_ok,
                  "dense_seeds": dense_n, "probe_seeds": probe_n}))

    if prog.staleness > 1:
        S = prog.staleness
        base = np.arange(64) + S
        window = base[:, None] - np.arange(S + 1)     # (steps, S+1)
        ring_seeds = _seed_grid(window.astype(np.int64), rounds, agents,
                                buckets, payloads)
        # the same (t - s) plane repeats across consecutive steps; dedupe
        # per distinct step value, then require global uniqueness
        uniq_steps = np.unique(window)
        flat = _seed_grid(uniq_steps.astype(np.int64), rounds, agents,
                          buckets, payloads)
        ok = len(np.unique(flat)) == flat.size
        out.append(RuleResult(
            "seeds.ring_window", ok=ok,
            detail=f"depth-{S} staleness ring window seeds are disjoint "
                   f"({flat.size} seeds over {len(uniq_steps)} steps)",
            evidence={"staleness": S, "n_seeds": int(flat.size),
                      "n_window_seeds": int(ring_seeds.size)}))
    return out


# --------------------------------------------------------------------------
# pass 5: sparse-wire invariants
# --------------------------------------------------------------------------


def _wire_entries(wire):
    if wire is None:
        return None
    if isinstance(wire, consensus.WireRing):
        return list(wire.slots)
    if isinstance(wire, (tuple, list)) and len(wire):
        return list(wire)
    return None


def pass_sparse_wire(ctx: CheckContext) -> List[RuleResult]:
    prog = ctx.program
    if prog is None or not prog.compressed:
        return [RuleResult("sparse.shape_contract", ok=True, skipped=True,
                           detail="dense wire (no compressor)")]
    from repro_torch.kernels.consensus_update import topk as tk

    kind, param = consensus.parse_compressor(prog.compressor)
    rows = [b.rows for b in ctx.spec.buckets]
    entries = _wire_entries(ctx.wire_template)
    out = []
    if entries is None:
        out.append(RuleResult(
            "sparse.shape_contract", ok=True, skipped=True,
            detail="no wire to validate",
            evidence={"compressor": prog.compressor}))
        return out

    problems: List[str] = []
    if kind == "topk":
        k_list = tk.topk_k_rows_for(rows, param)
        for bi, (e, k, r) in enumerate(zip(entries, k_list, rows)):
            if not isinstance(e, consensus.TopKWire):
                problems.append(f"bucket {bi}: expected TopKWire, got "
                                f"{type(e).__name__}")
                continue
            for fname, f, shp, dt in (
                    ("values", e.values, (k, flatbuf.LANE), torch.int8),
                    ("indices", e.indices, (k, flatbuf.LANE), torch.int32),
                    ("scales", e.scales, (k, 1), torch.float32)):
                if tuple(f.shape[-2:]) != shp or f.dtype != dt:
                    problems.append(
                        f"bucket {bi} {fname}: {tuple(f.shape)}/{f.dtype} != "
                        f"(*, {shp[0]}, {shp[1]})/{dt}")
        clamp_ok = all(1 <= k <= r for k, r in zip(k_list, rows))
        clamp_detail = f"k_rows {k_list} clamped into [1, rows] {rows}"
        budget_ev = {}
        if isinstance(param, tuple):          # ("auto", budget_bytes)
            budget = int(param[1])
            spend = sum(k * tk.TOPK_LANE_ROW_BYTES for k in k_list)
            over = spend > budget and any(k > 1 for k in k_list)
            clamp_ok = clamp_ok and not over
            budget_ev = {"budget_bytes": budget, "spend_bytes": spend}
            clamp_detail += f"; auto budget {budget} B, spend {spend} B"
        out.append(RuleResult(
            "sparse.k_rows_clamp", ok=clamp_ok, detail=clamp_detail,
            evidence={"k_rows": list(k_list), "rows": rows, **budget_ev}))
    else:
        r = int(param)
        for bi, (e, rw) in enumerate(zip(entries, rows)):
            if not isinstance(e, consensus.RankWire):
                problems.append(f"bucket {bi}: expected RankWire, got "
                                f"{type(e).__name__}")
                continue
            for fname, f, shp in (("p", e.p, (rw, r)),
                                  ("qt", e.qt, (r, flatbuf.LANE))):
                if tuple(f.shape[-2:]) != shp or f.dtype != torch.float32:
                    problems.append(
                        f"bucket {bi} {fname}: {tuple(f.shape)}/{f.dtype} != "
                        f"(*, {shp[0]}, {shp[1]})/torch.float32")
        out.append(RuleResult(
            "sparse.k_rows_clamp", ok=1 <= r,
            detail=f"rank r={r} >= 1", evidence={"rank": r, "rows": rows}))
    out.insert(0, RuleResult(
        "sparse.shape_contract", ok=not problems,
        detail=("every compressed wire field matches the static "
                f"{kind} contract" if not problems else "; ".join(problems)),
        evidence={"compressor": prog.compressor,
                  "n_entries": len(entries), "problems": problems}))
    out.append(_index_bounds_rule(ctx, kind, rows, entries))
    return out


def _index_bounds_rule(ctx, kind, rows, entries) -> RuleResult:
    if kind != "topk":
        return RuleResult("sparse.index_bounds", ok=True, skipped=True,
                          detail="rank wire carries no indices")
    if not ctx.values:
        return RuleResult("sparse.index_bounds", ok=True, skipped=True,
                          detail=NEEDS_VALUES)
    msgs = []
    for bi, (e, r) in enumerate(zip(entries, rows)):
        dense = r * flatbuf.LANE
        idx = e.indices
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= dense:
            msgs.append(f"bucket {bi}: indices in [{lo}, {hi}], the bucket "
                        f"holds [0, {dense})")
    return RuleResult(
        "sparse.index_bounds", ok=not msgs,
        detail=("every top-k index lies in its bucket (checked on the "
                "concrete wire)" if not msgs else "; ".join(msgs)),
        evidence={"buckets_checked": len(entries), "errors": msgs})


# --------------------------------------------------------------------------
# orchestration
# --------------------------------------------------------------------------


PASSES = {
    "census": pass_collective_census,
    "alias": pass_alias_donation,
    "bytes": pass_byte_accounting,
    "seeds": pass_seed_streams,
    "sparse": pass_sparse_wire,
}


def run_passes(ctx: CheckContext,
               passes: Optional[Sequence[str]] = None) -> CheckReport:
    """Execute the step(s) once and run every (or the named) pass."""
    t0 = time.perf_counter()
    ctx.assemble()
    results: List[RuleResult] = []
    for name in (passes or PASSES):
        try:
            results.extend(PASSES[name](ctx))
        except Exception:
            results.append(RuleResult(
                f"{name}.error", ok=False,
                detail="pass crashed (checker bug or unsupported program "
                       "shape)",
                evidence={"traceback": traceback.format_exc(limit=8)}))
    return CheckReport(label=ctx.label, mode=ctx.mode, schedule=ctx.schedule,
                       results=results,
                       walltime_s=time.perf_counter() - t0)


def schedule_period(program) -> int:
    """Steps a check executes: one per schedule entry of a time-varying
    program, else one."""
    if program is not None and program.strategy == "time_varying":
        return program.schedule.period
    return 1


def check_program(step_program, params, opt_state, batch, *, program,
                  optimizer, schedule: str, mode: str, n_agents: int,
                  mesh=None, spec=None, label: str = "",
                  steps: Optional[int] = None, factored: bool = False,
                  counter=None,
                  passes: Optional[Sequence[str]] = None) -> CheckReport:
    """Certify one assembled step (the low-level entry point).

    Runs ``step_program.step_fn`` on copies of ``params`` / ``opt_state``
    (``steps`` of them, default one period of the schedule) with ``batch``,
    which must already be tensors on the step's device.  ``spec`` defaults
    to the flat layout of ``params`` (``lead=1`` in the stacked mode).
    Tensors on ``meta`` run every rule that needs no values.  ``counter``
    (an :class:`~repro_torch.analysis.opcount.OpCounter`) is opened over
    the steps alone."""
    if spec is None:
        spec = flatbuf.make_flat_spec(params, lead=1 if mode == "stacked"
                                      else 0)
    values = not any(t.device.type == "meta" for t in tree_flatten(params)[0]
                     if isinstance(t, torch.Tensor))
    ctx = CheckContext(
        label=label or f"{mode}/{schedule}", mode=mode, schedule=schedule,
        program=program, optimizer=optimizer, spec=spec, n_agents=n_agents,
        step_program=step_program, params=params, opt_state=opt_state,
        batch=batch, mesh=mesh,
        steps=schedule_period(program) if steps is None else steps,
        factored=factored, values=values, counter=counter)
    return run_passes(ctx, passes)


def check_trainer(trainer, batch, *, label: str = "",
                  passes: Optional[Sequence[str]] = None,
                  schedule: Optional[str] = None) -> CheckReport:
    """Certify a stacked :class:`~repro_torch.core.trainer.
    CollaborativeTrainer` on ``batch`` (a dict of arrays; the trainer's
    state is left as it was).  ``schedule`` overrides the claimed
    schedule (default the trainer's)."""
    batch = {k: torch.as_tensor(v, device=trainer.device)
             for k, v in batch.items()}
    return check_program(
        trainer._program, trainer.state.params, trainer.state.opt_state,
        batch, program=trainer.program, optimizer=trainer.optimizer,
        schedule=schedule or trainer.schedule, mode="stacked",
        n_agents=trainer.topology.n_agents,
        label=label or f"stacked/{trainer.schedule}", passes=passes)


def check_bundle(bundle, params, batch, *, opt_state=None, label: str = "",
                 schedule: Optional[str] = None, counter=None,
                 passes: Optional[Sequence[str]] = None) -> CheckReport:
    """Certify one rank of a sharded :class:`~repro_torch.launch.steps.
    TrainStepBundle`: its step on this rank's ``params`` and ``batch``
    (local tensors) from ``opt_state`` (default ``bundle.init_state``),
    with the mesh's Census as the exchange's evidence.  Every rank of the
    mesh must call it together (the step exchanges)."""
    if opt_state is None:
        opt_state = bundle.init_state(params)
    mesh = bundle.mesh
    return check_program(
        bundle.step_fn.__self__, params, opt_state, batch,
        program=bundle.mixing_program, optimizer=bundle.optimizer,
        schedule=schedule or bundle.schedule, mode="sharded",
        n_agents=bundle.n_agents, mesh=mesh,
        label=label or f"sharded/{bundle.schedule}",
        factored=len(mesh.axis_names) > 1, counter=counter, passes=passes)
