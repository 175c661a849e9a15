"""Kernel microbenchmarks: the fused consensus update, the wire, flash
attention and WKV6 on the card (the port of ``benchmarks/
kernel_microbench.py``, the runner's ``kernels`` entry).

The reference's sections, rows, names and records, timed with CUDA events
on the card at the reference's sizes: one bucket of ``rows_n = 8192`` lane
rows (1 M float32 parameters) and the ring stencil S = 3 (self + 2
neighbours: phase 3 of ``chip_smoke.py``'s ``stencil`` form at A_out = 1).
Each kernel row adds the least time the card could take for the launch
(``bound_ms``, :func:`repro_torch.analysis.roofline.kernel_bound` on
:data:`~repro_torch.analysis.roofline.HW_H100`) and the measured time's
share of it.

Analytic HBM sweeps per element (S = stencil size, neighbours + self):

* CDSGD  unfused: mix (S reads + 1 write) + axpy (read mix + read grad +
  write out)                      = S + 4 sweeps
* CDSGD  fused:   S neighbour reads + grad read + out write = S + 2 sweeps
* CDMSGD unfused: mix (S+1) + momentum update (read v + read grad + write
  v') + param update (read mix + read v' + write out) = S + 7 sweeps
* CDMSGD fused:   S + grad + v reads, out + v' writes       = S + 4 sweeps

The sections: ``bucketed_model_update`` (one launch per dtype bucket
against one per leaf), ``exchange_wire`` (bytes on the wire per
precision), ``alias_accounting`` (the update's extra output bytes in place
and out of place, from the buffers' ``data_ptr``), ``schedule_overlap``
(sync against overlap: the same bytes, from the carried buffers),
``multi_round`` (k rounds move k x the sync bytes, error feedback 0 more),
``momentum_mix`` (the mixed momentum doubles the wire), ``stale_ring``
(the ring's bytes do not depend on S; drift under a straggler and a
dropped link, int8 and fp8), ``compressor_frontier`` (bytes against drift
over f32 / int8 / fp8 / top-k / rank-r) and ``sparse_update`` (the top-k
wire's dense and sparse operand forms, timed, and priced by
:func:`~repro_torch.analysis.roofline.consensus_update_cost`).  Without
``smoke`` flash attention and WKV6 are timed too.

``smoke`` cuts the step counts; ``device="cpu"`` runs the plain versions
at the smoke counts and marks every row ``device=cpu``: those times are
no card's.  Prints ``name,us_per_call,derived`` rows and one
``JSON,[...]`` line of the records.

    python -m repro_torch.benchmarks.kernel_microbench [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.analysis.roofline import (HW_H100, consensus_update_cost,
                                           kernel_bound)
from repro_torch.core import consensus as consensus_lib
from repro_torch.core import engine, flatbuf
from repro_torch.core.optim import CDMSGD, CDSGD, stacked_comm_ops
from repro_torch.core.topology import make_topology
from repro_torch.core.trainer import CollaborativeTrainer, TrainState
from repro_torch.device import resolve_device
from repro_torch.kernels.consensus_update import consensus_update as cu
from repro_torch.kernels.consensus_update import ops as kops
from repro_torch.kernels.consensus_update import ref
from repro_torch.kernels.consensus_update import topk as tk
from repro_torch.utils.tree import tree_leaves, tree_map

ROWS_N = 8192          # the reference's bucket: 1 M float32 parameters
STEPS, DRIFT_STEPS, FRONTIER_STEPS = 3, 10, 20
SMOKE_STEPS = 1        # timed steps and drift steps under smoke
CPU_REPS = 2           # timed calls a row off the card


def _time_us(fn, device: torch.device, reps: int = 20) -> float:
    """Microseconds a call: CUDA events on the card; elsewhere the host
    clock over ``CPU_REPS`` calls (no card's time); one warm call first."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return 1e3 * start.elapsed_time(end) / reps
    reps = min(reps, CPU_REPS)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t0) / reps


def _bound(us: float, b, prefix: str = "") -> str:
    """``bound_ms`` (and what bounds it) and the share of it ``us`` reaches."""
    b_ms, by = b
    share = 1e3 * b_ms / us if us else float("nan")
    return f"{prefix}bound_ms={b_ms:.5f}({by});{prefix}bound_share={share:.3f}"


def _randn(gen, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def _quad_loss(p, b):
    return 0.5 * (torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)), {}


def _testbed(device):
    """The reference's 33 k-parameter model, a 4-agent ring and a batch."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((256, 128), generator=gen),
              "b": torch.randn((300,), generator=gen)}
    batch = {"x": np.zeros((4, 1), np.float32)}
    return params, make_topology("ring", 4), batch


def _step_us(tr, batch, device, reps) -> float:
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    st = tr.state
    return _time_us(lambda: tr._program.step_fn(st.params, st.opt_state, b),
                    device, reps)


def _drift(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def consensus_rows(device, gen, rows_n: int = ROWS_N):
    """The dense update (CDSGD, CDMSGD) and the int8 ``_q`` CDMSGD form at
    the S = 3 stencil, each against its plain version."""
    nb = _randn(gen, (3, rows_n, 128), device)
    g = _randn(gen, (rows_n, 128), device)
    mom = _randn(gen, (rows_n, 128), device)
    w = torch.full((3,), 1 / 3, device=device)
    g1, m1 = g.clone(), mom.clone()
    t_kernel = _time_us(lambda: kops.cdsgd_update_flat(nb, w, g1, 0.05), device)
    t_ref = _time_us(lambda: ref.cdsgd_update_ref(w[None], nb, g[None], 0.05),
                     device)
    rows = [("kernel/consensus_update", t_kernel,
             f"ref_us={t_ref:.1f};hbm_traffic_fused/unfused={5 / 7:.3f};"
             + _bound(t_kernel, kernel_bound("cdsgd_update", 1, 3, rows_n)))]
    t_mom = _time_us(lambda: kops.cdmsgd_update_flat(nb, w, g1, m1, 0.05, 0.9),
                     device)
    rows.append(("kernel/consensus_update_momentum", t_mom,
                 f"hbm_traffic_fused/unfused={7 / 10:.3f};"
                 + _bound(t_mom, kernel_bound("cdmsgd_update", 1, 3, rows_n))))
    rec = {"bench": "consensus/hbm_ratio",
           "cdsgd": {"fused_sweeps": 5, "unfused_sweeps": 7},
           "cdmsgd": {"fused_sweeps": 7, "unfused_sweeps": 10}}
    # the int8 wire: neighbours int8 + row scales, self native at weights[0]
    q, sc = cu.sr_quantize(g[None], 0, "int8")
    nb_q = torch.cat([q, q]).contiguous()
    sc_q = torch.cat([sc, sc]).contiguous()
    slf = _randn(gen, (rows_n, 128), device)
    t_quant = _time_us(lambda: cu.sr_quantize(g[None], 0, "int8"), device)
    t_qmom = _time_us(lambda: kops.cdmsgd_update_flat(
        nb_q, w, g1, m1, 0.05, 0.9, scales=sc_q, self_buf=slf), device)
    rows.append(("kernel/consensus_update_momentum_int8", t_qmom,
                 f"quantize_us={t_quant:.1f};dequant=in-register;"
                 + _bound(t_qmom, kernel_bound("cdmsgd_update_q", 1, 2, rows_n,
                                               torch.int8))
                 + ";" + _bound(t_quant, kernel_bound(
                     "sr_quantize", 1, 0, rows_n, torch.int8), "quantize_")))
    return rows, rec


def _tiles(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    pad = -flat.numel() % flatbuf.LANE
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, flatbuf.LANE)


def bucketed_model_update(device, gen, reps: int = 20):
    """Whole-model fused (one launch per dtype bucket) against one launch
    per leaf on a mixed pytree; launches counted from the dispatcher, HBM
    bytes from the bucket geometry, collectives a step on a ring."""
    tree = {}
    for i, (n, dt) in enumerate([(7 * 9, torch.float32), (300, torch.float32),
                                 (128 * 64, torch.float32), (513, torch.float32),
                                 (4096, torch.bfloat16), (130, torch.bfloat16),
                                 (256 * 16, torch.float32), (1000, torch.bfloat16)]):
        tree[f"p{i}"] = _randn(gen, (n,), device, dt)
    left = tree_map(lambda x: x + 1, tree)
    right = tree_map(lambda x: x - 1, tree)
    grads = tree_map(torch.ones_like, tree)
    w = torch.full((3,), 1 / 3, device=device)
    s = 3                                       # ring stencil: self + 2
    spec = flatbuf.make_flat_spec(tree)
    calls = {"fused": 0, "per_leaf": 0}

    def fused():
        stacks = [torch.stack(b) for b in zip(*(flatbuf.pack(t, spec)
                                                for t in (tree, left, right)))]
        outs = []
        for nb, gb in zip(stacks, flatbuf.pack(grads, spec)):
            calls["fused"] += 1
            outs.append(kops.cdsgd_update_flat(nb, w, gb.clone(), 0.05))
        return flatbuf.unpack(outs, spec)

    def per_leaf():
        out = {}
        for k, x in tree.items():
            calls["per_leaf"] += 1
            nb = torch.stack([_tiles(t[k]) for t in (tree, left, right)])
            o = kops.cdsgd_update_flat(nb, w, _tiles(grads[k]), 0.05)
            out[k] = o.reshape(-1)[:x.numel()].reshape(x.shape)
        return out

    t_fused = _time_us(fused, device, reps)
    t_leaf = _time_us(per_leaf, device, reps)
    calls.update(fused=0, per_leaf=0)           # one call of each, counted
    fused()
    per_leaf()
    launches_fused, launches_leaf = calls["fused"], calls["per_leaf"]
    n_leaves = spec.n_leaves
    bytes_fused = sum((s + 2) * b.bytes for b in spec.buckets)
    bytes_unpadded = sum(x.numel() * x.element_size() for x in tree.values())
    bytes_unfused_opt = (s + 4) * bytes_unpadded
    coll_fused, coll_leaf = 2 * spec.n_buckets, 2 * n_leaves
    rec = {
        "bench": "consensus/bucketed_model_update",
        "n_leaves": n_leaves,
        "n_buckets": spec.n_buckets,
        "kernel_launches": {"per_leaf": launches_leaf, "fused": launches_fused},
        "collectives_per_step_ring": {"per_leaf": coll_leaf, "fused": coll_fused},
        "hbm_bytes": {"unfused_optimizer": bytes_unfused_opt,
                      "fused_kernel": bytes_fused},
        "wire_bytes_per_shift": {e: spec.exchange_bytes(e)
                                 for e in flatbuf.EXCHANGE_DTYPES},
        "us_per_call": {"per_leaf": round(t_leaf, 1), "fused": round(t_fused, 1)},
    }
    assert launches_fused < launches_leaf
    assert bytes_fused < bytes_unfused_opt
    row = ("kernel/bucketed_model_update", t_fused,
           f"per_leaf_us={t_leaf:.0f};launches={launches_fused}/{launches_leaf};"
           f"collectives={coll_fused}/{coll_leaf};"
           f"hbm_fused/unfused={bytes_fused / bytes_unfused_opt:.3f}")
    return row, rec


def exchange_wire():
    """Bytes on the wire per consensus step, per exchange precision: 1 M
    f32 params on a ring of 8 (degree 2); int8 / fp8 pay 1 byte an element
    and one f32 scale per 128-lane row (512 / 132 = 3.88x)."""
    spec = flatbuf.make_flat_spec(
        {"w": torch.empty((1024, 1024), device="meta")})
    topo = make_topology("ring", 8)
    per_step = {
        exch: consensus_lib.exchange_bytes_per_step(spec, topo, exch)["per_step_bytes"]
        for exch in flatbuf.EXCHANGE_DTYPES}
    ratio = per_step["f32"] / per_step["int8"]
    assert ratio >= 3.5, f"int8 exchange must cut wire bytes >=3.5x, got {ratio:.2f}"
    rec = {"bench": "consensus/exchange_wire", "model": "1M f32, ring deg 2",
           "per_step_bytes": per_step,
           "ratio_f32_over_int8": round(ratio, 3)}
    row = ("kernel/exchange_wire", 0.0,
           ";".join(f"{k}={v}" for k, v in per_step.items())
           + f";f32/int8={ratio:.2f}x")
    return row, rec


def alias_accounting(device, gen, rows_n: int = ROWS_N):
    """Extra HBM output bytes of the CDMSGD bucket update: the kernel's
    wrapper updates grad -> params and momentum -> momentum' in place (the
    outputs' ``data_ptr`` are the operands'), the plain version allocates
    both outputs anew."""
    nb = _randn(gen, (3, rows_n, 128), device)
    g = _randn(gen, (rows_n, 128), device)
    mom = _randn(gen, (rows_n, 128), device)
    w = torch.full((3,), 1 / 3, device=device)
    bucket_bytes = rows_n * 128 * 4
    ptrs = (g.data_ptr(), mom.data_ptr())
    out = {}
    got = kops.cdmsgd_update_flat(nb, w, g, mom, 0.05, 0.9)
    n = sum(t.data_ptr() == p for t, p in zip(got, ptrs))
    out["aliased"] = {"aliased_outputs": n,
                      "extra_output_bytes": (2 - n) * bucket_bytes}
    got = ref.cdmsgd_update_ref(w[None], nb, g[None], mom[None], 0.05, 0.9)
    n = sum(t.data_ptr() == p for t, p in zip(got, ptrs))
    out["unaliased"] = {"aliased_outputs": n,
                        "extra_output_bytes": (2 - n) * bucket_bytes}
    assert out["aliased"]["extra_output_bytes"] == 0
    rec = {"bench": "consensus/alias_accounting",
           "bucket_bytes": bucket_bytes, **out}
    row = ("kernel/alias_accounting", 0.0,
           f"extra_hbm_out_aliased={out['aliased']['extra_output_bytes']};"
           f"unaliased={out['unaliased']['extra_output_bytes']}")
    return row, rec


def schedule_overlap(device, steps_timed: int = STEPS):
    """sync against overlap: step time, and from the carried buffers that
    the overlap wire moves exactly the sync wire's int8 bytes a
    neighbour, a step later."""
    params, topo, batch = _testbed(device)
    us, wire_per_nbr = {}, {}
    for schedule in ("sync", "overlap"):
        tr = CollaborativeTrainer(_quad_loss, params, topo,
                                  CDSGD(0.01, fused=True), device=device,
                                  schedule=schedule, exchange="int8")
        us[schedule] = _step_us(tr, batch, device, steps_timed)
        if schedule == "overlap":
            wire_per_nbr[schedule] = engine.wire_bytes_per_neighbor(
                tr.state.opt_state.wire)
        else:
            spec = flatbuf.make_flat_spec(tr.state.params, lead=1)
            wire_per_nbr[schedule] = spec.exchange_bytes("int8")
    assert wire_per_nbr["overlap"] == wire_per_nbr["sync"], wire_per_nbr
    degree = topo.degree()
    rec = {
        "bench": "consensus/schedule_overlap",
        "model": "33k f32 params, ring deg 2, int8 wire",
        "us_per_step": {k: round(v, 1) for k, v in us.items()},
        "wire_bytes_per_neighbor": wire_per_nbr,
        "wire_bytes_per_step": {k: v * degree for k, v in wire_per_nbr.items()},
        # proven per config by launch.check's census.critical_path rule
        "overlap_exchange_off_critical_path": True,
    }
    row = ("kernel/schedule_overlap", us["overlap"],
           f"sync_us={us['sync']:.0f};"
           f"wire_bytes/step sync={rec['wire_bytes_per_step']['sync']}"
           f" overlap={rec['wire_bytes_per_step']['overlap']} (equal)")
    return row, rec


def multi_round(device, steps_timed: int = STEPS):
    """k-round i-CDSGD moves exactly k x the sync bytes a step, and error
    feedback adds none (the EF payload has the plain payload's layout),
    from the accounting and from the buffers."""
    params, topo, batch = _testbed(device)
    k = 3
    us, wire = {}, {}
    for label, kw in (("k1", {}), (f"k{k}", {"consensus_rounds": k}),
                      ("k1_ef", {"error_feedback": True})):
        if "consensus_rounds" in kw:
            kw = dict(kw, mixing_strategy="multi_round")
        tr = CollaborativeTrainer(_quad_loss, params, topo,
                                  CDSGD(0.01, fused=True), device=device,
                                  exchange="int8", **kw)
        us[label] = _step_us(tr, batch, device, steps_timed)
        wire[label] = tr.wire_bytes_per_step
    assert wire[f"k{k}"] == k * wire["k1"], wire
    assert wire["k1_ef"] == wire["k1"], wire
    fl = tr.comm.flat                   # the EF trainer's
    spec = fl.spec(tr.state.params)
    bufs = fl.pack(tr.state.params, spec)
    plain = fl.strategy.quantize_stage(bufs, 0)
    ef_wire, _ = fl.strategy.quantize_ef(bufs, 0, fl.strategy.residual_init(bufs))
    per_nbr = {"plain": engine.wire_bytes_per_neighbor(plain),
               "ef": engine.wire_bytes_per_neighbor(ef_wire)}
    assert per_nbr["ef"] == per_nbr["plain"] == spec.exchange_bytes("int8")
    rec = {
        "bench": "consensus/multi_round",
        "model": "33k f32 params, ring deg 2, int8 wire",
        "rounds": k,
        "us_per_step": {kk: round(v, 1) for kk, v in us.items()},
        "wire_bytes_per_step": wire,
        "ef_wire_bytes_per_neighbor": per_nbr,
        "k_round_wire_is_k_x_sync": True,
        "ef_extra_wire_bytes": 0,
    }
    row = ("kernel/multi_round", us[f"k{k}"],
           f"k1_us={us['k1']:.0f};wire/step k1={wire['k1']} "
           f"k{k}={wire[f'k{k}']} (={k}x);ef extra wire=0")
    return row, rec


def momentum_mix(device, steps_timed: int = STEPS):
    """The mixed momentum rides the wire: exactly 2x the params-only bytes,
    error feedback still 0 more, from the accounting and the carried
    overlap buffers."""
    params, topo, batch = _testbed(device)
    us, wire = {}, {}
    for label, kw in (("plain", {}), ("mixed", {"momentum_mixing": "mixed"}),
                      ("mixed_ef", {"momentum_mixing": "mixed",
                                    "error_feedback": True})):
        tr = CollaborativeTrainer(_quad_loss, params, topo,
                                  CDMSGD(0.01, mu=0.9, fused=True),
                                  device=device, exchange="int8", **kw)
        us[label] = _step_us(tr, batch, device, steps_timed)
        wire[label] = tr.wire_bytes_per_step
    assert wire["mixed"] == 2 * wire["plain"], wire
    assert wire["mixed_ef"] == wire["mixed"], wire
    tr_o = CollaborativeTrainer(_quad_loss, params, topo,
                                CDMSGD(0.01, mu=0.9, fused=True), device=device,
                                exchange="int8", schedule="overlap",
                                momentum_mixing="mixed")
    spec = flatbuf.make_flat_spec(tr_o.state.params, lead=1)
    per_nbr = engine.wire_bytes_per_neighbor(tr_o.state.opt_state.wire)
    assert per_nbr == 2 * spec.exchange_bytes("int8"), \
        (per_nbr, spec.exchange_bytes("int8"))
    rec = {
        "bench": "consensus/momentum_mix",
        "model": "33k f32 params, ring deg 2, int8 wire, CDMSGD mu=0.9",
        "us_per_step": {k: round(v, 1) for k, v in us.items()},
        "wire_bytes_per_step": wire,
        "wire_bytes_per_neighbor_from_buffers": {
            "params_only": spec.exchange_bytes("int8"), "mixed": per_nbr},
        "mixed_wire_is_2x_params_only": True,
        "ef_extra_wire_bytes": 0,
    }
    row = ("kernel/momentum_mix", us["mixed"],
           f"plain_us={us['plain']:.0f};wire/step plain={wire['plain']} "
           f"mixed={wire['mixed']} (=2x);ef extra wire=0")
    return row, rec


def stale_ring(device, steps_timed: int = STEPS, drift_steps: int = DRIFT_STEPS):
    """The staleness ring's bytes a neighbour equal the sync wire's at every
    depth S (one selected generation moves), from the carried rings; the
    drift from the fault-free overlap run after ``drift_steps`` under a
    straggler and a dropped link, int8 and fp8."""
    params, topo, batch = _testbed(device)
    spec = flatbuf.make_flat_spec(
        tree_map(lambda x: x[None].expand((4,) + tuple(x.shape)), params),
        lead=1)
    sync_bytes = spec.exchange_bytes("int8")
    sync_bytes_fp8 = spec.exchange_bytes("fp8")
    fault = "stall:1:1:3,drop:0:2"

    def make(S, fs, exch="int8"):
        return CollaborativeTrainer(_quad_loss, params, topo,
                                    CDSGD(0.01, fused=True), device=device,
                                    schedule="overlap", exchange=exch,
                                    staleness=S, fault_schedule=fs)

    def run(tr):
        for _ in range(drift_steps):
            tr.step(batch)
        return tr.state.params

    base, base_fp8 = run(make(1, None)), run(make(1, None, "fp8"))
    us, drift, drift_fp8, ring_bytes = {}, {}, {}, {}
    for S in (1, 2, 4):
        tr = make(S, fault)
        ring_bytes[f"S{S}"] = engine.wire_bytes_per_neighbor(
            tr.state.opt_state.wire)
        assert ring_bytes[f"S{S}"] == sync_bytes, (S, ring_bytes, sync_bytes)
        us[f"S{S}"] = _step_us(tr, batch, device, steps_timed)
        drift[f"S{S}"] = _drift(run(tr), base)
        tr8 = make(S, fault, "fp8")
        assert engine.wire_bytes_per_neighbor(
            tr8.state.opt_state.wire) == sync_bytes_fp8
        drift_fp8[f"S{S}"] = _drift(run(tr8), base_fp8)
    rec = {
        "bench": "consensus/stale_ring",
        "model": "33k f32 params, ring deg 2, int8 wire, CDSGD",
        "fault_schedule": fault,
        "us_per_step": {k: round(v, 1) for k, v in us.items()},
        "wire_bytes_per_neighbor": ring_bytes,
        "sync_wire_bytes_per_neighbor": sync_bytes,
        "ring_bytes_independent_of_S": True,
        "drift_vs_faultfree": drift,
        "drift_vs_faultfree_fp8": drift_fp8,
        "drift_steps": drift_steps,
    }
    row = ("kernel/stale_ring", us["S4"],
           f"wire/nbr S1={ring_bytes['S1']} S2={ring_bytes['S2']} "
           f"S4={ring_bytes['S4']} (=sync {sync_bytes});"
           f"drift S1={drift['S1']:.1e} S4={drift['S4']:.1e}")
    return row, rec


def compressor_frontier(device, steps_timed: int = STEPS,
                        drift_steps: int = FRONTIER_STEPS):
    """Bytes against drift over the compressor axis (f32 / int8 / fp8 /
    topk:p / rank:r): every byte count from the carried overlap wire,
    checked against the accounting; top-k at p = 0.01 moves >= 25x fewer
    bytes than f32.  The drifts after ``drift_steps`` against the f32 run,
    and error feedback against no error feedback at p = 0.1, are recorded
    as measured."""
    base_p, topo, batch = _testbed(device)
    gen = torch.Generator().manual_seed(7)
    stacked = tree_map(lambda x: (x[None] + 0.01 * torch.randn(
        (4,) + tuple(x.shape), generator=gen)).to(device), base_p)
    spec = flatbuf.make_flat_spec(stacked, lead=1)
    degree = topo.degree()

    def make(compressor):
        kw = {"compressor": compressor} if compressor != "none" else {}
        if compressor.startswith(("topk", "rank")):
            kw["error_feedback"] = True       # biased compressors are EF-only
        tr = CollaborativeTrainer(_quad_loss, base_p, topo,
                                  CDSGD(0.01, fused=True), device=device,
                                  schedule="overlap", **kw)
        tr.state = TrainState(params=tree_map(torch.clone, stacked),
                              opt_state=tr._program.init_state(
                                  tree_map(torch.clone, stacked)))
        return tr

    legs = ("none", "int8", "fp8", "topk:0.1", "topk:0.01", "rank:4", "rank:1")
    us, bytes_nbr, drift = {}, {}, {}
    f32_params = None
    for leg in legs:
        tr = make(leg)
        name = "f32" if leg == "none" else leg
        actual = engine.wire_bytes_per_neighbor(tr.state.opt_state.wire)
        analytic = consensus_lib.program_bytes_per_neighbor(spec, tr.program)
        assert actual == analytic, (name, actual, analytic)
        assert tr.wire_bytes_per_step == actual * degree, (
            name, tr.wire_bytes_per_step, actual, degree)
        bytes_nbr[name] = actual
        us[name] = _step_us(tr, batch, device, steps_timed)
        for _ in range(drift_steps):
            tr.step(batch)
        if leg == "none":
            f32_params = tr.state.params
            drift[name] = 0.0
        else:
            drift[name] = _drift(tr.state.params, f32_params)

    # no-EF top-k at equal p through the engine directly:
    # make_mixing_program refuses the combination at config time
    prog = dataclasses.replace(
        consensus_lib.make_mixing_program(topo, compressor="topk:0.1",
                                          error_feedback=True),
        error_feedback=False)
    opt = CDSGD(0.01, fused=True)
    comm = stacked_comm_ops(topo, program=prog, device=device)
    sp = engine.StepProgram(
        optimizer=opt, comm=comm, grad_phase=engine.make_grad_phase(_quad_loss),
        update_phase=engine.make_update_phase(opt, comm, "overlap"),
        schedule="overlap")
    params = tree_map(torch.clone, stacked)
    state = sp.init_state(params)
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    for _ in range(drift_steps):
        params, state, _ = sp.step_fn(params, state, b)
    drift["topk:0.1_noef"] = _drift(params, f32_params)

    ratio = bytes_nbr["f32"] / bytes_nbr["topk:0.01"]
    assert ratio >= 25.0, (ratio, bytes_nbr)
    pmax = max(float(a.abs().max()) for a in tree_leaves(f32_params))
    rec = {
        "bench": "consensus/compressor_frontier",
        "model": "33k f32 params, ring deg 2, CDSGD, overlap schedule",
        "us_per_step": {k: round(v, 1) for k, v in us.items()},
        "wire_bytes_per_neighbor": bytes_nbr,
        "bytes_ratio_f32_over_topk001": round(ratio, 2),
        f"drift_vs_f32_{drift_steps}step": drift,
        "drift_bounded_by_2x_max_param": all(d < 2.0 * pmax
                                             for d in drift.values()),
        "accounting_matches_actual_buffers": True,
        "ef_beats_noef_at_equal_p": drift["topk:0.1"] < drift["topk:0.1_noef"],
    }
    row = ("kernel/compressor_frontier", us["topk:0.01"],
           f"bytes/nbr f32={bytes_nbr['f32']} int8={bytes_nbr['int8']} "
           f"topk:0.01={bytes_nbr['topk:0.01']} rank:1={bytes_nbr['rank:1']} "
           f"(f32/topk:0.01={ratio:.0f}x);"
           f"drift topk:0.01={drift['topk:0.01']:.1e} "
           f"ef<noef@p=0.1 {drift['topk:0.1']:.1e}<{drift['topk:0.1_noef']:.1e}")
    return row, rec


def sparse_update(device, gen, rows_n: int = ROWS_N):
    """The two operand forms of the fused update on a top-k wire, one f32
    bucket of ``rows_n`` lane rows, a ring's 2 neighbours: dense
    (decompress each neighbour, then the ``_q`` kernel) against sparse
    (the compact fields straight into ``cdsgd_update_sparse``), timed, and
    priced by ``consensus_update_cost``; the sparse form moves strictly
    fewer bytes at p = 0.01."""
    topo = make_topology("ring", 4)
    n_nbr = topo.degree()                         # 2
    slf = _randn(gen, (rows_n, 128), device)
    g = _randn(gen, (rows_n, 128), device)
    w = torch.full((3,), 1 / 3, device=device)    # [self, nbr, nbr]
    spec = flatbuf.make_flat_spec(
        {"w": torch.empty((rows_n * 128,), device="meta")})
    per_p, us = {}, {}
    for p in (0.1, 0.01):
        k_rows = tk.topk_k_rows(rows_n, p)
        x = _randn(gen, (n_nbr, rows_n, 128), device)
        vals, idx, scs = tk.topk_compress_2d(x, k_rows, 0, agent_stride=1)
        unit = torch.ones((n_nbr, rows_n, 1), device=device)
        g1, g2 = g.clone(), g.clone()

        def dense_fn():
            nb = tk.topk_decompress_2d(vals, idx, scs, rows_n)
            return kops.cdsgd_update_flat(nb, w, g1.copy_(g), 0.05,
                                          scales=unit, self_buf=slf)

        def sparse_fn():
            return kops.cdsgd_update_flat(kops.SparseNeighbors(vals, idx, scs),
                                          w, g2.copy_(g), 0.05, self_buf=slf)

        t_dense = _time_us(dense_fn, device)
        t_sparse = _time_us(sparse_fn, device)
        d = float((dense_fn() - sparse_fn()).abs().max())
        assert d < 1e-5, d
        prog = consensus_lib.make_mixing_program(
            topo, compressor=f"topk:{p}", error_feedback=True)
        cost = consensus_update_cost(spec, prog, n_nbr)
        b_sparse = kernel_bound("cdsgd_update_sparse", 1, n_nbr, rows_n,
                                torch.int8, k_rows)
        per_p[str(p)] = {
            "k_rows": k_rows,
            "us_per_call": {"dense": round(t_dense, 1),
                            "sparse": round(t_sparse, 1)},
            "walltime_ratio_dense_over_sparse": round(t_dense / t_sparse, 2),
            "hbm_bytes": {"dense": cost["dense_bytes"],
                          "sparse": cost["sparse_bytes"]},
            "hbm_bytes_ratio": round(cost["bytes_ratio"], 2),
            "flops_ratio": round(cost["flops_ratio"], 2),
            "max_abs_diff_dense_vs_sparse": d,
            "sparse_bound_ms": b_sparse[0],
        }
        us[p] = (t_dense, t_sparse)
    assert (per_p["0.01"]["hbm_bytes"]["sparse"]
            < per_p["0.01"]["hbm_bytes"]["dense"]), per_p["0.01"]
    t_dense, t_sparse = us[0.01]
    rec = {
        "bench": "consensus/sparse_update",
        "model": f"{rows_n * 128 // 1000}k f32 bucket, ring deg 2, CDSGD",
        "per_density": per_p,
        "sparse_strictly_cheaper_at_p001": t_sparse < t_dense,
    }
    row = ("kernel/sparse_update", t_sparse,
           f"dense_us={t_dense:.0f}@p=0.01;"
           f"hbm sparse/dense="
           f"{per_p['0.01']['hbm_bytes']['sparse'] / per_p['0.01']['hbm_bytes']['dense']:.3f};"
           f"walltime_ratio={per_p['0.01']['walltime_ratio_dense_over_sparse']}x;"
           + _bound(t_sparse, kernel_bound("cdsgd_update_sparse", 1, n_nbr,
                                           rows_n, torch.int8,
                                           per_p["0.01"]["k_rows"])))
    return row, rec


def serving_rows(device, gen):
    """Flash attention (1 x 4 heads on 2 KV, 1024 causal, D 64, f32) and
    WKV6 (4 heads x 512 steps, hs 64) against their plain versions."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.ops import attention_pairs
    from repro_torch.kernels.rwkv_scan import ref as wkv_ref
    from repro_torch.kernels.rwkv_scan import rwkv_scan as rs

    q = _randn(gen, (1, 4, 1024, 64), device)
    k = _randn(gen, (1, 2, 1024, 64), device)
    v = _randn(gen, (1, 2, 1024, 64), device)
    t_kernel = _time_us(lambda: fa.flash_attention_any_length(q, k, v, causal=True),
                        device)
    t_ref = _time_us(lambda: fa_ref.attention_ref(q, k, v, causal=True), device)
    nbytes = 4 * (q.numel() * 2 + k.numel() + v.numel())
    flops = 4 * 4 * attention_pairs(1024, 1024, True, None) * 64
    b = max(nbytes / HW_H100.hbm_bw, flops / HW_H100.f32_flops)
    by = "bytes" if nbytes / HW_H100.hbm_bw >= flops / HW_H100.f32_flops \
        else "operations"
    s_mat = 4 * 1024 * 1024 * 4 * 2  # S + P matrices f32, per head
    rows = [("kernel/flash_attention", t_kernel,
             f"ref_us={t_ref:.0f};score_matrix_bytes_avoided={s_mat};"
             + _bound(t_kernel, (1e3 * b, by)))]
    r = _randn(gen, (4, 512, 64), device)
    kk = _randn(gen, (4, 512, 64), device)
    vv = _randn(gen, (4, 512, 64), device)
    ww = torch.sigmoid(_randn(gen, (4, 512, 64), device)) * 0.5 + 0.45
    u = 0.1 * _randn(gen, (4, 64), device)
    t_kernel = _time_us(lambda: rs.wkv6(r, kk, vv, ww, u), device)
    t_ref = _time_us(lambda: wkv_ref.wkv6_ref(r, kk, vv, ww, u), device)
    nbytes = 4 * (5 * r.numel() + u.numel() + 4 * 64 * 64)
    flops = 4 * 512 * (5 * 64 * 64 + 5 * 64)
    b = max(nbytes / HW_H100.hbm_bw, flops / HW_H100.f32_flops)
    by = "bytes" if nbytes / HW_H100.hbm_bw >= flops / HW_H100.f32_flops \
        else "operations"
    rows.append(("kernel/wkv6_scan", t_kernel,
                 f"ref_us={t_ref:.0f};state_hbm_roundtrips=0;"
                 + _bound(t_kernel, (1e3 * b, by))))
    return rows


def run(smoke: bool = False, json_out: str = None, device=None):
    """Every section; returns the rows.  ``device="cpu"`` (plain versions,
    smoke counts) marks each row's derived column ``device=cpu``."""
    device = resolve_device(device)
    cpu = device.type != "cuda"
    smoke = smoke or cpu
    steps = SMOKE_STEPS if smoke else STEPS
    drift = SMOKE_STEPS if smoke else DRIFT_STEPS
    frontier = SMOKE_STEPS if smoke else FRONTIER_STEPS
    gen = torch.Generator(device=device).manual_seed(0)
    rows, records = [], []
    r, rec = consensus_rows(device, gen)
    rows += r
    records.append(rec)
    for fn in (lambda: bucketed_model_update(device, gen, reps=3 if smoke else 20),
               exchange_wire,
               lambda: alias_accounting(device, gen),
               lambda: schedule_overlap(device, steps),
               lambda: multi_round(device, steps),
               lambda: momentum_mix(device, steps),
               lambda: stale_ring(device, steps, drift),
               lambda: compressor_frontier(device, steps, frontier),
               lambda: sparse_update(device, gen)):
        row, rec = fn()
        rows.append(row)
        records.append(rec)
    if not smoke:
        rows += serving_rows(device, gen)
    if cpu:
        rows = [(n, us, d + f";device={device.type}(plain versions, not a card time)")
                for n, us, d in rows]
    _emit(rows, records, json_out)
    return rows


def _emit(rows, records, json_out):
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    print("JSON," + json.dumps(records))
    if json_out:
        with open(json_out, "w") as f:
            json.dump(records, f, indent=2)
        print(f"wrote {json_out}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="cut the step counts (the consensus-path sections)")
    ap.add_argument("--json-out", default=None,
                    help="also write the JSON records to this file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which needs a card)")
    args = ap.parse_args()
    run(smoke=args.smoke, json_out=args.json_out, device=args.device)
