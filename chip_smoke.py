#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, train.

    python3 chip_smoke.py

Drives the port's main path — N agents on a fixed topology training the
paper's CIFAR CNN at full width with fused CDSGD / CDMSGD — through the
entry points a user calls, and holds every CUDA kernel on that path
against its plain PyTorch version.  Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of every kernel from ``src/repro_torch/csrc`` and its time;
3. each kernel against its plain version on the card, at the training
   path's shape (W (5, 5), 16,941 rows), with the ring's ``Pi`` (zero
   weights) at that shape, at a one-agent stencil shape (W (1, 3)) and at
   a ragged row count, with CUDA-event times beside the byte bound, the
   plain version's time and a one-call library yardstick;
4. training: 10 fused CDSGD and 10 fused CDMSGD steps of the full-width
   CNN on 5 agents (fully connected), then 3 fused CDMSGD steps on the
   ring; each kernel's launch count must rise by exactly one per step (one
   f32 bucket) and losses stay finite; then the ``kernels`` JSON line;
5. parity: 3 CDMSGD steps on the card against the same 3 steps of the
   port on the CPU, from the same init and batches.

Any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
float32 matmuls and convolutions run in full float32 (TF32 off).
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import make_optimizer, make_topology  # noqa: E402
from repro_torch.core.flatbuf import make_flat_spec  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer  # noqa: E402
from repro_torch.data import AgentPartitioner, make_classification  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.nn.param import count_params, init_params  # noqa: E402
from repro_torch.nn.paper_models import (  # noqa: E402
    classifier_loss,
    cnn_classifier_apply,
    cnn_classifier_template,
)

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores

AGENTS = 5
PATH_ROWS = 16941              # one f32 bucket of the full-width CNN
KERNEL_TOL = 1e-6              # abs; same f32 operations in the same order
PARITY_TOL = 1e-4              # abs, 3 steps card vs CPU: conv sums differ in order
LR = 0.01
MU = 0.9
RING_STEPS = 3                 # fused CDMSGD on the ring: a Pi with zero weights
SOURCE = "src/repro_torch/csrc/consensus_update.cu"
REPLACES = {
    "cdsgd_update": "src/repro/kernels/consensus_update/consensus_update.py:687",
    "cdmsgd_update": "src/repro/kernels/consensus_update/consensus_update.py:729",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(name: str, a_out: int, s: int, rows: int):
    """(bound_ms, bound_by): least bytes over HBM rate vs flops over f32 peak."""
    n = rows * 128
    per_out = 2 if name == "cdsgd_update" else 4     # G (+V) read, out (+V') written
    nbytes = 4 * (a_out * s + s * n + per_out * a_out * n)
    flops = a_out * n * (2 * s + (2 if name == "cdsgd_update" else 4))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels() -> dict:
    """Phase 3: each kernel vs its plain version at four operand sets, timed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # the ring's Pi has zero weights: the kernel must still sum every term
    ring_pi = torch.tensor(make_topology("ring", AGENTS).pi, dtype=torch.float32,
                           device=dev)
    results = {}
    for name in ("cdsgd_update", "cdmsgd_update"):
        worst = 0.0
        for label, a_out, s, rows in (("path", AGENTS, AGENTS, PATH_ROWS),
                                      ("ring", AGENTS, AGENTS, PATH_ROWS),
                                      ("stencil", 1, 3, PATH_ROWS),
                                      ("ragged", AGENTS, AGENTS, 1001)):
            if label == "ring":
                w = ring_pi
            else:
                w = torch.rand((a_out, s), generator=gen, device=dev)
                w = (w / w.sum(dim=1, keepdim=True)).contiguous()
            x = torch.randn((s, rows, 128), generator=gen, device=dev)
            g = torch.randn((a_out, rows, 128), generator=gen, device=dev)
            v = torch.randn((a_out, rows, 128), generator=gen, device=dev)
            if name == "cdsgd_update":
                want = ref.cdsgd_update_ref(w, x, g, LR)
                g2 = g.clone()
                ptr = g2.data_ptr()
                out = cu.cdsgd_update(w, x, g2, LR)
                ok_ptr = out.data_ptr() == ptr
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                kernel = lambda: cu.cdsgd_update(w, x, g2, LR)
                plain = lambda: ref.cdsgd_update_ref(w, x, g, LR)
                gf, xf = g.view(a_out, -1), x.view(s, -1)
                yardstick = lambda: torch.addmm(gf, w, xf, beta=-LR)
            else:
                want, want_v = ref.cdmsgd_update_ref(w, x, g, v, LR, MU)
                g2, v2 = g.clone(), v.clone()
                ptrs = (g2.data_ptr(), v2.data_ptr())
                out, out_v = cu.cdmsgd_update(w, x, g2, v2, LR, MU)
                ok_ptr = (out.data_ptr(), out_v.data_ptr()) == ptrs
                torch.cuda.synchronize()
                err = max(float((out - want).abs().max()),
                          float((out_v - want_v).abs().max()))
                kernel = lambda: cu.cdmsgd_update(w, x, g2, v2, LR, MU)
                plain = lambda: ref.cdmsgd_update_ref(w, x, g, v, LR, MU)
                yardstick = None     # no one PyTorch call computes it
            if not ok_ptr:
                raise AssertionError(f"{name} did not write its outputs in place")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"{name} [{label}] max abs err {err} > {KERNEL_TOL}")
            worst = max(worst, err)
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(plain)
            lib_ms = cuda_ms(yardstick) if yardstick is not None else None
            b_ms, b_by = bound(name, a_out, s, rows)
            print(f"kernel {name} [{label}] W=({a_out},{s}) rows={rows}: "
                  f"max_abs_err={err:.3e} (tol {KERNEL_TOL:g}) ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms="
                  f"{'none' if lib_ms is None else f'{lib_ms:.5f}'} "
                  f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.3f}")
            if label == "path":
                results[name] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by,
                                 "library_ms": lib_ms}
        results[name]["max_abs_err"] = worst
    return results


def train_main_path(params, train) -> dict:
    """Phase 4: fused CDSGD then fused CDMSGD on the full-width CNN (fully
    connected, 10 steps each), then fused CDMSGD on the ring (3 steps)."""
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    cu.reset_launch_counts()
    for topo_name, name, n_steps in (("fully_connected", "cdsgd", 10),
                                     ("fully_connected", "cdmsgd", 10),
                                     ("ring", "cdmsgd", RING_STEPS)):
        kernel = f"{name}_update"
        kw = {"mu": MU} if name == "cdmsgd" else {}
        topo = make_topology(topo_name, AGENTS)
        torch.cuda.reset_peak_memory_stats()
        tr = CollaborativeTrainer(loss, params, topo,
                                  make_optimizer(name, LR, fused=True, **kw))
        spec = make_flat_spec(tr.state.params, lead=1)
        if [b.rows for b in spec.buckets] != [PATH_ROWS]:
            raise AssertionError(f"expected one bucket of {PATH_ROWS} rows, got "
                                 f"{[b.rows for b in spec.buckets]}")
        before = cu.launch_counts()
        batches = AgentPartitioner(train, AGENTS, seed=0).batches(64)
        times, losses = [], []
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.step(next(batches))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(m["loss"])
            counts = cu.launch_counts()
            for k in counts:
                want = before[k] + (i + 1 if k == kernel else 0)
                if counts[k] != want:
                    raise AssertionError(f"step {i}: {k} launched {counts[k]} "
                                         f"times, expected {want}")
            if not np.isfinite(m["loss"]):
                raise AssertionError(f"{name} step {i}: loss {m['loss']}")
        for leaf in tr.state.params.values():
            for t in leaf.values():
                if t.shape[0] != AGENTS or not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"{name}: bad parameter tensor {tuple(t.shape)}")
        steady = times[1:]
        print(f"train {name} fused on {topo_name}: {n_steps} steps, cnn 32x32x3 "
              f"{count_params(cnn_classifier_template(32, 3, 10))} "
              f"params, {AGENTS} agents, batch 64/agent: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, consensus_error {m['consensus_error']:.3e}, "
              f"first step {times[0]:.2f} ms, steady step median "
              f"{float(np.median(steady)):.3f} ms mean {float(np.mean(steady)):.3f} ms, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
              f"{kernel} launches {counts[kernel] - before[kernel]}")
    return cu.launch_counts()


def parity(params, train) -> float:
    """Phase 5: 3 CDMSGD steps on the card vs the port on the CPU."""
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    topo = make_topology("fully_connected", AGENTS)
    trainers = [CollaborativeTrainer(loss, params, topo,
                                     make_optimizer("cdmsgd", LR, fused=True, mu=MU),
                                     device=d) for d in ("cuda", "cpu")]
    streams = [AgentPartitioner(train, AGENTS, seed=1).batches(64) for _ in trainers]
    for _ in range(3):
        for tr, batches in zip(trainers, streams):
            tr.step(next(batches))
    gpu, cpu = (tr.state.params for tr in trainers)
    diff = max(float((gpu[k][j].cpu() - cpu[k][j]).abs().max())
               for k in gpu for j in gpu[k])
    print(f"parity cdmsgd 3 steps card vs cpu: max param abs diff {diff:.3e} "
          f"(tol {PARITY_TOL:g})")
    if not diff <= PARITY_TOL:
        raise AssertionError(f"card/CPU parity {diff} > {PARITY_TOL}")
    return diff


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; device {kind} x{count}; TF32 off for "
          "matmul and cuDNN (full float32)")

    t0 = time.perf_counter()
    cu.library()
    print(f"build consensus_update.cu (nvcc sm_90a) and load: "
          f"{time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOGS.get("consensus_update", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    measured = check_kernels()

    train, _ = make_classification(4096, n_classes=10, image_hw=32, seed=0)
    params = init_params(cnn_classifier_template(32, 3, 10), seed=0)
    counts = train_main_path(params, train)
    kernels = []
    for name in ("cdsgd_update", "cdmsgd_update"):
        if counts[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name], "launches": counts[name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": kernels}))

    parity(params, train)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
