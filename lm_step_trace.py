"""Where a collaborative LM training step's time and memory go, on the card.

Runs ``repro_torch.launch.train.main`` on gemma3-1b at published width and
depth (3 agents on a ring, batch 1 x 1024 an agent, weights made live as
``chip_smoke.py`` makes them), once per optimizer setting of
``chip_smoke.LM_RUNS`` that the command line names, and prints for each:

- per step: the synchronized wall ms, the update phase's share of it (the
  engine's ``StepProgram._update``: packing, the exchange, the fused update
  kernel, the consensus metric), the allocator's peak in the gradient
  phase and in the update phase, and the allocator counters that moved in
  the step (``cudaMalloc`` / ``cudaFree`` calls, retries after a failed
  allocation, which free the cache and synchronize);
- for two steady steps under ``torch.profiler`` (host and card): the
  card's busy ms, the host ops with the most self time, and the CUDA
  runtime and driver calls with the most host time (``cudaMalloc``,
  ``cudaFree``, the ``cuMem*`` calls of expandable segments,
  synchronizations), with their counts.

``chip_smoke.py`` sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
unless the environment sets it; set it to ``expandable_segments:False`` to
trace the allocator's other mode.

Usage (one card)::

    python3 lm_step_trace.py [--runs cdmsgd,nesterov,cdadam] [--steps 8]

Run names: ``cdmsgd`` (f32 sync), ``nesterov`` (fused Nesterov, f32 sync),
``cdadam`` (fused CDAdam, int8 overlap), ``mixed`` (CDMSGD int8 with mixed
momentum).  The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.core.engine import StepProgram
from repro_torch.core.trainer import CollaborativeTrainer
from repro_torch.kernels.consensus_update import consensus_update as cu
from repro_torch.launch import train as lm_train

RUNS = {
    "cdmsgd": ["--optimizer", "cdmsgd", "--fused"],
    "nesterov": ["--optimizer", "cdmsgd_nesterov", "--fused"],
    "cdadam": ["--optimizer", "cdadam", "--lr", str(cs.ADAM_LR), "--fused",
               "--exchange", "int8", "--schedule", "overlap"],
    "mixed": ["--optimizer", "cdmsgd", "--exchange", "int8",
              "--momentum-mixing", "mixed"],
}
COUNTERS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
            "num_sync_all_streams")
GIB = 2.0 ** 30


def _stats() -> dict:
    s = torch.cuda.memory_stats()
    return {k: s.get(k, 0) for k in COUNTERS}


def trace_run(name: str, steps: int, profiled: tuple) -> None:
    """One training run with every step broken down (see the module doc)."""
    record = []
    phase = {}
    step_orig, update_orig = CollaborativeTrainer.step, StepProgram._update

    def update(self, params, grads, opt_state):
        torch.cuda.synchronize()
        phase["grad_peak"] = torch.cuda.max_memory_allocated() / GIB
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = update_orig(self, params, grads, opt_state)
        torch.cuda.synchronize()
        phase["update_ms"] = 1e3 * (time.perf_counter() - t0)
        phase["update_peak"] = torch.cuda.max_memory_allocated() / GIB
        return out

    def step(self, batch):
        i = len(record)
        if i == profiled[0]:
            phase["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
            phase["prof"].__enter__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _stats()
        t0 = time.perf_counter()
        out = step_orig(self, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        after = _stats()
        record.append({"ms": ms, "loss": out["loss"],
                       **{k: v for k, v in phase.items() if k != "prof"},
                       **{k: after[k] - before[k] for k in COUNTERS},
                       "reserved": torch.cuda.memory_reserved() / GIB})
        if i == profiled[-1]:
            phase["prof"].__exit__(None, None, None)
            _print_profile(name, phase.pop("prof"), len(profiled))
        return out

    argv = ["--arch", "gemma3-1b", "--preset", "full", "--agents",
            str(cs.GEMMA_TRAIN_AGENTS), "--topology", "ring", "--batch", "1",
            "--seq", "1024", "--steps", str(steps), "--log-every", "0",
            "--device", "cuda", *RUNS[name]]
    cs._free()
    cu.reset_launch_counts()
    CollaborativeTrainer.step, StepProgram._update = step, update
    t0 = time.perf_counter()
    try:
        with cs.live_init(get_config("gemma3-1b")):
            lm_train.main(argv)
    finally:
        CollaborativeTrainer.step, StepProgram._update = step_orig, update_orig
    wall = time.perf_counter() - t0
    print(f"trace {name} ({' '.join(RUNS[name])}): {steps} steps, run wall "
          f"{wall:.1f} s; launches {dict((k, v) for k, v in cu.launch_counts().items() if v)}")
    for i, r in enumerate(record):
        print(f"  step {i}: {r['ms']:.1f} ms, update phase {r['update_ms']:.1f} ms; "
              f"peak grad phase {r['grad_peak']:.2f} GiB, update phase "
              f"{r['update_peak']:.2f} GiB, reserved after {r['reserved']:.2f} GiB; "
              + ", ".join(f"{k} {r[k]}" for k in COUNTERS)
              + f"; loss {r['loss']:.4f}"
              + (" (profiled)" if i in profiled else ""))
    steady = [r["ms"] for i, r in enumerate(record) if i and i not in profiled]
    upd = [r["update_ms"] for i, r in enumerate(record) if i and i not in profiled]
    print(f"  steady (steps 1-{steps - 1} unprofiled): median {np.median(steady):.1f} ms, "
          f"min {min(steady):.1f}, max {max(steady):.1f}; update phase median "
          f"{np.median(upd):.1f} ms")


def _print_profile(name: str, prof, n: int) -> None:
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3 / n
    print(f"  profile {name}: {n} steps, card busy {busy:.1f} ms a step")
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:15]:
        print(f"    host {e.key}: self {e.self_cpu_time_total / 1e3 / n:.2f} ms a step, "
              f"{e.count / n:.0f} calls")
    runtime = sorted((e for e in events if e.key.startswith(("cuda", "cuMem"))),
                     key=lambda e: -e.cpu_time_total)
    for e in runtime[:10]:
        print(f"    runtime {e.key}: {e.count / n:.0f} calls, "
              f"{e.cpu_time_total / 1e3 / n:.2f} ms a step")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lm_step_trace: this script needs a CUDA card")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", default="cdmsgd,nesterov,cdadam")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    profiled = (args.steps - 3, args.steps - 2)
    for name in args.runs.split(","):
        trace_run(name, args.steps, profiled)


if __name__ == "__main__":
    main()
