"""Time the four sparse (top-k wire) update kernels of one or more builds of
``src/repro_torch/csrc/consensus_update.cu`` side by side on one card.

    python3 sparse_update_bench.py [--source LABEL=PATH ...] [--order L1,L2,...]
                                   [--iters N] [--no-bucket]

Each ``--source`` names a copy of ``consensus_update.cu`` (default: this
checkout's, labelled ``change``).  Every copy is built with ``nvcc``
(``sm_90a``, the port's flags, one process each, all at once) into
``build/sparse_bench/`` and loaded under the wrappers' C signatures; the
wrappers then run it in place of the port's own build.  Before any timing,
each build's four sparse forms are held bit for bit against their plain
versions at the CNN bucket and on a clustered layout, float32 and bf16.

Shapes (those of ``chip_smoke.py`` phases 3 and 3c): the paper's CNN
bucket (A = S = 5, 16,941 rows, ``topk:0.01``: 170 compact rows) under the
fully connected and the ring's self-separated weights, a one-agent stencil
(1 + 3), the ring at 1,001 rows, the clustered layout; then gemma3-1b's
bf16 bucket (7,811,037 rows, 78,112 compact rows) at A = S = 4 on a ring
(32 GB of operands) and at A = S = 2 fully connected.  For each shape and form the builds run in the order given
(``--order parent,change,change,parent`` compares two builds in turns on
one card), each printing one line: CUDA-event ms over ``--iters`` calls,
kernel-only ms from ``torch.profiler``, the byte bound
(``chip_smoke.bound``) and the event time's share of it.  The card's name
and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.kernels.consensus_update import consensus_update as cu
from repro_torch.kernels.consensus_update import topk as tk

OUT = Path(__file__).resolve().parent / "build" / "sparse_bench"
FORMS = list(cs.SPARSE)


def build_sources(sources: dict) -> dict:
    """``{label: loaded library}``: every source compiled by its own nvcc
    process, all started together; a failed build raises with its log."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.nvcc_path(), {}
    for label, src in sources.items():
        digest = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:12]
        so = OUT / f"{label}-{digest}.so"
        procs[label] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "sparse_" in line and "Compiling entry" in line:
                regs = next((ln.strip() for ln in lines[i + 1:i + 4]
                             if "registers" in ln), "")
                print(f"ptxas {label}: {line.split('Compiling entry function')[-1].strip()} "
                      f"{regs}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in cu.LIBRARIES["consensus_update"].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, list(argtypes)
        libs[label] = lib
    return libs


def use(lib) -> None:
    build._LOADED["consensus_update"] = lib


def operands(gen, name, a_out, s, rows, w, compact, bucket=torch.float32):
    """``(mix, state, scalars)`` of one form: self and state of the bucket
    type, Adam's second moment positive."""
    n_state = cs.SPARSE[name][1]
    make = ((lambda: cs._bucket(gen, a_out, rows)) if bucket == torch.float32
            else (lambda: torch.randn((a_out, rows, 128), generator=gen, device="cuda",
                                      dtype=bucket)))
    state = [make() for _ in range(n_state)]
    if n_state == 3:
        state[2] = (state[2].abs() * 0.01).contiguous()
    scalars = {1: (cs.LR,), 2: (cs.LR, cs.MU), 3: cs.ADAM}[n_state]
    return [w, make(), *compact], state, scalars


def call(name, mix, state, scalars):
    out = cu.KERNELS[name](*mix, *state, *scalars)
    return out if isinstance(out, tuple) else (out,)


def check_bits(libs: dict, gen) -> None:
    """Each build against the plain versions, bit for bit, in place."""
    dev = torch.device("cuda")
    w = torch.tensor(cs._self_separated_weights(cs.make_topology(
        "fully_connected", cs.AGENTS).pi), dtype=torch.float32, device=dev)
    k_rows = tk.topk_k_rows(cs.PATH_ROWS, cs.TOPK_P)
    layouts = {"spread": cs._compact(gen, cs.AGENTS, cs.PATH_ROWS, k_rows),
               "clustered": cs._clustered_compact(gen, cs.AGENTS, cs.PATH_ROWS, k_rows)}
    for bucket in (torch.float32, torch.bfloat16):
        for layout, compact in layouts.items():
            for name in FORMS:
                mix, state, scalars = operands(gen, name, cs.AGENTS, cs.AGENTS,
                                               cs.PATH_ROWS, w, compact, bucket)
                want = cs.SPARSE[name][0](*mix, *state, *scalars)
                want = want if isinstance(want, tuple) else (want,)
                for label, lib in libs.items():
                    use(lib)
                    got = call(name, mix, [t.clone() for t in state], scalars)
                    torch.cuda.synchronize()
                    if not all(cs._equal_bits(g, r) for g, r in zip(got, want)):
                        raise AssertionError(f"{label} {name} {layout} {bucket} differs "
                                             "from its plain version")
    print(f"bits: every build's four forms equal their plain versions on the "
          f"CNN bucket, spread and clustered, float32 and bf16 ({', '.join(libs)})")


def time_shape(libs, order, label, name, a_out, s, rows, mix, state, scalars,
               iters, bucket=torch.float32) -> None:
    k_rows = mix[2].shape[1]
    b_ms, b_by = cs.bound(name, a_out, s, rows, torch.int8, k_rows, bucket=bucket)
    for build_label in order:
        use(libs[build_label])
        fn = (lambda: call(name, mix, state, scalars))
        ms = cs.cuda_ms(fn, iters=iters, warmup=2)
        only = cs.device_ms(fn, "sparse_", iters=min(iters, 10))
        print(f"bench {name} [{label}] {build_label}: ms={ms:.5f} kernel_only_ms="
              f"{'not measured' if only is None else f'{only:.5f}'} bound_ms="
              f"{b_ms:.5f} ({b_by}) share={b_ms / ms:.3f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a consensus_update.cu (repeatable)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, in timing order (default: each once)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--no-bucket", action="store_true",
                    help="skip gemma3-1b's bf16 bucket")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sparse_update_bench: needs a CUDA card")
    sources = dict(s.split("=", 1) for s in args.source) or {
        "change": str(build.CSRC / "consensus_update.cu")}
    order = args.order.split(",") if args.order else list(sources)
    print(cs.card_line())
    libs = build_sources(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_bits(libs, gen)
    dev = torch.device("cuda")
    q_w = {t: torch.tensor(cs._self_separated_weights(cs.make_topology(t, cs.AGENTS).pi),
                           dtype=torch.float32, device=dev)
           for t in ("fully_connected", "ring")}
    for label, a_out, s, rows in (("path", cs.AGENTS, cs.AGENTS, cs.PATH_ROWS),
                                  ("ring", cs.AGENTS, cs.AGENTS, cs.PATH_ROWS),
                                  ("stencil", 1, 3, cs.PATH_ROWS),
                                  ("ragged-ring", cs.AGENTS, cs.AGENTS, 1001),
                                  ("clustered", cs.AGENTS, cs.AGENTS, cs.PATH_ROWS)):
        k_rows = tk.topk_k_rows(rows, cs.TOPK_P)
        if label in ("path", "clustered"):
            w = q_w["fully_connected"]
        elif "ring" in label:
            w = q_w["ring"]
        else:
            w = torch.rand((a_out, s + 1), generator=gen, device=dev)
            w = (w / w.sum(dim=1, keepdim=True)).contiguous()
        compact = (cs._clustered_compact(gen, s, rows, k_rows) if label == "clustered"
                   else tk.topk_compress_2d(cs._bucket(gen, s, rows), k_rows, rows,
                                            agent_stride=104729))
        for name in FORMS:
            mix, state, scalars = operands(gen, name, a_out, s, rows, w, compact)
            time_shape(libs, order, label, name, a_out, s, rows, mix, state, scalars,
                       args.iters)
    if args.no_bucket:
        return
    # gemma3-1b's bucket on a ring of 4 (phase 3c), and on the 2 fully
    # connected agents of phase 10b's top-k runs
    full = cs.lm_bucket_rows()
    for label, a, topo in (("bucket", cs.LM_AGENTS, "ring"), ("bucket-a2", 2, "fully_connected")):
        wq = torch.tensor(cs._self_separated_weights(cs.make_topology(topo, a).pi),
                          dtype=torch.float32, device=dev)
        compact = cs._compact(gen, a, full, tk.topk_k_rows(full, cs.TOPK_P))
        for name in FORMS:
            mix, state, scalars = operands(gen, name, a, a, full, wq, compact, torch.bfloat16)
            time_shape(libs, order, label, name, a, a, full, mix, state, scalars,
                       max(2, args.iters // 5), bucket=torch.bfloat16)
            del mix, state
            cs._free()
        del compact

if __name__ == "__main__":
    main()
