"""Time the plain chunked mamba scan (``repro_torch.nn.ssm.mamba_chunked``)
of one or more copies of ``src/repro_torch/nn/ssm.py`` side by side on one
card.

    python3 mamba_scan_bench.py [--form LABEL=PATH ...] [--order L1,L2,...]
                                [--iters N]

Each ``--form`` names a copy of ``ssm.py`` (default: this checkout's,
labelled ``change``), imported under a module name of its own.  Shapes are
hymba-1.5b's (``d_inner`` = d_model 1,600, 16 state channels, chunks of
32): one layer's scan in the 4 x 2048 prefill (forward under
``inference_mode``) and in training at b 1 x 1024 (forward and backward
with respect to u, dt, B and C).  For each shape the forms run in the
order given (``--order prev,change,change,prev`` compares two in turns),
each printing one line: CUDA-event ms per call over ``--iters`` calls and
the allocator's peak above the inputs.  Before any timing each form's
output is held within 1e-4 of max |y| of the step recurrence
(``mamba_scan``) at b 1 x 256, and the forms' prefill outputs are
compared with each other.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import torch

import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.nn import ssm

ROOT = Path(__file__).resolve().parent


def load_form(label: str, path: str):
    spec = importlib.util.spec_from_file_location(f"_mamba_form_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.mamba_chunked


def inputs(b: int, s: int, di: int, n: int, seed: int, grad: bool = False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((b, s, di), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(0.1 * torch.randn((b, s, di), generator=gen,
                                                        device="cuda"))
    b_in, c_in = (torch.randn((b, s, n), generator=gen, device="cuda") for _ in range(2))
    a = -torch.ones((di, n), device="cuda")
    return [t.requires_grad_(grad) for t in (u, dt, b_in, c_in)] + [a]


def timed(fn, iters: int):
    """CUDA-event ms per call and the allocator's peak above what was
    allocated before (GiB)."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, (torch.cuda.max_memory_allocated() - base) / 2**30


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--form", action="append", default=[],
                    help="LABEL=PATH of a copy of ssm.py (repeatable)")
    ap.add_argument("--order", default=None)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mamba_scan_bench: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    forms = {"change": ssm.mamba_chunked}
    for item in args.form:
        label, path = item.split("=", 1)
        forms[label] = load_form(label, path)
    order = args.order.split(",") if args.order else list(forms)
    cfg = get_config("hymba-1.5b")
    di, n = cfg.d_model, cfg.ssm_state

    small = inputs(1, 256, di, n, seed=1)
    with torch.inference_mode():
        want, _ = ssm.mamba_scan(*small)
        scale = float(want.abs().max())
        for label, fn in forms.items():
            gap = float((fn(*small)[0] - want).abs().max()) / scale
            print(f"mamba_chunked [{label}] against mamba_scan at b 1 x 256: "
                  f"{gap:.3e} of max |y|")
            if not gap <= 1e-4:
                raise AssertionError(f"mamba_chunked [{label}] differs: {gap}")

    prefill = inputs(4, 2048, di, n, seed=2)
    with torch.inference_mode():
        outs = {label: fn(*prefill)[0] for label, fn in forms.items()}
        ref = outs["change"]
        for label, y in outs.items():
            print(f"mamba_chunked [{label}] against [change] at b 4 x 2048: max |diff| "
                  f"{float((y - ref).abs().max()) / float(ref.abs().max()):.3e} of max |y|")
        del outs, ref
        for label in order:
            fn = forms[label]
            ms, peak = timed(lambda: fn(*prefill), args.iters)
            print(f"mamba prefill [{label}] b 4 x 2048 d {di} n {n}: {ms:.3f} ms a layer "
                  f"(x {cfg.n_layers} layers {ms * cfg.n_layers:.1f} ms), peak "
                  f"{peak:.2f} GiB above the inputs [{card}]")
    del prefill

    train = inputs(1, 1024, di, n, seed=3, grad=True)
    for label in order:
        fn = forms[label]

        def step():
            y, h = fn(*train)
            torch.autograd.grad((y.sum() + h.sum()), train[:4])

        ms, peak = timed(step, args.iters)
        print(f"mamba train [{label}] b 1 x 1024 d {di} n {n} forward + backward: "
              f"{ms:.3f} ms a layer, peak {peak:.2f} GiB above the inputs [{card}]")


if __name__ == "__main__":
    main()
