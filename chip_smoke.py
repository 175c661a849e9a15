#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, train.

    python3 chip_smoke.py

Drives the port's main paths — N agents on a fixed topology training the
paper's CIFAR CNN at full width with fused CDSGD / CDMSGD / CDMSGD-Nesterov
/ CDAdam, on the f32 wire and on the quantized (bf16 / int8 / fp8) wire,
with error feedback, the overlap schedule and momentum mixing, and the
gossip, time-varying, SGD / MSGD and FedAvg baselines — through the entry
points a user calls, and holds every CUDA kernel on those paths against
its plain PyTorch version.  Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of every kernel source in ``src/repro_torch/csrc`` (one
   ``nvcc`` each, all started together), its time and ptxas's register and
   spill lines;
3. each kernel against its plain version on the card, at the training
   path's shape (A = S = 5, 16,941 rows), with the ring's ``Pi`` (zero
   weights) at that shape, at a one-agent stencil shape and at a ragged row
   count, every payload dtype of the wire, with an all-zero row (scale 1.0)
   in every operand; CUDA-event times beside the byte bound, the plain
   version's time and a one-call library yardstick where there is one,
   and the kernel's own time from a ``torch.profiler`` trace.
   ``sr_quantize`` is held bit for bit (both sides draw the same Philox
   bits), and its int8 rounding to its error bound and, over 64 seeds, to
   unbiasedness.  The Nesterov and CDAdam kernels (dense, ``_q``, ``_qm``)
   and ``cdmsgd_update_qm`` are held the same way, every output (the
   lookahead, both Adam moments) equal to the plain version's;
4. training runs of the full-width CNN on 5 agents (table ``RUNS``): f32
   sync CDSGD / CDMSGD (and CDMSGD on the ring), int8 sync CDMSGD, int8
   overlap CDSGD with error feedback, fp8 and bf16 sync CDSGD, f32 overlap
   CDMSGD and int8 overlap CDMSGD on the ring; Nesterov (f32 sync, int8
   sync, int8 overlap mixed on the ring), CDAdam (f32 sync, int8 sync with
   EF, fp8 overlap mixed), mixed CDMSGD (int8 sync, f32 overlap); gossip,
   time-varying CDSGD, SGD, MSGD and FedAvg (no kernel).  Every launch
   count is set to 0 before a run and must rise by exactly the expected
   number per step (one update per step, one ``sr_quantize`` per quantized
   payload per step — two under momentum mixing — and as many more at
   overlap init; none for the baselines); losses stay finite.  Then the
   ``kernels`` JSON line, launches summed over the runs;
5. parity, card against the port on the CPU from the same init and
   batches: 3 f32 CDMSGD steps, 3 f32 overlap CDMSGD steps, one int8 sync
   CDMSGD step whose wire (codes and scales) must be equal bit for bit,
   two int8 mixed CDMSGD steps with both payload wires equal bit for bit
   from the same state, and CDAdam's update phase (int8, mixed) on card
   gradients copied to the CPU, within 1e-6.

The compressor slice (top-k and rank-r on the error-feedback rail) adds:
the four sparse update kernels (``*_update_sparse``: the ``_q`` forms'
arithmetic with the top-k wire's compact stacks scattered in) and the
top-k threshold kernel to phase 3, each against its plain version at the
path shape (``topk:0.01``: 170 compact rows), with the ring's ``Pi`` and
at 1,001 rows; six phase-4 runs (``COMPRESSED_RUNS``: CDSGD / CDMSGD /
Nesterov / CDAdam on ``topk:0.01`` and ``topk:auto:131072`` with the
sparse kernels, ``topk:0.01`` with ``sparse_update=False`` and ``rank:4``
through the ``_q`` kernels) with exact launch counts and wire bytes
checked against the accounting; the threshold kernel run on the first
top-k run's carried buffers ``x + e``, bracketing the K-th magnitude the
wire's exact selection kept; and three parity checks: the sparse and the
dense update phase on the card from one state with the same gradients
(wires bit for bit, params within 1e-6), and card vs CPU update phases of
CDMSGD ``topk:0.01`` (wire bit for bit, residual and params within 1e-6)
and ``rank:4`` (within 1e-5).

The serving slice (the model zoo's prefill and cached decode) adds the
flash attention and WKV6 kernels to phase 3, each against its plain
version at its path shape (gemma3-1b: B 4, S 2048, 4 query heads on 1 KV
head of 256, bf16, the 512 window and the global mask; rwkv6-1.6b: 4 x 32
heads of 64 over 2048 steps, bf16 r, k, v, f32 w, u; and both in float32)
with the time of one ``scaled_dot_product_attention`` call beside the
flash kernel, and then:

6. prefill: ``forward`` of full-width gemma3-1b and rwkv6-1.6b (bf16
   weights from ``init_params``, random, seed 0) on 4 x 2048 tokens under
   ``torch.inference_mode``: every launch count set to 0 before one
   forward and read after it (exactly 26 flash launches, 24 WKV launches),
   finite logits, the wall time and prefill tokens/s, the peak memory, and
   one profiled forward counting each kernel's launches in the trace;
7. serve: the ``serve`` loop at full width (batch 4, prompt 8, 16 new
   tokens; no kernel launch in decode) and its decode tokens/s, then the
   port's decode against its own kernel-backed forward over 64
   teacher-forced positions on float32 weights made live and well
   conditioned (``live_weights``), within 1e-3 of max |logit|; the same
   weights in bf16 at growing depth (the first 2 to all layers), where
   decode's distance from the float32 forward is held to at most twice
   the bf16 forward's own, and at 2 layers (the reference's depth) decode
   against forward within 5e-2 (the reference's bound); the template's
   draw is printed;
8. card against CPU at full width in float32 at reduced depth, on
   ``live_weights``: gemma3-1b at 7 layers (a 6-layer super-block and a
   tail: both masks) at b 1, s 640, and rwkv6-1.6b at 2 layers at b 1, s
   256, logits within 1e-4 of max |logit|.

The tensor-core slice routes bfloat16 attention to ``flash_tc_kernel``
(wgmma and TMA) and float32 to ``flash_kernel``, and lets the model path
take ragged lengths.  Phase 3 holds the bf16 kernel at the path shapes
and at s = 200 (window 512 and global) against the plain version (within
2e-2, and at most twice SDPA's max abs error on the same operands), its
bound taken at the bf16 tensor-core rate (the float32 rows keep the
float32 rate), with SDPA's time and the ratio beside each bf16 row, and
prints the speed criteria (global at most 2x SDPA causal and 0.23 ms, the
window at most SDPA's band mask) and the wrapper's host time per call at a
tiny shape; each launch is checked on the per-kernel count.  Phase 6
requires all 26 gemma3-1b launches on the tensor-core kernel (count and
trace) and prints its share of device time; phase 7 prints
``tokens_per_s`` (the reference's figure) and ``decode_tokens_per_s``.

The WKV6 kernel runs one 512-thread block per head (4 state rows by 2
columns in each thread's registers), takes the bonus term out of the
element loop as one scalar per step and lands the next 32 steps by
cp.async while the current ones compute; phase 3 prints its speed
criteria (the path row at most 0.40 ms, the goal at most 0.20 ms), met or
not, not held.

The mixed-momentum slice redesigns the ``_qm`` kernels (each neighbour's
payload read once per register tile of outputs: 4 with an f32 payload, one
with a narrow one) and ``sr_quantize`` (a persistent grid whose warps walk
the rows with the next row's load in flight; the wrapper resolves its C
function once and reads the raw stream handle).  Phase 3 adds a
``[path16-f32]`` row for each ``_qm`` kernel (A = 16, S = 15), an
``agents7`` row for ``sr_quantize`` (agent boundaries inside blocks), and
two lines of speed criteria, met or not, not held: ``_qm speed criteria``
(``cdmsgd_update_qm [path-f32]`` at most 0.13 ms, goal 0.11; Nesterov and
CDAdam f32 at 70% of their bounds; the narrow rows within 5% of the old
loop's times) and ``sr_quantize speed criteria`` (int8 kernel-only at most 0.021 ms, goal
0.019; the CUDA-event time within 15% of kernel-only; the wrapper's host
time per call over 1,000 unsynchronized calls).

The float32-flash and threshold slice redesigns ``flash_kernel`` (the key
loop of long query tiles split over blocks that combine their partial
results through a workspace, 128-key tiles, a cp.async ring) and moves the
whole ``topk_threshold`` function onto the card (amax, thresholds, counts
and the pick: a memset and two launches).  Phase 3 adds float32 flash rows
at the gemma3-1b prefill shape (``path-f32``, ``path-f32-global``, SDPA
float32 beside them) and a ``flash f32 speed criteria`` line (b 1, s 640
at most SDPA float32 and 0.08 ms, goal 0.05; the prefill shape at 40% of
the float32 bound); the threshold at 7 agents (``agents7``), its trace per
call (at most two kernels and one memset, no copy: held) and a
``topk_threshold speed criteria`` line (the CUDA-event card ms at most
0.05, the count sweep alone at most 0.018 ms, the function's device time,
all its kernels, at most 0.035 ms, and the wrapper's host time per call
over 1,000 unsynchronized calls), met or not, not held.

The strategies-and-benchmarks slice (the MixingProgram's time-varying and
multi-round strategies, the bounded-staleness ring with fault schedules,
FedAvg's partial participation, and the paper's benchmarks) adds, each
path with its launch counts set to 0 before it and read after it:

4b. ``MIXING_RUNS``: the full-width CNN on 5 agents, 3 steps each —
    time-varying f32 CDSGD over ``alternating:ring:star`` (the weights
    ``Pi_t`` the exchange hands the kernel checked to change with the
    step), int8 CDMSGD and f32 CDSGD with 2 and 3 consensus rounds, int8
    overlap CDMSGD on a depth-2 ring under ``straggler:1:1,drop:0:2``,
    int8 EF CDSGD over ``gossip:8``, int8 overlap Nesterov on a depth-4
    ring under ``stall:2:1:3``, and FedAvg (E = 2) with agent 1 absent
    every second step (no kernel; the partial sync leaves every agent
    equal).  Launches exact per step (one ``_q`` update, ``k`` quantizes
    a step per payload, one more at overlap init); wire bytes against the
    accounting (``k`` rounds move ``k`` times the bytes, a schedule its
    mean degree), the ring's one generation whatever its depth;
9.  the paper's benchmarks through ``repro_torch.benchmarks``: fig1a and
    fig1b at the reference's step counts (150 / 200; their CSV rows as the
    reference prints them), fig1a's CDSGD and fig1b's CDMSGD again fused
    (exactly one update launch a step), each row's steady step time beside
    the card's name and power limit; fig1b's CDMSGD unfused and fused
    against the CPU over 20 steps (loss and consensus within 1e-4
    relative) and Proposition 1's benchmark against its CPU run (1e-4).
    Phase 5 adds run 2's update phase, card against CPU from one state
    with the card's gradients (both rounds' int8 wires and the round-1 mix
    bit for bit, params and momentum within 1e-6), and run 4 over 3 steps
    from the card's state (the ring's slots bit for bit, ``send_age`` and
    ``ages`` equal, params within 1e-4).

The LM training slice (the model zoo trained through
``repro_torch.launch.train``, with bf16 parameter buckets in the update and
quantize kernels, and checkpoint / resume) adds:

3c. the dense and ``_q`` forms of CDSGD / CDMSGD and ``sr_quantize`` on
    bf16 buckets (``BF16_FORMS``) against their plain versions bit for bit
    on 1/16 of gemma3-1b's bucket (488,190 of 7,811,037 rows, A = S = 4 on
    a ring) and at 1,001 rows, every neighbour / payload / code type; then
    timed at the whole bucket (CUDA events, kernel-only from the profiler)
    beside the bf16 byte bound and the plain version over the bucket in 16
    row slices; each a ``:bf16`` entry of the ``kernels`` line, its
    launches the bf16-bucket launches of phases 10-12;
10. gemma3-1b at full width and depth through ``repro_torch.launch.train.
    main`` (``--preset full --agents 3 --topology ring --batch 1 --seq
    1024``: 22 banded local layers, 4 blockwise global ones; 4 agents ran
    out of the card's memory): fused CDMSGD
    on the f32 wire (one ``cdmsgd_update`` a step), CDSGD on the int8 wire
    with the overlap schedule (one ``sr_quantize`` and one
    ``cdsgd_update_q`` a step, one ``sr_quantize`` at init), fused CDMSGD
    with 2 microbatches (batch 2); 5 steps each, every launch on the bf16
    bucket, no flash or WKV6 launch, finite losses, the steady median step,
    tokens/s, peak memory, wire bytes against the accounting and one
    profiled step with the update kernels' share;
11. rwkv6-1.6b the same way (2 agents fully connected, batch 2, seq 128:
    the chunked WKV; fused CDSGD, 3 steps);
12. resume: gemma3-1b at full width with 2 layers, 2 agents, CDMSGD int8
    overlap with error feedback: 4 uninterrupted steps equal 2 +
    checkpoint + ``--resume`` + 2 bit for bit (params, momentum, wire,
    residual), the checkpoint restored on the CPU equal too (a temporary
    directory, removed);
13. card against CPU on reduced gemma3-1b: two float32 steps within 1e-4
    on ``live_weights``; the bf16 update phase (f32-wire CDMSGD, int8-wire
    CDSGD) from one state with the card's gradients, bit for bit.

The sharded slice (one process per agent, ``repro_torch.launch.steps.
build_train_step``) adds:

14. (run right after the build, while this process holds little of the
    card's memory) three ``gloo`` ranks, all on the one card, spawned through
    ``repro_torch.launch.mesh.spawn_agents`` (payloads staged through
    pinned host buffers): gemma3-1b at full width with ``SHARDED_RUN_LAYERS``
    layers on a ring of 3 (``live_weights``; batch 1 x 1024 of each rank's
    token shard), CDMSGD on the f32 wire (sync) and CDSGD on the int8 wire
    (overlap), 3 steps each: per rank the step ms, the exchange's host ms
    (staging plus gloo), the bytes posted a step against
    ``program_bytes_per_neighbor`` x 2 neighbours, exact launches (one
    update a step, one ``sr_quantize`` more on int8 and one at overlap
    init, no flash / WKV6), peak memory, finite losses; then at full width
    with 2 layers in float32, each rank's update phase against the
    stacked trainer's (one rank at a time builds it) from one seeded state,
    bit for bit, and one whole step within 1e-5 of max |param|.  A rank
    that fails or hangs past its limit fails the phase.

The bf16-optimizer and dense-configs slice (every update form on bf16
parameter buckets; h2o-danube-3-4b, granite-3-8b and starcoder2-7b, with
flash attention at head dim 120) adds:

3.  flash attention at h2o-danube's prefill shape (B 4, H 32 on KV 8, S
    2048, D 120, window 4096), at a ragged s = 200 with a window, and in
    float32 (b 1, s 640), against the plain version (``FLASH_D120``, its own
    row of the ``kernels`` line, SDPA causal beside it);
3c. (``BF16_FORMS``) the ``_qm``, Nesterov, CDAdam and sparse forms as well,
    bit for bit at A = S = 4 and at the one-agent stencil shapes, every
    payload type (the ``_qm`` forms with a second payload), the sparse forms
    on int8 compact stacks at ``topk:0.01``; timed at the whole bucket;
6-7. (``DENSE_ARCHS``) each of the three archs at published size, one at a
    time, bf16 weights drawn on the card: the counted 4 x 2048 prefill (24,
    40, 32 flash launches, all on ``flash_tc_kernel``), the serve loop, and
    decode against the forward on the first 2 layers;
8.  each of them card against CPU in float32 at full width and 2 layers;
10. gemma3-1b at full depth also with fused Nesterov (f32 wire), CDAdam
    (int8 overlap) and mixed-momentum CDMSGD (int8: ``cdmsgd_update_qm``);
10b. (``LM_SMALL_RUNS``) gemma3-1b at full width with 2 layers, 2 agents:
    the four top-k sparse forms (``topk:0.01`` with error feedback; the
    compact values' ``sr_quantize`` on float32), Nesterov's ``_q`` and
    ``_qm`` forms and CDAdam's dense and ``_qm`` forms, 3 steps each, with
    exact launches and finite losses.

The sparse-kernel redesign (persistent CTAs with a carried cursor into each
neighbour's indices) adds to phases 3 and 3c a ``clustered`` index layout
(each neighbour's entries in three runs, most tiles empty), bit for bit
like the others, and a ``sparse speed criteria`` line: each sparse form's
share of its byte bound at the path shape (CUDA events and kernel-only) and
at gemma3-1b's bf16 bucket against the 0.75 goal, and its time against the
parent kernel's (``SPARSE_BEFORE_MS``), met or not, not held.

The sharded mode's agent axis (the staleness ring and fault schedules,
the compressors, factored ``pod x data`` meshes) adds:

3c. the four sparse forms at one output agent over ``U`` received compact
    stacks (weights ``(1, 1 + U)``, U = 2 and 3; f32 and bf16 buckets; the
    2-layer gemma3-1b bucket's rows and 1,001 rows), bit for bit, timed at
    the 2-layer rows beside their byte bound;
14. (``SHARDED_SMALL_RUNS``) gemma3-1b at full width with 2 layers on the
    same 3 ranks: CDSGD int8 overlap (the baseline at that depth), CDSGD
    ``topk:0.01`` with error feedback under overlap (``cdsgd_update_sparse``
    at one output agent, the compact fields on the wire), CDSGD int8
    overlap with the staleness ring at depth 2 under
    ``straggler:1:1,drop:0:1``, CDMSGD ``rank:4`` with error feedback
    (sync), and (``SHARDED_SPARSE_RUNS``) CDMSGD, Nesterov and CDAdam on
    ``topk:0.01`` with error feedback (sync: the other three sparse forms
    at one output agent); each checked like the 4-layer runs, and
    certified by the wire-contract checker (phase 16's
    ``staticcheck.check_bundle``, one more step on every rank, after the
    launch counts), and
    printed against the baseline (``sharded 2 layers ...`` lines); the
    parity of all but ``SHARDED_SPARSE_RUNS`` at 2 float32 layers (rank-r
    within ``RANK_TOL``); then 4 ranks on ``pod 2 x data
    2`` (``FACTORED_AXES``), CDMSGD int8 sync, parity only against the
    stacked trainer on ``kron(Pi_pod, Pi_data)``.  The sharded runs'
    launches join the ``kernels`` line.

The MoE, MLA and VLM slice (kimi-k2-1t-a32b: GQA and MoE; deepseek-v2-236b:
MLA and MoE; internvl2-2b: a projected stub-patch frontend; the loss's
remat and the router's aux term) adds:

3.  flash attention at kimi-k2's and internvl2-2b's prefill shapes (B 4,
    S 2048, D 128, causal; H 64 on KV 8 and H 16 on KV 8), against the
    plain version, SDPA causal beside each;
6-7. (``FAMILY_ARCHS``) each at published width, one at a time, weights
    drawn on the card: internvl2-2b at full depth on 4 x (256 patches + 1792
    tokens), kimi-k2 and deepseek-v2 at 2 layers (1 dense, 1 MoE) on 4 x
    2048: the counted prefill (exactly 24, 2 and 0 flash launches, all on
    ``flash_tc_kernel``: deepseek-v2's MLA is plain, as in the reference),
    wall and device ms, the top kernels, peak memory and an MoE layer's
    dispatch share (``moe dispatch`` lines); the serve loop;
8.  each reduced in float32, card against CPU (the MoE routes compared
    first, all alike) and decode against the forward on the card;
10c. (``FAMILY_LM_RUNS``) internvl2-2b at full width on 2 agents, CDMSGD
    f32 sync and CDSGD int8 overlap, each without and with remat (its first
    step's update phase bit for bit with the run without; steady step,
    tokens/s and peak memory of both); kimi-k2 and deepseek-v2 reduced on 2
    agents, CDMSGD int8, an update and a quantize launch a step on each of
    their two buckets (bf16 weights, float32 routers), ``moe_aux`` finite
    and above 0;
13. their update phases card against CPU bit for bit;
14. the timed runs and their parity pass ``remat=False``, but for the
    2-layer float32 parity of ``SHARDED_REMAT_PARITY`` (CDSGD int8
    overlap), at ``build_train_step``'s default ``remat=True``.

The hybrid and encoder-decoder slice (hymba-1.5b: sliding-window attention
beside mamba heads; seamless-m4t-medium: a non-causal encoder over stub
audio frames, a decoder with cross-attention; the three LM examples) adds:

3.  (``FAMILY_FLASH``) flash attention at hymba-1.5b's prefill layer (B 4,
    H 25 on KV 5, S 2048, D 64, window 1024), seamless's encoder (B 4, 16
    on 16, S 1024, non-causal; bf16 and float32, the serve loop's float32
    encode), its decoder self-attention (S 2048, causal, no window, bf16)
    and its cross-attention (Sq 2048 over Sk 1024, non-causal, no window,
    bf16), against the plain version, SDPA beside each;
6-7. (``FAMILY_ARCHS``) both at full width and depth, bf16 weights drawn on
    the card: hymba-1.5b on 4 x 2048 tokens (exactly 32 flash launches; one
    profiled forward's mamba share of the device time, ``mamba share``),
    seamless on 4 x (1024 bf16 stub frames + 2048 tokens) (exactly 36: 12
    encoder, 12 decoder self, 12 cross); the serve loop, seamless's with
    its float32 encode before the timed loop (exactly 12 float32 flash
    launches, none in decode);
8.  both reduced in float32, card against CPU, and decode against the
    forward on the card over 32 positions (hymba's reduced window of 8
    exceeded; seamless's decode on ``encode_for_decode``'s ``enc_out``);
10c. (``FAMILY_LM_RUNS``) both at full width on 2 agents (a ring), CDMSGD
    int8 overlap, 3 steps: hymba-1.5b at b 1 x 1024 with remat (the
    reckoned peak printed before the run), seamless at b 1 x 1024 text
    behind its 1024 float32 frames; the update and quantize kernels timed
    at each bf16 bucket beside the byte bound;
13. both reduced, bf16, CDMSGD int8: the update phase card against CPU;
15. the examples ``serve_batched``, ``topology_study`` and
    ``collaborative_lm_pretrain`` at their tiny presets, a few steps, on
    the card.

The analysis slice (``repro_torch.analysis``: the op counter, the roofline
on the card's peaks, the wire-contract checker; ``launch.check``,
``launch.dryrun``, the kernel microbenchmark) adds:

10. (``COUNTED_RUN``) one more step of gemma3-1b's CDMSGD f32 run under the
    op counter on the card against the same step traced on ``meta``: equal
    dot FLOPs (a gate); the steady step's MFU against the card's bf16 peak,
    the useful-FLOPs ratio, and the meta trace's peak of live bytes beside
    the measured peak (``analysis op counter`` line);
14. the two ``SHARDED_RUNS`` at ``SHARDED_RUN_LAYERS`` layers instead of
    the full depth, and the remat parity folded into the int8 overlap
    parity; every 2-layer run certified by ``check_bundle`` on every rank
    (``analysis sharded`` lines);
16. ``launch.check`` over the stacked matrix on the card, the dry-run's
    records of gemma3-1b ``train_4k`` (CDMSGD int8 overlap; CDSGD
    ``topk:0.01``) with their roofline rows, and ``kernel_microbench
    --smoke`` on the card.

Any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
float32 matmuls and convolutions run in full float32 (TF32 off).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the LM phases hold a 1 B-parameter model's buckets (8 GB each at 4
# agents) beside freed activations of every size: without expandable
# segments the caching allocator's reserved blocks fragment and an 8 GB
# request fails with 27 GB reserved but free (an H100 80GB)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.analysis import opcount  # noqa: E402
from repro_torch.analysis import staticcheck  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    HW_H100,
    kernel_family,
    model_flops,
)
from repro_torch.analysis.roofline import kernel_bound as bound  # noqa: E402
from repro_torch.benchmarks import common as bench  # noqa: E402
from repro_torch.benchmarks import consensus_radius  # noqa: E402
from repro_torch.benchmarks import fig1a_cdsgd_vs_sgd, fig1b_cdmsgd_vs_fedavg  # noqa: E402
from repro_torch.checkpoint import restore_train_state  # noqa: E402
from repro_torch.configs import ARCH_CONFIGS, InputShape, get_config  # noqa: E402
from repro_torch.core import make_optimizer, make_topology  # noqa: E402
from repro_torch.core.consensus import (  # noqa: E402
    WireRing,
    _self_separated_weights,
    program_bytes_per_neighbor,
    widen_with_momentum,
)
from repro_torch.core.faults import make_fault_schedule  # noqa: E402
from repro_torch.core.engine import wire_bytes_per_neighbor  # noqa: E402
from repro_torch.core.flatbuf import make_flat_spec  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import (  # noqa: E402
    AgentPartitioner,
    lm_agent_batches,
    make_classification,
    make_lm_tokens,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.kernels.consensus_update import topk as tk  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rwkv_scan import rwkv_scan as rs  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch.mesh import spawn_agents  # noqa: E402
from repro_torch.launch.sharding import local_batch  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    _agent_factors,
    build_train_step,
    local_train_state,
)
from repro_torch.launch.serve import make_prompt, serve  # noqa: E402
from repro_torch.nn import moe as moe_lib  # noqa: E402
from repro_torch.nn import ssm as ssm_lib  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.layers import _act, mlp  # noqa: E402
from repro_torch.nn.param import count_params, init_params  # noqa: E402
from repro_torch.nn.paper_models import (  # noqa: E402
    classifier_loss,
    cnn_classifier_apply,
    cnn_classifier_template,
)
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit:
# the package's one table of the card (repro_torch.analysis.roofline)
HBM_BYTES_PER_S = HW_H100.hbm_bw
F32_FLOPS_PER_S = HW_H100.f32_flops          # float32 outside the tensor cores
BF16_TC_FLOPS_PER_S = HW_H100.peak_flops     # bf16 tensor cores, dense

AGENTS = 5
PATH_ROWS = 16941              # one f32 bucket of the full-width CNN
KERNEL_TOL = 1e-6              # abs; same f32 operations in the same order
PARITY_TOL = 1e-4              # abs, card vs CPU: conv sums differ in order
UPDATE_TOL = 1e-6              # abs, card vs CPU update phase, same gradients
SR_SEEDS = 64                  # int8 stochastic rounding: unbiasedness draws
LR = 0.01
ADAM_LR = 1e-3
MU = 0.9
ADAM = (ADAM_LR, 0.9, 0.999, 1e-8, 0.271, 0.002997)   # alpha b1 b2 eps bc1 bc2
RANK_TOL = 1e-5               # abs, card vs CPU rank-r update phase
TOPK_P = 0.01                 # the top-k runs' density: 170 compact rows
SOURCES = {"consensus_update": "src/repro_torch/csrc/consensus_update.cu",
           "sr_quantize": "src/repro_torch/csrc/sr_quantize.cu",
           "topk_threshold": "src/repro_torch/csrc/topk_threshold.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "wkv6": "src/repro_torch/csrc/wkv6.cu"}
_TPU = "src/repro/kernels/consensus_update/consensus_update.py"
KERNELS = {   # name -> (library, CUDA kernel symbol, the TPU kernel it replaces)
    "cdsgd_update": ("consensus_update", "cdsgd_kernel", f"{_TPU}:687"),
    "cdmsgd_update": ("consensus_update", "cdmsgd_kernel", f"{_TPU}:729"),
    "sr_quantize": ("sr_quantize", "sr_quantize_kernel", f"{_TPU}:130"),
    "cdsgd_update_q": ("consensus_update", "cdsgd_q_kernel", f"{_TPU}:257"),
    "cdmsgd_update_q": ("consensus_update", "cdmsgd_q_kernel", f"{_TPU}:276"),
    "cdmsgd_update_qm": ("consensus_update", "cdmsgd_qm_kernel", f"{_TPU}:282"),
    "cdmsgd_nesterov_update": ("consensus_update", "nesterov_kernel",
                               f"{_TPU}:783"),
    "cdmsgd_nesterov_update_q": ("consensus_update", "nesterov_q_kernel",
                                 f"{_TPU}:324"),
    "cdmsgd_nesterov_update_qm": ("consensus_update", "nesterov_qm_kernel",
                                  f"{_TPU}:330"),
    "cdadam_update": ("consensus_update", "adam_kernel", f"{_TPU}:842"),
    "cdadam_update_q": ("consensus_update", "adam_q_kernel", f"{_TPU}:369"),
    "cdadam_update_qm": ("consensus_update", "adam_qm_kernel", f"{_TPU}:375"),
    "cdsgd_update_sparse": ("consensus_update", "sparse_",
                            f"{_TPU}:507"),
    "cdmsgd_update_sparse": ("consensus_update", "sparse_",
                             f"{_TPU}:545"),
    "cdmsgd_nesterov_update_sparse": ("consensus_update", "sparse_",
                                      f"{_TPU}:590"),
    "cdadam_update_sparse": ("consensus_update", "sparse_",
                             f"{_TPU}:636"),
    # both of the function's kernels (threshold_amax_kernel, then
    # threshold_count_kernel): kernel-only is the function's device time
    "topk_threshold": ("topk_threshold", "threshold_",
                       "src/repro/kernels/consensus_update/topk.py:187"),
    "flash_attention": ("flash_attention", "flash_tc_kernel",
                        "src/repro/kernels/flash_attention/flash_attention.py:74"),
    "wkv6": ("wkv6", "wkv6_kernel", "src/repro/kernels/rwkv_scan/rwkv_scan.py:67"),
}
# the serving path's kernel wrappers (each with its ``launches`` count)
SERVE_KERNELS = {"flash_attention": fa.flash_attention, "wkv6": rs.wkv6}
# flash attention's kernels by variant (``launches_by_variant``): symbol,
# operation rate of the bound.  Neither symbol contains the other.
FLASH_VARIANTS = {"tc": ("flash_tc_kernel", BF16_TC_FLOPS_PER_S),
                  "f32": ("flash_kernel", F32_FLOPS_PER_S)}
# the acceptance criteria of the bf16 kernel at the path shape: global at
# most 2x SDPA causal and at most 0.23 ms; the window at most SDPA's band
FLASH_GLOBAL_SDPA_RATIO, FLASH_GLOBAL_MS = 2.0, 0.23
# WKV6's at the path shape (bf16): at most 0.40 ms; the goal, 0.20 ms
WKV_PATH_MS, WKV_GOAL_MS = 0.40, 0.20
# the _qm kernels': cdmsgd_update_qm [path-f32] at most 0.13 ms (goal 0.11);
# Nesterov's and CDAdam's f32 rows at 70% of their bounds; the narrow rows
# within 5% of the old loop's times (this script on an H100 at 700 W, before
# the register tile)
QM_PATH_MS, QM_GOAL_MS, QM_BOUND_SHARE = 0.13, 0.11, 0.70
# (event ms, kernel-only ms) of the old loop, cdmsgd_update_qm by row
QM_NARROW_BEFORE_MS = {"path": (0.09347, 0.09059), "path-fp8": (0.09511, 0.09230),
                       "path-bf16": (0.10312, 0.10083)}
QM_WIDE_AGENTS = 16            # fig. 2(a): the _qm kernels' [path16-f32] rows
# sr_quantize's: int8 kernel-only at most 0.021 ms (goal 0.019), the
# CUDA-event time within 15% of the kernel-only time
SR_KERNEL_MS, SR_GOAL_MS, SR_EVENT_RATIO = 0.021, 0.019, 1.15
# topk_threshold's at the path shape: the CUDA-event card ms (the wrapper
# included) at most 0.05; the count sweep alone at most 0.018 ms (72% of
# its one-read bound); the function's device time (all its kernels) at most
# 0.035 ms (74% of the two-read bound)
TOPK_EVENT_MS, TOPK_COUNT_MS, TOPK_DEVICE_MS = 0.05, 0.018, 0.035
# float32 flash's: at b 1, s 640 at most SDPA float32 on the same operands
# and at most 0.08 ms (goal 0.05); at the path shape 40% of the bound
FLASH_F32_MS, FLASH_F32_GOAL_MS, FLASH_F32_BOUND_SHARE = 0.08, 0.05, 0.40
# the serving path: (arch, its kernel, launches per prefill = layers)
SERVE_ARCHS = (("gemma3-1b", "flash_attention", 26), ("rwkv6-1.6b", "wkv6", 24))
# the other dense configs, served one at a time (weights drawn on the card):
# (arch, its kernel, launches per prefill = layers); h2o-danube's head dim
# of 120 runs flash attention's width-128 kernels zero-padded, its own row
# of the kernels line
DENSE_ARCHS = (("h2o-danube-3-4b", "flash_attention", 24),
               ("granite-3-8b", "flash_attention", 40),
               ("starcoder2-7b", "flash_attention", 32))
FLASH_D120 = "flash_attention:d120"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
# h2o-danube-3-4b's prefill attention: H 32 on KV 8, D 120, window 4096
# (above the prefill's 2048: causal)
D120_HEADS, D120_KV, D120_WINDOW = 32, 8, 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 8, 16
DECODE_CHECK = (2, 64)         # batch, positions: decode against forward
DECODE_TOL = 5e-2              # of max |logit|: tests/test_models.py's bound, 2 layers
DECODE_F32_TOL = 1e-3          # of max |logit|: float32 decode vs forward, full depth
# bf16 decode's distance from the float32 forward, at most this many times
# the bf16 forward's own: decode rounds like the forward, no worse
DECODE_BF16_RATIO = 2.0
# the bf16 decode check's depths (layers of the full-width weights): the
# reference's 2 and the full depth (the depths between, 7 / 13 and 6 / 12,
# ran until the analysis phase needed their wall time)
DECODE_DEPTHS = {"gemma3-1b": (2, 26), "rwkv6-1.6b": (2, 24),
                 "h2o-danube-3-4b": (2,), "granite-3-8b": (2,), "starcoder2-7b": (2,)}
# the other dense configs' decode checks run on their first layers
DENSE_CHECK_LAYERS = 2
MODEL_TOL = 1e-4               # of max |logit|: card vs CPU, f32 weights
# card vs CPU at full width, reduced depth: (arch, layers, batch, seq)
MODEL_PARITY = (("gemma3-1b", 7, 1, 640), ("rwkv6-1.6b", 2, 1, 256),
                ("h2o-danube-3-4b", 2, 1, 256), ("granite-3-8b", 2, 1, 256),
                ("starcoder2-7b", 2, 1, 256))
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # tol_for, abs and rel
# besides FLASH_TOL, the bf16 kernel's max abs error against the plain
# version is at most this many times SDPA's on the same operands (or one
# bf16 rounding of the largest output, 2^-8 of it, where SDPA's is smaller)
FLASH_BF16_SDPA_ERR_RATIO = 2.0
WKV_TOL = 1e-4                 # abs and rel (bf16 y: FLASH_TOL's 2e-2)
# the sparse (top-k wire) kernels: plain version, per-agent operands
# written in place
SPARSE = {
    "cdsgd_update_sparse": (ref.cdsgd_update_sparse_ref, 1),
    "cdmsgd_update_sparse": (ref.cdmsgd_update_sparse_ref, 2),
    "cdmsgd_nesterov_update_sparse": (ref.cdmsgd_nesterov_update_sparse_ref, 2),
    "cdadam_update_sparse": (ref.cdadam_update_sparse_ref, 3),
}
# the sparse kernels' speed goal: this share of the byte bound at the path
# shape and at gemma3-1b's bf16 bucket; and their times before the
# persistent-CTA kernel (CUDA events, this script on an H100 at 700 W):
# (path ms, bf16 bucket ms)
SPARSE_BOUND_SHARE = 0.75
SPARSE_BEFORE_MS = {
    "cdsgd_update_sparse": (0.06945, 15.38492),
    "cdmsgd_update_sparse": (0.09089, 18.96276),
    "cdmsgd_nesterov_update_sparse": (0.10636, 22.73006),
    "cdadam_update_sparse": (0.12906, 27.33769),
}
# the Nesterov / CDAdam / mixed-momentum kernels: plain version, number of
# per-agent operands written in place (grad, momentum / moments), form
B4 = {
    "cdmsgd_update_qm": (ref.cdmsgd_update_qm_ref, 2, "qm"),
    "cdmsgd_nesterov_update": (ref.cdmsgd_nesterov_update_ref, 2, "dense"),
    "cdmsgd_nesterov_update_q": (ref.cdmsgd_nesterov_update_q_ref, 2, "q"),
    "cdmsgd_nesterov_update_qm": (ref.cdmsgd_nesterov_update_qm_ref, 2, "qm"),
    "cdadam_update": (ref.cdadam_update_ref, 3, "dense"),
    "cdadam_update_q": (ref.cdadam_update_q_ref, 3, "q"),
    "cdadam_update_qm": (ref.cdadam_update_qm_ref, 3, "qm"),
}
WIRE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
        "bf16": torch.bfloat16, "f32": torch.float32}
# phase 4: (topology, optimizer, exchange, schedule, error_feedback,
# momentum_mixing, steps)
RUNS = (
    ("fully_connected", "cdsgd", "f32", "sync", False, "none", 10),
    ("fully_connected", "cdmsgd", "f32", "sync", False, "none", 10),
    ("ring", "cdmsgd", "f32", "sync", False, "none", 3),
    ("fully_connected", "cdmsgd", "int8", "sync", False, "none", 10),
    ("fully_connected", "cdsgd", "int8", "overlap", True, "none", 10),
    ("fully_connected", "cdsgd", "fp8", "sync", False, "none", 3),
    ("fully_connected", "cdsgd", "bf16", "sync", False, "none", 3),
    ("fully_connected", "cdmsgd", "f32", "overlap", False, "none", 3),
    ("ring", "cdmsgd", "int8", "overlap", False, "none", 3),
    ("fully_connected", "cdmsgd_nesterov", "f32", "sync", False, "none", 10),
    ("fully_connected", "cdmsgd_nesterov", "int8", "sync", False, "none", 3),
    ("ring", "cdmsgd_nesterov", "int8", "overlap", False, "mixed", 3),
    ("fully_connected", "cdadam", "f32", "sync", False, "none", 10),
    ("fully_connected", "cdadam", "int8", "sync", True, "none", 3),
    ("fully_connected", "cdadam", "fp8", "overlap", False, "mixed", 3),
    ("fully_connected", "cdmsgd", "int8", "sync", False, "mixed", 10),
    # the f32 wire's momentum payload is the packed momentum itself: the
    # kernel must write v' elsewhere (ExchangeResult.mom_selfs)
    ("fully_connected", "cdmsgd", "f32", "overlap", False, "mixed", 3),
    ("fully_connected", "gossip", "f32", "sync", False, "none", 3),
    ("fully_connected", "cdsgd_tv", "f32", "sync", False, "none", 3),
    ("fully_connected", "sgd", "f32", "sync", False, "none", 3),
    ("fully_connected", "msgd", "f32", "sync", False, "none", 3),
    ("fully_connected", "fedavg", "f32", "sync", False, "none", 3),
)
# phase 4, the compressor axis (error feedback on): (topology, optimizer,
# compressor, sparse_update, schedule, steps, wire bytes per step by the
# accounting).  Run 23 (the first) also feeds the threshold kernel.
COMPRESSED_RUNS = (
    ("fully_connected", "cdsgd", f"topk:{TOPK_P}", None, "sync", 10, 437920),
    ("fully_connected", "cdmsgd", f"topk:{TOPK_P}", None, "overlap", 3, 437920),
    ("ring", "cdmsgd_nesterov", f"topk:{TOPK_P}", None, "sync", 3, 218960),
    ("fully_connected", "cdadam", "topk:auto:131072", None, "sync", 3, 522928),
    ("fully_connected", "cdsgd", f"topk:{TOPK_P}", False, "sync", 3, 437920),
    ("fully_connected", "cdmsgd", "rank:4", None, "sync", 3, 1092416),
)
# the optimizers without a kernel (plain PyTorch)
BASELINES = ("gossip", "cdsgd_tv", "sgd", "msgd", "fedavg")
# phase 4b, the MixingProgram strategies, the staleness ring and FedAvg's
# partial participation (5 agents, fully connected, 3 steps each):
# (optimizer, exchange, schedule, trainer knobs)
MIXING_RUNS = (
    ("cdsgd", "f32", "sync", {"mixing_strategy": "time_varying",
                              "topology_schedule": "alternating:ring:star"}),
    ("cdmsgd", "int8", "sync", {"consensus_rounds": 2}),
    ("cdsgd", "f32", "sync", {"consensus_rounds": 3}),
    ("cdmsgd", "int8", "overlap", {"staleness": 2,
                                   "fault_schedule": "straggler:1:1,drop:0:2"}),
    ("cdsgd", "int8", "sync", {"error_feedback": True,
                               "mixing_strategy": "time_varying",
                               "topology_schedule": "gossip:8"}),
    ("cdmsgd_nesterov", "int8", "overlap", {"staleness": 4,
                                            "fault_schedule": "stall:2:1:3"}),
    ("fedavg", "f32", "sync", {}),
)
MIXING_STEPS = 3
FEDAVG_FAULTS = "straggler:1:1"    # agent 1 misses every second step
# phase 9, the paper's benchmarks: the fused reruns (name, optimizer, steps,
# optimizer knobs, the kernel they launch once a step)
BENCH_FUSED = (("fig1a/cdsgd_fused", "cdsgd", 150, {}, "cdsgd_update"),
               ("fig1b/cdmsgd_fused", "cdmsgd", 200, {"mu": MU}, "cdmsgd_update"))
BENCH_PARITY_STEPS = 20
BENCH_TOL = 1e-4               # relative: loss, consensus, Prop. 1's numbers
# phase 3c, the bf16 parameter buckets of the model zoo's training path:
# name in the kernels line -> (wrapper, CUDA kernel symbol, the TPU kernel)
BF16_FORMS = {f"{name}:bf16": (name, *KERNELS[name][1:]) for name in (
    "cdsgd_update", "cdmsgd_update", "cdsgd_update_q", "cdmsgd_update_q",
    "sr_quantize", "cdmsgd_update_qm", "cdmsgd_nesterov_update",
    "cdmsgd_nesterov_update_q", "cdmsgd_nesterov_update_qm", "cdadam_update",
    "cdadam_update_q", "cdadam_update_qm", "cdsgd_update_sparse",
    "cdmsgd_update_sparse", "cdmsgd_nesterov_update_sparse",
    "cdadam_update_sparse")}
LM_AGENTS = 4                  # gemma3-1b's bucket at A = S = 4 (ring)
# gemma3-1b trains on 3 agents: at 4 (batch 1, seq 1024) the grad phase ran
# out of the H100's 80 GB (77.67 GiB allocated: 8 GB of bf16 params, 8 of
# momentum, 8 of gradients, the saved activations and the float32 loss of
# a 262,144-token vocabulary for 4 agents at once under vmap)
GEMMA_TRAIN_AGENTS = 3
CARD = "cuda"                  # the LM phases' device
LM_SLICES = 16                 # the plain versions run on 1/16 of its rows
# gemma3-1b at full width with 2 layers (0.36 B parameters): phases 10b
# and 12, where the full depth would not fit or is not needed
GEMMA_2L = "gemma3-1b-2layers"
# phases 10, 10b and 11, training through repro_torch.launch.train.main:
# (label, arch, agents, topology, batch per agent, seq, steps, flags,
# launches at init, launches per step); every update and quantize launch on
# the bf16 bucket, except a top-k wire's one sr_quantize a step, which codes
# the float32 compact values
LM_RUNS = (
    ("gemma3-1b cdmsgd f32 sync", "gemma3-1b", GEMMA_TRAIN_AGENTS, "ring", 1, 1024, 5,
     ["--optimizer", "cdmsgd", "--fused"], {}, {"cdmsgd_update": 1}),
    ("gemma3-1b cdsgd int8 overlap", "gemma3-1b", GEMMA_TRAIN_AGENTS, "ring", 1, 1024,
     5,
     ["--optimizer", "cdsgd", "--exchange", "int8", "--schedule", "overlap"],
     {"sr_quantize": 1}, {"sr_quantize": 1, "cdsgd_update_q": 1}),
    # microbatches split each agent's batch: 2 sequences of 1024 per agent
    ("gemma3-1b cdmsgd f32 sync microbatch 2", "gemma3-1b", GEMMA_TRAIN_AGENTS,
     "ring", 2, 1024, 5, ["--optimizer", "cdmsgd", "--fused", "--microbatch", "2"], {},
     {"cdmsgd_update": 1}),
    ("rwkv6-1.6b cdsgd f32 sync", "rwkv6-1.6b", 2, "fully_connected", 2, 128, 3,
     ["--optimizer", "cdsgd", "--fused"], {}, {"cdsgd_update": 1}),
    # every optimizer fused on the bf16 bucket: Nesterov's dense kernel with
    # its lookahead, CDAdam's _q kernel behind an int8 overlap wire, CDMSGD's
    # _qm kernel (the momentum rides the int8 wire too)
    ("gemma3-1b cdmsgd_nesterov f32 sync", "gemma3-1b", GEMMA_TRAIN_AGENTS, "ring",
     1, 1024, 5, ["--optimizer", "cdmsgd_nesterov", "--fused"], {},
     {"cdmsgd_nesterov_update": 1}),
    ("gemma3-1b cdadam int8 overlap", "gemma3-1b", GEMMA_TRAIN_AGENTS, "ring", 1,
     1024, 5, ["--optimizer", "cdadam", "--lr", str(ADAM_LR), "--fused",
               "--exchange", "int8", "--schedule", "overlap"],
     {"sr_quantize": 1}, {"sr_quantize": 1, "cdadam_update_q": 1}),
    ("gemma3-1b cdmsgd int8 mixed", "gemma3-1b", GEMMA_TRAIN_AGENTS, "ring", 1, 1024,
     5, ["--optimizer", "cdmsgd", "--exchange", "int8", "--momentum-mixing",
         "mixed"], {}, {"sr_quantize": 2, "cdmsgd_update_qm": 1}),
)
# phase 10's op-counter check runs on this run's trainer (counter_check)
COUNTED_RUN = "gemma3-1b cdmsgd f32 sync"
# phase 10b, the other fused forms on gemma3-1b's bf16 bucket at 2 layers,
# 2 agents fully connected, batch 1 x 1024, 3 steps each: the top-k wire
# through the sparse kernels (its exact selection, torch.topk over a float32
# copy of every agent's bucket, would hold a further 4 GB an agent at full
# depth), and the Nesterov / CDAdam forms the full-depth runs leave out
TOPK = f"topk:{TOPK_P}"
LM_SMALL_RUNS = tuple(
    (f"gemma3-1b 2 layers {label}", GEMMA_2L, 2, "fully_connected", 1, 1024, 3,
     ["--optimizer", opt, *(["--lr", str(ADAM_LR)] if opt == "cdadam" else []),
      *flags], init, per_step)
    for label, opt, flags, init, per_step in (
        ("cdsgd topk", "cdsgd", ["--compressor", TOPK, "--error-feedback"], {},
         {"sr_quantize": 1, "cdsgd_update_sparse": 1}),
        ("cdadam topk", "cdadam", ["--compressor", TOPK, "--error-feedback"], {},
         {"sr_quantize": 1, "cdadam_update_sparse": 1}),
        ("cdmsgd topk", "cdmsgd", ["--compressor", TOPK, "--error-feedback"], {},
         {"sr_quantize": 1, "cdmsgd_update_sparse": 1}),
        ("cdmsgd_nesterov topk", "cdmsgd_nesterov",
         ["--compressor", TOPK, "--error-feedback"], {},
         {"sr_quantize": 1, "cdmsgd_nesterov_update_sparse": 1}),
        ("cdmsgd_nesterov int8 sync", "cdmsgd_nesterov", ["--exchange", "int8"], {},
         {"sr_quantize": 1, "cdmsgd_nesterov_update_q": 1}),
        ("cdmsgd_nesterov int8 mixed overlap", "cdmsgd_nesterov",
         ["--exchange", "int8", "--schedule", "overlap", "--momentum-mixing",
          "mixed"], {"sr_quantize": 2},
         {"sr_quantize": 2, "cdmsgd_nesterov_update_qm": 1}),
        ("cdadam f32 sync", "cdadam", ["--fused"], {}, {"cdadam_update": 1}),
        ("cdadam fp8 mixed", "cdadam", ["--exchange", "fp8", "--momentum-mixing",
                                        "mixed"], {},
         {"sr_quantize": 2, "cdadam_update_qm": 1})))
# the runs whose profiled step is printed (the others are checked the same
# way, launches, losses and wire, without one): the 2-layer runs ending so,
# and of the full-size runs gemma3-1b's first (reading a full-size step's
# trace took the profiler 10-60 s a run: rwkv6-1.6b's about 60)
LM_PROFILED = ("cdsgd topk", "cdadam topk")
PROFILED_RUNS = ("gemma3-1b cdmsgd f32 sync",)
# phase 12, resume: gemma3-1b at full width with 2 layers (0.36 B
# parameters), 2 agents, CDMSGD int8 overlap with error feedback; the
# whole run's steps, and the split run's before its checkpoint
RESUME_STEPS, RESUME_SPLIT = 4, 2
# phase 14, the sharded mode: gemma3-1b at full width, one gloo rank per
# agent on a ring, all on the one card; (label, optimizer, knobs, launches
# at init, launches per step), every launch on the bf16 bucket.  These two
# runs took the full 26 layers until the analysis phase needed their wall
# time: SHARDED_RUN_LAYERS now (the exchange's bytes scale with the depth,
# the kernels' launches a step do not)
SHARDED_AGENTS = 3
SHARDED_RUN_LAYERS = 4
SHARDED_RUNS = (
    ("cdmsgd f32 sync", "cdmsgd", {"exchange": "f32", "schedule": "sync"}, {},
     {"cdmsgd_update": 1}),
    ("cdsgd int8 overlap", "cdsgd", {"exchange": "int8", "schedule": "overlap"},
     {"sr_quantize": 1}, {"sr_quantize": 1, "cdsgd_update_q": 1}),
)
# the agent-axis rest of the sharded mode at 2 layers (gemma3-1b at full
# width, phase 10b's depth, live weights): the int8 overlap baseline at that
# depth, the top-k wire through cdsgd_update_sparse at one output agent, the
# staleness ring under a straggler and a dropped ring link, rank-r
SHARDED_FAULTS = "straggler:1:1,drop:0:1"
SHARDED_SMALL_LAYERS = 2
SHARDED_SMALL_RUNS = (
    ("cdsgd int8 overlap", "cdsgd", {"exchange": "int8", "schedule": "overlap"},
     {"sr_quantize": 1}, {"sr_quantize": 1, "cdsgd_update_q": 1}),
    (f"cdsgd {TOPK} EF overlap", "cdsgd",
     {"compressor": TOPK, "error_feedback": True, "schedule": "overlap"},
     {"sr_quantize": 1}, {"sr_quantize": 1, "cdsgd_update_sparse": 1}),
    (f"cdsgd int8 overlap staleness 2 {SHARDED_FAULTS}", "cdsgd",
     {"exchange": "int8", "schedule": "overlap", "staleness": 2,
      "fault_schedule": SHARDED_FAULTS},
     {"sr_quantize": 1}, {"sr_quantize": 1, "cdsgd_update_q": 1}),
    ("cdmsgd rank:4 EF sync", "cdmsgd",
     {"compressor": "rank:4", "error_feedback": True}, {}, {"cdmsgd_update_q": 1}),
)
# the other three sparse forms at one output agent on the sharded path:
# timed and counted like the runs above, held by phase 3c (no parity)
SHARDED_SPARSE_RUNS = tuple(
    (f"{name} {TOPK} EF sync", name, {"compressor": TOPK, "error_feedback": True},
     {}, {"sr_quantize": 1, f"{name}_update_sparse": 1})
    for name in ("cdmsgd", "cdmsgd_nesterov", "cdadam"))
# the parity run at build_train_step's default remat=True (the timed runs
# pass remat=False, as before the loss had remat, and so do the other
# parities)
SHARDED_REMAT_PARITY = "cdsgd int8 overlap"
SHARDED_STEPS, SHARDED_SEQ = 3, 1024        # batch 1 x 1024 per rank
SHARDED_PARITY_LAYERS, SHARDED_PARITY_SEQ = 2, 128
SHARDED_TOL = 1e-5             # of max |param|: a whole step, sharded vs stacked
# the factored agent mesh: 4 gloo ranks on pod 2 x data 2, parity only
FACTORED_AXES = {"pod": 2, "data": 2}
FACTORED_RUN = ("cdmsgd int8 sync pod 2 x data 2", "cdmsgd", {"exchange": "int8"})
# each rank's allocator is capped in the full-depth runs at its share of
# the card's free memory less a CUDA context (sharded_path): three peaks of
# 22.4 GiB (an H100 80GB) fit in its 79 GiB only when no rank hoards freed
# blocks that another needs (uncapped, a rank's backward can find the card
# full); capped, a rank frees its own cache and retries before it fails
SHARDED_HEADROOM = 512 << 20   # B per rank beyond a CUDA context
SHARDED_PG_TIMEOUT = 120.0     # s, each collective in the ranks
SHARDED_JOIN_S = 600.0         # s, the whole phase
# the MoE, MLA and VLM families at published width (phases 6-7): (arch,
# layers or None for the full depth, flash launches per 4 x 2048 prefill:
# its GQA layers).  kimi-k2-1t-a32b's and deepseek-v2-236b's full depths
# (2.1 TB and 472 GB of bf16 weights) fit no card: 2 layers each (1 dense,
# 1 MoE: 37.2 and 9.98 GiB); deepseek-v2's MLA prefill runs the plain
# blockwise attention (qk width 192, v 128), as the reference's does: no
# flash launch
FAMILY_ARCHS = (("internvl2-2b", None, 24), ("kimi-k2-1t-a32b", 2, 2),
                ("deepseek-v2-236b", 2, 0), ("hymba-1.5b", None, 32),
                ("seamless-m4t-medium", None, 36))
# the hybrid and encoder-decoder configs (their own phase walls): hymba's 32
# layers each launch flash once (its mamba heads are plain, as the
# reference's are XLA); seamless's 12 encoder, 12 decoder self and 12 cross
# attentions
NEW_FAMILIES = ("hymba-1.5b", "seamless-m4t-medium")
FAMILY_CHECK = (2, 32)         # phase 8, reduced: batch, positions
# phase 10c, the families trained through repro_torch.launch.train.main:
# internvl2-2b at full width and depth on 2 agents (a ring), batch 1 x 1024
# positions (256 stub patches of ones + 768 tokens), 3 steps without and with
# remat (the first step's update phase held bit for bit between them); kimi-k2 and
# deepseek-v2 reduced on 2 agents, CDMSGD on the int8 wire: their bf16
# weights and float32 routers are two buckets, an update and a quantize
# launch a step on each.  (label, arch, agents, topology, batch, seq, steps,
# flags, launches at init, launches per step, remat)
VLM_ARCH = "internvl2-2b"
FAMILY_LM_RUNS = tuple(
    (f"{VLM_ARCH} {label}{' remat' if remat else ''}", VLM_ARCH, 2, "ring", 1, 768, 3,
     flags, init, per_step, remat)
    for label, flags, init, per_step in (
        ("cdmsgd f32 sync", ["--optimizer", "cdmsgd", "--fused"], {},
         {"cdmsgd_update": 1}),
        ("cdsgd int8 overlap", ["--optimizer", "cdsgd", "--exchange", "int8",
                                "--schedule", "overlap"],
         {"sr_quantize": 1}, {"sr_quantize": 1, "cdsgd_update_q": 1}))
    for remat in (False, True)) + tuple(
    (f"{arch} reduced cdmsgd int8 sync", f"{arch}-reduced", 2, "fully_connected", 2,
     64, 3, ["--optimizer", "cdmsgd", "--exchange", "int8"], {},
     {"sr_quantize": 2, "cdmsgd_update_q": 2}, False)
    for arch in ("kimi-k2-1t-a32b", "deepseek-v2-236b")) + tuple(
    # the hybrid and encoder-decoder configs at full width on 2 agents:
    # CDMSGD on the int8 overlap wire (_q kernel, a quantize a step and one
    # at init); hymba with remat (its chunked scan's backward otherwise
    # keeps about 0.9 GB a layer per agent), seamless's 1024 text tokens behind
    # its 1024 float32 stub frames
    (f"{arch} cdmsgd int8 overlap{' remat' if remat else ''}", arch, 2, "ring", 1, 1024,
     3, ["--optimizer", "cdmsgd", "--exchange", "int8", "--schedule", "overlap"],
     {"sr_quantize": 1}, {"sr_quantize": 1, "cdmsgd_update_q": 1}, remat)
    for arch, remat in (("hymba-1.5b", True), ("seamless-m4t-medium", False)))
# phase 3: flash attention at the hybrid and encoder-decoder prefill shapes:
# (label, b, h, kv, sq, sk, d, causal, window, dtype)
FAMILY_FLASH = (
    ("hymba", PREFILL_BATCH, 25, 5, PREFILL_LEN, PREFILL_LEN, 64, True, 1024,
     torch.bfloat16),
    ("seamless-enc", PREFILL_BATCH, 16, 16, 1024, 1024, 64, False, None, torch.bfloat16),
    ("seamless-enc-f32", PREFILL_BATCH, 16, 16, 1024, 1024, 64, False, None,
     torch.float32),
    ("seamless-dec-self", PREFILL_BATCH, 16, 16, PREFILL_LEN, PREFILL_LEN, 64, True, None,
     torch.bfloat16),
    ("seamless-cross", PREFILL_BATCH, 16, 16, PREFILL_LEN, 1024, 64, False, None,
     torch.bfloat16))
# phase 15: the examples at their tiny presets, a few steps each
EXAMPLES = (("serve_batched", ["--train-steps", "3", "--new-tokens", "4",
                               "--arch", "seamless-m4t-medium"]),
            ("topology_study", ["--steps", "4"]),
            ("collaborative_lm_pretrain", ["--steps", "3", "--arch", "hymba-1.5b",
                                           "--exchange", "int8"]))
RESUME_FLAGS = ["--agents", "2", "--topology", "fully_connected", "--batch", "1",
                "--seq", "1024", "--optimizer", "cdmsgd", "--exchange", "int8",
                "--schedule", "overlap", "--error-feedback"]


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


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` in microseconds, launches not waited
    for (of a launch-bound call: what the card waits for between them)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def device_ms(fn, symbol: str, iters: int = 20):
    """Mean device time per call of the kernels named ``symbol`` that ``fn``
    launches, from a ``torch.profiler`` trace of ``iters`` calls: the
    kernel alone, without the host time between launches that the
    CUDA-event figure includes.  None when the trace shows no such kernel.
    A trace can lose a kernel's record (seen: 4 of 5 calls of a 19 ms
    kernel, which read as a time under its byte bound), so the time is
    per recorded call: the spans over the calls they make up, at the
    kernels per call that the count of spans shows."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and symbol in e.name]
    if not spans:
        return None
    per_call = max(1, round(len(spans) / iters))
    return sum(spans) / 1e3 / (len(spans) / per_call)


def _bucket(gen, a: int, rows: int) -> torch.Tensor:
    """(a, rows, 128) float32 with row scales over six decades; row 0 of
    every agent all zero (its scale is 1.0)."""
    dev = torch.device("cuda")
    x = torch.randn((a, rows, 128), generator=gen, device=dev)
    x = x * 10.0 ** (6 * torch.rand((a, rows, 1), generator=gen, device=dev) - 3)
    x[:, 0] = 0.0
    return x.contiguous()


def _report(results: dict, name: str, label: str, shape: str, err: float,
            kernel, plain, yardstick, b) -> dict:
    """Time one checked operand set and print its line; the ``path`` row of
    each kernel is the one the ``kernels`` JSON line carries.  Returns the
    row's ``ms``, ``kernel_only_ms`` and ``bound_ms``."""
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    lib_ms = cuda_ms(yardstick) if yardstick is not None else None
    dev_ms = device_ms(kernel, KERNELS[name][1])
    b_ms, b_by = b
    print(f"kernel {name} [{label}] {shape}: max_abs_err={err:.3e} "
          f"(tol {KERNEL_TOL:g}) ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms="
          f"{'none' if lib_ms is None else f'{lib_ms:.5f}'} "
          f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.3f} "
          f"kernel_only_ms={'not measured' if dev_ms is None else f'{dev_ms:.5f}'}")
    entry = results.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if label == "path":
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms)
    return {"ms": ms, "kernel_only_ms": dev_ms, "bound_ms": b_ms}


def _check(name: str, label: str, err: float, ok_ptr: bool = True) -> None:
    if not ok_ptr:
        raise AssertionError(f"{name} [{label}] did not write its outputs in place")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name} [{label}] max abs err {err} > {KERNEL_TOL}")


def check_dense(results: dict, gen) -> None:
    """Phase 3, the dense form (f32 and bf16 neighbours)."""
    dev = torch.device("cuda")
    # the ring's Pi has zero weights: the kernel must still sum every term
    ring_pi = torch.tensor(make_topology("ring", AGENTS).pi, dtype=torch.float32,
                           device=dev)
    for name in ("cdsgd_update", "cdmsgd_update"):
        for label, a_out, s, rows, dtype in (
                ("path", AGENTS, AGENTS, PATH_ROWS, torch.float32),
                ("ring", AGENTS, AGENTS, PATH_ROWS, torch.float32),
                ("stencil", 1, 3, PATH_ROWS, torch.float32),
                ("ragged", AGENTS, AGENTS, 1001, torch.float32),
                ("path-bf16", AGENTS, AGENTS, PATH_ROWS, torch.bfloat16),
                ("ring-bf16", AGENTS, AGENTS, PATH_ROWS, torch.bfloat16),
                ("stencil-bf16", 1, 3, 1001, torch.bfloat16)):
            if label.startswith("ring"):
                w = ring_pi
            else:
                w = torch.rand((a_out, s), generator=gen, device=dev)
                w = (w / w.sum(dim=1, keepdim=True)).contiguous()
            x = _bucket(gen, s, rows).to(dtype)
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
                yardstick = None
                if dtype == torch.float32:
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
            _check(name, label, err, ok_ptr)
            _report(results, name, label,
                    f"W=({a_out},{s}) {str(dtype)[6:]} neighbours rows={rows}",
                    err, kernel, plain, yardstick,
                    bound(name, a_out, s, rows, dtype))


def check_q(results: dict, gen) -> None:
    """Phase 3, the self-separated form, every payload dtype of the wire."""
    dev = torch.device("cuda")
    path_w = torch.tensor(_self_separated_weights(
        make_topology("fully_connected", AGENTS).pi), dtype=torch.float32,
        device=dev)
    ring_w = torch.tensor(_self_separated_weights(
        make_topology("ring", AGENTS).pi), dtype=torch.float32, device=dev)
    for name in ("cdsgd_update_q", "cdmsgd_update_q"):
        for wire, dtype in WIRE.items():
            for label, a_out, s, rows in (("path", AGENTS, AGENTS, PATH_ROWS),
                                          ("ring", AGENTS, AGENTS, PATH_ROWS),
                                          ("stencil", 1, 3, PATH_ROWS),
                                          ("ragged", AGENTS, AGENTS, 1001)):
                if label == "path":
                    w = path_w
                elif label == "ring":
                    w = ring_w
                else:
                    w = torch.rand((a_out, s + 1), generator=gen, device=dev)
                    w = (w / w.sum(dim=1, keepdim=True)).contiguous()
                x = _bucket(gen, s, rows)
                if wire in ("int8", "fp8"):
                    q, sc = cu.sr_quantize(x, rows, wire)
                else:
                    q, sc = x.to(dtype), torch.ones((s, rows, 1), device=dev)
                slf, g, v = (torch.randn((a_out, rows, 128), generator=gen,
                                         device=dev) for _ in range(3))
                if name == "cdsgd_update_q":
                    want = ref.cdsgd_update_q_ref(w, slf, q, sc, g, LR)
                    g2 = g.clone()
                    ptr = g2.data_ptr()
                    out = cu.cdsgd_update_q(w, slf, q, sc, g2, LR)
                    ok_ptr = out.data_ptr() == ptr
                    torch.cuda.synchronize()
                    err = float((out - want).abs().max())
                    kernel = lambda: cu.cdsgd_update_q(w, slf, q, sc, g2, LR)
                    plain = lambda: ref.cdsgd_update_q_ref(w, slf, q, sc, g, LR)
                else:
                    want, want_v = ref.cdmsgd_update_q_ref(w, slf, q, sc, g, v,
                                                           LR, MU)
                    g2, v2 = g.clone(), v.clone()
                    ptrs = (g2.data_ptr(), v2.data_ptr())
                    out, out_v = cu.cdmsgd_update_q(w, slf, q, sc, g2, v2, LR, MU)
                    ok_ptr = (out.data_ptr(), out_v.data_ptr()) == ptrs
                    torch.cuda.synchronize()
                    err = max(float((out - want).abs().max()),
                              float((out_v - want_v).abs().max()))
                    kernel = lambda: cu.cdmsgd_update_q(w, slf, q, sc, g2, v2,
                                                        LR, MU)
                    plain = lambda: ref.cdmsgd_update_q_ref(w, slf, q, sc, g, v,
                                                            LR, MU)
                _check(name, f"{label} {wire}", err, ok_ptr)
                # the headline row is the int8 payload at the path shape
                row = label if wire == "int8" else f"{label}-{wire}"
                _report(results, name, row,
                        f"W=({a_out},{s + 1}) {wire} payload rows={rows}", err,
                        kernel, plain, None, bound(name, a_out, s, rows, dtype))


def check_b4(results: dict, gen) -> None:
    """Phase 3, the Nesterov and CDAdam kernels (dense, ``_q``, ``_qm``) and
    ``cdmsgd_update_qm``: every output against the plain version, every
    payload dtype; the headline row is f32 (dense) or int8 at the path
    shape.  The ``_qm`` kernels also run with an f32 payload at fig.
    2(a)'s fully connected 16 agents (``[path16-f32]``: A = 16, S = 15),
    and their speed criteria are printed."""
    dev = torch.device("cuda")
    pis = {t: make_topology(t, AGENTS).pi for t in ("fully_connected", "ring")}
    dense_w = {"ring": torch.tensor(pis["ring"], dtype=torch.float32, device=dev)}
    q_w = {"path": torch.tensor(_self_separated_weights(pis["fully_connected"]),
                                dtype=torch.float32, device=dev),
           "ring": torch.tensor(_self_separated_weights(pis["ring"]),
                                dtype=torch.float32, device=dev),
           # one agent's stencil on 16 fully connected agents, for each of
           # 16 outputs: 1/16 on itself and on each of its 15 neighbours
           "path16": torch.full((QM_WIDE_AGENTS, QM_WIDE_AGENTS),
                                1.0 / QM_WIDE_AGENTS, device=dev)}

    def payload(wire, s, rows):
        x = _bucket(gen, s, rows)
        if wire in ("int8", "fp8"):
            return cu.sr_quantize(x, rows, wire)
        return x.to(WIRE[wire]), torch.ones((s, rows, 1), device=dev)

    times = {}
    for name, (plain, n_state, form) in B4.items():
        wires = ("f32", "bf16") if form == "dense" else tuple(WIRE)
        headline = "f32" if form == "dense" else "int8"
        for wire in wires:
            shapes = [("path", AGENTS, AGENTS, PATH_ROWS),
                      ("ring", AGENTS, AGENTS, PATH_ROWS),
                      ("stencil", 1, 3, PATH_ROWS),
                      ("ragged", AGENTS, AGENTS, 1001)]
            if form == "qm" and wire == "f32":      # fig. 2(a)'s 16 agents
                shapes.append(("path16", QM_WIDE_AGENTS, QM_WIDE_AGENTS - 1,
                               PATH_ROWS))
            for label, a_out, s, rows in shapes:
                n_w = s if form == "dense" else s + 1
                w = (dense_w if form == "dense" else q_w).get(label)
                if w is None:
                    w = torch.rand((a_out, n_w), generator=gen, device=dev)
                    w = (w / w.sum(dim=1, keepdim=True)).contiguous()
                if form == "dense":
                    mix = [w, _bucket(gen, s, rows).to(WIRE[wire])]
                else:
                    slf = torch.randn((a_out, rows, 128), generator=gen, device=dev)
                    mix = [w, slf, *payload(wire, s, rows)]
                    if form == "qm":
                        mix += payload(wire, s, rows)
                state = [_bucket(gen, a_out, rows) for _ in range(n_state)]
                if n_state == 3:                     # Adam's second moment
                    state[2] = (state[2].abs() * 0.01).contiguous()
                scalars = ADAM if n_state == 3 else (LR, MU)
                want = plain(*mix, *state, *scalars)
                outs = [t.clone() for t in state]
                ptrs = [t.data_ptr() for t in outs]
                fn = cu.KERNELS[name]
                got = fn(*mix, *outs, *scalars)
                ok_ptr = [t.data_ptr() for t in got[:n_state]] == ptrs
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, want))
                _check(name, f"{label} {wire}", err, ok_ptr)
                row = label if wire == headline else f"{label}-{wire}"
                times[(name, row)] = _report(
                    results, name, row,
                    f"W=({a_out},{n_w}) {wire} {'neighbours' if form == 'dense' else 'payload'}"
                    f" rows={rows}", err,
                    lambda: fn(*mix, *outs, *scalars),
                    lambda: plain(*mix, *state, *scalars), None,
                    bound(name, a_out, s, rows, WIRE[wire]))
    qm_criteria(times)


def qm_criteria(times: dict) -> None:
    """Print the ``_qm`` kernels' speed criteria at the path shape, met or
    not (not held): ``cdmsgd_update_qm [path-f32]`` at most 0.13 ms (goal
    0.11), Nesterov's and CDAdam's f32 rows at 70% of their bounds or more,
    and the narrow-payload rows of ``cdmsgd_update_qm`` at most 5% above
    the old loop's times (this script on an H100 at 700 W, before the
    register tile), by CUDA events and kernel-only (the events also see
    the host's jitter between launches)."""
    msgd = times[("cdmsgd_update_qm", "path-f32")]
    parts = [f"cdmsgd_update_qm [path-f32] {msgd['ms']:.5f} ms <= {QM_PATH_MS:g}: "
             f"{msgd['ms'] <= QM_PATH_MS}; goal <= {QM_GOAL_MS:g}: "
             f"{msgd['ms'] <= QM_GOAL_MS} (bound share {msgd['bound_ms'] / msgd['ms']:.3f})"]
    for name in ("cdmsgd_nesterov_update_qm", "cdadam_update_qm"):
        t = times[(name, "path-f32")]
        share = t["bound_ms"] / t["ms"]
        parts.append(f"{name} [path-f32] {t['ms']:.5f} ms, bound share {share:.3f} "
                     f">= {QM_BOUND_SHARE:g}: {share >= QM_BOUND_SHARE}")
    for row, (before, before_only) in QM_NARROW_BEFORE_MS.items():
        t = times[("cdmsgd_update_qm", row)]
        only = t["kernel_only_ms"]
        parts.append(f"cdmsgd_update_qm [{row}] {t['ms']:.5f} ms <= 1.05 x {before:g}: "
                     f"{t['ms'] <= 1.05 * before}, kernel-only "
                     + ("not measured" if only is None else
                        f"{only:.5f} <= 1.05 x {before_only:g}: "
                        f"{only <= 1.05 * before_only}"))
    print("_qm speed criteria: " + "; ".join(parts))


def check_sr_quantize(results: dict, gen) -> None:
    """Phase 3, the wire quantizer: bit for bit against the plain version
    (also at 7 agents, so agent boundaries fall inside blocks and the
    persistent grid's last sweep is partial), the int8 error bound, unbiased
    int8 rounding over 64 seeds, and the speed criteria with the wrapper's
    host time per call."""
    times = {}
    for exchange in ("int8", "fp8"):
        for label, a, rows in (("path", AGENTS, PATH_ROWS),
                               ("stencil", 1, PATH_ROWS),
                               ("ragged", AGENTS, 1001),
                               ("agents7", 7, PATH_ROWS)):
            x = _bucket(gen, a, rows)
            seed = -1 - rows                  # negative: the seed wraps to uint32
            q, sc = cu.sr_quantize(x, seed, exchange, agent_stride=104729)
            torch.cuda.synchronize()
            want_q, want_sc = ref.sr_quantize_ref(x, seed, exchange, 104729)
            same = (q.dtype == want_q.dtype
                    and torch.equal(q.view(torch.uint8), want_q.view(torch.uint8))
                    and torch.equal(sc, want_sc))
            if not same or not bool((sc[:, 0] == 1.0).all()):
                raise AssertionError(f"sr_quantize [{label} {exchange}] differs "
                                     "from its plain version")
            if exchange == "int8":
                err = (q.float() * sc - x).abs()
                if not bool((err <= sc * (1 + 1e-6)).all()):
                    raise AssertionError(f"sr_quantize [{label}] int8 error above "
                                         f"one scale: {float((err / sc).max())}")
            row = label if exchange == "int8" else f"{label}-fp8"
            times[row] = _report(
                results, "sr_quantize", row, f"A={a} rows={rows} {exchange}",
                0.0, lambda: cu.sr_quantize(x, seed, exchange, agent_stride=104729),
                lambda: ref.sr_quantize_ref(x, seed, exchange, 104729), None,
                bound("sr_quantize", a, 0, rows, WIRE[exchange]))
    x = torch.randn((1, 64, 128), generator=gen, device="cuda")
    bias = torch.zeros_like(x)
    for seed in range(SR_SEEDS):
        q, sc = cu.sr_quantize(x, seed, "int8")
        bias += (q.float() * sc - x) / sc
    bias /= SR_SEEDS
    signed, mean_abs, worst = (float(bias.mean()), float(bias.abs().mean()),
                               float(bias.abs().max()))
    print(f"sr_quantize int8 over {SR_SEEDS} seeds, in units of the row scale: "
          f"mean bias {signed:.2e} (bound 1e-2), mean |bias| {mean_abs:.4f} "
          f"(bound 0.06; 0.039 expected of unbiased rounding), max |bias| "
          f"{worst:.4f} (bound 0.4)")
    if not (abs(signed) <= 1e-2 and mean_abs <= 0.06 and worst <= 0.4):
        raise AssertionError("sr_quantize int8 rounding looks biased")
    tiny = torch.randn((1, 8, 128), generator=gen, device="cuda")
    host = host_us(lambda: cu.sr_quantize(tiny, 7, "int8"), iters=1000)
    path, fp8 = times["path"], times["path-fp8"]
    only, fp8_only = path["kernel_only_ms"], fp8["kernel_only_ms"]
    if only is None or fp8_only is None:
        print("sr_quantize speed criteria: kernel-only time not measured")
        return
    print(f"sr_quantize speed criteria: int8 [path] kernel-only {only:.5f} ms <= "
          f"{SR_KERNEL_MS:g}: {only <= SR_KERNEL_MS}; goal <= {SR_GOAL_MS:g}: "
          f"{only <= SR_GOAL_MS} (bound share {path['bound_ms'] / only:.3f}); card ms "
          f"{path['ms']:.5f} <= {SR_EVENT_RATIO:g} x kernel-only: "
          f"{path['ms'] <= SR_EVENT_RATIO * only}; fp8 [path-fp8] kernel-only "
          f"{fp8_only:.5f} ms, card ms {fp8['ms']:.5f}; wrapper host time "
          f"{host:.1f} us per call (time.perf_counter over 1000 calls at "
          "(1, 8, 128), no synchronize)")


def check_sparse(results: dict, gen) -> dict:
    """Phase 3, the sparse (top-k wire) update kernels: every output against
    the plain version (``index_add_`` per neighbour), on compact stacks
    that ``topk_compress_2d`` makes at ``topk:0.01``; the fully connected
    and the ring's self-separated weights at the path shape, a one-agent
    stencil, the ring at 1,001 rows, and the fully connected weights on
    ``_clustered_compact``'s layout (most tiles empty).  Returns the rows'
    times by (kernel, label)."""
    dev = torch.device("cuda")
    q_w = {t: torch.tensor(_self_separated_weights(make_topology(t, AGENTS).pi),
                           dtype=torch.float32, device=dev)
           for t in ("fully_connected", "ring")}
    times = {}
    for name, (plain, n_state) in SPARSE.items():
        for label, a_out, s, rows in (("path", AGENTS, AGENTS, PATH_ROWS),
                                      ("ring", AGENTS, AGENTS, PATH_ROWS),
                                      ("stencil", 1, 3, PATH_ROWS),
                                      ("ragged-ring", AGENTS, AGENTS, 1001),
                                      ("clustered", AGENTS, AGENTS, PATH_ROWS)):
            k_rows = tk.topk_k_rows(rows, TOPK_P)
            if label in ("path", "clustered"):
                w = q_w["fully_connected"]
            elif "ring" in label:
                w = q_w["ring"]
            else:
                w = torch.rand((a_out, s + 1), generator=gen, device=dev)
                w = (w / w.sum(dim=1, keepdim=True)).contiguous()
            if label == "clustered":
                compact = _clustered_compact(gen, s, rows, k_rows)
            else:
                compact = tk.topk_compress_2d(_bucket(gen, s, rows), k_rows, rows,
                                              agent_stride=104729)
            mix = [w, torch.randn((a_out, rows, 128), generator=gen,
                                  device=dev), *compact]
            state = [_bucket(gen, a_out, rows) for _ in range(n_state)]
            if n_state == 3:                         # Adam's second moment
                state[2] = (state[2].abs() * 0.01).contiguous()
            scalars = {1: (LR,), 2: (LR, MU), 3: ADAM}[n_state]
            want = plain(*mix, *state, *scalars)
            want = want if isinstance(want, tuple) else (want,)
            outs = [t.clone() for t in state]
            ptrs = [t.data_ptr() for t in outs]
            fn = cu.KERNELS[name]
            got = fn(*mix, *outs, *scalars)
            got = got if isinstance(got, tuple) else (got,)
            ok_ptr = [t.data_ptr() for t in got[:n_state]] == ptrs
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, want))
            _check(name, label, err, ok_ptr)
            times[(name, label)] = _report(
                results, name, label,
                f"W=({a_out},{s + 1}) int8 compact k_rows={k_rows} rows={rows}"
                + (" clustered" if label == "clustered" else ""), err,
                lambda: fn(*mix, *outs, *scalars),
                lambda: plain(*mix, *state, *scalars), None,
                bound(name, a_out, s, rows, torch.int8, k_rows))
    print("library_ms none for the sparse kernels: no one PyTorch call "
          "computes the function (index_add_ scatters one neighbour's "
          "products, without the self term or the optimizer epilogue)")
    return times


def sparse_criteria(results: dict, times: dict) -> None:
    """Print the sparse kernels' speed criteria, met or not (not held):
    each form's share of its byte bound at the path shape (CUDA events and
    kernel-only) and at gemma3-1b's bf16 bucket, against
    ``SPARSE_BOUND_SHARE``, and its times against ``SPARSE_BEFORE_MS``."""
    parts = []
    for name, (path_before, bucket_before) in SPARSE_BEFORE_MS.items():
        t, b = times[(name, "path")], results[f"{name}:bf16"]
        share, b_share = t["bound_ms"] / t["ms"], b["bound_ms"] / b["ms"]
        only, b_only = t["kernel_only_ms"], b.get("kernel_only_ms")
        parts.append(
            f"{name} [path] {t['ms']:.5f} ms, share {share:.3f} >= "
            f"{SPARSE_BOUND_SHARE:g}: {share >= SPARSE_BOUND_SHARE}, kernel-only "
            + ("not measured" if only is None else
               f"{only:.5f} (share {t['bound_ms'] / only:.3f})")
            + f", <= {path_before:g} before: {t['ms'] <= path_before}; [bucket] "
            f"{b['ms']:.5f} ms, share {b_share:.3f} >= {SPARSE_BOUND_SHARE:g}: "
            f"{b_share >= SPARSE_BOUND_SHARE}, kernel-only "
            + ("not measured" if b_only is None else
               f"{b_only:.5f} (share {b['bound_ms'] / b_only:.3f})")
            + f", <= {bucket_before:g} before: {b['ms'] <= bucket_before}")
    print("sparse speed criteria: " + "; ".join(parts))


def _trace_counts(fn, iters: int = 10) -> dict:
    """Device activity of ``iters`` calls of ``fn`` in a ``torch.profiler``
    trace, per call: kernels, memsets and copies by name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return {n: c / iters for n, c in names.items()}


def check_threshold(results: dict, gen) -> None:
    """Phase 3, the top-k threshold function on the card (amax, thresholds,
    counts and pick): counts exact and ``tau`` equal bit for bit to the
    plain path's, with an all-zero bucket and ties, also at 7 agents (agent
    boundaries inside the blocks' chunks); the trace of one call (two
    kernels, at most one memset, no copy); the speed criteria, met or not,
    with the count sweep alone, the function's device time and the
    wrapper's host time per call."""
    times = {}
    for label, a, rows in (("path", AGENTS, PATH_ROWS),
                           ("stencil", 1, PATH_ROWS),
                           ("ragged", AGENTS, 1001),
                           ("agents7", 7, PATH_ROWS)):
        k = tk.topk_k_rows(rows, TOPK_P) * 128
        x = _bucket(gen, a, rows)
        x[-1] = 0.0                                  # an all-zero bucket
        x[0, 1:4] = 0.5                              # ties
        tau, counts = tk.topk_threshold(x, k)
        torch.cuda.synchronize()
        taus = tk.threshold_taus(x)
        want = ref.topk_threshold_counts_ref(x, taus)
        want_tau = taus.gather(1, torch.clamp((want <= k).sum(dim=1) - 1,
                                              min=0)[:, None])[:, 0]
        if not (torch.equal(counts, want.float()) and torch.equal(tau, want_tau)):
            raise AssertionError(f"topk_threshold [{label}] differs from its "
                                 "plain version")
        times[label] = _report(
            results, "topk_threshold", label, f"A={a} rows={rows} k={k}",
            0.0, lambda: tk.topk_threshold(x, k),
            lambda: ref.topk_threshold_counts_ref(x, taus), None,
            bound("topk_threshold", a, 0, rows))
        if label == "path":
            fn = lambda: tk.topk_threshold(x, k)
            count_ms = device_ms(fn, "threshold_count_kernel")
            trace = _trace_counts(fn)
            kernels = {n: c for n, c in trace.items() if "threshold_" in n}
            memsets = sum(c for n, c in trace.items() if "memset" in n.lower())
            copies = sum(c for n, c in trace.items() if "memcpy" in n.lower())
            print(f"topk_threshold [path] trace per call: kernels "
                  f"{ {n[n.find('threshold_'):].split('(')[0]: c for n, c in kernels.items()} }, "
                  f"memsets {memsets:g}, copies {copies:g}")
            if sum(kernels.values()) > 2 or memsets > 1 or copies:
                raise AssertionError("topk_threshold: more than two kernels and "
                                     "one memset per call, or a copy")
            tiny = torch.randn((1, 8, 128), generator=gen, device="cuda")
            host = host_us(lambda: tk.topk_threshold(tiny, 128), iters=1000)
    path = times["path"]
    fn_ms = path["kernel_only_ms"]
    two_read_ms = 2 * bound("topk_threshold", AGENTS, 0, PATH_ROWS)[0]
    measured = fn_ms is not None and count_ms is not None
    print("topk_threshold: counts exact and tau equal bit for bit at every "
          "shape; library_ms none: no one PyTorch call counts |x| >= tau for "
          "16 thresholds")
    print(f"topk_threshold speed criteria: [path] card ms {path['ms']:.5f} <= "
          f"{TOPK_EVENT_MS:g}: {path['ms'] <= TOPK_EVENT_MS}; count sweep "
          + (f"kernel-only {count_ms:.5f} ms <= {TOPK_COUNT_MS:g}: "
             f"{count_ms <= TOPK_COUNT_MS} (share of the one-read bound "
             f"{path['bound_ms'] / count_ms:.3f}); the function's device time "
             f"{fn_ms:.5f} ms <= {TOPK_DEVICE_MS:g}: {fn_ms <= TOPK_DEVICE_MS} "
             f"(share of the two-read bound {two_read_ms:.5f} ms: "
             f"{two_read_ms / fn_ms:.3f})" if measured else "kernel-only not measured")
          + f"; wrapper host time {host:.1f} us per call (time.perf_counter "
          "over 1000 calls at (1, 8, 128), no synchronize)")


def expected_launches(name: str, exchange: str, schedule: str,
                      mixing: str = "none", compressor: str = "none",
                      sparse_update=None) -> tuple:
    """(at trainer init, per step) launch counts of one phase-4 run."""
    init = {k: 0 for k in cu.KERNELS}
    step = dict(init)
    if name in BASELINES:
        return init, step
    kind = compressor.partition(":")[0]
    if kind == "topk":          # one sr_quantize for the compact values
        sparse = sparse_update is not False
        step[f"{name}_update_{'sparse' if sparse else 'q'}"] = 1
        step["sr_quantize"] = 1
        init["sr_quantize"] = 1 if schedule == "overlap" else 0
        return init, step
    if kind == "rank":          # two f32 factors, decompressed for _q
        step[f"{name}_update_q"] = 1
        return init, step
    quantized = exchange in ("int8", "fp8")
    mixed = mixing == "mixed"
    # the legacy f32 / bf16 form: the dense kernel
    dense = schedule == "sync" and not quantized and not mixed
    step[f"{name}_update{'' if dense else '_qm' if mixed else '_q'}"] = 1
    if quantized:               # one launch per payload tree, all agents
        step["sr_quantize"] = 2 if mixed else 1
        init["sr_quantize"] = step["sr_quantize"] if schedule == "overlap" else 0
    return init, step


def make_run_optimizer(name: str):
    """A phase-4 optimizer: fused where it has a fused path."""
    kw = {"cdmsgd": {"mu": MU}, "cdmsgd_nesterov": {"mu": MU}, "msgd": {"mu": MU},
          "fedavg": {"local_steps": 2, "mu": MU},
          "gossip": {"n_agents": AGENTS},
          "cdsgd_tv": {"topologies": [make_topology("ring", AGENTS),
                                      make_topology("fully_connected", AGENTS)]},
          }.get(name, {})
    return make_optimizer(name, ADAM_LR if name == "cdadam" else LR, fused=True,
                          **kw)


def _run_specs():
    """Every phase-4 run as keyword sets: ``RUNS``, then ``COMPRESSED_RUNS``
    (error feedback on, the wire precision set by the compressor)."""
    for i, (topo, name, exchange, schedule, ef, mixing, steps) in enumerate(RUNS):
        yield dict(topo=topo, name=name, exchange=exchange, schedule=schedule,
                   ef=ef, mixing=mixing, steps=steps, compressor="none",
                   sparse_update=None, wire=None, profile=i == 0)
    for topo, name, comp, sparse, schedule, steps, wire in COMPRESSED_RUNS:
        yield dict(topo=topo, name=name, exchange="f32", schedule=schedule,
                   ef=True, mixing="none", steps=steps, compressor=comp,
                   sparse_update=sparse, wire=wire, profile=True)


def profile_step(tr, batch, what: str) -> None:
    """One more step under ``torch.profiler``: its device time (kernels and
    copies) against its wall time, and the device time by kernel."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {what}: one step under the profiler, wall {wall_ms:.3f} ms, "
          f"device {busy:.3f} ms ({busy / wall_ms:.1%} busy) over "
          f"{len(by_name)} kernel names; top: "
          + "; ".join(f"{n[:48]} {t:.3f} ms" for n, t in top))


def train_main_path(params, train) -> dict:
    """Phase 4: every run of ``RUNS`` and ``COMPRESSED_RUNS``, launch counts
    checked per step; the threshold kernel on the first top-k run's carried
    buffers."""
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    total = {k: 0 for k in cu.KERNELS}
    f32_bytes = None
    for run in _run_specs():
        name, schedule, comp = run["name"], run["schedule"], run["compressor"]
        what = (f"{name} {comp if comp != 'none' else run['exchange']}"
                f"{' dense-update' if run['sparse_update'] is False else ''} "
                f"{schedule}{' EF' if run['ef'] else ''}"
                f"{' mixed' if run['mixing'] == 'mixed' else ''} on {run['topo']}")
        init, per_step = expected_launches(name, run["exchange"], schedule,
                                           run["mixing"], comp,
                                           run["sparse_update"])
        torch.cuda.reset_peak_memory_stats()
        cu.reset_launch_counts()
        tr = CollaborativeTrainer(loss, params, make_topology(run["topo"], AGENTS),
                                  make_run_optimizer(name),
                                  exchange=run["exchange"], schedule=schedule,
                                  error_feedback=run["ef"],
                                  momentum_mixing=run["mixing"], compressor=comp,
                                  sparse_update=run["sparse_update"])
        spec = make_flat_spec(tr.state.params, lead=1)
        if [b.rows for b in spec.buckets] != [PATH_ROWS]:
            raise AssertionError(f"expected one bucket of {PATH_ROWS} rows, got "
                                 f"{[b.rows for b in spec.buckets]}")
        if cu.launch_counts() != init:
            raise AssertionError(f"{what}: init launched {cu.launch_counts()}, "
                                 f"expected {init}")
        if f32_bytes is None:
            f32_bytes = tr.wire_bytes_per_step          # run 1: f32 on FC
        if run["wire"] is not None and tr.wire_bytes_per_step != run["wire"]:
            raise AssertionError(f"{what}: {tr.wire_bytes_per_step} wire B/step,"
                                 f" the accounting says {run['wire']}")
        batches = AgentPartitioner(train, AGENTS, seed=0).batches(64)
        times, losses = [], []
        for i in range(run["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.step(next(batches))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(m["loss"])
            counts = cu.launch_counts()
            want = {k: init[k] + (i + 1) * per_step[k] for k in counts}
            if counts != want:
                raise AssertionError(f"{what} step {i}: launched {counts}, "
                                     f"expected {want}")
            if not np.isfinite(m["loss"]):
                raise AssertionError(f"{what} step {i}: loss {m['loss']}")
        for leaf in tr.state.params.values():
            for t in leaf.values():
                if t.shape[0] != AGENTS or not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"{what}: bad parameter tensor "
                                         f"{tuple(t.shape)}")
        for k in total:
            total[k] += counts[k]
        wire_note = ""
        if comp != "none":
            wire_note = f" ({f32_bytes / tr.wire_bytes_per_step:.1f}x under f32)"
            if schedule == "overlap":
                carried = (wire_bytes_per_neighbor(tr.state.opt_state.wire)
                           * make_topology(run["topo"], AGENTS).degree())
                if carried != tr.wire_bytes_per_step:
                    raise AssertionError(f"{what}: the carried wire moves "
                                         f"{carried} B/step, the accounting "
                                         f"{tr.wire_bytes_per_step}")
                wire_note += ", equal to the carried wire's buffers"
        steady = times[1:]
        launched = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        print(f"train {what}: {run['steps']} steps, cnn 32x32x3 "
              f"{count_params(cnn_classifier_template(32, 3, 10))} "
              f"params, {AGENTS} agents, batch 64/agent: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, consensus_error {m['consensus_error']:.3e}, "
              f"wire {tr.wire_bytes_per_step} B/step{wire_note}, first step "
              f"{times[0]:.2f} ms, steady step median "
              f"{float(np.median(steady)):.3f} ms mean {float(np.mean(steady)):.3f} ms, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
              f"launches: {launched}")
        if comp.startswith("topk") and total["topk_threshold"] == 0:
            cu.reset_launch_counts()
            threshold_on_carried(tr)
            for k, v in cu.launch_counts().items():
                total[k] += v
        if run["profile"]:          # after the counts: not a main-path launch
            profile_step(tr, next(batches), what)
        del tr                      # the next run's peak memory is its own
    return total


def threshold_on_carried(tr) -> None:
    """The threshold function on every agent's carried buffer ``x + e``
    (what the next step compresses) at ``k = K``: one call, against its
    plain version, and bracketing within one geometric bin the K-th
    magnitude that the wire's exact selection keeps."""
    fl, st = tr.comm.flat, tr.state
    bufs = fl.pack(st.params, fl.spec(st.params))
    k_list = tk.topk_k_rows_for([b.shape[-2] for b in bufs],
                                tr.program.compressor_param)
    for b, e, k_rows in zip(bufs, st.opt_state.residual, k_list):
        x = (b.float() + e).contiguous()
        k = k_rows * 128
        tau, counts = tk.topk_threshold(x, k)
        torch.cuda.synchronize()
        taus = tk.threshold_taus(x)
        want = ref.topk_threshold_counts_ref(x, taus)
        idx = torch.clamp((want <= k).sum(dim=1) - 1, min=0)
        if not (torch.equal(counts, want.float())
                and torch.equal(tau, taus.gather(1, idx[:, None])[:, 0])):
            raise AssertionError("topk_threshold on the carried buffers "
                                 "differs from its plain version")
        flat = x.reshape(x.shape[0], -1)
        kept = tk.topk_indices(flat, k)
        kth = flat.abs().gather(1, kept.long()).amin(dim=1)
        last = taus.shape[1] - 1
        below = taus.gather(1, torch.clamp(idx + 1, max=last)[:, None])[:, 0]
        at = counts.gather(1, idx[:, None])[:, 0]
        # the next bin down holds more than k (unless tau is the last bin),
        # and tau holds at most k: kth lies in [tau_{b+1}, tau] (above tau
        # only when exactly k elements reach tau)
        ok = ((idx == last) | (kth >= below)) & ((kth <= tau) | (at == k))
        print(f"topk_threshold on run 23's carried x + e, k = {k}: tau "
              f"{[f'{v:.6e}' for v in tau.tolist()]}, the kept K-th magnitude "
              f"{[f'{v:.6e}' for v in kth.tolist()]}, count(|x| >= tau) "
              f"{[int(v) for v in at.tolist()]}; counts exact and tau bitwise "
              "against the plain version")
        if not bool(ok.all()):
            raise AssertionError("topk_threshold does not bracket the kept "
                                 "K-th magnitude within one bin")


def expected_mixing_launches(name: str, exchange: str, schedule: str,
                             rounds: int) -> tuple:
    """(at trainer init, per step) launch counts of one ``MIXING_RUNS`` run,
    from ``MixingStrategy.continue_from_wire``: a non-trivial program feeds
    the ``_q`` kernel once a step; a quantized wire quantizes ``k`` times a
    step (sync: round 1 and the ``k - 1`` inner rounds; overlap:
    ``advance_wire`` once and the ``k - 1`` inner rounds) and once more at
    overlap init."""
    init = {k: 0 for k in cu.KERNELS}
    step = dict(init)
    if name in BASELINES:
        return init, step
    step[f"{name}_update_q"] = 1
    if exchange in ("int8", "fp8"):
        step["sr_quantize"] = rounds
        init["sr_quantize"] = 1 if schedule == "overlap" else 0
    return init, step


def _mixing_trainer(params, name, exchange, schedule, knobs, device=None):
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    if name == "fedavg":
        opt = make_optimizer("fedavg", LR, local_steps=2, mu=MU,
                             faults=make_fault_schedule(FEDAVG_FAULTS, AGENTS))
    else:
        opt = make_run_optimizer(name)
    return CollaborativeTrainer(loss, params, make_topology("fully_connected", AGENTS),
                                opt, device=device, exchange=exchange,
                                schedule=schedule, **knobs)


def mixing_main_path(params, train) -> dict:
    """Phase 4b: every run of ``MIXING_RUNS``, launch counts checked per step
    against ``expected_mixing_launches``, the byte accounting against the
    buffers of the wire the trainer sends (``k`` rounds move ``k`` times
    the bytes, a schedule its mean degree, the staleness ring one
    generation whatever its depth)."""
    total = {k: 0 for k in cu.KERNELS}
    ring_bytes = {}
    for name, exchange, schedule, knobs in MIXING_RUNS:
        rounds = knobs.get("consensus_rounds", 1)
        what = " ".join([name, exchange, schedule]
                        + [f"{k}={v}" for k, v in knobs.items()]
                        + ([f"faults={FEDAVG_FAULTS} E=2"] if name == "fedavg" else []))
        init, per_step = expected_mixing_launches(name, exchange, schedule, rounds)
        torch.cuda.reset_peak_memory_stats()
        cu.reset_launch_counts()
        tr = _mixing_trainer(params, name, exchange, schedule, knobs)
        if cu.launch_counts() != init:
            raise AssertionError(f"{what}: init launched {cu.launch_counts()}, "
                                 f"expected {init}")
        spec = make_flat_spec(tr.state.params, lead=1)
        prog = tr.program
        note = ""
        batches = AgentPartitioner(train, AGENTS, seed=0).batches(64)
        times, ms = [], []
        for i in range(MIXING_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.step(next(batches))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            ms.append(m)
            counts = cu.launch_counts()
            want = {k: init[k] + (i + 1) * per_step[k] for k in counts}
            if counts != want:
                raise AssertionError(f"{what} step {i}: launched {counts}, "
                                     f"expected {want}")
            if not np.isfinite(m["loss"]):
                raise AssertionError(f"{what} step {i}: loss {m['loss']}")
            if name == "fedavg" and i == 1:
                # step 1 syncs over the 4 present agents and broadcasts
                if not all(torch.equal(t[0].expand_as(t), t)
                           for t in tree_leaves(tr.state.params)):
                    raise AssertionError(f"{what}: the agents differ after "
                                         "the partial sync")
        for k in total:
            total[k] += counts[k]
        wire = tr.state.opt_state.wire
        if name != "fedavg":
            # the accounting against the bytes of a wire the trainer sends:
            # the carried one (overlap), else the one this state sends in
            # round 1 (every round's wire has its shapes)
            fl = tr.comm.flat
            sent = wire if len(wire) else fl.strategy.quantize_stage(
                fl.pack(tr.state.params, spec), MIXING_STEPS)
            per = wire_bytes_per_neighbor(sent)
            degree = (prog.schedule.mean_degree() if prog.strategy == "time_varying"
                      else tr.topology.degree())
            if tr.wire_bytes_per_step != int(per * degree * rounds):
                raise AssertionError(f"{what}: {tr.wire_bytes_per_step} wire B/step, "
                                     f"the wire holds {per} B a neighbour x "
                                     f"{degree:g} neighbours x {rounds} rounds")
            note = (f" ({per} B a neighbour on the wire x {degree:g} neighbours "
                    f"x {rounds} round(s))")
        if rounds > 1:
            # one inner-round mix (``combine``) on this state's operands;
            # after the counts, and it launches no counted kernel
            sg, bufs = fl.strategy, fl.pack(tr.state.params, spec)
            nb, w, sc = sg.exchange_stage(sent, MIXING_STEPS)
            mix_ms = cuda_ms(lambda: sg.combine(nb, w, sc, bufs), iters=20)
            note += (f"; inner-round mix {mix_ms:.5f} ms a round (CUDA events, "
                     f"{rounds - 1} a step)")
        if prog.strategy == "time_varying" and exchange == "f32":
            # the step selects Pi_t: the weights the exchange hands the kernel
            rows = [fl.strategy.exchange_stage(sent, t)[1] for t in range(2)]
            for t, w in enumerate(rows):
                want_w = torch.tensor(_self_separated_weights(
                    prog.schedule.topology_at(t).pi), dtype=torch.float32,
                    device=w.device)
                if not torch.equal(w, want_w):
                    raise AssertionError(f"{what}: step {t}'s weights are not Pi_{t}'s")
            if torch.equal(rows[0], rows[1]):
                raise AssertionError(f"{what}: the weights do not change with the step")
            note += f"; weights Pi_t change with the step (period {prog.schedule.period})"
        if isinstance(wire, WireRing):
            depth = wire.slots[0][0].shape[1]
            if per != spec.exchange_bytes(exchange):
                raise AssertionError(f"{what}: the ring moves {per} B/neighbour, "
                                     f"one generation is {spec.exchange_bytes(exchange)}")
            ring_bytes[depth] = per
            note += (f"; ring depth {depth}, {per} B/neighbour (one generation), "
                     f"send_age {wire.send_age.tolist()}, ages row 0 "
                     f"{wire.ages[0].tolist()}")
        if name == "fedavg":
            note += (f"; every agent's params equal bit for bit after the "
                     f"partial sync (consensus_error {ms[1]['consensus_error']:.3e}"
                     ", the rounding of the mean)")
        launched = ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "none"
        print(f"mixing {what}: {MIXING_STEPS} steps, cnn, {AGENTS} agents, batch "
              f"64/agent: loss {ms[0]['loss']:.4f} -> {ms[-1]['loss']:.4f}, "
              f"consensus_error {ms[-1]['consensus_error']:.3e}, wire "
              f"{tr.wire_bytes_per_step} B/step{note}, first step {times[0]:.2f} ms, "
              f"steady median {float(np.median(times[1:])):.3f} ms, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} "
              f"MiB, launches: {launched}")
        del tr
    if len(set(ring_bytes.values())) != 1:
        raise AssertionError(f"ring bytes depend on the depth: {ring_bytes}")
    print(f"mixing: the staleness ring moves {set(ring_bytes.values()).pop()} B "
          f"per neighbour at depths {sorted(ring_bytes)}")
    return total


def paper_benchmarks() -> dict:
    """Phase 9: the paper's benchmarks through ``repro_torch.benchmarks``
    on the card: fig1a and fig1b at the reference's step counts (their rows
    printed as the reference prints them, unfused: no kernel), fig1a's
    CDSGD and fig1b's CDMSGD again fused (one update launch a step),
    fig1b's CDMSGD unfused and fused against the CPU over 20 steps, and
    Proposition 1's benchmark against its CPU run."""
    card = card_line()
    total = {k: 0 for k in cu.KERNELS}
    cu.reset_launch_counts()
    rows = fig1a_cdsgd_vs_sgd.run() + fig1b_cdmsgd_vs_fedavg.run()
    if any(cu.launch_counts().values()):
        raise AssertionError(f"unfused benchmark rows launched {cu.launch_counts()}")
    for name, opt, steps, kw, kernel in BENCH_FUSED:
        cu.reset_launch_counts()
        r = bench.run_experiment(name, opt, steps=steps, fused=True, **kw)
        counts = cu.launch_counts()
        want = {k: steps if k == kernel else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"{name}: launched {counts}, expected {want}")
        total[kernel] += steps
        bench.emit([r])
        rows.append(r)
    # where a benchmark step's time goes: one profiled fused CDMSGD step of
    # the MLP, after two warm-up steps (not a counted launch)
    tr = CollaborativeTrainer(bench.MLP_LOSS, bench.base_params("flat"),
                              make_topology("fully_connected", AGENTS),
                              make_optimizer("cdmsgd", 0.05, mu=MU, fused=True))
    batches = AgentPartitioner(bench.dataset("flat")[0], AGENTS, seed=0).batches(64)
    for _ in range(2):
        tr.step(next(batches))
    profile_step(tr, next(batches), "fig1b/cdmsgd fused (the benchmark MLP)")
    del tr
    for r in rows:
        if not (np.isfinite(r["loss"]) and 0.0 <= r["val_acc"] <= 1.0):
            raise AssertionError(f"{r['name']}: {r}")
        print(f"bench {r['name']}: steady step {r['us_per_call'] / 1e3:.4f} ms "
              f"(mean over steps 2..N, evaluations included), loss "
              f"{r['loss']:.5f}, val_acc {r['val_acc']:.4f}, consensus "
              f"{r['consensus']:.4e}; {card}")
    for fused in (False, True):
        g, c = (bench.run_experiment("fig1b/cdmsgd", "cdmsgd", steps=BENCH_PARITY_STEPS,
                                     mu=MU, fused=fused, device=d)
                for d in ("cuda", "cpu"))
        rel = {k: abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
               for k in ("loss", "consensus")}
        print(f"bench parity fig1b/cdmsgd{' fused' if fused else ''} card vs cpu, "
              f"{BENCH_PARITY_STEPS} steps from the same init: loss {g['loss']:.7f} / "
              f"{c['loss']:.7f}, consensus {g['consensus']:.6e} / {c['consensus']:.6e}, "
              + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items())
              + f" (tol {BENCH_TOL:g})")
        if not max(rel.values()) <= BENCH_TOL:
            raise AssertionError(f"fig1b/cdmsgd card/CPU: {rel}")
    t0 = time.perf_counter()
    got = consensus_radius.measure(device="cuda")
    card_s = time.perf_counter() - t0
    want = consensus_radius.measure(device="cpu")
    worst = 0.0
    for (name, e, b), (_, ec, bc) in zip(got, want):
        worst = max(worst, abs(e - ec) / abs(ec), abs(b - bc) / abs(bc))
        if not e <= b:
            raise AssertionError(f"{name}: measured {e} above the bound {b}")
    print(f"bench prop1 card vs cpu: {len(got)} rows, worst relative gap of "
          f"measured and bound {worst:.2e} (tol {BENCH_TOL:g}); every measured "
          f"error under its bound; card run {card_s:.2f} s")
    if not worst <= BENCH_TOL:
        raise AssertionError(f"prop1 card/CPU: {worst}")
    return total


def _max_param_diff(trainers) -> float:
    gpu, cpu = (tr.state.params for tr in trainers)
    return max(float((gpu[k][j].cpu() - cpu[k][j]).abs().max())
               for k in gpu for j in gpu[k])


def parity(params, train, steps: int, exchange: str = "f32",
           schedule: str = "sync") -> float:
    """Phase 5: ``steps`` CDMSGD steps on the card vs the port on the CPU.
    A quantized wire is also compared bit for bit: the wire the first step
    quantizes from the (shared) initial params at its seed."""
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    topo = make_topology("fully_connected", AGENTS)
    trainers = [CollaborativeTrainer(loss, params, topo,
                                     make_optimizer("cdmsgd", LR, fused=True, mu=MU),
                                     device=d, exchange=exchange, schedule=schedule)
                for d in ("cuda", "cpu")]
    streams = [AgentPartitioner(train, AGENTS, seed=1).batches(64) for _ in trainers]
    what = f"cdmsgd {exchange} {schedule} {steps} step(s)"
    if exchange in ("int8", "fp8"):
        wires = []
        for tr in trainers:
            fl, p = tr.comm.flat, tr.state.params
            wires.append(fl.strategy.quantize_stage(fl.pack(p, fl.spec(p)),
                                                    tr.state.opt_state.step))
        for (qg, sg), (qc, sc) in zip(*wires):
            if not (torch.equal(qg.cpu().view(torch.uint8), qc.view(torch.uint8))
                    and torch.equal(sg.cpu(), sc)):
                raise AssertionError(f"{what}: card and CPU wires differ")
        print(f"parity {what}: the first step's wire codes and scales equal bit "
              f"for bit ({sum(q.numel() for q, _ in wires[1])} codes)")
    for _ in range(steps):
        for tr, batches in zip(trainers, streams):
            tr.step(next(batches))
    diff = _max_param_diff(trainers)
    print(f"parity {what} card vs cpu: max param abs diff {diff:.3e} "
          f"(tol {PARITY_TOL:g})")
    if not diff <= PARITY_TOL:
        raise AssertionError(f"card/CPU parity {what}: {diff} > {PARITY_TOL}")
    return diff


def _copy_state(src, dst) -> None:
    """``dst`` trainer takes ``src``'s params and optimizer state (moved to
    ``dst``'s device)."""
    move = lambda t: t.to(dst.device)
    o = src.state.opt_state
    dst.state = TrainState(
        params=tree_map(move, src.state.params),
        opt_state=o._replace(inner=tree_map(move, o.inner),
                             wire=tree_map(move, o.wire),
                             residual=tree_map(move, o.residual),
                             qwarm=tree_map(move, o.qwarm)),
        step=src.state.step)


def _wire_of(tr):
    """The (params, momentum) wire a mixed sync step quantizes now."""
    fl, st = tr.comm.flat, tr.state
    spec = fl.spec(st.params)
    bufs = widen_with_momentum(
        fl, fl.pack(st.params, spec),
        fl.pack(tr.optimizer.momentum_tree(st.opt_state.inner), spec))
    return fl.strategy.quantize_stage(bufs, st.opt_state.step)


def parity_mixed(params, train) -> float:
    """Phase 5: int8 momentum-mixed CDMSGD, card vs CPU.  One step from the
    same init; the card's state copied to the CPU; both payload wires (the
    params' and the momentum's) quantized there equal bit for bit; one more
    step from that state."""
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    topo = make_topology("fully_connected", AGENTS)
    trainers = [CollaborativeTrainer(
        loss, params, topo, make_optimizer("cdmsgd", LR, fused=True, mu=MU),
        device=d, exchange="int8", momentum_mixing="mixed")
        for d in ("cuda", "cpu")]
    streams = [AgentPartitioner(train, AGENTS, seed=2).batches(64) for _ in trainers]
    for tr, batches in zip(trainers, streams):
        tr.step(next(batches))
    first = _max_param_diff(trainers)
    _copy_state(*trainers)
    wires = [_wire_of(tr) for tr in trainers]
    if len(wires[0]) != 2:
        raise AssertionError(f"mixed wire has {len(wires[0])} entries, expected 2")
    for (qg, sg), (qc, sc) in zip(*wires):
        if not (torch.equal(qg.cpu().view(torch.uint8), qc.view(torch.uint8))
                and torch.equal(sg.cpu(), sc)):
            raise AssertionError("mixed int8: card and CPU wires differ")
    for tr, batches in zip(trainers, streams):
        tr.step(next(batches))
    diff = _max_param_diff(trainers)
    print(f"parity cdmsgd int8 sync mixed card vs cpu: max param abs diff "
          f"{first:.3e} after one step from the same init, {diff:.3e} after "
          f"one step from the same state (tol {PARITY_TOL:g}); both payload "
          f"wires equal bit for bit ({sum(q.numel() for q, _ in wires[1])} codes)")
    if not max(first, diff) <= PARITY_TOL:
        raise AssertionError(f"card/CPU parity mixed int8: {first}, {diff}")
    return diff


def parity_adam_update(params, train) -> float:
    """Phase 5: CDAdam's update phase (int8 wire, mixed first moment) on the
    card and on the CPU from the same state with the same gradients: the
    card's, copied to the CPU."""
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    topo = make_topology("fully_connected", AGENTS)
    gpu, cpu = (CollaborativeTrainer(
        loss, params, topo, make_optimizer("cdadam", ADAM_LR, fused=True),
        device=d, exchange="int8", momentum_mixing="mixed")
        for d in ("cuda", "cpu"))
    batches = AgentPartitioner(train, AGENTS, seed=3).batches(64)
    for _ in range(2):
        gpu.step(next(batches))
    _copy_state(gpu, cpu)
    batch = {k: torch.as_tensor(v, device=gpu.device)
             for k, v in next(batches).items()}
    program = gpu._program
    _, grads = program.grad_phase(
        gpu.optimizer.grad_params(gpu.state.params, gpu.state.opt_state), batch)
    grads = tree_map(lambda t: t.detach(), grads)
    with torch.no_grad():
        new_g, st_g = program.update_phase(gpu.state.params, grads,
                                           gpu.state.opt_state)
        new_c, st_c = cpu._program.update_phase(
            cpu.state.params, tree_map(lambda t: t.cpu(), grads),
            cpu.state.opt_state)
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves((new_g, st_g.inner)), tree_leaves((new_c, st_c.inner))))
    print(f"parity cdadam int8 sync mixed update phase card vs cpu, same "
          f"gradients: max abs diff of params, m, v {diff:.3e} "
          f"(tol {UPDATE_TOL:g})")
    if not diff <= UPDATE_TOL:
        raise AssertionError(f"CDAdam update phase card/CPU: {diff} > {UPDATE_TOL}")
    return diff


def _compressed_trainers(params, train, devices, name: str, compressor: str,
                         sparse=(None, None), seed: int = 4):
    """Trainers with error feedback on ``compressor``, one per device, all
    in the first's state after two of its steps; and the card gradients of
    the next batch (detached, on the first trainer's device)."""
    loss = functools.partial(classifier_loss, cnn_classifier_apply)
    topo = make_topology("fully_connected", AGENTS)
    trs = [CollaborativeTrainer(loss, params, topo, make_run_optimizer(name),
                                device=d, error_feedback=True,
                                compressor=compressor, sparse_update=sp)
           for d, sp in zip(devices, sparse)]
    batches = AgentPartitioner(train, AGENTS, seed=seed).batches(64)
    for _ in range(2):
        trs[0].step(next(batches))
    for tr in trs[1:]:
        _copy_state(trs[0], tr)
    first = trs[0]
    batch = {k: torch.as_tensor(v, device=first.device)
             for k, v in next(batches).items()}
    _, grads = first._program.grad_phase(
        first.optimizer.grad_params(first.state.params, first.state.opt_state),
        batch)
    return trs, tree_map(lambda t: t.detach(), grads)


def _compress_now(tr):
    """The wire, residual and warm start the next sync step compresses."""
    fl, st = tr.comm.flat, tr.state
    bufs = fl.pack(st.params, fl.spec(st.params))
    return fl.strategy.compress_ef(bufs, st.opt_state.step,
                                   st.opt_state.residual, st.opt_state.qwarm)


def _update(tr, grads):
    with torch.no_grad():
        return tr._program.update_phase(
            tr.state.params, tree_map(lambda t: t.to(tr.device), grads),
            tr.state.opt_state)


def _gap(a, b) -> float:
    """Max abs difference over two trees of tensors (any devices)."""
    return max([float((x.cpu().float() - y.cpu().float()).abs().max())
                for x, y in zip(tree_leaves(a), tree_leaves(b))], default=0.0)


def _same_bits(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(
        x.cpu().contiguous().view(torch.uint8), y.cpu().contiguous().view(torch.uint8))
        for x, y in zip(tree_leaves(a), tree_leaves(b)))


def parity_sparse_dense(params, train) -> float:
    """Phase 5: one CDSGD ``topk:0.01`` update phase with ``sparse_update``
    on and one with it off, on the card, from one state with the same
    gradients: the wires equal bit for bit, params within 1e-6 (predicted
    0.0: the same products in the same order)."""
    (sp, dn), grads = _compressed_trainers(params, train, ("cuda", "cuda"),
                                           "cdsgd", f"topk:{TOPK_P}",
                                           sparse=(True, False))
    if not _same_bits(_compress_now(sp)[0], _compress_now(dn)[0]):
        raise AssertionError("sparse/dense: the compressed wires differ")
    (ps, ss), (pd, sd) = _update(sp, grads), _update(dn, grads)
    diff = _gap(ps, pd)
    res = _gap(ss.residual, sd.residual)
    print(f"parity cdsgd topk:{TOPK_P} sync EF update phase, sparse vs dense "
          f"on the card, same state and gradients: wires equal bit for bit, "
          f"max param abs diff {diff:.3e}, residual {res:.3e} "
          f"(tol {UPDATE_TOL:g})")
    if not max(diff, res) <= UPDATE_TOL:
        raise AssertionError(f"sparse vs dense update phase: {diff}, {res}")
    return diff


def parity_compressed_update(params, train, compressor: str, tol: float) -> float:
    """Phase 5: one CDMSGD sync EF update phase on ``compressor``, card vs
    CPU from the same state with the card's gradients.  Top-k: the wire
    (values, indices, scales) equal bit for bit, residual and params within
    ``tol``; rank: every field within ``tol``."""
    (gpu, cpu), grads = _compressed_trainers(params, train, ("cuda", "cpu"),
                                             "cdmsgd", compressor, seed=5)
    (wg, rg, qg), (wc, rc, qc) = _compress_now(gpu), _compress_now(cpu)
    topk_wire = compressor.startswith("topk")
    if topk_wire and not _same_bits(wg, wc):
        raise AssertionError(f"{compressor}: card and CPU wires differ")
    wire_gap = 0.0 if topk_wire else _gap(wg, wc)
    (pg, sg), (pc, sc) = _update(gpu, grads), _update(cpu, grads)
    gaps = {"wire": wire_gap, "residual": _gap(sg.residual, sc.residual),
            "params": _gap(pg, pc), "momentum": _gap(sg.inner, sc.inner),
            "qwarm": _gap(sg.qwarm, sc.qwarm)}
    codes = sum(t.numel() for t in tree_leaves(wg))
    print(f"parity cdmsgd {compressor} sync EF update phase card vs cpu, same "
          f"state and gradients: "
          + (f"wire equal bit for bit ({codes} values, indices and scales), "
             if topk_wire else "")
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (tol {tol:g})")
    if not max(gaps.values()) <= tol:
        raise AssertionError(f"{compressor} card/CPU update phase: {gaps}")
    return gaps["params"]


def parity_multi_round_update(params, train) -> float:
    """Phase 5: ``MIXING_RUNS``' run 2 (CDMSGD, int8, sync, two rounds): its
    update phase on the card and on the CPU from the same state with the
    card's gradients; both rounds' int8 wires equal bit for bit, and the
    round-1 mix between them too; params and momentum within 1e-6."""
    name, exchange, schedule, knobs = MIXING_RUNS[1]
    gpu, cpu = (_mixing_trainer(params, name, exchange, schedule, knobs, device=d)
                for d in ("cuda", "cpu"))
    batches = AgentPartitioner(train, AGENTS, seed=6).batches(64)
    for _ in range(2):
        gpu.step(next(batches))
    _copy_state(gpu, cpu)
    batch = {k: torch.as_tensor(v, device=gpu.device)
             for k, v in next(batches).items()}
    _, grads = gpu._program.grad_phase(
        gpu.optimizer.grad_params(gpu.state.params, gpu.state.opt_state), batch)
    grads = tree_map(lambda t: t.detach(), grads)
    stages = []
    for tr in (gpu, cpu):
        fl, st = tr.comm.flat, tr.state
        sg, step = fl.strategy, st.opt_state.step
        bufs = fl.pack(st.params, fl.spec(st.params))
        w1 = sg._quantize_payloads(bufs, step)
        nb, w, sc = sg.exchange_stage(w1, step)
        mix = sg.combine(nb, w, sc, bufs)
        stages.append((w1, mix, sg._quantize_payloads(mix, step, rnd=1)))
    for what, g, c in zip(("round-1 wire", "round-1 mix", "round-2 wire"), *stages):
        if not _same_bits(g, c):
            raise AssertionError(f"multi-round update phase: the {what} differs "
                                 "between the card and the CPU")
    (pg, sg_), (pc, sc_) = _update(gpu, grads), _update(cpu, grads)
    gaps = {"params": _gap(pg, pc), "momentum": _gap(sg_.inner, sc_.inner)}
    codes = sum(q.numel() for q, _ in stages[0][0]) * 2
    print(f"parity cdmsgd int8 sync consensus_rounds=2 update phase card vs cpu, "
          f"same state and gradients: both rounds' wires and the round-1 mix "
          f"equal bit for bit ({codes} codes), "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (tol {UPDATE_TOL:g})")
    if not max(gaps.values()) <= UPDATE_TOL:
        raise AssertionError(f"multi-round update phase card/CPU: {gaps}")
    return gaps["params"]


def parity_ring(params, train) -> float:
    """Phase 5: ``MIXING_RUNS``' run 4 (CDMSGD, int8, overlap, staleness 2,
    a straggler and a dropped link) over 3 steps, card against CPU, the
    card's state copied to the CPU before each step: the ring's slots equal
    bit for bit after every step, ``send_age`` and ``ages`` equal, params
    within 1e-4."""
    name, exchange, schedule, knobs = MIXING_RUNS[3]
    gpu, cpu = (_mixing_trainer(params, name, exchange, schedule, knobs, device=d)
                for d in ("cuda", "cpu"))
    batches = AgentPartitioner(train, AGENTS, seed=7).batches(64)
    worst, ages = 0.0, []
    for step in range(3):
        _copy_state(gpu, cpu)
        b = next(batches)
        gpu.step(b)
        cpu.step(b)
        wg, wc = gpu.state.opt_state.wire, cpu.state.opt_state.wire
        if not (_same_bits(wg.slots, wc.slots)
                and torch.equal(wg.send_age.cpu(), wc.send_age)
                and torch.equal(wg.ages.cpu(), wc.ages)):
            raise AssertionError(f"staleness ring step {step}: the card's ring "
                                 "differs from the CPU's")
        ages.append(wc.send_age.tolist())
        worst = max(worst, _max_param_diff((gpu, cpu)))
    print(f"parity cdmsgd int8 overlap staleness=2 faults "
          f"{knobs['fault_schedule']} card vs cpu, 3 steps each from the card's "
          f"state: ring slots equal bit for bit, send_age {ages} and ages equal, "
          f"max param abs diff {worst:.3e} (tol {PARITY_TOL:g})")
    if not worst <= PARITY_TOL:
        raise AssertionError(f"staleness ring card/CPU: {worst}")
    return worst


def _close_err(got: torch.Tensor, want: torch.Tensor, tol: float):
    """(max abs err, ok): ``|got - want| <= tol + tol |want|`` everywhere
    (the reference's allclose with rtol = atol = tol)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.abs()).all())


def _report_serving(results: dict, name: str, label: str, shape: str, err: float,
                    tol: float, kernel, plain, library, flops: float,
                    nbytes: float, plain_iters: int = 20, symbol: str = None,
                    peak: float = F32_FLOPS_PER_S) -> dict:
    """Time one checked operand set of a serving-path kernel and print its
    line: CUDA-event ms, the kernel alone from a profiler trace (kernels
    named ``symbol``), the bound (operations at ``peak``, float32 on the
    CUDA cores unless the bf16 tensor cores are given, vs bytes), the bf16
    tensor-core time of the same operations, the plain version's and the
    library's ms and the ratio to the library.  Returns the times."""
    ms = cuda_ms(kernel, iters=20, warmup=2)
    plain_ms = cuda_ms(plain, iters=plain_iters, warmup=1)
    lib_ms = cuda_ms(library, iters=20, warmup=2) if library is not None else None
    dev_ms = device_ms(kernel, symbol or KERNELS[name][1], iters=10)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    b_ms, b_by = 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    rate = "bf16 tensor-core" if peak == BF16_TC_FLOPS_PER_S else "float32"
    print(f"kernel {name} [{label}] {shape}: max_abs_err={err:.3e} (tol {tol:g} "
          f"abs and rel) ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms="
          f"{'none' if lib_ms is None else f'{lib_ms:.5f}'} "
          f"{'' if lib_ms is None else f'ms/library_ms={ms / lib_ms:.3f} '}"
          f"bound_ms={b_ms:.5f} ({b_by}: {flops:.4g} {rate} operations, "
          f"{nbytes:.4g} bytes) bound_share={b_ms / ms:.3f} bf16_tensor_core_ms="
          f"{1e3 * flops / BF16_TC_FLOPS_PER_S:.5f} kernel_only_ms="
          f"{'not measured' if dev_ms is None else f'{dev_ms:.5f}'}")
    entry = results.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if label == "path":
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms)
    return {"ms": ms, "library_ms": lib_ms, "bound_ms": b_ms, "kernel_only_ms": dev_ms}


def _allowed_pairs(sq: int, sk: int, window) -> int:
    """(row, col) pairs the causal (+ window) mask keeps."""
    rows = torch.arange(sq, dtype=torch.float64)
    lo = torch.zeros_like(rows) if window is None else torch.clamp(rows - window + 1, min=0)
    return int((torch.clamp(rows, max=sk - 1) - lo + 1).clamp(min=0).sum())


def check_flash(results: dict, gen) -> None:
    """Phase 3, the flash attention kernels against ``attention_ref``: the
    tensor-core kernel at the gemma3-1b prefill shape (bf16; the 512-window
    local layer is the ``path`` row, the global layer beside it) and at a
    ragged s = 200 (both masks, through the model path's any-length
    launch), the float32 kernel at the float32 card-vs-CPU shape; the
    other dense configs' prefill shapes (h2o-danube-3-4b's head dim 120,
    bf16 and float32; granite-3-8b's and starcoder2-7b's bf16 GQA groups of
    4 and 9 at D 128; kimi-k2-1t-a32b's and internvl2-2b's, groups of 8 and
    2 at D 128); ``scaled_dot_product_attention`` on the same operands (GQA, causal or a
    boolean band mask) as the library yardstick.  Then the bf16 speed
    criteria, printed (met or not), not held."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    times = {}
    gemma = ("flash_attention", 4, 1, 256)
    h2o = (FLASH_D120, D120_HEADS, D120_KV, 120)
    # granite-3-8b's and starcoder2-7b's global prefill layers: D 128 on GQA
    # groups of 4 and 9
    granite, starcoder = (("flash_attention", c.n_heads, c.n_kv_heads, c.head_dim_)
                          for c in map(get_config, ("granite-3-8b", "starcoder2-7b")))
    # kimi-k2-1t-a32b's and internvl2-2b's prefill layers: D 128 on GQA groups
    # of 8 (64 heads on 8) and 2 (16 on 8)
    kimi, internvl = (("flash_attention", c.n_heads, c.n_kv_heads, c.head_dim_)
                      for c in map(get_config, ("kimi-k2-1t-a32b", "internvl2-2b")))
    for (name, h, kv, d), label, b, s, dtype, window in (
            (gemma, "path", PREFILL_BATCH, PREFILL_LEN, torch.bfloat16, 512),
            (gemma, "path-global", PREFILL_BATCH, PREFILL_LEN, torch.bfloat16, None),
            (gemma, "ragged", PREFILL_BATCH, 200, torch.bfloat16, 512),
            (gemma, "ragged-global", PREFILL_BATCH, 200, torch.bfloat16, None),
            (gemma, "f32-local", 1, 640, torch.float32, 512),
            (gemma, "f32-global", 1, 640, torch.float32, None),
            (gemma, "path-f32", PREFILL_BATCH, PREFILL_LEN, torch.float32, 512),
            (gemma, "path-f32-global", PREFILL_BATCH, PREFILL_LEN, torch.float32, None),
            # h2o-danube-3-4b's prefill at head dim 120, and float32 at it
            (h2o, "path", PREFILL_BATCH, PREFILL_LEN, torch.bfloat16, D120_WINDOW),
            (h2o, "ragged", PREFILL_BATCH, 200, torch.bfloat16, 64),
            (h2o, "f32", 1, 640, torch.float32, D120_WINDOW),
            (granite, "granite", PREFILL_BATCH, PREFILL_LEN, torch.bfloat16, None),
            (starcoder, "starcoder2", PREFILL_BATCH, PREFILL_LEN, torch.bfloat16, None),
            (kimi, "kimi-k2", PREFILL_BATCH, PREFILL_LEN, torch.bfloat16, None),
            (internvl, "internvl2", PREFILL_BATCH, PREFILL_LEN, torch.bfloat16, None)):
        q = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, kv, s, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, kv, s, d), generator=gen, device=dev).to(dtype)
        launch = fa.flash_attention_any_length if label.startswith("ragged") \
            else fa.flash_attention
        variant = "tc" if dtype == torch.bfloat16 else "f32"
        symbol, peak = FLASH_VARIANTS[variant]
        before = dict(fa.flash_attention.launches_by_variant)
        out = launch(q, k, v, window=window)
        torch.cuda.synchronize()
        before[variant] += 1
        if fa.flash_attention.launches_by_variant != before:
            raise AssertionError(f"flash_attention [{label}] ran "
                                 f"{fa.flash_attention.launches_by_variant}, "
                                 f"expected one more {variant}")
        want = attention_ref(q, k, v, window=window)
        err, ok = _close_err(out, want, FLASH_TOL[dtype])
        if not ok or out.dtype != dtype:
            raise AssertionError(f"flash_attention [{label}] differs from its "
                                 f"plain version: max abs err {err}")
        if window is None or window >= s:
            library = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(s, device=dev)
            band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            library = lambda: sdpa(q, k, v, attn_mask=band, enable_gqa=True)
        lib_err, _ = _close_err(library(), want, FLASH_TOL[dtype])
        print(f"  sdpa [{label}] against the plain version: max abs err {lib_err:.3e}")
        if dtype == torch.bfloat16:
            err_cap = FLASH_BF16_SDPA_ERR_RATIO * max(
                lib_err, float(want.float().abs().max()) * 2.0 ** -8)
            if err > err_cap:
                raise AssertionError(
                    f"flash_attention [{label}]: max abs err {err:.3e} above "
                    f"{FLASH_BF16_SDPA_ERR_RATIO:g} x SDPA's {lib_err:.3e}")
        esize = q.element_size()
        times[label if name == "flash_attention" else f"d120-{label}"] = _report_serving(
            results, name, label,
            f"q ({b},{h},{s},{d}) k,v ({b},{kv},{s},{d}) {str(dtype)[6:]} "
            f"window={window} ({symbol})", err, FLASH_TOL[dtype],
            lambda: launch(q, k, v, window=window),
            lambda: attention_ref(q, k, v, window=window), library,
            4.0 * d * b * h * _allowed_pairs(s, s, window),
            esize * (2 * q.numel() + k.numel() + v.numel()), symbol=symbol, peak=peak)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 1, 64, 256), generator=gen, device=dev).to(dtype)
        print(f"flash_attention wrapper host time at (1,1,64,256) {str(dtype)[6:]}: "
              f"{host_us(lambda: fa.flash_attention(q, q, q)):.1f} us per call "
              "(launch-bound: the ragged rows' ms above is this, not the kernel)")
    glob, loc = times["path-global"], times["path"]
    print(f"flash bf16 speed criteria: global {glob['ms']:.5f} ms <= "
          f"{FLASH_GLOBAL_SDPA_RATIO:g} x SDPA causal {glob['library_ms']:.5f} and <= "
          f"{FLASH_GLOBAL_MS:g} ms: "
          f"{glob['ms'] <= min(FLASH_GLOBAL_SDPA_RATIO * glob['library_ms'], FLASH_GLOBAL_MS)}; "
          f"window {loc['ms']:.5f} ms <= SDPA band {loc['library_ms']:.5f}: "
          f"{loc['ms'] <= loc['library_ms']}; goal, global <= SDPA causal: "
          f"{glob['ms'] <= glob['library_ms']} (bound share {glob['bound_ms'] / glob['ms']:.3f})")
    parts = []
    for label in ("f32-local", "f32-global"):
        t = times[label]
        cap = min(t["library_ms"], FLASH_F32_MS)
        parts.append(f"[{label}] {t['ms']:.5f} ms <= SDPA float32 {t['library_ms']:.5f} "
                     f"and <= {FLASH_F32_MS:g}: {t['ms'] <= cap}; goal <= "
                     f"{FLASH_F32_GOAL_MS:g}: {t['ms'] <= FLASH_F32_GOAL_MS}")
    for label in ("path-f32", "path-f32-global"):
        t = times[label]
        share = t["bound_ms"] / t["ms"]
        parts.append(f"[{label}] {t['ms']:.5f} ms, bound share {share:.3f} >= "
                     f"{FLASH_F32_BOUND_SHARE:g}: {share >= FLASH_F32_BOUND_SHARE} "
                     f"(SDPA float32 {t['library_ms']:.5f})")
    print("flash f32 speed criteria: " + "; ".join(parts))
    t = times["d120-path"]
    print(f"flash bf16 head dim 120 (h2o-danube-3-4b prefill): {t['ms']:.5f} ms, "
          f"SDPA causal {t['library_ms']:.5f} (ratio {t['ms'] / t['library_ms']:.3f}), "
          f"bound share {t['bound_ms'] / t['ms']:.3f}; not held")


def check_flash_families(results: dict, gen) -> None:
    """Phase 3, the flash kernels at the hybrid and encoder-decoder prefill
    shapes (``FAMILY_FLASH``) against ``attention_ref``: hymba-1.5b's
    causal GQA group of 5 with its 1024 window, seamless's non-causal
    encoder (bf16 and float32), its causal decoder self-attention and its
    cross-attention (Sq 2048 over Sk 1024); SDPA on the same operands (non-causal, or the band mask) as the
    library yardstick, the bound over the pairs the mask keeps."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    for label, b, h, kv, sq, sk, d, causal, window, dtype in FAMILY_FLASH:
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
        variant = "tc" if dtype == torch.bfloat16 else "f32"
        symbol, peak = FLASH_VARIANTS[variant]
        before = dict(fa.flash_attention.launches_by_variant)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        before[variant] += 1
        if fa.flash_attention.launches_by_variant != before:
            raise AssertionError(f"flash_attention [{label}] ran "
                                 f"{fa.flash_attention.launches_by_variant}, "
                                 f"expected one more {variant}")
        want = attention_ref(q, k, v, causal=causal, window=window)
        err, ok = _close_err(out, want, FLASH_TOL[dtype])
        if not ok or out.dtype != dtype:
            raise AssertionError(f"flash_attention [{label}] differs from its "
                                 f"plain version: max abs err {err}")
        if window is not None:
            rows = torch.arange(sq, device=dev)[:, None]
            cols = torch.arange(sk, device=dev)[None, :]
            band = (cols <= rows) & (cols > rows - window)
            library = lambda: sdpa(q, k, v, attn_mask=band, enable_gqa=True)  # noqa: E731
        else:
            library = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)  # noqa: E731
        lib_err, _ = _close_err(library(), want, FLASH_TOL[dtype])
        print(f"  sdpa [{label}] against the plain version: max abs err {lib_err:.3e}")
        if dtype == torch.bfloat16:
            err_cap = FLASH_BF16_SDPA_ERR_RATIO * max(
                lib_err, float(want.float().abs().max()) * 2.0 ** -8)
            if err > err_cap:
                raise AssertionError(
                    f"flash_attention [{label}]: max abs err {err:.3e} above "
                    f"{FLASH_BF16_SDPA_ERR_RATIO:g} x SDPA's {lib_err:.3e}")
        pairs = _allowed_pairs(sq, sk, window) if causal else sq * sk
        t = _report_serving(
            results, "flash_attention", label,
            f"q ({b},{h},{sq},{d}) k,v ({b},{kv},{sk},{d}) {str(dtype)[6:]} "
            f"causal={causal} window={window} ({symbol})", err, FLASH_TOL[dtype],
            lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
            lambda: attention_ref(q, k, v, causal=causal, window=window), library,
            4.0 * d * b * h * pairs, q.element_size() * (2 * q.numel() + k.numel()
                                                         + v.numel()),
            symbol=symbol, peak=peak)
        print(f"flash [{label}] {t['ms']:.5f} ms, SDPA {t['library_ms']:.5f} (ratio "
              f"{t['ms'] / t['library_ms']:.3f}), bound share {t['bound_ms'] / t['ms']:.3f} "
              f"[{card_line()}]; not held")
        del q, k, v, out, want


def wkv_flops(bh: int, s: int, hs: int) -> float:
    """Operations of the WKV6 recurrence, per step and head: y_j = sum_i
    r_i S_ij + v_j sum_i r_i u_i k_i is 2 hs^2 + 5 hs (the bonus term is a
    scalar per step, not an hs x hs product), S <- w (.) S + k (x) v is
    3 hs^2."""
    return float(bh * s * (5 * hs * hs + 5 * hs))


def check_wkv(results: dict, gen) -> None:
    """Phase 3, the WKV6 kernel against ``wkv6_ref`` at the rwkv6-1.6b
    prefill shape, in the model's (b, s, n_h, hs) layout: bf16 r, k, v with
    f32 w, u (the ``path`` row; y bf16 within 2e-2, the state within 1e-4)
    and the same operands in float32 (y and state within 1e-4)."""
    dev = torch.device("cuda")
    b, s, nh, hs = PREFILL_BATCH, PREFILL_LEN, 32, 64
    r, k, v = (torch.randn((b, s, nh, hs), generator=gen, device=dev) for _ in range(3))
    w = torch.sigmoid(torch.randn((b, s, nh, hs), generator=gen, device=dev)) * 0.5 + 0.45
    u = 0.1 * torch.randn((nh, hs), generator=gen, device=dev)

    def fold(x):
        return x.transpose(1, 2).reshape(b * nh, s, hs)

    times = {}
    for label, dtype in (("path", torch.bfloat16), ("f32", torch.float32)):
        rr, kk, vv = (x.to(dtype) for x in (r, k, v))
        y, state = rs.wkv6(rr, kk, vv, w, u)
        torch.cuda.synchronize()
        want_y, want_state = wkv6_ref(fold(rr), fold(kk), fold(vv), fold(w),
                                      u.repeat(b, 1))
        y_tol = FLASH_TOL[torch.bfloat16] if dtype == torch.bfloat16 else WKV_TOL
        y_err, y_ok = _close_err(fold(y), want_y.to(dtype), y_tol)
        s_err, s_ok = _close_err(state, want_state, WKV_TOL)
        if not (y_ok and s_ok) or y.dtype != dtype:
            raise AssertionError(f"wkv6 [{label}] differs from its plain version: "
                                 f"y {y_err}, state {s_err}")
        print(f"  wkv6 [{label}]: y max abs err {y_err:.3e} (tol {y_tol:g} abs and "
              f"rel, {str(dtype)[6:]} y), state {s_err:.3e} (tol {WKV_TOL:g})")
        esize = rr.element_size()
        times[label] = _report_serving(
            results, "wkv6", label,
            f"(b,s,n_h,hs)=({b},{s},{nh},{hs}) {str(dtype)[6:]} r,k,v, float32 w,u",
            max(y_err, s_err), y_tol, lambda: rs.wkv6(rr, kk, vv, w, u),
            lambda: wkv6_ref(fold(rr), fold(kk), fold(vv), fold(w), u.repeat(b, 1)),
            None, wkv_flops(b * nh, s, hs),
            esize * 4 * r.numel() + 4 * w.numel() + 4 * u.numel() + 4 * b * nh * hs * hs,
            plain_iters=2)
    print("library_ms none for wkv6: no one PyTorch call computes the recurrence")
    path = times["path"]
    only = path["kernel_only_ms"]
    print(f"wkv6 speed criteria: path {path['ms']:.5f} ms <= {WKV_PATH_MS:g} ms: "
          f"{path['ms'] <= WKV_PATH_MS}; goal <= {WKV_GOAL_MS:g} ms: "
          f"{path['ms'] <= WKV_GOAL_MS} (bound share {path['bound_ms'] / path['ms']:.3f}, "
          f"kernel-only {'not measured' if only is None else f'{only:.5f} ms'})")


def _serving_counts() -> dict:
    return {k: fn.launches for k, fn in SERVE_KERNELS.items()}


def _reset_serving_counts() -> None:
    fa.reset_launches()
    rs.wkv6.launches = 0


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (on the CPU, float32)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"compared shapes differ: {tuple(got.shape)} and "
                             f"{tuple(want.shape)}")
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def prefill_path(params_by_arch: dict, archs=SERVE_ARCHS) -> dict:
    """Phase 6: one counted forward per arch at full width, then the timed
    and the profiled ones; returns each kernel's launches per forward,
    summed over the archs."""
    counts = {}
    for arch, kernel, per_forward in archs:
        cfg = get_config(arch)
        params = params_by_arch[arch]
        batch = prefill_batch(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_serving_counts()
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, _ = tt.forward(cfg, params, batch)
            torch.cuda.synchronize()
            first_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**20
        got = _serving_counts()
        want = {k: per_forward if k == kernel else 0 for k in SERVE_KERNELS}
        variants = dict(fa.flash_attention.launches_by_variant)
        want_variants = {"tc": want["flash_attention"], "f32": 0}
        if got != want or variants != want_variants:
            raise AssertionError(f"prefill {arch}: launched {got}, flash by kernel "
                                 f"{variants}; expected {want}, {want_variants}")
        counts[kernel] = counts.get(kernel, 0) + got[kernel]
        finite = bool(torch.isfinite(logits).all())
        if tuple(logits.shape) != (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size) \
                or not finite:
            raise AssertionError(f"prefill {arch}: logits {tuple(logits.shape)}, "
                                 f"finite {finite}")
        del logits
        walls = []
        with torch.inference_mode():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tt.forward(cfg, params, batch)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
        symbol = KERNELS[kernel][1]
        # the counter above is exact; a trace can lose a kernel's record
        # (seen once: 23 of 24), so a short trace is taken once more
        for attempt in range(2):
            with torch.inference_mode(), \
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tt.forward(cfg, params, batch)
                torch.cuda.synchronize()
            spans = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            mine = [e.time_range.elapsed_us() / 1e3 for e in spans if symbol in e.name]
            if len(mine) == per_forward:
                break
            print(f"prefill {arch}: trace {attempt + 1} shows {len(mine)} {symbol} "
                  f"launches of {per_forward}")
        other = sum(FLASH_VARIANTS["f32"][0] in e.name for e in spans)
        if other:
            raise AssertionError(f"prefill {arch}: the trace shows {other} float32 "
                                 "flash launches")
        busy = sum(e.time_range.elapsed_us() for e in spans) / 1e3
        by_name = {}
        for e in spans:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        if len(mine) != per_forward:
            raise AssertionError(f"prefill {arch}: the trace shows {len(mine)} "
                                 f"{symbol} launches, expected {per_forward}")
        wall = float(np.median(walls))
        tokens_n = PREFILL_BATCH * PREFILL_LEN
        text = batch["inputs"].shape[1]
        split = "" if text == PREFILL_LEN else \
            f" ({PREFILL_LEN - text} patches + {text} text)"
        if cfg.is_encoder_decoder:
            split = (f" (text; {batch['frontend'].shape[1]} "
                     f"{str(batch['frontend'].dtype)[6:]} stub frames into the encoder)")
        print(f"prefill {arch}: {cfg.param_count()} params bf16, {PREFILL_BATCH}x"
              f"{PREFILL_LEN} tokens{split}: first forward {first_ms:.2f} ms, wall median "
              f"{wall:.3f} ms over {len(walls)} ({[round(x, 3) for x in walls]}), "
              f"{tokens_n / wall * 1e3:.1f} prefill tokens/s, max_memory_allocated "
              f"{peak:.1f} MiB ({', '.join(params_by_arch)} weights resident), "
              f"logits finite; "
              f"{kernel} launches per forward "
              f"{got[kernel]} (trace: {len(mine)} {symbol}, {sum(mine):.3f} ms of "
              f"{busy:.3f} ms device time, {100 * sum(mine) / busy:.1f}%"
              f"{'; by kernel ' + str(variants) if kernel == 'flash_attention' else ''})"
              f"; top: " + "; ".join(
                  f"{n[:60]} {t:.3f} ms" for n, t in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))
        if cfg.is_moe:
            moe_dispatch(cfg, params, batch, busy)
        if cfg.hybrid:
            mamba_share(cfg, params, batch, busy)
    return counts


def prefill_batch(cfg) -> dict:
    """The 4 x 2048 prefill batch (``make_prompt``, seed 0) on the card; a
    frontend model gets ``min(frontend_tokens, PREFILL_LEN // 2)`` stub
    embeddings (seeded normal draws), as ``prefill_batch_specs`` budgets
    them: a VLM's patches take that many positions from its text, an
    encoder-decoder's bf16 frames go to its encoder beside all 2048 text
    tokens."""
    front = 0
    if cfg.modality in ("audio", "vlm"):
        front = min(cfg.frontend_tokens, PREFILL_LEN // 2)
    text = PREFILL_LEN if cfg.is_encoder_decoder else PREFILL_LEN - front
    batch = {"inputs": torch.as_tensor(
        make_prompt(cfg, PREFILL_BATCH, text, 0), device="cuda")}
    if front:
        batch["frontend"] = torch.randn(
            (PREFILL_BATCH, front, cfg.frontend_dim), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        if cfg.is_encoder_decoder:
            batch["frontend"] = batch["frontend"].to(cfg.dtype)
    return batch


def mamba_share(cfg, params, batch, forward_device_ms: float) -> None:
    """One profiled prefill forward with every ``mamba_apply`` call inside a
    ``record_function`` range: the device time of the kernels those calls
    launched (the profiler's per-range device total), as a share of the
    forward's device time."""
    original = ssm_lib.mamba_apply

    def traced(p, x, state=None):
        with torch.profiler.record_function("mamba_apply"):
            return original(p, x, state)

    ssm_lib.mamba_apply = traced
    try:
        with torch.inference_mode(), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tt.forward(cfg, params, batch)
            torch.cuda.synchronize()
    finally:
        ssm_lib.mamba_apply = original
    ranges = [e for e in prof.events()
              if e.name == "mamba_apply" and e.device_type == DeviceType.CPU]
    total = "device_time_total" if ranges and hasattr(ranges[0], "device_time_total") \
        else "cuda_time_total"
    mamba_ms = sum(getattr(e, total) for e in ranges) / 1e3
    # the ranges also show as device-side annotations: not kernels
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name != "mamba_apply") / 1e3
    if len(ranges) != cfg.n_layers or not mamba_ms > 0:
        raise AssertionError(f"mamba share {cfg.name}: {len(ranges)} mamba_apply ranges "
                             f"of {cfg.n_layers}, {mamba_ms:.3f} ms of device time")
    print(f"mamba share {cfg.name}: {len(ranges)} mamba_apply calls (plain PyTorch: "
          f"the chunked scan) {mamba_ms:.3f} ms of the traced forward's {busy:.3f} ms "
          f"device time ({mamba_ms / busy:.1%}; the counted forward's device time "
          f"{forward_device_ms:.3f} ms) [{card_line()}]")


def moe_dispatch(cfg, params, batch, forward_device_ms: float) -> None:
    """An MoE layer of the prefill, timed (CUDA events) on its own input
    (captured from one forward) beside its expert and shared FFNs alone on
    buffers of the same shapes: the difference is the dispatch (router,
    top-k sort, slots, scatter, gather, gate combine), printed as a share
    of the layer and of the forward's device time."""
    seen = {}
    original = moe_lib.moe_apply

    def capture(p, x, **kw):
        seen.setdefault("call", (p, x.clone(), kw))
        return original(p, x, **kw)

    moe_lib.moe_apply = capture
    try:
        with torch.inference_mode():
            tt.forward(cfg, params, batch)
    finally:
        moe_lib.moe_apply = original
    p, x, kw = seen["call"]
    b, s, d = x.shape
    e, k = p["router"].shape[-1], kw["top_k"]
    cap = moe_lib.capacity(b * s, k, e, kw["capacity_factor"])
    buf = torch.randn((e, cap, d), device=x.device).to(x.dtype)
    xf, act = x.reshape(b * s, d), _act(kw["act"])

    def ffn():
        h = act(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
        torch.bmm(h, p["wo"])
        if "shared" in p:
            mlp(p["shared"], xf, act=kw["act"])

    with torch.inference_mode():
        layer_ms = cuda_ms(lambda: original(p, x, **kw), iters=10, warmup=2)
        ffn_ms = cuda_ms(ffn, iters=10, warmup=2)
    dispatch = layer_ms - ffn_ms
    print(f"moe dispatch {cfg.name}: one MoE layer on {b}x{s} tokens (top-{k} of {e} "
          f"experts, capacity {cap}, {cfg.n_shared_experts} shared): {layer_ms:.3f} ms; "
          f"its expert and shared FFNs alone {ffn_ms:.3f} ms; the dispatch {dispatch:.3f} "
          f"ms, {dispatch / layer_ms:.1%} of the layer, "
          f"{dispatch / forward_device_ms:.1%} of the forward's device time "
          f"{forward_device_ms:.3f} ms [{card_line()}]")
    del seen, x, buf


def serve_path(params_by_arch: dict, archs=SERVE_ARCHS, check_layers=None,
               decode_check: bool = True) -> None:
    """Phase 7: the ``serve`` loop at full width (no kernel launches in
    decode), then (``decode_check``) decode against the kernel-backed
    forward over 64 teacher-forced positions (on the first ``check_layers``
    layers when given, else at full depth)."""
    for arch, _, _ in archs:
        cfg = get_config(arch)
        params = params_by_arch[arch]
        prompt = make_prompt(cfg, SERVE_BATCH, SERVE_PROMPT, 0)
        _reset_serving_counts()
        seqs, stats = serve(cfg, params, prompt, SERVE_NEW, "cuda")
        # an encoder-decoder's encoder runs once before the loop, in float32
        # (the reference's float32 ones): one float32 flash launch a layer
        encode = cfg.enc_layers if cfg.is_encoder_decoder else 0
        want = {k: encode if k == "flash_attention" else 0 for k in SERVE_KERNELS}
        if _serving_counts() != want or \
                fa.flash_attention.launches_by_variant["f32"] != encode:
            raise AssertionError(f"serve {arch}: launched {_serving_counts()} "
                                 f"({fa.flash_attention.launches_by_variant}), expected "
                                 f"{want}: the encode's float32 launches, none in decode")
        if seqs.shape != (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW) \
                or not np.array_equal(seqs[:, :SERVE_PROMPT], prompt) \
                or not ((seqs >= 0) & (seqs < cfg.vocab_size)).all():
            raise AssertionError(f"serve {arch}: bad tokens {seqs.shape}")
        print(f"serve {arch}: batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
              f"{SERVE_NEW} new tokens: {stats['decode_steps']} decode steps in "
              f"{stats['seconds'] * 1e3:.1f} ms, decode_tokens_per_s "
              f"{stats['decode_tokens_per_s']:.1f}, tokens_per_s (the reference's "
              f"figure) {stats['tokens_per_s']:.1f}; "
              f"{f'the encode before the loop: {encode} float32 flash launches, ' if encode else ''}"
              f"no kernel launch in decode; first sequence {seqs[0].tolist()}")
        if not decode_check:
            continue
        toks = torch.as_tensor(make_prompt(cfg, *DECODE_CHECK, 1), device="cuda")
        if check_layers is not None:
            cfg, params = first_layers(cfg, params, check_layers)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        template_gaps = (_rel_gap(*_decode_and_forward(cfg, params, toks)),
                         _rel_gap(*_decode_and_forward(cfg32, params32, toks)))
        live = live_weights(cfg32, params32, seed=3)
        dec32, fwd32 = _decode_and_forward(cfg32, live, toks)
        gap = _rel_gap(dec32, fwd32)
        print(f"serve {arch}: decode vs the kernel-backed forward over "
              f"{DECODE_CHECK[1]} teacher-forced positions (b={DECODE_CHECK[0]}, "
              f"{cfg.n_layers} layers), "
              f"max |diff| / max |logit|: live float32 weights {gap:.3e} (tol "
              f"{DECODE_F32_TOL:g}); not held: the template's draw "
              f"{template_gaps[0]:.3e} in bf16 and {template_gaps[1]:.3e} in float32")
        if not gap <= DECODE_F32_TOL:
            raise AssertionError(f"serve {arch}: float32 decode/forward gap {gap}")
        del dec32, fwd32
        decode_bf16_by_depth(arch, cfg, live, toks)
        del live, params32


def dense_serving_path() -> dict:
    """Phases 6-7 for the other dense configs, one arch at a time (the bf16
    weights of all three would take 39 GB): full-width weights drawn on the
    card (``init_params`` with a CUDA generator, seed 0), the counted,
    timed and profiled 4 x 2048 prefill (h2o-danube's at head dim 120), the
    serve loop, and decode against the forward on the first
    ``DENSE_CHECK_LAYERS`` layers.  Returns the flash launches: head dim 120
    under ``FLASH_D120``, the others under ``flash_attention``."""
    counts = {"flash_attention": 0, FLASH_D120: 0}
    for spec in DENSE_ARCHS:
        arch = spec[0]
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = init_params(tt.model_template(cfg),
                             torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        torch.cuda.synchronize()
        print(f"{arch}: full-width bf16 weights ({cfg.param_count():,} params, "
              f"head dim {cfg.head_dim_}) drawn on the card (seed 0): "
              f"{time.perf_counter() - t0:.1f} s")
        got = prefill_path({arch: params}, (spec,))["flash_attention"]
        counts[FLASH_D120 if cfg.head_dim_ == 120 else "flash_attention"] += got
        serve_path({arch: params}, (spec,), check_layers=DENSE_CHECK_LAYERS)
        del params
        _free()
    return counts


@contextlib.contextmanager
def registered(cfg):
    """``cfg`` in the config registry under its name while the block runs
    (a registered config stays)."""
    added = cfg.name not in ARCH_CONFIGS
    ARCH_CONFIGS.setdefault(cfg.name, cfg)
    try:
        yield cfg
    finally:
        if added:
            del ARCH_CONFIGS[cfg.name]


def family_config(arch: str, layers):
    """``arch``'s config, cut to ``layers`` (named for it) unless None."""
    cfg = get_config(arch)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, name=f"{arch}-{layers}layers")


def family_serving_path(archs=FAMILY_ARCHS) -> int:
    """Phases 6-7 for the MoE, MLA, VLM, hybrid and encoder-decoder configs
    at published width (``archs``, of ``FAMILY_ARCHS``), one at a time, bf16
    weights drawn on the card (seed 0): the counted, timed and profiled 4 x
    2048 prefill (internvl2-2b: 256 stub patches + 1792 tokens; seamless:
    1024 bf16 stub frames + 2048 tokens; exact flash launches, all on
    ``flash_tc_kernel``; an MoE layer's dispatch share, hymba's mamba
    share), its peak memory, and the serve loop (no kernel launch in
    decode; seamless's float32 encode before it).  Returns the flash
    launches."""
    launches = 0
    for arch, layers, per_forward in archs:
        with registered(family_config(arch, layers)) as cfg:
            _free()
            t0 = time.perf_counter()
            params = init_params(tt.model_template(cfg),
                                 torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
            torch.cuda.synchronize()
            gib = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 2**30
            print(f"{cfg.name}: full-width weights ({cfg.param_count():,} params, "
                  f"{cfg.n_layers} layers{f' + {cfg.enc_layers} encoder' if cfg.enc_layers else ''}, "
                  f"{gib:.2f} GiB: bf16{', float32 routers' if cfg.is_moe else ''}) drawn "
                  f"on the card (seed 0): {time.perf_counter() - t0:.1f} s")
            spec = (cfg.name, "flash_attention", per_forward)
            launches += prefill_path({cfg.name: params}, (spec,))["flash_attention"]
            serve_path({cfg.name: params}, (spec,), decode_check=False)
            del params
            _free()
    return launches


def parity_families() -> None:
    """Phase 8 for ``FAMILY_ARCHS``, reduced, in float32, on
    ``live_weights``: the card's forward against the CPU's from the same
    weights and batch (an MoE model's routes compared first: the share of
    (token, layer) routes alike is printed and must be all; logits within
    ``MODEL_TOL`` of max |logit|), then on the card decode against the
    forward over ``FAMILY_CHECK`` teacher-forced positions within
    ``DECODE_F32_TOL`` (an MoE model at a capacity factor of E / k, where
    the forward drops no pair, as decode's one token a step never does; a
    VLM's decode, text only, against its text decoder's forward; an
    encoder-decoder's decode on ``encode_for_decode``'s output of the same
    frames; hymba's over more positions than its reduced window)."""
    b, n = FAMILY_CHECK
    for arch, _, _ in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float32")
        cpu_params = live_weights(cfg, init_params(tt.model_template(cfg), seed=1),
                                  seed=4)
        toks = torch.as_tensor(make_prompt(cfg, b, n, 2))
        batch = {"inputs": toks}
        if cfg.modality in ("audio", "vlm"):
            batch["frontend"] = torch.randn((b, cfg.frontend_tokens, cfg.frontend_dim),
                                            generator=torch.Generator().manual_seed(5))
        routes = []                  # per forward: the top-k indices of each layer
        original = moe_lib.route

        def record(router, xf, top_k):
            out = original(router, xf, top_k)
            routes[-1].append(out[2].cpu())
            return out

        card_params = _to(cpu_params, CARD)
        moe_lib.route = record
        try:
            with torch.inference_mode():
                routes.append([])
                want, _ = tt.forward(cfg, cpu_params, batch)
                _reset_serving_counts()
                routes.append([])
                got, _ = tt.forward(cfg, card_params, _to(batch, CARD))
                torch.cuda.synchronize()
        finally:
            moe_lib.route = original
        launched = _serving_counts()
        alike = "no MoE layer"
        if cfg.is_moe:
            cpu_r, card_r = (torch.cat(r) for r in routes)
            same = (cpu_r.sort(-1).values == card_r.sort(-1).values).all(-1)
            alike = f"{int(same.sum())} of {same.numel()} MoE routes alike"
            if not bool(same.all()):
                raise AssertionError(f"card/CPU {arch} reduced: {alike}")
        gap = _rel_gap(got, want)
        fcfg = cfg
        if cfg.modality == "vlm":
            fcfg = dataclasses.replace(cfg, modality="text")
        elif cfg.is_moe:
            fcfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        dcfg = cfg if cfg.modality == "vlm" else fcfg
        tc = toks.to(CARD)
        with torch.inference_mode():
            fbatch = {"inputs": tc}
            enc_len = cfg.frontend_tokens if cfg.is_encoder_decoder else 0
            cache = tt.init_cache(dcfg, b, n, enc_len=enc_len, device=CARD)
            if cfg.is_encoder_decoder:
                fbatch["frontend"] = batch["frontend"].to(CARD)
                cache["enc_out"] = tt.encode_for_decode(cfg, card_params,
                                                        fbatch["frontend"])
            fwd, _ = tt.forward(fcfg, card_params, fbatch)
            dec = torch.stack([tt.decode_step(dcfg, card_params, cache, tc[:, t:t + 1],
                                              t)[0].float().cpu() for t in range(n)], 1)
        dgap = _rel_gap(dec, fwd)
        window = f", window {cfg.window}" if cfg.window else ""
        print(f"parity {arch} reduced float32 b={b} s={n}{window}"
              f"{f' (+ {cfg.frontend_tokens} stub patches)' if cfg.modality == 'vlm' else ''}"
              f"{f' (+ {cfg.frontend_tokens} stub frames)' if cfg.modality == 'audio' else ''}"
              f" card vs cpu: {alike}; max |logit diff| / max |logit| {gap:.3e} (tol "
              f"{MODEL_TOL:g}); card launches {launched}; decode vs forward on the card "
              f"over {n} positions {dgap:.3e} (tol {DECODE_F32_TOL:g})")
        if not gap <= MODEL_TOL or not dgap <= DECODE_F32_TOL:
            raise AssertionError(f"{arch} reduced: card/CPU {gap}, decode/forward {dgap}")
        del card_params, cpu_params


def parity_moe_lm() -> None:
    """Phase 13 for the MoE, hybrid and encoder-decoder configs: kimi-k2 and
    deepseek-v2 reduced in bf16 (a bf16 bucket and a float32 routers'
    bucket), hymba-1.5b and seamless-m4t-medium reduced (one bf16 bucket;
    seamless behind float32 stub frames), CDMSGD on the int8 wire, 2 agents:
    one card step, then the update phase from its state with the card's
    gradients on the card and on the CPU: the bf16 and int8 tensors bit for
    bit, the float32 ones within ``UPDATE_TOL``."""
    stream = lm_agent_batches(make_lm_tokens(1 << 14, vocab=512, seed=1), 2, 2, 32,
                              seed=1)
    batches = [next(stream) for _ in range(2)]
    for arch in ("kimi-k2-1t-a32b", "deepseek-v2-236b", *NEW_FAMILIES):
        cfg = get_config(arch).reduced()
        params = live_weights(cfg, init_params(tt.model_template(cfg), seed=5), seed=6)
        trs = [CollaborativeTrainer(lm_train.lm_loss(cfg), params,
                                    make_topology("fully_connected", 2),
                                    make_optimizer("cdmsgd", LR, mu=MU, fused=True),
                                    exchange="int8", device=d) for d in ("cpu", CARD)]
        cpu, card = trs
        out = card.step(batches[0])
        st = card.state
        gp = card.optimizer.grad_params(st.params, st.opt_state)
        (_, metrics), grads = card._program.grad_phase(
            gp, {k: torch.as_tensor(v, device=CARD) for k, v in batches[1].items()})
        # the CPU's operands first: the kernels write their gradient and
        # momentum operands in place, and a bucket of one leaf (the stacked
        # routers) is a view of it
        operands = (_to(st.params, "cpu"), _to(grads, "cpu"), _to(st.opt_state, "cpu"))
        with torch.no_grad():
            got = card._program.update_phase(st.params, grads, st.opt_state)
            want = cpu._program.update_phase(*operands)
        leaves = [(x.cpu(), y) for x, y in zip(tree_leaves(got), tree_leaves(want))
                  if isinstance(x, torch.Tensor)]
        # float32 (the routers' bucket, the wire's row scales) within
        # UPDATE_TOL, as phase 5 holds float32 update phases; the rest bit for bit
        f32 = [(x, y) for x, y in leaves if x.dtype == torch.float32]
        other = [(x, y) for x, y in leaves if x.dtype != torch.float32]
        f32_gap = max((float((x - y).abs().max()) for x, y in f32), default=0.0)
        f32_same = sum(_equal_bits(x, y) for x, y in f32)
        other_same = [_equal_bits(x, y) for x, y in other]
        dtypes = sorted({str(x.dtype)[6:] for x, _ in other})
        print(f"parity {arch} reduced bf16 cdmsgd int8 update phase card vs cpu, same "
              f"state and gradients: {sum(other_same)} of {len(other)} "
              f"{'/'.join(dtypes)} tensors bit for bit; float32 {f32_same} of {len(f32)} "
              f"bit for bit, max |diff| {f32_gap:.3e} (tol {UPDATE_TOL:g}); step 1 "
              f"loss {out['loss']:.4f}, moe_aux {out['moe_aux']:.4f}; grad phase "
              f"moe_aux {[round(float(v), 4) for v in metrics['moe_aux']]}")
        if not all(other_same) or not f32_gap <= UPDATE_TOL:
            raise AssertionError(f"{arch} reduced int8 update phase: card and CPU differ")


def first_layers(cfg, params, depth: int):
    """``(cfg with depth layers, views of params' first layers)``: each
    stacked group cut to the counts of that depth's template."""
    cut = dataclasses.replace(cfg, n_layers=depth)
    groups = {name: tree_map(lambda t: t[:count], params["groups"][name])
              for name, count, _ in tt.layer_groups(cut) if count > 0}
    sub = {**params, "groups": groups}
    want = [pd.shape for pd in tree_leaves(tt.model_template(cut))]
    if [tuple(t.shape) for t in tree_leaves(sub)] != want:
        raise AssertionError(f"first {depth} layers: shapes differ from the template")
    return cut, sub


def decode_bf16_by_depth(arch: str, cfg, live, toks) -> None:
    """The bf16 decode against the bf16 forward at growing depth, each
    beside the float32 forward of the same (live float32) weights: held
    where decode rounds worse than the forward (its distance from the
    float32 forward over DECODE_BF16_RATIO times the bf16 forward's), and
    at the reference's 2 layers within DECODE_TOL."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    for depth in DECODE_DEPTHS[arch]:
        cut32, sub32 = first_layers(cfg32, live, depth)
        cut16 = dataclasses.replace(cut32, param_dtype=cfg.param_dtype)
        sub16 = tree_map(lambda t: t.to(cfg.dtype), sub32)
        _, fwd32 = _decode_and_forward(cut32, sub32, toks, decode=False)
        dec16, fwd16 = _decode_and_forward(cut16, sub16, toks)
        gap, e_fwd, e_dec = (_rel_gap(dec16, fwd16), _rel_gap(fwd16, fwd32),
                             _rel_gap(dec16, fwd32))
        print(f"serve {arch}: bf16 at {depth} layers, max |diff| / max |logit|: "
              f"decode vs forward {gap:.3e}"
              f"{f' (tol {DECODE_TOL:g})' if depth == 2 else ''}; against the "
              f"float32 forward: bf16 forward {e_fwd:.3e}, bf16 decode {e_dec:.3e} "
              f"(ratio {e_dec / max(e_fwd, 1e-30):.3f}, at most {DECODE_BF16_RATIO:g})")
        if not e_dec <= DECODE_BF16_RATIO * e_fwd or (depth == 2 and not gap <= DECODE_TOL):
            raise AssertionError(f"serve {arch}: bf16 decode at {depth} layers: gap "
                                 f"{gap}, {e_dec} against {e_fwd} for the forward")
        del sub16, fwd32, dec16, fwd16


def card_draw(template, seed: int, device):
    """``init_params`` drawn on the card from a CUDA generator seeded with
    ``seed``: the same bits in every process on the card (a host draw of a
    billion parameters takes tens of seconds)."""
    return init_params(template, torch.Generator(device=device).manual_seed(seed),
                       device=device)


def live_weights(cfg, params, seed: int):
    """Make a template draw well conditioned and fully live, in place, for
    the parity checks: the attention projections rescaled to variance 1 /
    (contraction size) and the zero-initialised RWKV6 leaves drawn (token-
    shift ``mu_*`` uniform in [0, 1), ``w0`` ~ N(-0.5, 0.3), the bonus ``u``
    ~ N(0, 0.3)).  The template's ``scaled`` init reads the head axis of a
    ``(d, heads, hd)`` projection as its fan-in (gemma3-1b: std 0.5 over d
    1152, so q and k entries have std ~17 and scores std ~290): attention
    is then an argmax that float32 summation order can flip, and the model
    is chaotic.  MLA's ``(rank, heads, k)`` up-projections are rescaled to
    variance 1 / rank the same way, and a decoder's cross-attention
    (``xattn``) as its self-attention.  Phases 7 and 8 print the template
    draw's gaps beside the held ones."""
    gen = torch.Generator().manual_seed(seed)

    def draw(leaf, fn):
        leaf.copy_(fn(torch.empty(leaf.shape).normal_(generator=gen)))

    for group in params["groups"].values():
        for a in [group[n] for n in ("attn", "xattn") if n in group]:
            for n in ("wq", "wk", "wv"):
                if n in a:
                    a[n].mul_(math.sqrt(a[n].shape[-2] / cfg.d_model))
            # MLA's up-projections (rank, heads, k) contract over the rank
            for n in ("wuq", "wuk", "wuv"):
                if n in a:
                    a[n].mul_(math.sqrt(a[n].shape[-2] / a[n].shape[-3]))
            a["wo"].mul_(1 / math.sqrt(cfg.n_heads))
        if "time_mix" in group:
            tm, cm = group["time_mix"], group["channel_mix"]
            for leaf in [v for k, v in {**tm, **cm}.items() if k.startswith("mu_")]:
                leaf.copy_(torch.rand(leaf.shape, generator=gen))
            draw(tm["w0"], lambda z: -0.5 + 0.3 * z)
            draw(tm["u"], lambda z: 0.3 * z)
    return params


def _decode_and_forward(cfg, params, toks, decode: bool = True):
    """``(decode logits or None, forward logits)`` over teacher-forced
    ``toks``, on the CPU in float32."""
    b, n = toks.shape
    with torch.inference_mode():
        fwd, _ = tt.forward(cfg, params, {"inputs": toks})
        fwd = fwd.float().cpu()
        if not decode:
            return None, fwd
        cache = tt.init_cache(cfg, b, n, device=toks.device)
        steps = []
        for t in range(n):
            logits, cache = tt.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
            steps.append(logits.float().cpu())
        return torch.stack(steps, dim=1), fwd


def parity_models() -> None:
    """Phase 8: full width, float32 weights, reduced depth: the card's
    forward (the kernels) against the port's on the CPU (the plain
    versions) from the same weights (:func:`live_weights`) and tokens."""
    for arch, layers, b, s in MODEL_PARITY:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  param_dtype="float32")
        toks = torch.as_tensor(make_prompt(cfg, b, s, 2))
        cpu_params = init_params(tt.model_template(cfg), seed=1)
        template_gap = _card_vs_cpu(cfg, cpu_params, toks)[0]
        gap, launched, cpu_s = _card_vs_cpu(cfg, live_weights(cfg, cpu_params, seed=4),
                                            toks)
        print(f"parity {arch} {layers} layers float32 b={b} s={s} card vs cpu: max "
              f"|logit diff| / max |logit| {gap:.3e} on live_weights (tol "
              f"{MODEL_TOL:g}; the template's draw, not held: {template_gap:.3e}); "
              f"card launches {launched}; CPU forward {cpu_s:.1f} s")
        if not gap <= MODEL_TOL:
            raise AssertionError(f"card/CPU forward {arch}: {gap} > {MODEL_TOL}")
        del cpu_params


def _card_vs_cpu(cfg, cpu_params, toks):
    """(gap, the card forward's kernel launches, CPU seconds) of one forward
    on the CPU and on the card from the same weights."""
    card_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want, _ = tt.forward(cfg, cpu_params, {"inputs": toks})
        cpu_s = time.perf_counter() - t0
        _reset_serving_counts()
        got, _ = tt.forward(cfg, card_params, {"inputs": toks.to("cuda")})
        torch.cuda.synchronize()
    return _rel_gap(got, want), _serving_counts(), cpu_s


# ---------------------------------------------------------------------------
# the model zoo's training path: bf16 parameter buckets (phases 3c, 10-13)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lm_bucket_rows(arch: str = "gemma3-1b") -> int:
    """Rows of the architecture's one bf16 parameter bucket (per agent)."""
    spec = make_flat_spec(tt.model_template(get_config(arch)))
    if [b.dtype for b in spec.buckets] != [torch.bfloat16]:
        raise AssertionError(f"{arch}: expected one bf16 bucket, got "
                             f"{[b.dtype for b in spec.buckets]}")
    return spec.buckets[0].rows


def _bf16_rows(gen, a: int, rows: int) -> torch.Tensor:
    """``_bucket`` rounded to bf16: rows over six decades, row 0 zero."""
    return _bucket(gen, a, rows).to(torch.bfloat16)


def _equal_bits(got, want) -> bool:
    """Two tensors on one device with equal dtype, shape and bytes."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(torch.uint8), want.view(torch.uint8)))


def _compact(gen, s: int, rows: int, k_rows: int, r0: int = 0) -> tuple:
    """Top-k compact stacks of ``s`` neighbours, made on the card: int8
    values, float32 row scales, and ``k_rows * 128`` sorted unique int32
    flat positions per neighbour, one in each equal stride of rows ``r0 ..
    r0 + rows`` of the bucket."""
    dev = torch.device(CARD)
    kk = k_rows * 128
    stride = rows * 128 // kk
    base = r0 * 128 + stride * torch.arange(kk, device=dev)
    idx = (base + torch.randint(0, stride, (s, kk), generator=gen, device=dev))
    vals = torch.randint(-127, 128, (s, k_rows, 128), generator=gen, device=dev,
                         dtype=torch.int8)
    scales = 1e-5 + 0.03 * torch.rand((s, k_rows, 1), generator=gen, device=dev)
    return vals, idx.to(torch.int32).view(s, k_rows, 128), scales


def _clustered_compact(gen, s: int, rows: int, k_rows: int) -> tuple:
    """Compact stacks like ``_compact``'s whose positions each neighbour
    keeps in three runs, one at a random place in each third of the bucket:
    most 1,024-element tiles hold no entry, and a run fills whole tiles."""
    dev = torch.device(CARD)
    n, kk = rows * 128, k_rows * 128
    cuts = [n * i // 3 for i in range(4)]
    lens = [kk * (i + 1) // 3 - kk * i // 3 for i in range(3)]
    idx = []
    for _ in range(s):
        starts = [c + int(torch.randint(0, cuts[i + 1] - c - lens[i] + 1, (1,),
                                        generator=gen, device=dev))
                  for i, c in enumerate(cuts[:3])]
        idx.append(torch.cat([torch.arange(a, a + ln, device=dev)
                              for a, ln in zip(starts, lens)]))
    vals = torch.randint(-127, 128, (s, k_rows, 128), generator=gen, device=dev,
                         dtype=torch.int8)
    scales = 1e-5 + 0.03 * torch.rand((s, k_rows, 1), generator=gen, device=dev)
    return vals, torch.stack(idx).to(torch.int32).view(s, k_rows, 128), scales


def _bf16_operands(gen, a_out: int, s: int, rows: int, x=None) -> dict:
    """The operands of every bf16-bucket form at ``a_out`` outputs over
    ``s`` neighbours: the neighbours ``x`` (bf16, the ``s`` senders), the
    self, grad, momentum and Adam's second moment ``v2`` (bf16 buckets,
    rows over six decades, row 0 zero), and the top-k compact stacks at
    ``topk:0.01``, spread (``comp``) and clustered (``compc``); the weights
    are added by the caller."""
    o = {"x": _bf16_rows(gen, s, rows) if x is None else x}
    for k in ("slf", "g", "v"):
        o[k] = _bf16_rows(gen, a_out, rows)
    o["v2"] = (o["v"].abs() * 0.01).contiguous()
    k_rows = tk.topk_k_rows(rows, TOPK_P)
    o["comp"] = _compact(gen, s, rows, k_rows)
    o["compc"] = _clustered_compact(gen, s, rows, k_rows)
    return o


def _bf16_args(wrapper: str, o: dict) -> tuple:
    """``(mix operands, names of the state operands, scalars)`` of one
    update form: the dense form over ``o["w"]`` and ``x``, the _q form over
    ``o["wq"]``, ``slf`` and the payload ``q``, ``sc``, the _qm form with the
    momentum's payload ``mq``, ``msc`` too, the sparse form over the compact
    stacks; CDAdam's first moment is ``v`` and its second ``v2``."""
    fam = kernel_family(wrapper)
    if wrapper.endswith("_sparse"):
        mix = [o["wq"], o["slf"], *o["comp"]]
    elif wrapper.endswith("_qm"):
        mix = [o["wq"], o["slf"], o["q"], o["sc"], o["mq"], o["msc"]]
    elif wrapper.endswith("_q"):
        mix = [o["wq"], o["slf"], o["q"], o["sc"]]
    else:
        mix = [o["w"], o["x"]]
    state = {"cdsgd": ("g",), "cdmsgd": ("g", "v"), "nesterov": ("g", "v"),
             "adam": ("g", "v", "v2")}[fam]
    scalars = {"cdsgd": (LR,), "cdmsgd": (LR, MU), "nesterov": (LR, MU),
               "adam": ADAM}[fam]
    return mix, state, scalars


def _bf16_form_calls(name: str, o: dict, seed: int, exchange: str = "int8"):
    """``(kernel call, plain version call)`` of one bf16-bucket form on the
    operands ``o`` (the kernel writes into its state tensors in place;
    ``sr_quantize`` codes ``o["x"]`` to ``exchange``); each returns a tuple."""
    wrapper = BF16_FORMS[name][0]
    if wrapper == "sr_quantize":
        return (lambda: cu.sr_quantize(o["x"], seed, exchange, agent_stride=104729),
                lambda: ref.sr_quantize_ref(o["x"], seed, exchange, 104729))
    mix, state, scalars = _bf16_args(wrapper, o)

    def call(fn):
        out = fn(*mix, *[o[k] for k in state], *scalars)
        return out if isinstance(out, tuple) else (out,)

    return (lambda: call(cu.KERNELS[wrapper]),
            lambda: call(getattr(ref, f"{wrapper}_ref")))


def _bf16_bitwise(name: str, label: str, rows: int, o: dict) -> None:
    """One bf16-bucket form's kernel against its plain version, bit for bit,
    the update kernels writing their outputs in place."""
    exchange = "fp8" if label.endswith("fp8") else "int8"
    o = {**o, **{k: o[k].clone() for k in ("g", "v", "v2")}}
    kernel, plain = _bf16_form_calls(name, o, rows, exchange)
    want = [t.clone() for t in plain()]
    got = kernel()
    torch.cuda.synchronize()
    if len(got) != len(want) or not all(_equal_bits(gt, wt)
                                        for gt, wt in zip(got, want)):
        raise AssertionError(f"{name} [{label} rows={rows}] differs "
                             "from its plain version")
    if name != "sr_quantize:bf16" and got[0].data_ptr() != o["g"].data_ptr():
        raise AssertionError(f"{name} did not write its output in place")


def _bf16_variants(name: str, o: dict, stencil: bool) -> list:
    """``(label, operands)`` of one form's bit-for-bit checks: f32 and bf16
    neighbours (dense: ``o["xd"]`` where the senders differ from the
    payload stack), int8 / fp8 / bf16 payloads of ``o["x"]`` (_q, _qm), the
    compact stacks, spread and clustered (sparse), int8 / fp8 codes (``sr_quantize``, of the self
    bucket in the stencil form)."""
    wrapper = BF16_FORMS[name][0]
    pre = "one agent, " if stencil else ""
    if wrapper == "sr_quantize":
        x = o["slf"] if stencil else o["x"]
        return [(f"{pre}{k}", {**o, "x": x}) for k in ("int8", "fp8")]
    if wrapper.endswith("_sparse"):
        return [(f"{pre}int8 compact", o),
                (f"{pre}int8 compact clustered", {**o, "comp": o["compc"]})]
    if wrapper.endswith(("_q", "_qm")):
        out = []
        for k in ("int8", "fp8", "bf16"):
            # the momentum's payload (the _qm forms): the negated stack's
            payload = {}
            for key, x in (("", o["x"]), ("m", -o["x"])):
                if k == "bf16":
                    q, sc = x, torch.ones(x.shape[:-1] + (1,), device=CARD)
                else:
                    q, sc = cu.sr_quantize(x, 5, k, agent_stride=104729)
                payload.update({f"{key}q": q, f"{key}sc": sc})
            out.append((f"{pre}{k}", {**o, **payload}))
        return out
    x = o.get("xd", o["x"])
    return [(f"{pre}bf16", {**o, "x": x}), (f"{pre}f32 neighbours", {**o, "x": x.float()})]


def _bf16_bucket_slices(gen, full: int, part: int):
    """The whole bucket's compact stacks made of one stack per row slice of
    ``part`` rows (each slice's own share of ``topk:0.01``), and each
    slice's stacks with its positions made slice-local, so the plain
    version can run slice by slice."""
    cuts = [(i * part, min(full, (i + 1) * part)) for i in range(LM_SLICES)]
    per = [_compact(gen, LM_AGENTS, r1 - r0, tk.topk_k_rows(r1 - r0, TOPK_P), r0)
           for r0, r1 in cuts]
    whole = tuple(torch.cat(parts, dim=1) for parts in zip(*per))
    local = [(v, i - r0 * 128, sc) for (v, i, sc), (r0, _) in zip(per, cuts)]
    return cuts, whole, local


def check_bf16_buckets(results: dict, gen) -> None:
    """Phase 3c: every update form (dense, _q, _qm and sparse, of CDSGD,
    CDMSGD, Nesterov and CDAdam) and ``sr_quantize`` on bf16 parameter
    buckets (gemma3-1b's one bucket, A = S = 4 on a ring).  Each against
    its plain version bit for bit on 1/16 of the bucket's rows (the plain
    versions' float32 temporaries at the whole bucket would take 16 GB
    each) and at 1,001 rows, with f32 and bf16 neighbours, int8, fp8 and
    bf16 payloads, int8 compact stacks, int8 and fp8 codes, and at phase
    14's one-agent stencil shapes; then CUDA-event and kernel-only
    (``torch.profiler``) times at the whole bucket beside the byte bound,
    and the plain version's time over the whole bucket in 16 row slices."""
    dev = torch.device(CARD)
    a, full = LM_AGENTS, lm_bucket_rows()
    pi = make_topology("ring", a).pi
    w = torch.tensor(pi, dtype=torch.float32, device=dev)
    wq = torch.tensor(_self_separated_weights(pi), dtype=torch.float32, device=dev)
    part = -(-full // LM_SLICES)
    # phase 14's one-agent stencil forms (the sharded mode, agent 1 of a ring
    # of SHARDED_AGENTS): one output agent; the dense forms over its row's
    # three senders in sender order, (1, 3); the _q, _qm and sparse forms
    # over the self bucket and the two received payloads, (1, 1 + 2)
    row = make_topology("ring", SHARDED_AGENTS).pi[1]
    w1 = torch.tensor(row[None], dtype=torch.float32, device=dev)
    wq1 = torch.tensor([[row[1], row[0], row[2]]], dtype=torch.float32, device=dev)
    for rows in (part, 1001):
        for stencil in (False, True):
            if stencil:
                x3 = _bf16_rows(gen, SHARDED_AGENTS, rows)
                o = {**_bf16_operands(gen, 1, SHARDED_AGENTS - 1, rows, x3[:2]),
                     "w": w1, "wq": wq1, "xd": x3}
            else:
                o = {**_bf16_operands(gen, a, a, rows), "w": w, "wq": wq}
            for name in BF16_FORMS:
                for label, ov in _bf16_variants(name, o, stencil):
                    _bf16_bitwise(name, label, rows, ov)
            del o
    print(f"kernel bf16 buckets: every form bit for bit against its plain version "
          f"at A = S = {a} and at phase 14's one-agent stencil forms (dense (1, "
          f"{SHARDED_AGENTS}), _q / _qm / sparse (1, 1 + {SHARDED_AGENTS - 1}), "
          f"sr_quantize A = 1), rows {part} (1/{LM_SLICES} of gemma3-1b's {full}) "
          "and 1001 (f32 / bf16 neighbours; int8 / fp8 / bf16 payloads; int8 "
          f"compact stacks at {TOPK}, spread and clustered; int8 / fp8 codes)")
    _free()
    # the whole bucket: 4 x 7,811,037 x 128 bf16 per operand (8.0 GB); the
    # forms that read the neighbour stack x first, then (x freed) the
    # momentum's own int8 payload for the _qm forms
    o = {"w": w, "wq": wq}
    for k in ("x", "slf", "g", "v"):
        o[k] = torch.randn((a, full, 128), generator=gen, device=dev, dtype=torch.bfloat16)
    o["v2"] = (o["v"].abs() * 0.01).contiguous()
    o["q"], o["sc"] = cu.sr_quantize(o["x"], 11, "int8", agent_stride=104729)
    cuts, o["comp"], local = _bf16_bucket_slices(gen, full, part)
    k_rows = o["comp"][0].shape[1]
    reads_x = [n for n, (wr, _, _) in BF16_FORMS.items()
               if wr == "sr_quantize" or not wr.endswith(("_q", "_qm", "_sparse"))]
    for name in reads_x + [n for n in BF16_FORMS if n not in reads_x]:
        wrapper, symbol, _ = BF16_FORMS[name]
        if "x" in o and name not in reads_x:
            del o["x"]
            _free()
            o["mq"], o["msc"] = cu.sr_quantize(o["slf"], 12, "int8",
                                               agent_stride=104729)
        kernel, _ = _bf16_form_calls(name, o, 11)
        sparse = wrapper.endswith("_sparse")

        def plain(name=name, sparse=sparse):
            for (r0, r1), comp in zip(cuts, local):
                sl = {k: (t[:, r0:r1] if isinstance(t, torch.Tensor) and t.dim() == 3
                          else t) for k, t in o.items()}
                if sparse:
                    sl["comp"] = comp
                _bf16_form_calls(name, sl, 11)[1]()

        ms = cuda_ms(kernel, iters=10, warmup=2)
        # sr_quantize's plain version draws its Philox stream in int64
        # tensors: seconds over the whole bucket, so one timed call
        plain_ms = (cuda_ms(plain, iters=1, warmup=0) if wrapper == "sr_quantize"
                    else cuda_ms(plain, iters=2, warmup=1))
        dev_ms = device_ms(kernel, symbol, iters=5)
        kind = (torch.bfloat16 if not wrapper.endswith(("_q", "_qm", "_sparse"))
                and wrapper != "sr_quantize" else torch.int8)
        b_ms, b_by = bound(wrapper, a, 0 if wrapper == "sr_quantize" else a, full,
                           kind, k_rows if sparse else 0, bucket=torch.bfloat16)
        results[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                         "kernel_only_ms": dev_ms}
        operand = ("int8 compact stacks, k_rows=" + str(k_rows) if sparse else
                   "int8 payload" if kind == torch.int8 and wrapper != "sr_quantize"
                   else "int8 codes" if wrapper == "sr_quantize" else "bf16 neighbours")
        print(f"kernel {name} [bucket] A={a} rows={full} bf16 bucket ({operand}): "
              f"bit for bit (above) ms={ms:.5f} plain_ms={plain_ms:.5f} (the whole "
              f"bucket in {LM_SLICES} row slices) library_ms=none bound_ms={b_ms:.5f} "
              f"({b_by}) bound_share={b_ms / ms:.3f} kernel_only_ms="
              f"{'not measured' if dev_ms is None else f'{dev_ms:.5f}'}")
    del o
    _free()


SPARSE_FORMS = ("cdsgd_update_sparse", "cdmsgd_update_sparse",
                "cdmsgd_nesterov_update_sparse", "cdadam_update_sparse")


def check_sparse_one_agent(gen) -> None:
    """Phase 3c: the four sparse forms at one output agent, the sharded
    mode's top-k path: ``weights (1, 1 + U)`` over ``U`` received compact
    stacks in sender order (U = 2: agent 1 of a ring of 3; U = 3: an agent
    of ``pod 2 x data 2``, every product weight 1/4), on f32 and bf16
    buckets at the 2-layer gemma3-1b bucket's rows (phase 14's) and at
    1,001 rows; each against its plain version bit for bit, then timed at
    the 2-layer rows (CUDA events, kernel-only, the plain version) beside
    its byte bound.  Nothing here counts toward the kernels line."""
    dev = torch.device(CARD)
    cfg2 = dataclasses.replace(get_config("gemma3-1b"), n_layers=SHARDED_SMALL_LAYERS)
    rows2 = make_flat_spec(tt.model_template(cfg2)).buckets[0].rows
    ring = make_topology("ring", SHARDED_AGENTS).pi[1]
    stencils = {2: [ring[1], ring[0], ring[2]],
                3: list(make_topology("fully_connected", 4).pi[0])}
    card = card_line()
    for bucket in (torch.float32, torch.bfloat16):
        for u, row in stencils.items():
            wq = torch.tensor([row], dtype=torch.float32, device=dev)
            for rows in (rows2, 1001):
                k_rows = tk.topk_k_rows(rows, TOPK_P)
                o = {k: _bucket(gen, 1, rows).to(bucket) for k in ("slf", "g", "v")}
                o["v2"] = (o["v"].abs() * 0.01).contiguous()
                o["wq"], o["comp"] = wq, _compact(gen, u, rows, k_rows)
                for wrapper in SPARSE_FORMS:
                    mix, state, scalars = _bf16_args(wrapper, o)
                    want = getattr(ref, f"{wrapper}_ref")(*mix, *[o[k] for k in state],
                                                          *scalars)
                    want = want if isinstance(want, tuple) else (want,)
                    outs = [o[k].clone() for k in state]
                    got = cu.KERNELS[wrapper](*mix, *outs, *scalars)
                    got = got if isinstance(got, tuple) else (got,)
                    torch.cuda.synchronize()
                    if len(got) != len(want) or not all(
                            _equal_bits(g, w.to(g.dtype)) for g, w in zip(got, want)):
                        raise AssertionError(
                            f"{wrapper} [one agent, U={u}, {bucket}, rows={rows}] "
                            "differs from its plain version")
                    if got[0].data_ptr() != outs[0].data_ptr():
                        raise AssertionError(f"{wrapper} did not write in place")
                    if rows != rows2:
                        continue

                    def kernel(wrapper=wrapper, mix=mix, outs=outs, scalars=scalars):
                        cu.KERNELS[wrapper](*mix, *outs, *scalars)

                    def plain(wrapper=wrapper, mix=mix, state=state, scalars=scalars):
                        getattr(ref, f"{wrapper}_ref")(*mix, *[o[k] for k in state],
                                                       *scalars)

                    ms = cuda_ms(kernel, iters=20, warmup=3)
                    plain_ms = cuda_ms(plain, iters=3, warmup=1)
                    dev_ms = device_ms(kernel, KERNELS[wrapper][1], iters=10)
                    b_ms, b_by = bound(wrapper, 1, u, rows, torch.int8, k_rows,
                                       bucket=bucket)
                    print(f"kernel {wrapper} [one agent] A_out=1 U={u} rows={rows} "
                          f"{str(bucket).replace('torch.', '')} bucket (int8 compact "
                          f"stacks, k_rows={k_rows}): bit for bit ms={ms:.5f} "
                          f"plain_ms={plain_ms:.5f} library_ms=none bound_ms={b_ms:.5f} "
                          f"({b_by}) bound_share={b_ms / ms:.3f} kernel_only_ms="
                          f"{'not measured' if dev_ms is None else f'{dev_ms:.5f}'} "
                          f"[{card}]")
                del o
    print(f"kernel sparse forms at one output agent: bit for bit against their plain "
          f"versions, weights (1, 1 + U) for U = {', '.join(map(str, stencils))}, f32 "
          f"and bf16 buckets, rows {rows2} ({SHARDED_SMALL_LAYERS}-layer gemma3-1b) "
          "and 1001")
    _free()


@contextlib.contextmanager
def timed_steps(record: list, on_step1=None):
    """Wrap ``CollaborativeTrainer.step`` while a training entry point runs:
    each step synchronized and timed, with its loss, MoE aux term and the
    launch counts after it, appended to ``record``; ``on_step1(trainer)``
    after the first step, outside its time."""
    original = CollaborativeTrainer.step

    def step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, batch)
        torch.cuda.synchronize()
        record.append({"ms": 1e3 * (time.perf_counter() - t0), "loss": out["loss"],
                       "moe_aux": out.get("moe_aux", 0.0), "counts": cu.launch_counts()})
        if on_step1 is not None and len(record) == 1:
            on_step1(self)
        return out

    CollaborativeTrainer.step = step
    try:
        yield
    finally:
        CollaborativeTrainer.step = original


_LIVE_DRAWS = {}      # (config name, layers, seed) -> live_init's host draw


@contextlib.contextmanager
def live_init(cfg):
    """The training entry point draws its weights (``init_params``, seed as
    given) and makes them well conditioned with :func:`live_weights` before
    they go to the card.  The template's ``scaled`` init reads the head
    axis of the attention projections as their fan-in, and gemma3-1b's
    gradient grows with depth from it (a float32 loss at seq 128: norm
    1.5e3 at 2 layers, 5.2e5 at 7, on a CPU): at full depth one step at lr
    0.01 left the agents 4.6e11 apart and the loss NaN two steps later.
    The draw runs on the card (a CUDA generator: a billion parameters take
    about ten seconds to draw on the host) and is kept on the host for the
    next run of the same config and seed."""
    original = lm_train.init_params

    def init(template, seed, device=None):
        key = (cfg.name, cfg.n_layers, seed)
        if key not in _LIVE_DRAWS:
            drawn = original(template, torch.Generator(device=CARD).manual_seed(seed),
                             device=CARD)
            _LIVE_DRAWS[key] = tree_map(lambda t: t.cpu(),
                                        live_weights(cfg, drawn, seed + 1))
            del drawn
        return tree_map(lambda t: t.to(device, copy=True), _LIVE_DRAWS[key])

    lm_train.init_params = init
    try:
        yield
    finally:
        lm_train.init_params = original


def profile_lm_step(tr, batch, what: str, symbols) -> None:
    """One more training step under ``torch.profiler`` (after the counts):
    its device time and the share of the update kernels (``symbols``)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    update = sum(t for n, t in by_name.items() if any(sym in n for sym in symbols))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile {what}: one step, wall {wall_ms:.1f} ms, device {busy:.1f} ms "
          f"({busy / wall_ms:.1%} busy); update kernels {update:.3f} ms "
          f"({update / max(busy, 1e-9):.2%} of device time); top: "
          + "; ".join(f"{n[:40]} {t:.1f} ms" for n, t in top))


def _want_counts(init: dict, per_step: dict, steps: int) -> dict:
    return {k: init.get(k, 0) + steps * per_step.get(k, 0) for k in cu.KERNELS}


@contextlib.contextmanager
def gemma_2layers():
    """gemma3-1b at full width with 2 layers, registered as ``GEMMA_2L``
    while the block runs."""
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=2, name=GEMMA_2L)
    ARCH_CONFIGS[cfg.name] = cfg
    try:
        yield cfg
    finally:
        del ARCH_CONFIGS[cfg.name]


def lm_train_path() -> dict:
    """Phases 10, 10b and 11: gemma3-1b (full width and depth; f32 wire
    CDMSGD, int8 overlap CDSGD, CDMSGD with 2 microbatches, f32 wire
    Nesterov, int8 overlap CDAdam, int8 mixed-momentum CDMSGD), gemma3-1b
    at 2 layers (the four top-k sparse forms, Nesterov's _q and _qm, CDAdam's
    dense and _qm forms) and rwkv6-1.6b (CDSGD) trained through
    ``repro_torch.launch.train.main`` on the card, each run with every
    launch count set to 0 before it and read after it: exact launches a
    step, on the bf16 bucket (a top-k wire's sr_quantize on its float32
    compact values), no flash / WKV6 launch, finite losses, wire bytes
    against the accounting.  Returns the runs' launches by kernel and bucket
    type."""
    total = {k: {"float32": 0, "bfloat16": 0} for k in cu.KERNELS}
    with gemma_2layers():
        for run in (*LM_RUNS, *LM_SMALL_RUNS):
            for k, by in lm_run(*run).items():
                for bucket, n in by.items():
                    total[k][bucket] += n
    return total


@contextlib.contextmanager
def remat_loss(remat: bool):
    """``launch.train``'s loss with ``remat`` while the block runs (its CLI,
    as the reference's, has no flag)."""
    original = lm_train.loss_fn
    if remat:
        lm_train.loss_fn = functools.partial(tt.loss_fn, remat=True)
    try:
        yield
    finally:
        lm_train.loss_fn = original


def grad_phase_peak(tr, batch, label: str) -> None:
    """One grad phase of ``tr`` on ``batch`` alone: its wall and the
    allocator's peak above what the train state holds before it."""
    st = tr.state
    gp = tr.optimizer.grad_params(st.params, st.opt_state)
    dev_batch = {k: torch.as_tensor(v, device=CARD) for k, v in batch.items()}
    _free()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = tr._program.grad_phase(gp, dev_batch)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    grads = sum(t.numel() * t.element_size() for t in tree_leaves(out[1]))
    del out, gp
    _free()
    print(f"grad phase {label}: {wall:.1f} ms, allocator peak {peak / 2**30:.2f} GiB "
          f"above the {base / 2**30:.2f} GiB train state ({grads / 2**30:.2f} GiB of it "
          f"the gradients they return) [{card_line()}]")


def _first_step(store: dict, key: str, remat: bool, tr) -> None:
    """After a run's first step: agent 0's params and optimizer state (the
    update phase's output) kept on the host without remat, held bit for bit
    with remat."""
    leaves = [t[0] for t in tree_leaves((tr.state.params, tr.state.opt_state))
              if isinstance(t, torch.Tensor) and t.dim()]
    if not remat:
        store[key] = [t.detach().cpu() for t in leaves]
        return
    want = store.pop(key)
    if len(want) != len(leaves) or not all(
            _equal_bits(x.detach().cpu(), y) for x, y in zip(leaves, want)):
        raise AssertionError(f"train {key}: the first step's update phase with remat "
                             "differs from the run without")
    print(f"train {key}: the first step's update phase with remat equals the run "
          f"without bit for bit (agent 0's {len(leaves)} tensors: params and "
          "optimizer state)")


def family_train_path(runs=FAMILY_LM_RUNS) -> dict:
    """Phase 10c: ``runs`` (of ``FAMILY_LM_RUNS``) through
    ``repro_torch.launch.train.main``, each checked as
    ``lm_run`` checks (exact launches on each bucket, finite losses, an MoE
    model's aux term finite and above 0, wire bytes against the accounting);
    internvl2-2b's runs with remat against those without (the first step's
    update phase of agent 0 bit for bit; steady step, tokens/s and peak
    memory of both, and for the CDMSGD pair one grad phase's own peak); the
    update and quantize kernels of the runs at full width timed at their
    bf16 buckets.  Returns the launches by kernel and bucket type."""
    total = {k: {"float32": 0, "bfloat16": 0} for k in cu.KERNELS}
    first = {}
    timed = []
    for *run, remat in runs:
        label, arch = run[0], run[1]
        if arch in NEW_FAMILIES:
            reckon_train_peak(arch, agents=run[2], batch=run[4], seq=run[5], remat=remat)
            timed.append((arch, run[2], tuple(run[9])))
        elif arch == VLM_ARCH and not any(t[0] == VLM_ARCH for t in timed):
            # the forms of its CDMSGD f32 and CDSGD int8 overlap runs
            timed.append((VLM_ARCH, 2, ("cdmsgd_update", "cdsgd_update_q", "sr_quantize")))
        hook = None
        if arch == VLM_ARCH:
            hook = functools.partial(_first_step, first, label.removesuffix(" remat"),
                                     remat)
        for k, by in lm_run(*run, remat=remat, on_step1=hook,
                            grad_peak="cdmsgd f32" in label).items():
            for bucket, n in by.items():
                total[k][bucket] += n
    _LIVE_DRAWS.clear()
    if first:
        raise AssertionError(f"runs without their remat twin: {sorted(first)}")
    for arch, a, forms in timed:
        time_family_bucket(arch, a, forms)
    return total


def reckon_train_peak(arch: str, agents: int, batch: int, seq: int, remat: bool) -> None:
    """Print, before a full-width training run, the peak its memory is
    reckoned at: per agent the bf16 parameters, their gradients, the
    momentum and the int8 overlap wire (two payload generations, a scale per
    128-wide row each), then the largest activation term: with remat one
    block's recompute, where a hybrid's chunked mamba scan keeps about 9
    ``(b, 32, d, ssm_state)`` float32 tensors a chunk for its backward
    (``mamba_scan_bench.py`` measures one layer's peak), and the loss's
    float32 logits and their gradient."""
    cfg = get_config(arch)
    n = cfg.param_count()
    state = n * (2 + 2 + 2) + 2 * (n + 4 * n // 128)
    chunk = batch * 32 * cfg.d_model * max(cfg.ssm_state, 1) * 4
    block = 9 * (seq // 32) * chunk if cfg.hybrid else \
        16 * batch * seq * max(cfg.d_ff, cfg.d_model) * 4
    logits = 3 * batch * seq * cfg.vocab_size * 4
    act = (block if remat else block * cfg.n_layers) + logits
    print(f"train {arch}: reckoned peak {agents * (state + act) / 2**30:.1f} GiB on "
          f"{agents} agents ({state / 2**30:.2f} GiB of params, gradients, momentum "
          f"and wire per agent; {act / 2**30:.2f} GiB of activations per agent "
          f"{'with' if remat else 'without'} remat at b {batch} x {seq}; "
          f"one mamba chunk's float32 tensor {chunk / 2**20:.1f} MiB)")


def time_family_bucket(arch: str, a: int, forms) -> None:
    """The update and quantize kernels of a family's runs (the wrappers
    named in ``forms``) timed at its whole bf16 bucket on ``a`` agents (A =
    S = a, a ring): a dense form on bf16 neighbours, a ``_q`` form on an
    int8 payload, ``sr_quantize`` to int8; CUDA events and kernel-only
    beside the byte bound (phase 3c holds these forms bit for bit on
    gemma3-1b's bucket)."""
    dev = torch.device(CARD)
    rows = lm_bucket_rows(arch)
    gen = torch.Generator(device=dev).manual_seed(7)
    pi = make_topology("ring", a).pi
    o = {"w": torch.tensor(pi, dtype=torch.float32, device=dev),
         "wq": torch.tensor(_self_separated_weights(pi), dtype=torch.float32, device=dev)}
    for k in ("x", "slf", "g", "v"):
        o[k] = torch.randn((a, rows, 128), generator=gen, device=dev, dtype=torch.bfloat16)
    o["q"], o["sc"] = cu.sr_quantize(o["x"], 11, "int8", agent_stride=104729)
    for name in (f"{form}:bf16" for form in forms):
        wrapper, symbol, _ = BF16_FORMS[name]
        kernel, _ = _bf16_form_calls(name, o, 11)
        ms = cuda_ms(kernel, iters=10, warmup=2)
        dev_ms = device_ms(kernel, symbol, iters=5)
        kind = torch.bfloat16 if wrapper == "cdmsgd_update" else torch.int8
        b_ms, b_by = bound(wrapper, a, 0 if wrapper == "sr_quantize" else a, rows,
                           kind, bucket=torch.bfloat16)
        print(f"kernel {name} [{arch} bucket] A={a} rows={rows}: ms={ms:.5f} "
              f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.3f} kernel_only_ms="
              f"{'not measured' if dev_ms is None else f'{dev_ms:.5f}'} [{card_line()}]")
    del o
    _free()


def lm_run(label, arch, agents, topo, batch, seq, steps, flags, init,
           per_step, remat: bool = False, on_step1=None,
           grad_peak: bool = False) -> dict:
    """One training run of ``lm_train_path``; returns its launches by
    kernel and bucket type.  An MoE model's launches fall half on its bf16
    bucket, half on its float32 routers' bucket.  ``grad_peak``: after the
    run, one grad phase alone, its allocator peak above the resident train
    state (what remat trades)."""
    argv = ["--arch", arch, "--preset", "full", "--agents", str(agents),
            "--topology", topo, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--log-every", "0", "--device", CARD, *flags]
    cfg = get_config(arch)
    t_run = time.perf_counter()
    _free()
    torch.cuda.reset_peak_memory_stats()
    record = []
    cu.reset_launch_counts()
    _reset_serving_counts()
    t0 = time.perf_counter()
    with timed_steps(record, on_step1), live_init(cfg), remat_loss(remat):
        tr = lm_train.main(argv)
    wall = time.perf_counter() - t0
    counts, buckets, serving = (cu.launch_counts(), cu.bucket_launch_counts(),
                                _serving_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(record):
        if r["counts"] != _want_counts(init, per_step, i + 1):
            raise AssertionError(f"train {label} step {i}: launched "
                                 f"{r['counts']}, expected "
                                 f"{_want_counts(init, per_step, i + 1)}")
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"train {label} step {i}: loss {r['loss']}")
        if cfg.is_moe and not (np.isfinite(r["moe_aux"]) and r["moe_aux"] > 0):
            raise AssertionError(f"train {label} step {i}: moe_aux {r['moe_aux']}")
    if len(record) != steps or any(serving.values()):
        raise AssertionError(f"train {label}: {len(record)} steps, flash / "
                             f"WKV6 launches {serving} (expected none)")
    # a top-k wire codes the float32 compact values of the bucket
    on_f32 = {"sr_quantize"} if "--compressor" in flags else set()
    out = {}
    for k, by in buckets.items():
        if cfg.is_moe:
            if by["bfloat16"] != by["float32"] or sum(by.values()) != counts[k]:
                raise AssertionError(f"train {label}: {k} launches {by}, expected "
                                     "half on the bf16 bucket, half on the float32 "
                                     "routers' bucket")
            out[k] = dict(by)
            continue
        bucket = "float32" if k in on_f32 else "bfloat16"
        if by[bucket] != counts[k] or sum(by.values()) != counts[k]:
            raise AssertionError(f"train {label}: {k} launches {by}, all "
                                 f"expected on the {bucket} bucket")
        out[k] = {bucket: by[bucket]}
    spec = make_flat_spec(tr.state.params, lead=1)
    degree = make_topology(topo, agents).degree()
    want_wire = degree * program_bytes_per_neighbor(spec, tr.program)
    wire_note = ""
    if tr.wire_bytes_per_step != want_wire:
        raise AssertionError(f"train {label}: {tr.wire_bytes_per_step} wire "
                             f"B/step, the bf16 bucket's accounting {want_wire}")
    if "overlap" in flags:
        carried = wire_bytes_per_neighbor(tr.state.opt_state.wire) * degree
        if carried != want_wire:
            raise AssertionError(f"train {label}: the carried wire moves "
                                 f"{carried} B/step, the accounting {want_wire}")
        wire_note = ", equal to the carried wire's buffers"
    steady = [r["ms"] for r in record[1:]]
    med = float(np.median(steady))
    tokens = agents * batch * seq
    launched = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
    cons = tr.history.series("consensus_error")
    losses = ", ".join(f"{r['loss']:.4f}" for r in record)
    if cfg.is_moe:
        losses += "; moe_aux " + ", ".join(f"{r['moe_aux']:.4f}" for r in record)
    print(f"train {label}: {steps} steps through repro_torch.launch.train, "
          f"{count_params(tt.model_template(get_config(arch))):,} params x "
          f"{agents} agents on {topo}, batch {batch} x seq {seq} per agent"
          f"{f' (+ {cfg.frontend_tokens} stub patches)' if cfg.modality == 'vlm' else ''}"
          f"{f' (+ {cfg.frontend_tokens} float32 stub frames)' if cfg.modality == 'audio' else ''}"
          f"{', remat' if remat else ''} (live_init weights): losses {losses}, "
          f"consensus_error {cons[0]:.3e} -> {cons[-1]:.3e}; first step "
          f"{record[0]['ms']:.1f} ms, steady median {med:.1f} ms "
          f"(steps 2-{steps}), {tokens / med * 1e3:,.0f} tokens/s; "
          f"max_memory_allocated {peak:.2f} GiB; wire {tr.wire_bytes_per_step:,} "
          f"B/step ({tr.program.describe()}{wire_note}); launches at init "
          f"{init or 'none'}, per step {per_step} "
          f"({'bf16 and float32 router buckets' if cfg.is_moe else 'bf16 bucket'}"
          f"{', sr_quantize on the float32 compact values' if on_f32 else ''}): "
          f"{launched}; flash / WKV6 launches 0; entry point wall {wall:.1f} s")
    if label == COUNTED_RUN:
        counter_check(tr, cfg, agents, batch, seq, med, peak)
    # a hybrid or encoder-decoder step's trace (hymba: over 10^5 launches
    # under vmap and remat) takes the profiler most of a minute to read
    profiled = (label in PROFILED_RUNS
                or (arch == GEMMA_2L and label.endswith(LM_PROFILED))) \
        and arch not in NEW_FAMILIES and not remat
    if profiled or grad_peak:
        vocab = tr.state.params["embed"]["table"].shape[1]
        stream = lm_agent_batches(make_lm_tokens(1 << 15, vocab=vocab, seed=0),
                                  agents, batch, seq, seed=0)
        extra = next(stream)
        with remat_loss(remat):
            if grad_peak:
                grad_phase_peak(tr, extra, label)
            if profiled:
                symbols = [BF16_FORMS[f"{k}:bf16"][1] for k in per_step]
                profile_lm_step(tr, extra, label, symbols)
        del stream
    del tr
    _free()
    print(f"train {label}: run wall {time.perf_counter() - t_run:.1f} s (entry point, "
          f"checks{', profiled step' if profiled else ''}"
          f"{', op counter' if label == COUNTED_RUN else ''})")
    return out


def counter_check(tr, cfg, agents: int, batch: int, seq: int, step_ms: float,
                  peak_gib: float) -> None:
    """Phase 10's op counter (``repro_torch.analysis.opcount``): one more
    step of the trainer ``tr`` on the card under the counter (the kernels
    report their work) against the same step traced on ``meta`` (the plain
    versions, shapes only): equal dot FLOPs, a gate.  Prints the measured
    steady step's MFU against the card's bf16 peak, the useful-FLOPs ratio,
    and the meta trace's peak of live tensor bytes beside the allocator's
    measured peak of the run (a finding, not a gate)."""
    stream = lm_agent_batches(make_lm_tokens(1 << 15, vocab=cfg.vocab_size, seed=0),
                              agents, batch, seq, seed=0)
    host = next(stream)
    st = tr.state
    dev_batch = {k: torch.as_tensor(v, device=CARD) for k, v in host.items()}
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with opcount.OpCounter(track_live=True,
                           roots=(st.params, st.opt_state, dev_batch)) as card:
        tr._program.step_fn(st.params, st.opt_state, dev_batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    del dev_batch
    _free()
    t0 = time.perf_counter()
    single = tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype,
                                            device="meta"), st.params)
    mtr = CollaborativeTrainer(tr.loss_fn, single, tr.topology, tr.optimizer,
                               device="meta", exchange=tr.exchange,
                               schedule=tr.schedule)
    mb = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype, device="meta")
          for k, v in host.items()}
    ms = mtr.state
    with opcount.OpCounter(track_live=True, roots=(ms.params, ms.opt_state, mb)) as meta:
        mtr._program.step_fn(ms.params, ms.opt_state, mb)
    meta_s = time.perf_counter() - t0
    if card.dot_flops != meta.dot_flops:
        raise AssertionError(f"op counter: {card.dot_flops} dot FLOPs on the card, "
                             f"{meta.dot_flops} on meta")
    mf = model_flops(cfg, InputShape("phase10", seq, agents * batch, "train"))
    mfu = mf / (step_ms / 1e3 * HW_H100.peak_flops)
    print(f"analysis op counter gemma3-1b {COUNTED_RUN} ({agents} agents x batch "
          f"{batch} x seq {seq}, stacked on one card): dot FLOPs {card.dot_flops:,} "
          f"on the card (kernels report their work) = {meta.dot_flops:,} traced on "
          f"meta (plain versions); traffic {card.traffic_bytes:,} B card, "
          f"{meta.traffic_bytes:,} B meta (unfused upper bound); counted in "
          f"{card_s:.1f} s / {meta_s:.1f} s; model_flops 6 N D {mf:.4e}, "
          f"useful_flops_ratio {mf / card.dot_flops:.4f}; the steady step "
          f"{step_ms:.1f} ms gives MFU {mfu:.4f} of {HW_H100.peak_flops:.3g} bf16 "
          f"FLOP/s ({mfu * card.dot_flops / mf:.4f} counting every dot FLOP); "
          f"peak live bytes of the meta trace {meta.peak_live_bytes / 2**30:.2f} GiB "
          f"(op counter; {card.peak_live_bytes / 2**30:.2f} GiB counted on the card "
          f"in the same step) against max_memory_allocated {step_peak:.2f} GiB in "
          f"that step and {peak_gib:.2f} GiB over the run [{card_line()}]")


def analysis_path() -> None:
    """Phase 16, the analysis layer on the card: ``launch.check`` over the
    stacked matrix (every rule passes); the dry-run's records of gemma3-1b
    ``train_4k`` (16 agents, traced on ``meta``: CDMSGD on the int8 wire
    under overlap, and CDSGD on the ``topk:0.01`` wire with error feedback)
    with their roofline rows; and ``kernel_microbench --smoke`` on the card.
    (Phase 14 ran ``check_bundle`` in its 2-layer rank runs.)"""
    from repro_torch.benchmarks import kernel_microbench
    from repro_torch.benchmarks import roofline as roofline_bench
    from repro_torch.launch import check as check_lib
    from repro_torch.launch import dryrun

    card = card_line()
    t0 = time.perf_counter()
    reports = check_lib.stacked_reports(check_lib.MATRIX, device=CARD, verbose=False)
    bad = [(r.label, f.rule, f.detail) for r in reports for f in r.failures()]
    if bad:
        raise AssertionError(f"launch.check on the card: {bad}")
    n_rules = sum(len(r.results) for r in reports)
    n_skip = sum(x.skipped for r in reports for x in r.results)
    print(f"analysis launch.check --mode stacked on the card: {len(reports)} "
          f"configs, {n_rules} rules ({n_skip} skipped), 0 failures, "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    out = str(ROOT / "results" / "dryrun_torch")
    table = str(ROOT / "results" / "roofline_torch.md")
    for tag, kw in (("_int8_overlap", dict(optimizer_name="cdmsgd", exchange="int8",
                                           schedule="overlap")),
                    ("_topk", dict(optimizer_name="cdsgd", compressor=TOPK,
                                   error_feedback=True, schedule="overlap"))):
        t0 = time.perf_counter()
        rec = dryrun.run_pair("gemma3-1b", "train_4k", out_dir=out, tag=tag,
                              verbose=False, **kw)
        if rec["status"] != "ok" or not rec["verify"]["ok"]:
            raise AssertionError(f"dry-run {tag}: {rec['status']} "
                                 f"{rec.get('traceback', '')[-800:]}")
        rl = rec["roofline"]
        print(f"analysis dryrun gemma3-1b train_4k data16{tag} (meta, "
              f"{time.perf_counter() - t0:.1f} s): compute {rl['compute_s']:.4e} s, "
              f"memory {rl['memory_s']:.4e} s, collective {rl['collective_s']:.4e} s "
              f"on H100 peaks, dominant {rl['dominant']}, useful_flops_ratio "
              f"{rl['useful_flops_ratio']:.4f}, mfu_bound {rl['mfu_bound']:.4f}; "
              f"peak {rec['peak_bytes_per_device'] / 2**30:.2f} GiB live (op "
              f"counter), fits_h100_80gb {rec['fits_h100_80gb']}; wire "
              f"{rec['exchange_bytes_per_step']['per_step_bytes']:,} B a step; "
              f"verify {len(rec['verify']['rules'])} rules ok")
    roofline_bench.run(results=out, table=table)
    t0 = time.perf_counter()
    rows = kernel_microbench.run(smoke=True, device=CARD)
    print(f"analysis kernel_microbench --smoke on the card: {len(rows)} rows, "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def examples_path() -> None:
    """Phase 15: the port's examples (``EXAMPLES``) at their tiny presets on
    the card, each through its ``main(argv)``, with the update, quantize and
    serving kernels' launches while it ran (the LM pre-training example on
    the int8 wire must launch the ``_q`` update and the quantize)."""
    for name, argv in EXAMPLES:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        cu.reset_launch_counts()
        _reset_serving_counts()
        t0 = time.perf_counter()
        module.main(argv)
        torch.cuda.synchronize()
        launched = {k: v for k, v in cu.launch_counts().items() if v}
        print(f"example {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s on "
              f"the card; update / quantize launches {launched or 'none'}, serving "
              f"{_serving_counts()} [{card_line()}]")
        if "--exchange" in argv and not {"sr_quantize", "cdmsgd_update_q"} <= set(launched):
            raise AssertionError(f"example {name}: launched {launched}, expected the "
                                 "int8 wire's quantize and _q update")
        _free()


def _cpu_like(tree):
    """Empty CPU tensors shaped and typed like ``tree``'s (ints kept)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def lm_resume() -> dict:
    """Phase 12: gemma3-1b at full width with 2 layers (0.36 B parameters),
    2 agents, CDMSGD int8 overlap with error feedback, through
    ``repro_torch.launch.train.main``: four uninterrupted steps against two,
    ``--checkpoint-dir``, ``--resume`` and two more, bit for bit in the
    params, momentum, wire and residual; the final checkpoint restored on
    the CPU equal to the card's state.  Returns the launches by bucket."""
    total = {k: {"float32": 0, "bfloat16": 0} for k in cu.KERNELS}
    with gemma_2layers() as cfg:
        base = ["--arch", cfg.name, "--preset", "full", "--log-every", "0",
                "--device", CARD, *RESUME_FLAGS]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
            cu.reset_launch_counts()
            _reset_serving_counts()
            t0 = time.perf_counter()
            with live_init(cfg):
                whole = lm_train.main([*base, "--steps", str(RESUME_STEPS)])
                lm_train.main([*base, "--steps", str(RESUME_SPLIT),
                               "--checkpoint-dir", d])
                resumed = lm_train.main([*base, "--steps",
                                         str(RESUME_STEPS - RESUME_SPLIT),
                                         "--checkpoint-dir", d, "--resume"])
            wall = time.perf_counter() - t0
            for k, by in cu.bucket_launch_counts().items():
                for bucket, n in by.items():
                    total[k][bucket] += n
            if any(_serving_counts().values()):
                raise AssertionError("resume: flash / WKV6 launched in training")
            if resumed.state.step != RESUME_STEPS:
                raise AssertionError(f"resume: ended at step {resumed.state.step}")
            parts = {"params": (whole.state.params, resumed.state.params),
                     "momentum": (whole.state.opt_state.inner,
                                  resumed.state.opt_state.inner),
                     "wire": (whole.state.opt_state.wire, resumed.state.opt_state.wire),
                     "residual": (whole.state.opt_state.residual,
                                  resumed.state.opt_state.residual)}
            for part, (a, b) in parts.items():
                la, lb = tree_leaves(a), tree_leaves(b)
                if not la or len(la) != len(lb) or \
                        not all(_equal_bits(x, y) for x, y in zip(la, lb)):
                    raise AssertionError(f"resume: the {part} differ from the "
                                         "uninterrupted run's")
            st = resumed.state
            p_cpu, o_cpu = restore_train_state(d, _cpu_like(st.params),
                                               _cpu_like(st.opt_state))
            if o_cpu.step != RESUME_STEPS or not all(
                    _equal_bits(x.cpu(), y) for x, y in
                    zip(tree_leaves((st.params, st.opt_state)),
                        tree_leaves((p_cpu, o_cpu))) if isinstance(x, torch.Tensor)):
                raise AssertionError("resume: the checkpoint restored on the CPU "
                                     "differs from the card's state")
            n_bytes = sum(f.stat().st_size for f in Path(d).glob("ckpt_*.npz"))
        n = count_params(tt.model_template(cfg))
        print(f"resume gemma3-1b full width 2 layers ({n:,} params) x 2 agents, "
              f"CDMSGD int8 overlap EF: {RESUME_STEPS} uninterrupted steps equal "
              f"{RESUME_SPLIT} + checkpoint + --resume + "
              f"{RESUME_STEPS - RESUME_SPLIT} bit for bit (params, momentum, wire, "
              f"residual: {len(tree_leaves(st.params))} + "
              f"{len(tree_leaves(st.opt_state.inner))} + "
              f"{len(tree_leaves(st.opt_state.wire))} + "
              f"{len(tree_leaves(st.opt_state.residual))} leaves); the final "
              f"checkpoint loads on the CPU and equals the card's state; two "
              f"checkpoints {n_bytes / 2**30:.2f} GiB; three entry-point runs "
              f"{wall:.1f} s")
    _free()
    return total


def _to(tree, device):
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def parity_lm() -> None:
    """Phase 13: reduced gemma3-1b, card against CPU.  float32 weights made
    live (:func:`live_weights`), fused CDMSGD on a ring of 4, two whole
    steps within 1e-4; then bf16 weights, the update phase (CDMSGD on the
    f32 wire: the dense kernel; CDSGD on the int8 wire: ``sr_quantize`` and
    the ``_q`` kernel) from one state with the card's gradients, new
    params, momentum and wire bit for bit."""
    def loss_of(cfg):
        return lambda p, b: tt.loss_fn(cfg, p, b)

    cfg32 = dataclasses.replace(get_config("gemma3-1b").reduced(),
                                param_dtype="float32")
    params = live_weights(cfg32, init_params(tt.model_template(cfg32), seed=5), seed=6)
    stream = lm_agent_batches(make_lm_tokens(1 << 14, vocab=cfg32.vocab_size, seed=1),
                              LM_AGENTS, 2, 32, seed=1)
    batches = [next(stream) for _ in range(2)]
    trs = [CollaborativeTrainer(loss_of(cfg32), params, make_topology("ring", LM_AGENTS),
                                make_optimizer("cdmsgd", LR, mu=MU, fused=True),
                                device=d) for d in ("cpu", CARD)]
    for b in batches:
        for tr in trs:
            tr.step(b)
    gap = max(float((x.cpu() - y).abs().max()) for x, y in
              zip(tree_leaves(trs[1].state.params), tree_leaves(trs[0].state.params)))
    print(f"parity gemma3-1b reduced float32 LM, fused CDMSGD on a ring of "
          f"{LM_AGENTS}, 2 steps card vs cpu: max |param diff| {gap:.3e} "
          f"(tol {PARITY_TOL:g})")
    if not gap <= PARITY_TOL:
        raise AssertionError(f"LM card/CPU whole steps: {gap} > {PARITY_TOL}")
    cfg16 = get_config("gemma3-1b").reduced()
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    for name, exchange in (("cdmsgd", "f32"), ("cdsgd", "int8")):
        kw = {"mu": MU} if name == "cdmsgd" else {}
        trs = [CollaborativeTrainer(loss_of(cfg16), params16,
                                    make_topology("ring", LM_AGENTS),
                                    make_optimizer(name, LR, fused=True, **kw),
                                    exchange=exchange, device=d)
               for d in ("cpu", CARD)]
        cpu, card = trs
        card.step(batches[0])                            # a state past init
        st = card.state
        gp = card.optimizer.grad_params(st.params, st.opt_state)
        _, grads = card._program.grad_phase(gp, {k: torch.as_tensor(v, device=CARD)
                                                 for k, v in batches[1].items()})
        with torch.no_grad():
            got = card._program.update_phase(st.params, grads, st.opt_state)
            want = cpu._program.update_phase(_to(st.params, "cpu"), _to(grads, "cpu"),
                                             _to(st.opt_state, "cpu"))
        leaves = [(x, y) for x, y in zip(tree_leaves(got), tree_leaves(want))
                  if isinstance(x, torch.Tensor)]
        if not all(_equal_bits(x.cpu(), y) for x, y in leaves):
            raise AssertionError(f"bf16 {name} {exchange} update phase: card and "
                                 "CPU differ")
        print(f"parity gemma3-1b reduced bf16 {name} {exchange} update phase card vs "
              f"cpu, same state and gradients: {len(leaves)} tensors (params"
              f"{', momentum' if name == 'cdmsgd' else ''}) bit for bit")


# ---------------------------------------------------------------------------
# phase 14: the sharded mode, one process per agent on one card


def _seeded_like(tree, device, agent: int, salt: int, scale: float):
    """``scale * N(0, 1)`` shaped like ``tree``'s leaves, drawn on the card
    from a generator seeded by ``(agent, salt)`` leaf by leaf in tree
    order: the same bits in every process."""
    gen = torch.Generator(device=device).manual_seed(1000 * salt + agent)
    return tree_map(lambda x: scale * torch.randn(x.shape, generator=gen,
                                                  device=device), tree)


def _stacked_rows(tr, base, batch, n: int, rank: int, momentum: bool) -> dict:
    """The stacked trainer ``tr`` (on the card) from a seeded state past
    init: params ``base + 0.01 N`` per agent, the overlap wire quantized
    from another such draw, a seeded momentum and gradients (the same bits
    in every rank).  Returns agent ``rank``'s share of that state and of
    the trainer's update phase and whole step from it (on the card)."""
    dev = tr.device
    stack = lambda rows: tree_map(lambda *xs: torch.stack(xs), *rows)  # noqa: E731
    base_d = tree_map(lambda t: t.to(dev), base)
    params = stack([tree_map(torch.add, base_d, _seeded_like(base_d, dev, a, 1, 0.01))
                    for a in range(n)])
    prev = stack([tree_map(torch.add, base_d, _seeded_like(base_d, dev, a, 2, 0.01))
                  for a in range(n)])
    del base_d
    prog = tr._program
    state = prog.init_state(prev)._replace(step=1)
    del prev
    one = tree_map(lambda x: x[0], params)
    if momentum:
        state = state._replace(inner=stack([_seeded_like(one, dev, a, 3, 0.01)
                                            for a in range(n)]))
    grads = stack([_seeded_like(one, dev, a, 4, 0.1) for a in range(n)])
    clone = lambda tree: tree_map(  # noqa: E731
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
    rows = {"state": local_train_state(params, state, rank),
            "grads": tree_map(lambda x: x[rank].clone(), grads)}
    with torch.no_grad():
        up, us = prog.update_phase(clone(params), grads, clone(state))
    rows["update"] = local_train_state(up, us, rank)
    del up, us, grads
    wp, _, _ = prog.step_fn(params, state, {k: torch.as_tensor(v, device=dev)
                                            for k, v in batch.items()})
    rows["step"] = tree_map(lambda x: x[rank].clone(), wp)
    return rows


def _sharded_optimizer(name: str):
    if name == "cdadam":
        return make_optimizer(name, ADAM_LR, fused=True)
    return make_optimizer(name, LR, fused=True,
                          **({"mu": MU} if name.startswith("cdmsgd") else {}))


def _sharded_run(mesh, cfg, params, batches, label, opt_name, knobs, init,
                 per_step, cap: int) -> dict:
    """One full-width run of phase 14 on this rank: ``SHARDED_STEPS`` steps
    through ``build_train_step``, each timed, with its launches, exchange
    census and loss; checked here (exact launches, bytes against the
    accounting, finite losses, no flash / WKV6 launch, the allocator's
    peak within ``cap`` bytes)."""
    _free()
    dev = mesh.device
    census = mesh.census
    torch.cuda.reset_peak_memory_stats(dev)
    cu.reset_launch_counts()
    _reset_serving_counts()
    census.reset()
    shape = InputShape("phase14", SHARDED_SEQ, mesh.size, "train")
    bundle = build_train_step(cfg, shape, mesh, _sharded_optimizer(opt_name),
                              topology_name="ring", mixing="ppermute_fused",
                              remat=False, **knobs)
    state = bundle.init_state(params)
    torch.cuda.synchronize(dev)
    if cu.launch_counts() != _want_counts(init, per_step, 0):
        raise AssertionError(f"sharded {label} rank {mesh.rank}: init launched "
                             f"{cu.launch_counts()}, expected {init}")
    spec = make_flat_spec(params)
    degree = bundle.topology.degree()
    want_bytes = program_bytes_per_neighbor(spec, bundle.mixing_program) * degree
    steps, p = [], params
    for i, b in enumerate(batches):
        census.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        p, state, metrics = bundle.step_fn(p, state, local_batch(b, mesh))
        loss = float(metrics["loss"])
        torch.cuda.synchronize(dev)
        steps.append({"ms": 1e3 * (time.perf_counter() - t0), "loss": loss,
                      "exchange_ms": 1e3 * census.seconds,
                      "census": census.snapshot(), "counts": cu.launch_counts()})
        what = f"sharded {label} rank {mesh.rank} step {i}"
        if steps[-1]["counts"] != _want_counts(init, per_step, i + 1):
            raise AssertionError(f"{what}: launched {steps[-1]['counts']}, "
                                 f"expected {_want_counts(init, per_step, i + 1)}")
        c = steps[-1]["census"]
        if c["bytes_sent"] != want_bytes or c["bytes_received"] != want_bytes:
            raise AssertionError(f"{what}: posted {c['bytes_sent']} B, received "
                                 f"{c['bytes_received']} B, the accounting "
                                 f"{want_bytes} B ({degree} neighbours)")
        if not np.isfinite(loss):
            raise AssertionError(f"{what}: loss {loss}")
    if any(_serving_counts().values()):
        raise AssertionError(f"sharded {label}: flash / WKV6 launched in training")
    by_bucket = cu.bucket_launch_counts()
    # a top-k wire's one sr_quantize a step codes the float32 compact values
    f32_ok = ({"sr_quantize"} if knobs.get("compressor", "").startswith("topk")
              else set())
    for k, by in by_bucket.items():
        if by["float32"] and k not in f32_ok:
            raise AssertionError(f"sharded {label}: {k} launched on an f32 bucket "
                                 f"{by}; the model is one bf16 bucket")
    carried = (wire_bytes_per_neighbor(state.wire) * degree
               if bundle.schedule == "overlap" else None)
    if carried is not None and carried != want_bytes:
        raise AssertionError(f"sharded {label}: the carried wire moves {carried} "
                             f"B a step, the accounting {want_bytes}")
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    if peak_reserved > cap:
        raise AssertionError(f"sharded {label} rank {mesh.rank}: reserved "
                             f"{peak_reserved / 2**30:.2f} GiB, over its cap "
                             f"{cap / 2**30:.2f} GiB")
    check = None
    if cfg.n_layers == SHARDED_SMALL_LAYERS:
        # phase 16's wire-contract check of this rank, one more step (after
        # the launch counts above, which it would add to)
        rep = staticcheck.check_bundle(bundle, p, local_batch(batches[0], mesh),
                                       opt_state=state, label=f"sharded/{label}")
        check = {"ok": rep.ok, "rules": len(rep.results),
                 "skipped": sum(r.skipped for r in rep.results),
                 "failures": [(r.rule, r.detail) for r in rep.failures()],
                 "seconds": rep.walltime_s}
        if not rep.ok:
            raise AssertionError(f"sharded {label} rank {mesh.rank}: the wire "
                                 f"contract fails: {check['failures']}")
    out = {"label": label, "steps": steps, "want_bytes": want_bytes,
           "check": check, "layers": cfg.n_layers, "by_bucket": by_bucket,
           "params": count_params(tt.model_template(cfg)),
           "degree": degree, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "peak_reserved_gib": peak_reserved / 2**30, "cap_gib": cap / 2**30,
           "exchange": bundle.exchange, "schedule": bundle.schedule,
           "init": dict(init), "per_step": dict(per_step)}
    del bundle, state, p
    return out


def _parity_config():
    return dataclasses.replace(get_config("gemma3-1b"), n_layers=SHARDED_PARITY_LAYERS,
                               param_dtype="float32", name="gemma3-1b-2layers-f32")


def _sharded_parity(mesh, base, batch, label, opt_name, knobs,
                    fraction: float, topology=None, remat=False) -> dict:
    """Phase 14's parity on this rank: gemma3-1b at full width with
    ``SHARDED_PARITY_LAYERS`` layers in float32, the stacked trainer on
    ``topology`` (the ring by default; one rank at a time builds it for
    every agent, its allocator uncapped: about 30 GiB) against this rank's
    sharded step from the same seeded state (all ranks at once, each capped
    at ``fraction`` of the card): the update phase with the same gradients
    and wire bit for bit (a rank-r wire within ``RANK_TOL``: its float64
    power iteration is a batched product in the stacked trainer), the whole
    step on the same batch within ``SHARDED_TOL`` of max |param|.  The
    sharded step's ``remat`` as given (None: ``build_train_step``'s
    default, on); the stacked trainer's loss has none."""
    cfg = _parity_config()
    n, dev = mesh.size, mesh.device
    topology = topology or make_topology("ring", n)
    t0 = time.perf_counter()
    rows = None
    for r in range(n):
        dist.barrier()
        if mesh.rank == r:
            _free()
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
            tr = CollaborativeTrainer(lambda p, b: tt.loss_fn(cfg, p, b), base,
                                      topology, _sharded_optimizer(opt_name),
                                      device=dev, **knobs)
            tr.state = None
            # this rank's rows wait on the host: the next rank's stacked
            # trainer needs the card (with two ranks' 2-layer float32 rows on
            # it, a rank-r stacked update ran out of its memory), and this
            # rank's capped sharded step its share (a rank-r step beside its
            # rows ran out of it)
            rows = _to(_stacked_rows(tr, base, batch, n, r, opt_name == "cdmsgd"),
                       "cpu")
            del tr
            _free()
            torch.cuda.set_per_process_memory_fraction(fraction, dev)
    dist.barrier()
    stacked_s = time.perf_counter() - t0
    bundle = build_train_step(cfg, InputShape("phase14-parity", SHARDED_PARITY_SEQ, n,
                                              "train"),
                              mesh, _sharded_optimizer(opt_name),
                              topology_name="ring", mixing="ppermute_fused",
                              **({} if remat is None else {"remat": remat}), **knobs)
    params, state = _to(rows["state"], dev)
    with torch.no_grad():
        got = bundle.update_phase(tree_map(torch.clone, params),
                                  _to(rows["grads"], dev),
                                  tree_map(lambda t: t.clone()
                                           if isinstance(t, torch.Tensor) else t,
                                           state))
    want = rows["update"]
    rank_r = knobs.get("compressor", "").startswith("rank:")
    n_tensors, update_gap, same = 0, 0.0, len(tree_leaves(got)) == len(tree_leaves(want))
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        if not isinstance(x, torch.Tensor):
            continue
        y = y.to(dev)
        n_tensors += 1
        if rank_r and x.is_floating_point():
            update_gap = max(update_gap, float((x - y).abs().max()))
        same = same and (x.shape == y.shape if rank_r else _equal_bits(x, y))
    if not same or (rank_r and not update_gap <= RANK_TOL):
        raise AssertionError(f"sharded parity {label} rank {mesh.rank}: the update "
                             f"phase differs from the stacked trainer's (max gap "
                             f"{update_gap})")
    del got, x, y
    wp, _, _ = bundle.step_fn(params, state, local_batch(batch, mesh))
    step = _to(rows["step"], dev)
    top = max(float(y.abs().max()) for y in tree_leaves(step))
    gap = max(float((x - y).abs().max())
              for x, y in zip(tree_leaves(wp), tree_leaves(step)))
    if not gap <= SHARDED_TOL * top:
        raise AssertionError(f"sharded parity {label} rank {mesh.rank}: whole step "
                             f"{gap} from the stacked trainer's, max |param| {top}")
    del wp, bundle, params, state, rows, step
    _free()
    return {"label": label, "tensors": n_tensors, "gap": gap, "max_param": top,
            "update_gap": update_gap, "bitwise": not rank_r, "remat": remat,
            "stacked_s": stacked_s, "params": count_params(tt.model_template(cfg))}


def sharded_rank(mesh, cap: int) -> dict:
    """Phase 14, one rank (agent ``mesh.rank`` of ``SHARDED_AGENTS``, all on
    the one card over gloo): gemma3-1b at full width with
    ``SHARDED_RUN_LAYERS`` layers on ``live_weights``, batch 1 x 1024 of its own token
    shard, the runs of ``SHARDED_RUNS`` with the allocator capped at
    ``cap`` bytes; then the 2-layer parity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = torch.cuda.get_device_properties(mesh.device).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total, mesh.device)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=SHARDED_RUN_LAYERS)
    params = live_weights(cfg, card_draw(tt.model_template(cfg), 0, mesh.device), 1)
    stream = lm_agent_batches(make_lm_tokens(1 << 15, vocab=cfg.vocab_size, seed=0),
                              mesh.size, 1, SHARDED_SEQ, seed=0)
    batches = [next(stream) for _ in range(SHARDED_STEPS)]
    out = {"init_s": time.perf_counter() - t0, "runs": [], "parity": []}
    for label, opt_name, knobs, init, per_step in SHARDED_RUNS:
        out["runs"].append(_sharded_run(mesh, cfg, params, batches, label, opt_name,
                                        knobs, init, per_step, cap))
    del params
    _free()
    cfg2 = dataclasses.replace(cfg, n_layers=SHARDED_SMALL_LAYERS)
    params = live_weights(cfg2, card_draw(tt.model_template(cfg2), 0, mesh.device), 1)
    for label, opt_name, knobs, init, per_step in (SHARDED_SMALL_RUNS
                                                   + SHARDED_SPARSE_RUNS):
        out["runs"].append(_sharded_run(mesh, cfg2, params, batches, label, opt_name,
                                        knobs, init, per_step, cap))
    del params
    _free()
    pcfg = _parity_config()
    base = tree_map(lambda t: t.cpu(), live_weights(
        pcfg, card_draw(tt.model_template(pcfg), 2, mesh.device), 3))
    batch = next(lm_agent_batches(make_lm_tokens(1 << 14, vocab=pcfg.vocab_size,
                                                 seed=1),
                                  mesh.size, 1, SHARDED_PARITY_SEQ, seed=1))
    done = set()
    for label, opt_name, knobs, _, _ in SHARDED_RUNS + SHARDED_SMALL_RUNS:
        if label in done:
            continue
        done.add(label)
        remat = None if label == SHARDED_REMAT_PARITY else False
        out["parity"].append(_sharded_parity(mesh, base, batch, label, opt_name,
                                             knobs, cap / total, remat=remat))
    out["pinned_gib"] = sum(b.numel() for b in mesh.pinned.values()) / 2**30
    out["max_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return out


def sharded_factored_rank(mesh, cap: int) -> dict:
    """Phase 14's factored mesh, one rank of ``pod 2 x data 2``: the 2-layer
    float32 parity of ``FACTORED_RUN`` against the stacked trainer on
    ``kron(Pi_pod, Pi_data)`` (the factors ``build_train_step`` picks)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = torch.cuda.get_device_properties(mesh.device).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total, mesh.device)
    pcfg = _parity_config()
    base = tree_map(lambda t: t.cpu(), live_weights(
        pcfg, card_draw(tt.model_template(pcfg), 2, mesh.device), 3))
    batch = next(lm_agent_batches(make_lm_tokens(1 << 14, vocab=pcfg.vocab_size,
                                                 seed=1),
                                  mesh.size, 1, SHARDED_PARITY_SEQ, seed=1))
    factored = _agent_factors(mesh, tuple(mesh.shape)).topology()
    label, opt_name, knobs = FACTORED_RUN
    return _sharded_parity(mesh, base, batch, label, opt_name, knobs, cap / total,
                           topology=factored)


def _rank_cap(n: int) -> tuple:
    """``(cap, free, total, context)``: each of ``n`` ranks' allocator cap,
    its share of the card's free memory less a CUDA context and a
    headroom per rank."""
    free, total = torch.cuda.mem_get_info()
    # this process's CUDA context and loaded modules: what the card holds
    # beyond its allocator's pool (every kernel library is loaded here, so
    # a rank's context, which loads fewer, takes about as much), plus a
    # headroom for what a rank loads lazily in its grad phase
    context = total - free - torch.cuda.memory_reserved()
    return (free - n * (context + SHARDED_HEADROOM)) // n, free, total, context


def _host_available_gib() -> float:
    """The host's MemAvailable (``/proc/meminfo``), GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def sharded_path() -> dict:
    """Phase 14: the sharded mode on the card, ``SHARDED_AGENTS`` gloo ranks
    (one process per agent, one card), through ``spawn_agents``; then the
    factored ``pod 2 x data 2`` mesh on 4 ranks.  Every check runs in the
    ranks, and a failing or hung rank fails the phase.  Returns the update
    and quantize kernels' launches of every rank's timed runs, by bucket."""
    a = torch.ones((256, 256), device=CARD)
    float((a @ a).sum())            # load cuBLAS here, as each rank will
    del a
    _free()
    cap, free, total, context = _rank_cap(SHARDED_AGENTS)
    print(f"sharded phase: the card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
          f"free before the ranks start (this process: "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, context "
          f"{context / 2**30:.2f} GiB); each rank's allocator capped at "
          f"{cap / 2**30:.2f} GiB; host {_host_available_gib():.1f} GiB available",
          flush=True)
    t0 = time.perf_counter()
    results = spawn_agents(sharded_rank, SHARDED_AGENTS, args=(cap,), backend="gloo",
                           device="cuda", timeout=SHARDED_PG_TIMEOUT,
                           join_timeout=SHARDED_JOIN_S, threads=2)
    wall = time.perf_counter() - t0
    card = card_line()
    n_layers = get_config("gemma3-1b").n_layers
    launches = {k: {"float32": 0, "bfloat16": 0} for k in cu.KERNELS}
    for r, res in enumerate(results):
        for run in res["runs"]:
            for k, by in run["by_bucket"].items():
                for b, n in by.items():
                    launches[k][b] += n
            steps = run["steps"]
            steady = [s["ms"] for s in steps[1:]]
            xch = [s["exchange_ms"] for s in steps[1:]]
            c = steps[-1]["census"]
            per_step = ", ".join(f"{k} {v}" for k, v in run["per_step"].items())
            init = ", ".join(f"{k} {v}" for k, v in run["init"].items()) or "none"
            losses = ", ".join(f"{s['loss']:.4f}" for s in steps)
            step_ms = ", ".join(f"{s['ms']:.1f}" for s in steps)
            xch_ms = ", ".join(f"{s['exchange_ms']:.1f}" for s in steps)
            depth = ("and depth" if run["layers"] == n_layers
                     else f"{run['layers']} layers")
            print(f"sharded rank {r}/{SHARDED_AGENTS} gemma3-1b full width {depth} "
                  f"({run['params']:,} params, one bf16 bucket) {run['label']} on a ring: "
                  f"losses {losses}; step ms {step_ms} (steady median "
                  f"{float(np.median(steady)):.1f}); exchange host ms {xch_ms} "
                  f"(steady median {float(np.median(xch)):.1f}: staging plus gloo); posted "
                  f"{c['bytes_sent']:,} B a step in {c['sends']} transfers / "
                  f"{c['messages']} messages = program_bytes_per_neighbor x "
                  f"{run['degree']} ({run['want_bytes']:,} B); staged {c['staged_bytes']:,} "
                  f"B; launches a step {per_step} (init: {init}), flash / WKV6 0; "
                  f"max_memory_allocated {run['peak_gib']:.2f} GiB, reserved "
                  f"{run['peak_reserved_gib']:.2f} of its cap {run['cap_gib']:.2f} GiB "
                  f"(margin {run['cap_gib'] - run['peak_reserved_gib']:.2f} GiB) [{card}]")
            if run["check"] is not None:
                ch = run["check"]
                print(f"analysis sharded rank {r} {run['label']}: check_bundle "
                      f"{'OK' if ch['ok'] else 'FAIL'}, {ch['rules']} rules "
                      f"({ch['skipped']} skipped) in {ch['seconds']:.2f} s [{card}]")
        for par in res["parity"]:
            _print_parity(r, par, "a ring")
        print(f"sharded rank {r}: weights drawn and moved in {res['init_s']:.1f} s; "
              f"pinned staging {res['pinned_gib']:.2f} GiB; peak host RSS "
              f"{res['max_rss_gib']:.2f} GiB")
    _compare_small_runs(results[0]["runs"], card)
    print(f"sharded phase: {SHARDED_AGENTS} gloo ranks on one card, wall {wall:.1f} s "
          f"(spawn, build check, the {len(SHARDED_RUNS)} {SHARDED_RUN_LAYERS}-layer and "
          f"{len(SHARDED_SMALL_RUNS + SHARDED_SPARSE_RUNS)} {SHARDED_SMALL_LAYERS}-layer "
          "runs and the "
          f"parity); host {_host_available_gib():.1f} GiB available after [{card}]",
          flush=True)
    n_f = math.prod(FACTORED_AXES.values())
    _free()
    cap_f, free, _, _ = _rank_cap(n_f)
    t0 = time.perf_counter()
    factored = spawn_agents(sharded_factored_rank, n_f, args=(cap_f,), backend="gloo",
                            device="cuda", timeout=SHARDED_PG_TIMEOUT,
                            join_timeout=SHARDED_JOIN_S, threads=2,
                            axes=FACTORED_AXES)
    for r, par in enumerate(factored):
        _print_parity(r, par, "kron(Pi_pod, Pi_data) (fully connected factors)")
    print(f"sharded factored phase: {n_f} gloo ranks on pod {FACTORED_AXES['pod']} x "
          f"data {FACTORED_AXES['data']}, each capped at {cap_f / 2**30:.2f} GiB of "
          f"{free / 2**30:.2f} free, wall {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


def _print_parity(r: int, par: dict, topology: str) -> None:
    held = ("bit for bit" if par["bitwise"] else
            f"within {RANK_TOL:g} (max |diff| {par['update_gap']:.3e})")
    print(f"sharded parity rank {r} gemma3-1b full width {SHARDED_PARITY_LAYERS} "
          f"layers float32 ({par['params']:,} params) {par['label']} on {topology}"
          f"{', build_train_step default remat=True' if par['remat'] is None else ', remat=False'}: "
          f"update phase {held} against the stacked trainer ({par['tensors']} "
          f"tensors: params and optimizer state), whole step max |diff| "
          f"{par['gap']:.3e} (max |param| {par['max_param']:.3e}, tol "
          f"{SHARDED_TOL:g} of it); stacked references {par['stacked_s']:.1f} s")


def _compare_small_runs(runs: list, card: str) -> None:
    """The 2-layer runs of rank 0 beside the int8 overlap baseline at the
    same depth: steady step and exchange medians, bytes a step."""
    small = [r for r in runs if r["layers"] == SHARDED_SMALL_LAYERS]
    base = small[0]

    def med(run, key):
        return float(np.median([s[key] for s in run["steps"][1:]]))

    for run in small[1:]:
        print(f"sharded {SHARDED_SMALL_LAYERS} layers rank 0 {run['label']} against "
              f"{base['label']}: steady step {med(run, 'ms'):.1f} against "
              f"{med(base, 'ms'):.1f} ms, exchange host {med(run, 'exchange_ms'):.1f} "
              f"against {med(base, 'exchange_ms'):.1f} ms, posted "
              f"{run['want_bytes']:,} against {base['want_bytes']:,} B a step "
              f"({run['want_bytes'] / base['want_bytes']:.4f}) [{card}]")


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
    build.build_all(SOURCES)
    cu.build_libraries()
    fa.library()
    rs.library()
    print(f"build {', '.join(SOURCES)} (nvcc sm_90a, in parallel) and load: "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in SOURCES:
        if lib not in build.BUILD_LOGS:
            print(f"  {lib}: library current, not rebuilt by this run")
        for line in build.BUILD_LOGS.get(lib, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "Performance Loss")):
                print(f"  ptxas {lib}: {line.strip()}")
    walls = {}

    @contextlib.contextmanager
    def phase(name):
        t = time.perf_counter()
        yield
        walls[name] = time.perf_counter() - t

    # phase 14 first: its three ranks need the card's memory, which the
    # later phases' caches in this process would hold
    with phase("14 sharded"):
        sharded_launches = sharded_path()

    measured = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    with phase("3 kernels"):
        check_dense(measured, gen)
        check_sr_quantize(measured, gen)
        check_q(measured, gen)
        check_b4(measured, gen)
        sparse_times = check_sparse(measured, gen)
        check_threshold(measured, gen)
        check_flash(measured, gen)
        check_flash_families(measured, gen)
        check_wkv(measured, gen)
    with phase("3c bf16 buckets"):
        check_bf16_buckets(measured, gen)
        sparse_criteria(measured, sparse_times)
        check_sparse_one_agent(gen)

    train, _ = make_classification(4096, n_classes=10, image_hw=32, seed=0)
    params = init_params(cnn_classifier_template(32, 3, 10), seed=0)
    with phase("4, 4b, 9 CNN and benchmarks"):
        counts = train_main_path(params, train)
        for path in (lambda: mixing_main_path(params, train), paper_benchmarks):
            for k, v in path().items():
                counts[k] += v

    with phase("6-7 gemma3-1b, rwkv6-1.6b serving"):
        t0 = time.perf_counter()
        serving = {arch: card_draw(tt.model_template(get_config(arch)), 0, CARD)
                   for arch, _, _ in SERVE_ARCHS}
        print(f"full-width bf16 weights of {', '.join(serving)} drawn on the card "
              f"(seed 0): {time.perf_counter() - t0:.1f} s")
        counts.update(prefill_path(serving))
        serve_path(serving)
        del serving
        _free()
    with phase("6-7 dense configs serving"):
        for k, n in dense_serving_path().items():
            counts[k] = counts.get(k, 0) + n
    with phase("6-7 MoE, MLA, VLM serving"):
        counts["flash_attention"] += family_serving_path(
            [f for f in FAMILY_ARCHS if f[0] not in NEW_FAMILIES])
    with phase("6-7 hymba, seamless serving"):
        counts["flash_attention"] += family_serving_path(
            [f for f in FAMILY_ARCHS if f[0] in NEW_FAMILIES])
    with phase("10-12 LM training and resume"):
        lm = lm_train_path()
        for k, by in lm_resume().items():
            for bucket, n in by.items():
                lm[k][bucket] += n
    with phase("10c MoE, MLA, VLM training"):
        for k, by in family_train_path(
                [r for r in FAMILY_LM_RUNS if r[1] not in NEW_FAMILIES]).items():
            for bucket, n in by.items():
                lm[k][bucket] += n
    with phase("10c hymba, seamless training"):
        for k, by in family_train_path(
                [r for r in FAMILY_LM_RUNS if r[1] in NEW_FAMILIES]).items():
            for bucket, n in by.items():
                lm[k][bucket] += n
    for name, (wrapper, _, _) in BF16_FORMS.items():
        counts[name] = lm[wrapper]["bfloat16"] + sharded_launches[wrapper]["bfloat16"]
    for k, by in lm.items():
        counts[k] += by["float32"] + sharded_launches[k]["float32"]
    kernels = []
    for name, (lib, _, replaces) in [*KERNELS.items(),
                                     *((n, (KERNELS[w][0], sym, rep)) for n, (w, sym, rep)
                                       in BF16_FORMS.items()),
                                     (FLASH_D120, KERNELS["flash_attention"])]:
        if counts[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[lib],
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": kernels}))

    with phase("5, 8, 13 parity"):
        parities(params, train)
    with phase("15 examples"):
        examples_path()
    with phase("16 analysis"):
        analysis_path()
    print("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def parities(params, train) -> None:
    """Phases 5, 8 and 13: card against CPU (8 and 13 also for the MoE, MLA,
    VLM, hybrid and encoder-decoder configs)."""
    parity(params, train, 3)
    parity(params, train, 3, schedule="overlap")
    parity(params, train, 1, exchange="int8")
    parity_mixed(params, train)
    parity_adam_update(params, train)
    parity_sparse_dense(params, train)
    parity_compressed_update(params, train, f"topk:{TOPK_P}", UPDATE_TOL)
    parity_compressed_update(params, train, "rank:4", RANK_TOL)
    parity_multi_round_update(params, train)
    parity_ring(params, train)
    parity_models()
    parity_families()
    parity_lm()
    parity_moe_lm()


if __name__ == "__main__":
    main()
