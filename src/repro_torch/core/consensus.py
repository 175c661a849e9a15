"""Consensus mixing ``w = Pi x`` over agent-stacked tensors, and its wire.

The stacked-simulation half of :mod:`repro.core.consensus`:

* :func:`mix_stacked` / :func:`mix_pytree_stacked` — every leaf carries a
  leading agent axis ``(N, ...)``; mixing is a dense matmul with ``Pi``
  (the per-leaf reference path of the unfused optimizers);
* :class:`MixingProgram` / :func:`make_mixing_program` — what the exchange
  does each step: a strategy (``static``, ``time_varying`` over a
  :class:`~repro_torch.core.topology.TopologySchedule`, ``multi_round``
  with ``rounds`` inner consensus rounds), a wire precision (``exchange``
  f32 | bf16 | int8 | fp8), optional error feedback and
  ``momentum_mixing`` (``"mixed"``: the momentum buffer rides the wire next
  to the params), the bounded-staleness ring (``staleness``, ``faults``)
  and the compressor axis, validated at config time;
* :class:`MixingStrategy` (:class:`StaticMixing`,
  :class:`TimeVaryingMixing`, :class:`MultiRoundMixing`) — the strategy's
  stages: ``quantize_stage`` (packed buckets to the wire state, one
  ``(payload, row scales)`` pair per bucket), ``exchange_stage`` (wire
  state to the self-separated kernel operands under the step's ``Pi_t``,
  arrival-masked on the fault path), ``continue_from_wire`` (rounds
  ``1..k``), the one-shot ``gather``, the overlap hooks ``initial_wire`` /
  ``advance_wire`` (which push a :class:`WireRing` on the fault path) and
  the error-feedback ``quantize_ef`` / ``residual_init``;
* :func:`stacked_flat_comm` — the fused path's :class:`FlatComm`;
* :func:`wire_seed` — the stochastic-rounding seed of one wire payload;
* :func:`widen_with_momentum` — the bucket list of a momentum-mixing
  program: the params' buckets, then the momentum's;
* :func:`initial_wire_state` / :func:`initial_residual_state`, the wire
  byte accounting (:func:`exchange_bytes_per_step`,
  :func:`describe_exchange_cost`) and :func:`consensus_error_pytree`.

Quantized wires quantize each packed bucket once per step and round with
:func:`repro_torch.kernels.consensus_update.sr_quantize` (one launch for
all agents, per-agent seeds) and hand the fused ``_q`` kernels the native
self stack with ``[diag(Pi_t) | zero-diag Pi_t]`` weights, so agent ``j``
mixes its own exact parameters and the dequantized payloads of the others
— what the sharded exchange delivers, where the self buffer never crosses
the wire.  The f32 and bf16 wires of the trivial program keep the legacy
dense form under the sync schedule: the whole stack (cast to bf16 for
``"bf16"``, self included) with the dense ``Pi``; every other program
carries f32 / bf16 payloads with unit scales into the same ``_q`` kernels.

Every per-step table — the ``(A, A+1)`` weights of each schedule entry,
the fault path's arrival-masked weights, straggle and age rows — is built
on the host once and moved to the device with the comm (each weight row
its own, 16-byte aligned, tensor); a step (a Python int) selects its row
on the host, so no table crosses a device sync.  Inner rounds mix in full
precision between re-quantizations (:meth:`MixingStrategy.combine`, float64
elementwise in a fixed order and rounded once, so the card and the CPU
agree bit for bit) and the last round is fused into the update kernel.

With ``momentum_mixing="mixed"`` every bucket list the strategy sees is
``params_bufs + momentum_bufs`` (equal halves); the momentum half is
quantized with its own stochastic-rounding streams (``wire_seed(...,
payload=1)``), carried in the same wire state and residuals, and handed
to the ``_qm`` kernels.

The compressor axis (``compressor="topk:p" | "topk:auto:B" | "rank:r"``)
rides the error-feedback rail: :meth:`MixingStrategy.compress_ef` compresses
``x + e`` to a :class:`TopKWire` (int8 compact values, int32 flat indices,
row scales; :func:`repro_torch.kernels.consensus_update.topk.
topk_compress_2d`) or a :class:`RankWire` (two f32 factors, the warm-start
basis carried in ``OptState.qwarm``), and the residual takes what the
receivers' decompression loses.  With ``sparse_update`` (the default for
top-k) the exchange hands the compact fields to the sparse update kernels
as a :class:`~repro_torch.kernels.consensus_update.ops.SparseNeighbors`;
otherwise compressed entries decompress to dense f32 stacks with unit
scales for the ``_q`` kernels.

The sharded mode (one process per agent, :mod:`repro_torch.launch.steps`)
has its own strategy, :class:`ShardedMixing`, built by
:func:`sharded_flat_comm`: the same stages over one agent's buckets, with
the exchange a point-to-point permutation per circulant shift
(:func:`repro_torch.core.collectives.ppermute`) and the received stencil
ordered by sender: the staleness ring (each rank keeps its own
:class:`WireRing` and ships the slot it selects), the fault schedules (its
row of the arrival-masked weights), the top-k and rank-r compressors (the
compact fields cross the wire and feed the sparse kernels at one output
agent) and the factored ``pod x data`` agent meshes (:class:`FactoredMix`:
one transfer per non-identity shift combination, weights the products of
the factors').  :func:`make_sharded_mix_fn` and
:func:`make_sharded_mean_fn` are its per-leaf mixing and mean for the
unfused optimizers.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, flatbuf
from repro_torch.core.faults import (MAX_FAULT_PERIOD, FaultSchedule,
                                     arrival_masked_pi, trivial_faults)
from repro_torch.core.topology import Topology, TopologySchedule, fixed_schedule
from repro_torch.device import resolve_device
from repro_torch.kernels.consensus_update import sr_quantize
from repro_torch.kernels.consensus_update import topk as tk
from repro_torch.kernels.consensus_update.ops import SparseNeighbors
from repro_torch.kernels.consensus_update.ref import as_int32
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

PyTree = Any

MIXING_STRATEGIES = ("static", "time_varying", "multi_round")
MOMENTUM_MIXINGS = ("none", "mixed")
COMPRESSOR_KINDS = ("none", "int8", "fp8", "topk", "rank")


# --------------------------------------------------------------------------
# MixingProgram: the configuration of the mixing-strategy layer
# --------------------------------------------------------------------------


def _check_exchange(exchange: str) -> str:
    """Fail at construction, not inside the first update."""
    if exchange not in flatbuf.EXCHANGE_DTYPES:
        raise ValueError(f"unknown exchange precision {exchange!r}; "
                         f"expected one of {flatbuf.EXCHANGE_DTYPES}")
    return exchange


def parse_compressor(spec: str):
    """``"none" | "int8" | "fp8" | "topk:p" | "topk:auto:B" | "rank:r"`` ->
    ``(kind, param)``: the density ``p in (0, 1]`` for ``topk``, ``("auto",
    B)`` for a per-neighbour byte budget ``B``, the int rank ``r >= 1`` for
    ``rank``, ``None`` for the dense kinds.  Malformed specs raise the JAX
    package's ``ValueError``."""
    if not isinstance(spec, str):
        raise TypeError(f"compressor spec must be a str, got "
                        f"{type(spec).__name__}")
    kind, _, arg = spec.partition(":")
    if kind not in COMPRESSOR_KINDS:
        raise ValueError(
            f"unknown compressor {spec!r}; expected one of "
            f"{COMPRESSOR_KINDS[:3]} or 'topk:p' (0 < p <= 1) or "
            "'rank:r' (int r >= 1)")
    if kind in ("none", "int8", "fp8"):
        if arg:
            raise ValueError(f"compressor {kind!r} takes no parameter "
                             f"(got {spec!r})")
        return kind, None
    if not arg:
        raise ValueError(
            f"compressor {kind!r} needs a parameter: "
            + ("'topk:p' with density 0 < p <= 1 (e.g. 'topk:0.01')"
               if kind == "topk" else
               "'rank:r' with int rank r >= 1 (e.g. 'rank:4')"))
    if kind == "topk":
        if arg.startswith("auto:") or arg == "auto":
            _, _, barg = arg.partition(":")
            try:
                budget = int(barg)
            except ValueError:
                raise ValueError(
                    f"topk:auto needs an int byte budget per neighbor, got "
                    f"{barg!r} in {spec!r} (e.g. 'topk:auto:65536')") from None
            if budget < 1:
                raise ValueError(f"topk:auto byte budget must be >= 1, got "
                                 f"{budget} in {spec!r}")
            return kind, ("auto", budget)
        try:
            p = float(arg)
        except ValueError:
            raise ValueError(f"top-k density must be a float, got {arg!r} "
                             f"in {spec!r}; for adaptive per-bucket density "
                             f"use 'topk:auto:B' with a byte budget") from None
        if not (0.0 < p <= 1.0):
            raise ValueError(f"top-k density must be in (0, 1], got {p!r} "
                             f"in {spec!r}")
        return kind, p
    try:
        r = int(arg)
    except ValueError:
        raise ValueError(f"rank must be an int, got {arg!r} in {spec!r}") \
            from None
    if r < 1:
        raise ValueError(f"rank must be >= 1, got {r} in {spec!r}")
    return kind, r


@dataclasses.dataclass(frozen=True)
class MixingProgram:
    """What the consensus exchange does each optimizer step.

    * ``strategy="static"`` — one fixed ``Pi``, one round (the paper's
      setting);
    * ``strategy="time_varying"`` — ``Pi_t = schedule[t % period]``
      selected by the optimizer step (B-connected sequences, gossip pairs);
    * ``strategy="multi_round"`` — ``rounds`` inner consensus rounds per
      gradient step, re-quantizing between rounds: ``x' = Pi^k x - a g``
      (i-CDSGD, Jiang et al. 1805.12120).  ``rounds`` also composes with
      ``time_varying`` (``Pi_t`` applied ``k`` times).

    ``error_feedback`` quantizes ``residual + payload`` instead of the raw
    payload and carries the quantization error in ``OptState.residual``
    (it needs an int8 / fp8 wire or a biased compressor).
    ``momentum_mixing="mixed"`` widens the wire to two payload trees: the
    momentum buffer (CDAdam: the first moment) rides next to the params
    and is mixed with the same ``Pi``, ``v' = mu (Pi v) - alpha g``; it
    doubles the wire bytes at equal precision.

    ``staleness=S`` / ``faults`` engage the bounded-staleness ring
    (``schedule="overlap"`` only): the overlap wire becomes a depth-``S``
    ring of each agent's last ``S`` quantized generations
    (:class:`WireRing`); under the injected
    :class:`~repro_torch.core.faults.FaultSchedule` each sender contributes
    its freshest generation that arrived (up to ``S`` steps stale) and the
    weights renormalize over arrived neighbours — a dropped or over-stale
    neighbour's mass folds into the receiver's self term.  The per-step
    wire bytes do not depend on ``S``.

    ``compressor`` is the compressor axis: the dense aliases ``"int8"`` /
    ``"fp8"`` (they set ``exchange`` and change nothing else) or the
    biased ``"topk:p"`` / ``"topk:auto:B"`` / ``"rank:r"``, which need
    error feedback.  ``sparse_update`` feeds the top-k wire's compact
    fields straight to the sparse update kernels; ``False`` keeps the
    dense decompress-then-update form.  Built by
    :func:`make_mixing_program`.
    """

    schedule: TopologySchedule
    strategy: str = "static"
    rounds: int = 1
    error_feedback: bool = False
    exchange: str = "f32"
    momentum_mixing: str = "none"
    staleness: int = 1
    faults: Optional[FaultSchedule] = None
    compressor: str = "none"
    sparse_update: bool = False

    @property
    def fault_tolerant(self) -> bool:
        """True iff the depth-S staleness ring / arrival-masked weight path
        is engaged (``staleness > 1`` or an injected fault schedule)."""
        return self.staleness > 1 or self.faults is not None

    @property
    def compressor_kind(self) -> str:
        return parse_compressor(self.compressor)[0]

    @property
    def compressor_param(self):
        """Density ``p`` or ``("auto", B)`` (topk), rank ``r`` (rank); None
        for the dense kinds."""
        return parse_compressor(self.compressor)[1]

    @property
    def compressed(self) -> bool:
        """True iff a biased (top-k / rank-r) compressor rides the wire."""
        return self.compressor_kind in ("topk", "rank")

    @property
    def is_trivial(self) -> bool:
        """True iff this is exactly the legacy single-round fixed-``Pi``
        program."""
        return (self.strategy == "static" and self.rounds == 1
                and not self.error_feedback
                and self.momentum_mixing == "none"
                and not self.fault_tolerant
                and not self.compressed)

    @property
    def n_payloads(self) -> int:
        """Payload trees on the wire: params, plus the mixed momentum."""
        return 2 if self.momentum_mixing == "mixed" else 1

    def describe(self) -> dict:
        return {
            "strategy": self.strategy,
            "schedule": self.schedule.name,
            "period": self.schedule.period,
            "rounds": self.rounds,
            "error_feedback": self.error_feedback,
            "exchange": self.exchange,
            "momentum_mixing": self.momentum_mixing,
            "staleness": self.staleness,
            "faults": self.faults.describe() if self.faults else None,
            "compressor": self.compressor,
            "sparse_update": self.sparse_update,
        }


def make_mixing_program(
    topology_or_schedule,
    *,
    strategy: str = "static",
    rounds: int = 1,
    error_feedback: bool = False,
    exchange: str = "f32",
    momentum_mixing: str = "none",
    staleness: int = 1,
    faults: Optional[FaultSchedule] = None,
    compressor: str = "none",
    sparse_update: Optional[bool] = None,
) -> MixingProgram:
    """Validate and build a :class:`MixingProgram` at config time.

    Takes a :class:`Topology` (wrapped in a period-1 schedule) or a
    :class:`TopologySchedule`.  The knobs are the JAX package's, checked
    in its order with its ``ValueError`` / ``TypeError``:
    ``strategy="static"`` with ``rounds > 1`` becomes ``"multi_round"``
    and ``"multi_round"`` with ``rounds=1`` becomes ``"static"``; the fixed
    strategies reject a schedule of period > 1; a trivial fault schedule is
    dropped; error feedback excludes the staleness ring.
    ``compressor="int8"|"fp8"`` are dense aliases that set ``exchange``;
    ``"topk:p"`` / ``"topk:auto:B"`` / ``"rank:r"`` need
    ``error_feedback=True`` and exclude staleness, inner rounds and
    momentum mixing; top-k sets ``exchange="int8"`` (its compact values)
    and rank keeps ``"f32"``.  ``sparse_update=None`` resolves to True
    exactly for top-k.
    """
    _check_exchange(exchange)
    ckind, _ = parse_compressor(compressor)
    if sparse_update is None:
        sparse_update = ckind == "topk"
    elif sparse_update and ckind != "topk":
        raise ValueError(
            f"sparse_update=True needs --compressor topk:p / topk:auto:B "
            f"(got {compressor!r}): only the top-k wire has the compact "
            "gather-dequant-accumulate operand form — drop sparse_update "
            "or switch to a top-k compressor")
    if ckind in ("int8", "fp8"):
        if exchange not in ("f32", ckind):
            raise ValueError(
                f"--compressor {ckind} conflicts with --exchange "
                f"{exchange}: the dense compressor aliases ARE the "
                f"quantized exchange — drop --exchange or set it to "
                f"{ckind!r}")
        exchange = ckind
    if ckind in ("topk", "rank"):
        exchange = _check_compressed(compressor, ckind, error_feedback,
                                     exchange, staleness, faults, rounds,
                                     strategy, momentum_mixing)
    if isinstance(topology_or_schedule, Topology):
        schedule = fixed_schedule(topology_or_schedule)
    elif isinstance(topology_or_schedule, TopologySchedule):
        schedule = topology_or_schedule
    else:
        raise TypeError(f"expected Topology or TopologySchedule, got "
                        f"{type(topology_or_schedule).__name__}")
    if not isinstance(rounds, int) or rounds < 1:
        raise ValueError(f"consensus rounds must be an int >= 1, got {rounds!r}")
    if strategy not in MIXING_STRATEGIES:
        raise ValueError(f"unknown mixing strategy {strategy!r}; expected one "
                         f"of {MIXING_STRATEGIES}")
    if strategy == "static" and rounds > 1:
        strategy = "multi_round"
    if strategy == "multi_round" and rounds == 1:
        strategy = "static"
    if strategy in ("static", "multi_round") and schedule.period != 1:
        raise ValueError(
            f"strategy={strategy!r} takes a fixed topology but the schedule "
            f"{schedule.name!r} has period {schedule.period}; use "
            "strategy='time_varying'")
    if error_feedback and exchange not in ("int8", "fp8") \
            and ckind not in ("topk", "rank"):
        raise ValueError(
            "--error-feedback needs a lossy wire to feed back: set "
            "--exchange int8/fp8 (quantization error) or --compressor "
            f"topk:p/rank:r (compression error); exchange={exchange!r} "
            "with a dense compressor has no error to carry")
    if momentum_mixing not in MOMENTUM_MIXINGS:
        raise ValueError(f"unknown momentum_mixing {momentum_mixing!r}; "
                         f"expected one of {MOMENTUM_MIXINGS}")
    if not isinstance(staleness, int) or staleness < 1:
        raise ValueError(f"staleness must be an int >= 1, got {staleness!r}")
    if faults is not None:
        if not isinstance(faults, FaultSchedule):
            raise TypeError(f"faults must be a FaultSchedule, got "
                            f"{type(faults).__name__}")
        if faults.n_agents != schedule.n_agents:
            raise ValueError(f"fault schedule covers {faults.n_agents} agents "
                             f"but the topology has {schedule.n_agents}")
        faults.validate()
        if faults.is_trivial:
            faults = None           # the all-arrive schedule: no fault layer
    if error_feedback and (staleness > 1 or faults is not None):
        raise ValueError(
            "--error-feedback is incompatible with --staleness > 1 / "
            "--fault-schedule: the residual telescoping assumes every "
            "carried wire payload is consumed exactly one step later, which "
            "bounded staleness breaks by design — drop --error-feedback "
            "(plain SR quantization is unbiased) or run staleness=1 with "
            "no fault schedule")
    return MixingProgram(schedule=schedule, strategy=strategy, rounds=rounds,
                         error_feedback=bool(error_feedback),
                         exchange=exchange, momentum_mixing=momentum_mixing,
                         staleness=staleness, faults=faults,
                         compressor=compressor,
                         sparse_update=bool(sparse_update))


def _check_compressed(compressor, ckind, error_feedback, exchange, staleness,
                      faults, rounds, strategy, momentum_mixing) -> str:
    """The biased compressors' rules (the JAX package's messages); returns
    the wire precision they set."""
    if not error_feedback:
        raise ValueError(
            f"--compressor {compressor} is a biased compressor and "
            "needs --error-feedback: without the EF residual "
            "(OptState.residual) the dropped mass accumulates and the "
            "consensus diverges (Karimireddy et al. 2019) — add "
            "--error-feedback, or use --compressor int8/fp8 for an "
            "unbiased dense wire")
    if staleness > 1 or faults is not None:
        raise ValueError(
            f"--compressor {compressor} is incompatible with "
            "--staleness > 1 / --fault-schedule: the EF residual "
            "telescoping it requires assumes every carried payload is "
            "consumed exactly one step later — use --compressor "
            "int8/fp8 (no EF) with the staleness ring instead")
    if rounds > 1 or strategy == "multi_round":
        raise ValueError(
            f"--compressor {compressor} is incompatible with "
            "--consensus-rounds > 1: inner i-CDSGD rounds re-compress "
            "partially mixed buffers without an EF residual to absorb "
            "the bias — use a single round, or --compressor int8/fp8 "
            "for multi-round")
    if momentum_mixing != "none":
        raise ValueError(
            f"--compressor {compressor} is incompatible with "
            "--momentum-mixing mixed: only the params payload rides "
            "the sparse/low-rank wire — use --compressor int8/fp8 to "
            "mix the momentum buffer, or momentum_mixing='none'")
    if ckind == "topk":
        if exchange not in ("f32", "int8"):
            raise ValueError(
                f"--compressor {compressor} ships int8 SR-quantized "
                f"compact values; --exchange {exchange} conflicts — "
                "drop --exchange (the compact-value precision is part "
                "of the top-k wire contract)")
        return "int8"
    if exchange != "f32":
        raise ValueError(
            f"--compressor {compressor} ships two dense f32 "
            f"factors; --exchange {exchange} conflicts — drop "
            "--exchange (quantizing the factors is not part of "
            "the rank-r wire contract)")
    return "f32"


# --------------------------------------------------------------------------
# wire seeds and payloads
# --------------------------------------------------------------------------

# distinct odd strides decorrelate the stochastic-rounding streams across
# steps, buckets, agents, inner consensus rounds and wire payloads (the JAX
# package's constants: the same seeds select each agent's stream)
_SEED_STEP_STRIDE = 1000003
_SEED_BUCKET_STRIDE = 7919
_SEED_AGENT_STRIDE = 104729
_SEED_ROUND_STRIDE = 611953
_SEED_PAYLOAD_STRIDE = 2750161


def wire_seed(step: int, agent: int = 0, bucket: int = 0, rnd: int = 0,
              payload: int = 0) -> int:
    """The stochastic-rounding seed of one quantized wire payload:

        seed = STEP * (step + ROUND * rnd) + AGENT * agent
             + BUCKET * bucket + PAYLOAD * payload      (mod 2^32)

    as a signed int32, the JAX package's composition bit for bit (Python
    ints are exact, so wrapping once at the end equals the reference's
    int64 arithmetic cast to int32; ``STEP * step`` alone leaves int32 from
    step 2148 on).
    """
    s = step + _SEED_ROUND_STRIDE * rnd
    return as_int32(_SEED_STEP_STRIDE * s + _SEED_AGENT_STRIDE * agent
                    + _SEED_BUCKET_STRIDE * bucket
                    + _SEED_PAYLOAD_STRIDE * payload)


def _wire_payload(buf: torch.Tensor, exchange: str) -> torch.Tensor:
    """The unquantized wire payload of one packed bucket: itself (f32, the
    native precision) or a bf16 cast."""
    return buf.to(torch.bfloat16) if exchange == "bf16" else buf


def _quantize_wire_stacked(bufs, seed: int, exchange: str, payload: int = 0,
                           rnd: int = 0):
    """Quantize agent-stacked ``(A, rows, 128)`` buckets for the wire.

    Returns the wire state: one ``(payload, (A, rows, 1) f32 scales)`` pair
    per bucket.  int8 / fp8 run one :func:`sr_quantize` launch per bucket
    for all agents, agent ``a`` of bucket ``bi`` seeded with
    ``wire_seed(seed, agent=a, bucket=bi, rnd=rnd, payload=payload)``
    (``rnd``: the inner consensus round).  f32 / bf16 wires cast and carry
    unit scales (the ``_q`` kernels' dequant multiply is then the
    identity), so every precision shares one wire layout.
    """
    if exchange in ("f32", "bf16"):
        return tuple(
            (_wire_payload(b, exchange),
             torch.ones(b.shape[:-1] + (1,), dtype=torch.float32,
                        device=b.device)) for b in bufs)
    return tuple(
        sr_quantize(b, wire_seed(seed, bucket=bi, rnd=rnd, payload=payload),
                    exchange, agent_stride=_SEED_AGENT_STRIDE)
        for bi, b in enumerate(bufs))


def _self_separated_weights(pi: np.ndarray) -> np.ndarray:
    """``[diag(Pi) | zero-diag Pi]`` — the quantized-form (A, A+1) weights."""
    n = pi.shape[0]
    pi = np.asarray(pi, np.float64)
    return np.concatenate([np.diag(pi)[:, None],
                           pi * (1.0 - np.eye(n))], axis=1)


# --------------------------------------------------------------------------
# compressed wire payloads (the biased EF-rail compressors)
# --------------------------------------------------------------------------


class TopKWire(NamedTuple):
    """The wire of one top-k-compressed bucket, every field crossing it:
    ``values`` int8 ``(A, k_rows, 128)``, ``indices`` int32 ``(A, k_rows,
    128)`` flat dense positions (``row * 128 + lane``, sorted ascending),
    ``scales`` f32 ``(A, k_rows, 1)``."""

    values: torch.Tensor
    indices: torch.Tensor
    scales: torch.Tensor


class RankWire(NamedTuple):
    """The wire of one rank-r-compressed bucket: the two f32 factors ``p
    (A, rows, r)`` and ``qt (A, r, 128)`` (reconstruction ``p @ qt``).
    The warm-start basis stays local, in ``OptState.qwarm``."""

    p: torch.Tensor
    qt: torch.Tensor


def _is_compressed_entry(entry) -> bool:
    return isinstance(entry, (TopKWire, RankWire))


def _decompress_entry(entry, rows: int) -> torch.Tensor:
    """Compressed wire entry -> dense f32 ``(A, rows, 128)`` bucket: the
    gather-dequant form the receivers (and the EF residual) apply."""
    if isinstance(entry, TopKWire):
        return tk.topk_decompress_2d(entry.values, entry.indices,
                                     entry.scales, rows)
    if isinstance(entry, RankWire):
        return tk.rank_decompress_2d(entry.p, entry.qt)
    raise TypeError(f"not a compressed wire entry: {type(entry).__name__}")


def _compress_wire_stacked(bufs, seed: int, program: MixingProgram, qwarm,
                           agent: int = 0):
    """Compress agent-stacked ``(A, rows, 128)`` buckets for the wire.

    Top-k: bucket ``bi``'s compact values take one ``sr_quantize`` launch
    for all agents, agent ``a`` seeded ``wire_seed(seed, agent=agent + a,
    bucket=bi)`` (the dense int8 wire's composition; ``agent``: the first
    agent's index, the rank of a one-agent stack).  Rank: one power
    iteration per bucket from its warm start.  Returns ``(wire, qwarm')``
    (``qwarm`` is ``()`` in and out for top-k).
    """
    kind, param = parse_compressor(program.compressor)
    if kind == "topk":
        k_list = tk.topk_k_rows_for([b.shape[-2] for b in bufs], param)
        wire = tuple(
            TopKWire(*tk.topk_compress_2d(
                b.float(), k_rows, wire_seed(seed, agent=agent, bucket=bi),
                agent_stride=_SEED_AGENT_STRIDE))
            for bi, (b, k_rows) in enumerate(zip(bufs, k_list)))
        return wire, ()
    wire, nq = [], []
    for b, q in zip(bufs, qwarm):
        p, qt, q2 = tk.rank_compress_2d(b.float(), q)
        wire.append(RankWire(p=p, qt=qt))
        nq.append(q2)
    return tuple(wire), tuple(nq)


def _qwarm_init_stacked(bufs, program: MixingProgram) -> tuple:
    """The rank compressor's warm starts: :func:`~repro_torch.kernels.
    consensus_update.topk.rank_init_q` broadcast to one ``(A, 128, r)``
    stack per bucket; ``()`` for every other program."""
    kind, param = parse_compressor(program.compressor)
    if kind != "rank":
        return ()
    out = []
    for b in bufs:
        q0 = tk.rank_init_q(param, device=b.device)
        out.append(q0.expand((b.shape[0],) + tuple(q0.shape)).clone())
    return tuple(out)


# --------------------------------------------------------------------------
# bounded-staleness wire ring (fault-tolerant overlap schedule)
# --------------------------------------------------------------------------


class WireRing(NamedTuple):
    """The overlap wire state of a fault-tolerant program, depth ``S``.

    * ``slots`` — one ``(payload, scales)`` pair per bucket (x payload
      tree), with a ring axis after the agent axis: ``(A, S, rows, 128)``.
      Ring index 0 is the agent's freshest quantized generation, index
      ``k`` is ``k`` steps older.  Slots are never re-quantized: each
      generation keeps the stochastic-rounding bits it was born with.
    * ``send_age`` — ``(A,)`` int32: the ring index each agent contributes
      this step (its freshest generation that escaped the straggler
      delays; ``S`` means nothing within the ring arrived and receivers
      mask it out).  One generation per sender, for all receivers.
    * ``ages`` — ``(A, A)`` int32: receiver row ``i``, the staleness minus
      one of what sender ``j`` delivered (sentinel ``S``: masked by a drop
      or over-stale; diagonal 0, the self term is always fresh).
    """

    slots: tuple
    send_age: torch.Tensor
    ages: torch.Tensor


def _ring_select(ring: WireRing, staleness: int):
    """Sender-side slot selection: ring -> plain per-bucket wire pairs.
    Each agent contributes ``ring[min(send_age, S-1)]``; a fully masked
    sender (``send_age == S``) selects the oldest slot, which every
    receiver weights zero."""
    sel = torch.clamp(ring.send_age.long(), max=staleness - 1)
    agents = torch.arange(sel.shape[0], device=sel.device)
    return tuple((p[agents, sel], sc[agents, sel]) for p, sc in ring.slots)


def _ring_push(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Shift one ring buffer: the fresh generation in, the oldest out."""
    return torch.cat([new[:, None], old[:, :-1]], dim=1)


def _fault_tables(program: MixingProgram) -> dict:
    """The fault path's host tables over the combined period ``P`` =
    lcm(schedule period, fault period), indexed by ``step % P``:

    * ``send_age (P, A)`` — steady state of the carried ``send_age``
      recurrence (valid because ``straggle[0]`` is all-False);
    * ``arrive (P, A, A)`` — receiver ``i`` uses sender ``j`` this step;
    * ``weights (P, A, A+1)`` — the arrival-masked, renormalized
      self-separated weights (:func:`~repro_torch.core.faults.
      arrival_masked_pi` of each schedule entry's ``Pi``);
    * ``ages (P, A, A)`` — the :class:`WireRing` bookkeeping rows;
    * ``straggle (P, A)`` — each agent's own straggle bit.
    """
    s = program.staleness
    sched = program.schedule
    f = program.faults or trivial_faults(sched.n_agents)
    tb = f.tables(s)
    pw = int(np.lcm(sched.period, f.period))
    if pw > MAX_FAULT_PERIOD:
        raise ValueError(
            f"combined schedule x fault period {pw} exceeds "
            f"{MAX_FAULT_PERIOD}; align the fault period with the "
            "topology schedule period")
    ts = np.arange(pw)
    straggle = f.straggle[ts % f.period]
    send_age = tb["send_age"][ts % f.period]
    arrive = tb["arrive"][ts % f.period]
    weights = np.stack([
        _self_separated_weights(arrival_masked_pi(
            sched.topologies[t % sched.period].pi, arrive[t]))
        for t in range(pw)])
    ages = np.where(arrive, send_age[:, None, :], s).astype(np.int32)
    di = np.arange(sched.n_agents)
    ages[:, di, di] = 0
    return {"period": pw, "S": s, "straggle": straggle,
            "send_age": send_age, "arrive": arrive,
            "weights": weights, "ages": ages}


class _FaultOps(NamedTuple):
    """The fault tables on the device, each selected by ``step % period``
    (a host int): ``weights``, one ``(A, A+1)`` f32 tensor per period step
    (each its own allocation: the kernels read weights 16-byte aligned),
    ``straggle (P, A)`` bool, ``ages (P, A, A)`` int32."""

    period: int
    S: int
    weights: tuple
    straggle: torch.Tensor
    ages: torch.Tensor


def _weight_rows(stack: np.ndarray, device) -> tuple:
    """One float32 device tensor per leading index of ``stack``: a row
    of a stacked table would start at any multiple of its size, and the
    update kernels take their weights 16-byte aligned."""
    return tuple(torch.tensor(w, dtype=torch.float32, device=device)
                 for w in stack)


# --------------------------------------------------------------------------
# the mixing strategies (stacked simulation)
# --------------------------------------------------------------------------


class MixingStrategy:
    """One consensus round of a (possibly step-indexed) ``Pi`` over the
    agent stack.

    ``pi`` is the dense ``(A, A)`` float32 ``Pi`` of the schedule's first
    entry (the trivial program's legacy form) and ``pi_q`` the
    self-separated ``(A, A+1)`` weights of every schedule entry (a tuple,
    one tensor per entry), all on the device the buffers live on; ``fault_ops`` carries the
    fault path's tables (``None``: fault-free).  The wire state is a tuple
    of ``(payload, scales)`` per bucket with the leading agent axis kept
    (under momentum mixing the params' pairs, then the momentum's; under a
    compressor, one :class:`TopKWire` / :class:`RankWire` per bucket), or
    a :class:`WireRing` of them on the fault path.
    """

    name = "static"

    def __init__(self, program: MixingProgram, pi: torch.Tensor,
                 pi_q: tuple, fault_ops: Optional[_FaultOps] = None):
        self.program = program
        self.rounds = program.rounds
        self.pi = pi
        self.pi_q = pi_q
        self.fault_ops = fault_ops
        self.compressed = program.compressed
        # the dense row count of every bucket: the compact top-k payload
        # cannot recover it, so every bufs-seeing stage records it
        self._rows = None

    # -- schedule indexing ---------------------------------------------------
    def _entry(self, step) -> int:
        """The schedule entry of optimizer step ``step`` (static: 0)."""
        return 0

    def _note_bufs(self, bufs):
        """Record the dense bucket row counts the decompressors need."""
        if self.compressed:
            self._rows = [int(b.shape[-2]) for b in bufs]

    def _rows_of(self, bi: int) -> int:
        if self._rows is None:
            raise RuntimeError(
                "compressed exchange before any bufs-seeing stage: call "
                "quantize_stage/compress_ef (or continue_from_wire) once so "
                "the strategy records the dense bucket row counts")
        return self._rows[bi]

    def _quantize_payloads(self, bufs, seed: int, rnd: int = 0):
        """Quantize the wire payload(s) of round ``rnd``: params, plus (under
        momentum mixing, ``bufs = params_bufs + momentum_bufs``) the
        momentum half at ``payload=1`` (seed stride 2750161), so the two
        payloads' rounding stays independent."""
        exchange = self.program.exchange
        if self.program.momentum_mixing != "mixed":
            return _quantize_wire_stacked(bufs, seed, exchange, rnd=rnd)
        b = len(bufs) // 2
        return (_quantize_wire_stacked(bufs[:b], seed, exchange, rnd=rnd)
                + _quantize_wire_stacked(bufs[b:], seed, exchange, payload=1,
                                         rnd=rnd))

    def _compress(self, bufs, seed: int, qwarm):
        """``(wire, qwarm')`` of the program's compressor on ``bufs``."""
        return _compress_wire_stacked(bufs, seed, self.program, qwarm)

    def _qwarm_init(self, bufs) -> tuple:
        return _qwarm_init_stacked(bufs, self.program)

    def quantize_stage(self, bufs, seed: int):
        """Packed buckets -> the wire state (seed: the optimizer step).

        A compressed program reaches this only from :meth:`initial_wire`
        (the seed -1 priming; every step compresses through
        :meth:`compress_ef`), with the initial warm start.
        """
        if self.compressed:
            self._note_bufs(bufs)
            wire, _ = self._compress(bufs, seed, self._qwarm_init(bufs))
            return wire
        return self._quantize_payloads(bufs, seed)

    def _exchange_t(self, wire, t: int):
        """One round of exchange under schedule entry ``t``: in the stacked
        simulation every agent already sees the whole stack, so the
        exchange hands the payloads to the kernels with the self-separated
        weights ``pi_q[t]``."""
        nbrs, scs = self._operands(wire)
        return nbrs, self.pi_q[t], scs

    def _operands(self, stacks):
        """Wire entries stacked over the senders -> the kernels' neighbour
        operands and scales, one per bucket.  A top-k entry under
        ``sparse_update`` becomes a :class:`SparseNeighbors` (scales
        ``None``: they ride inside); other compressed entries decompress to
        dense f32 stacks with unit scales."""
        nbrs, scs = [], []
        for bi, e in enumerate(stacks):
            if isinstance(e, TopKWire) and self.program.sparse_update:
                nbrs.append(SparseNeighbors(e.values, e.indices, e.scales))
                scs.append(None)
            elif _is_compressed_entry(e):
                d = _decompress_entry(e, self._rows_of(bi))
                nbrs.append(d)
                scs.append(torch.ones(d.shape[:-1] + (1,),
                                      dtype=torch.float32, device=d.device))
            else:
                nbrs.append(e[0])
                scs.append(e[1])
        return nbrs, scs

    def _ring_select(self, ring: WireRing):
        return _ring_select(ring, self.fault_ops.S)

    def post_exchange(self, wire, step):
        """Start the exchange of a carried ``wire`` before the grad phase
        (the overlap schedule).  The stacked simulation has nothing to
        move: the wire itself is the exchange's input."""
        return wire

    def exchange_stage(self, wire, step=None):
        """Wire state -> ``(payloads, weights_q, scales)`` of one round.

        On the fault path ``wire`` is the carried :class:`WireRing` (round
        1: each sender's selected slot is exchanged) or a freshly quantized
        tuple (inner rounds: a masked sender's live transmissions miss the
        whole step, so the same arrival mask applies); either way the
        weights are the step's arrival-masked row.
        """
        fo = self.fault_ops
        if fo is None:
            return self._exchange_t(wire, self._entry(step))
        if step is None:
            raise ValueError("fault-tolerant mixing needs the optimizer "
                             "step; exchange_stage(wire, step)")
        if isinstance(wire, WireRing):
            wire = self._ring_select(wire)
        nbrs, _, scs = self._exchange_t(wire, self._entry(step))
        return nbrs, fo.weights[step % fo.period], scs

    def combine(self, nbrs, weights_q, scales, selfs):
        """Full-precision one-round mix of the agent stack (inner rounds):
        ``mixed_j = sum_l w[j,1+l] dequant(payload_l) + w[j,0] self_j``, the
        sum the fused kernels evaluate, materialized because the next
        round re-quantizes it.  The sum runs in float64 in ``l`` order and
        rounds to float32 once: a float32 weight times a float32 operand is
        exact in float64, so each ``addcmul_`` rounds once whether or not
        the device fuses it, and the card and the CPU produce the same bits
        (and re-quantize the mix to the same codes).  The sum is also
        nearly the exact one, which keeps it next to the reference's
        float32 einsum: a float32 sum rounded term by term differs from
        that in the last bits, which after 10 steps of two-round CDSGD (5
        agents, a 6 x 50 MLP) left the parameters 2.1e-5 from the
        reference's (float64: 3.0e-7)."""
        out = []
        w = weights_q.double()[:, :, None, None]             # (A, S+1, 1, 1)
        for p, sc, sf in zip(nbrs, scales, selfs):
            mixed = w[:, 1] * (p[0].float() * sc[0]).double()
            for l in range(1, p.shape[0]):
                mixed.addcmul_(w[:, 1 + l], (p[l].float() * sc[l]).double())
            mixed.addcmul_(w[:, 0], sf.double())
            out.append(mixed.to(sf.dtype))
        return out

    # -- carried wire state (schedule="overlap") -----------------------------
    def advance_wire(self, bufs, old_wire, step: int):
        """The wire state step ``step + 1`` consumes (overlap).

        Fault-free: the current buckets, quantized; the old wire is
        dropped.  Fault path: the fresh generation is pushed into the
        :class:`WireRing` and the age counters advance by the recurrence
        whose steady state is the ``send_age`` table (``a' = min(a + 1,
        S)`` while straggling, else 0).
        """
        fresh = self.quantize_stage(bufs, step)
        fo = self.fault_ops
        if fo is None:
            return fresh
        slots = tuple((_ring_push(op, p), _ring_push(osc, sc))
                      for (op, osc), (p, sc) in zip(old_wire.slots, fresh))
        t1 = (step + 1) % fo.period
        send_age = torch.where(
            fo.straggle[t1], torch.clamp(old_wire.send_age + 1, max=fo.S),
            torch.zeros_like(old_wire.send_age)).to(torch.int32)
        return WireRing(slots=slots, send_age=send_age, ages=fo.ages[t1])

    def initial_wire(self, bufs):
        """The wire state priming step 0: ``x_{-1} := x_0``, seed ``-1``.
        Fault path: that one generation replicated across the ring slots
        (one draw, copied), ``send_age`` 0 for every agent (``straggle[0]``
        is all-False) and the first ages row."""
        wire = self.quantize_stage(bufs, -1)
        fo = self.fault_ops
        if fo is None:
            return wire
        slots = tuple((torch.repeat_interleave(p[:, None], fo.S, dim=1),
                       torch.repeat_interleave(sc[:, None], fo.S, dim=1))
                      for p, sc in wire)
        n = slots[0][0].shape[0]
        send_age = torch.zeros((n,), dtype=torch.int32,
                               device=slots[0][0].device)
        return WireRing(slots=slots, send_age=send_age, ages=fo.ages[0])

    def continue_from_wire(self, bufs, wire, step):
        """Rounds ``1..k`` of the step, round 1 from ``wire`` (fresh under
        sync, carried under overlap).  Returns the last round's kernel
        operands ``(nbrs, weights, scales, selfs)``, ``selfs`` the round
        ``k-1`` mix (the fresh native buckets for one round): the fused
        kernel applies round ``k`` and the gradient in one launch.  Round
        ``r`` (0-based) re-quantizes at ``wire_seed(step, rnd=r)``."""
        self._note_bufs(bufs)
        nbrs, w, sc = self.exchange_stage(wire, step)
        if self.rounds == 1:
            return nbrs, w, sc, list(bufs)
        b = self.combine(nbrs, w, sc, bufs)                     # round 1
        for r in range(1, self.rounds - 1):
            wire_r = self._quantize_payloads(b, step, rnd=r)
            nb, wr, scr = self.exchange_stage(wire_r, step)
            b = self.combine(nb, wr, scr, b)
        wire_k = self._quantize_payloads(b, step, rnd=self.rounds - 1)
        nbrs, w, sc = self.exchange_stage(wire_k, step)
        return nbrs, w, sc, b

    def gather(self, bufs, seed: int):
        """One-shot sync form.  The trivial program on an f32 / bf16 wire:
        the legacy dense operands (the whole stack, cast for bf16, with the
        dense ``Pi``; no scales, no selfs).  Otherwise: quantize the
        current buckets and run every round.  A momentum-mixing program
        has no one-shot form: its momentum payload comes from the
        optimizer state, which the engine packs."""
        if self.program.momentum_mixing == "mixed":
            raise ValueError(
                "momentum_mixing='mixed' needs the StepProgram engine's "
                "staged exchange (CollaborativeTrainer); the optimizer "
                "cannot gather the momentum payload itself")
        exchange = self.program.exchange
        if self.program.is_trivial and exchange in ("f32", "bf16"):
            return ([_wire_payload(b, exchange) for b in bufs], self.pi,
                    [None] * len(bufs), [None] * len(bufs))
        return self.continue_from_wire(
            bufs, self._quantize_payloads(bufs, seed), seed)

    def wire_to_bufs(self, wire):
        """Local dequantization (decompression) of a wire state, f32."""
        return [_decompress_entry(e, self._rows_of(bi))
                if _is_compressed_entry(e) else e[0].float() * e[1]
                for bi, e in enumerate(wire)]

    def quantize_ef(self, bufs, seed: int, residual):
        """Error-feedback quantization ``Q(x + e)``: returns ``(wire,
        new_residual)`` with ``new_residual = (x + e) - dequant(Q(x + e))``,
        so the quantization error telescopes instead of accumulating.  It
        applies to the round-1 payload(s) only: inner rounds' payloads are
        fresh each step."""
        carried = [b.float() + e for b, e in zip(bufs, residual)]
        wire = self.quantize_stage(carried, seed)
        deq = self.wire_to_bufs(wire)
        return wire, tuple(c - d for c, d in zip(carried, deq))

    def compress_ef(self, bufs, seed: int, residual, qwarm):
        """The compressor-axis form of :meth:`quantize_ef`: ``C(x + e)``
        for the program's compressor, returning ``(wire, new_residual,
        new_qwarm)`` with ``new_residual = (x + e) - decompress(C(x +
        e))``.  Dense programs quantize and pass ``qwarm`` through, so the
        engine calls this at both error-feedback sites."""
        if not self.compressed:
            wire, new_residual = self.quantize_ef(bufs, seed, residual)
            return wire, new_residual, qwarm
        self._note_bufs(bufs)
        carried = [b.float() + e for b, e in zip(bufs, residual)]
        wire, new_qwarm = self._compress(carried, seed, qwarm)
        deq = self.wire_to_bufs(wire)
        return (wire, tuple(c - d for c, d in zip(carried, deq)),
                new_qwarm)

    def residual_init(self, bufs):
        """Zero f32 residuals, one per packed bucket (agent axis kept)."""
        self._note_bufs(bufs)
        return tuple(torch.zeros(b.shape, dtype=torch.float32, device=b.device)
                     for b in bufs)

    def qwarm_init(self, bufs):
        """``OptState.qwarm`` at init: the rank compressor's per-bucket
        ``(A, 128, r)`` basis, ``()`` for every other program."""
        if not self.compressed:
            return ()
        self._note_bufs(bufs)
        return self._qwarm_init(bufs)


class StaticMixing(MixingStrategy):
    """The paper's fixed ``Pi``, one round."""

    name = "static"


class TimeVaryingMixing(MixingStrategy):
    """``Pi_t = schedule[t % period]`` selected by the optimizer step: the
    self-separated weights are entry ``t % period`` of ``pi_q``."""

    name = "time_varying"

    def _entry(self, step) -> int:
        if step is None:
            raise ValueError("TimeVaryingMixing needs the optimizer step to "
                             "select Pi_t; exchange_stage(wire, step)")
        return step % self.program.schedule.period


class MultiRoundMixing(MixingStrategy):
    """``rounds`` inner consensus rounds per gradient step (i-CDSGD):
    ``x' = Pi^k x - alpha g``; rounds ``1..k-1`` mix in full precision
    between re-quantizations, round ``k`` is fused into the update kernel.
    The wire moves exactly ``k`` times the single-round bytes."""

    name = "multi_round"


def _make_strategy(program: MixingProgram, *args, **kw) -> MixingStrategy:
    if program.strategy == "time_varying":
        return TimeVaryingMixing(program, *args, **kw)
    if program.strategy == "multi_round" and program.rounds > 1:
        return MultiRoundMixing(program, *args, **kw)
    return StaticMixing(program, *args, **kw)


@dataclasses.dataclass(frozen=True)
class FlatComm:
    """Whole-model fused-update support carried inside ``CommOps``.

    ``gather(bufs, seed) -> (neighbor_stacks, weights, scales, selfs)`` maps
    the packed self-buffers to kernel-ready operands (see
    :meth:`MixingStrategy.gather`); ``strategy`` carries the same
    computation as separately schedulable stages (``quantize_stage``,
    ``exchange_stage``) and the overlap and error-feedback hooks the
    :mod:`repro_torch.core.engine` schedules.
    """

    lead: int                     # leading replica axes excluded from packing
    gather: Callable
    strategy: MixingStrategy
    program: MixingProgram

    def spec(self, tree: PyTree) -> flatbuf.FlatSpec:
        return flatbuf.make_flat_spec(tree, lead=self.lead)

    def pack(self, tree: PyTree, spec: flatbuf.FlatSpec):
        return flatbuf.pack(tree, spec)

    def unpack(self, bufs, spec: flatbuf.FlatSpec) -> PyTree:
        return flatbuf.unpack(bufs, spec)


def stacked_flat_comm(topology: Topology, *, exchange: str = "f32",
                      program: Optional[MixingProgram] = None,
                      device=None) -> FlatComm:
    """FlatComm for agent-stacked trees (dense ``Pi``, any topology) on
    ``device`` (``cuda`` unless ``device`` says otherwise).  ``program``
    defaults to the trivial static program over ``topology``; its schedule
    supplies the per-step ``Pi_t`` of a time-varying strategy, and a
    fault-tolerant program's tables (:func:`_fault_tables`) go to the
    device here, once."""
    if program is None:
        program = make_mixing_program(topology, exchange=exchange)
    dev = resolve_device(device)
    schedule = program.schedule
    pi_q = np.stack([_self_separated_weights(t.pi)
                     for t in schedule.topologies])
    fault_ops = None
    if program.fault_tolerant:
        ft = _fault_tables(program)
        fault_ops = _FaultOps(
            period=ft["period"], S=ft["S"],
            weights=_weight_rows(ft["weights"], dev),
            straggle=torch.tensor(ft["straggle"], device=dev),
            ages=torch.tensor(ft["ages"], dtype=torch.int32, device=dev))
    strategy = _make_strategy(
        program,
        torch.tensor(schedule.topologies[0].pi, dtype=torch.float32,
                     device=dev),
        _weight_rows(pi_q, dev), fault_ops)
    return FlatComm(lead=1, gather=strategy.gather, strategy=strategy,
                    program=program)


def widen_with_momentum(fl: FlatComm, bufs, momentum_bufs=None):
    """The strategy-facing bucket list: ``bufs``, and under momentum mixing
    the momentum buckets after them (equal halves, the momentum packed
    against the params' spec).  ``momentum_bufs=None`` appends zeros, the
    initializer convention ``v_{-1} := v_0 = 0``."""
    if fl.program.momentum_mixing != "mixed":
        if momentum_bufs is not None:
            raise ValueError("momentum payload without a momentum-mixing "
                             "program")
        return list(bufs)
    if momentum_bufs is None:
        momentum_bufs = [torch.zeros_like(b) for b in bufs]
    if len(momentum_bufs) != len(bufs):
        raise ValueError(f"{len(momentum_bufs)} momentum buckets for "
                         f"{len(bufs)} param buckets")
    return list(bufs) + list(momentum_bufs)


def _packed(fl: FlatComm, params: PyTree):
    return widen_with_momentum(
        fl, flatbuf.pack(params, flatbuf.make_flat_spec(params, lead=fl.lead)))


def initial_wire_state(fl: FlatComm, params: PyTree) -> tuple:
    """Wire state priming the ``schedule="overlap"`` double buffer: the
    initial params (and zero momentum, under momentum mixing) quantized
    with seed ``-1`` (``x_{-1} := x_0``)."""
    return fl.strategy.initial_wire(_packed(fl, params))


def initial_residual_state(fl: FlatComm, params: PyTree) -> tuple:
    """Zero error-feedback residuals, one f32 buffer per packed bucket per
    wire payload."""
    return fl.strategy.residual_init(_packed(fl, params))


def initial_qwarm_state(fl: FlatComm, params: PyTree) -> tuple:
    """The compressor's warm-start state: one ``(A, 128, r)`` basis per
    bucket under ``rank:r`` (identical across agents and buckets), ``()``
    otherwise.  Independent of :func:`initial_wire_state`, whose seed -1
    compression discards its warm-start output."""
    if not fl.program.compressed:
        return ()
    return fl.strategy.qwarm_init(_packed(fl, params))


# --------------------------------------------------------------------------
# the sharded mode: one agent per process
# --------------------------------------------------------------------------

class _StencilPlan(NamedTuple):
    """One schedule entry's exchange, seen from one agent ``a``:

    * ``shifts`` — the non-identity shifts (ints on a one-axis mesh, one
      offset per agent axis on a factored mesh), ordered by their sender
      (``senders``, ascending);
    * ``weights_q`` — ``(U+1,)`` float32: ``Pi[a, a]``, then ``Pi[a,
      sender]`` in that order (the self-separated ``_q`` form);
    * ``stencil`` / ``weights`` — the legacy dense form: the senders and
      ``a`` itself in ascending order, and ``Pi[a, j]`` over them.

    Ordered by sender, the kernels' ``acc + w x`` sum runs over the terms
    of the stacked simulation's row ``a`` in the same order, minus its
    zero-weight terms, which add exact zeros: the same float32 result."""

    shifts: tuple
    senders: tuple
    weights_q: torch.Tensor
    stencil: tuple
    weights: torch.Tensor


def _factor_shifts(factors, mesh) -> list:
    """``[(shift, sender)]`` of this agent for every non-identity
    combination of the factors' circulant shifts (the reference's
    ``_combos``), ordered by sender (an agent index): an int shift on a
    mesh of one agent axis, else one offset per agent axis.  A factor of
    one agent moves nothing; a ``model`` axis never shifts."""
    names, per_axis = [], []
    for axis, topo in factors:
        if topo.n_agents == 1:
            continue
        shifts = topo.shift_weights()
        if shifts is None:
            raise ValueError(
                f"topology {topo.name!r} on axis {axis!r} is not circulant; "
                "the sharded exchange permutes along circulant shifts (use "
                "mixing='ppermute' or 'dense' for a general Pi)")
        names.append(axis)
        per_axis.append(sorted({s % topo.n_agents for s in shifts}))
    out = []
    for combo in itertools.product(*per_axis):
        if not any(combo):
            continue
        by_axis = dict(zip(names, combo))
        full = tuple(by_axis.get(a, 0) for a in mesh.agent_axes)
        shift = full[0] if len(full) == 1 else full
        out.append((shift, mesh.agent_of(mesh.peers(shift)[1])))
    return sorted(out, key=lambda x: x[1])


def _stencil_plan(pi: np.ndarray, factors, mesh, name: str) -> _StencilPlan:
    agent = mesh.agent
    wire = _factor_shifts(factors, mesh)
    if not wire:
        raise ValueError(f"topology {name!r} has no neighbours: the "
                         "exchange needs at least one wire-crossing shift")
    senders = tuple(j for _, j in wire)
    stencil = tuple(sorted(senders + (agent,)))
    dev = mesh.device
    return _StencilPlan(
        shifts=tuple(s for s, _ in wire), senders=senders,
        weights_q=torch.tensor([pi[agent, agent]] + [pi[agent, j]
                                                      for j in senders],
                               dtype=torch.float32, device=dev),
        stencil=stencil,
        weights=torch.tensor([pi[agent, j] for j in stencil],
                             dtype=torch.float32, device=dev))


class _PostedWire(NamedTuple):
    """A wire exchange in flight: the schedule entry, the pending transfers,
    what they land in (one entry per bucket, each field stacked over the
    senders in sender order: ``(payloads (U, rows, 128), scales (U, rows,
    1))``, a :class:`TopKWire` or a :class:`RankWire`) and the carried
    wire state it was posted from (a :class:`WireRing` keeps its stale
    slots)."""

    entry: int
    pending: Any
    received: list
    source: Any


def _as_lead(b: torch.Tensor) -> torch.Tensor:
    """A local bucket ``(rows, 128)`` (or already ``(1, rows, 128)``) with
    the size-1 agent axis the wire state keeps."""
    return b.reshape((1,) + tuple(b.shape[-2:]))


def _wire_fields(entry, quantized: bool) -> list:
    """The tensors of one wire entry that cross the wire, without the
    agent axis: every field of a compressed entry, the payload and (int8 /
    fp8) its row scales of a dense pair."""
    if _is_compressed_entry(entry):
        return [f[0] for f in entry]
    p, sc = entry
    return [p[0], sc[0]] if quantized else [p[0]]


class ShardedMixing(MixingStrategy):
    """The mixing strategy of one agent (``mesh.agent``) of the sharded
    mode: on a mesh with a ``model`` axis, this rank's shard of the agent,
    exchanged with the ranks of its ``model`` coordinate.

    The stages of :class:`MixingStrategy` over this agent's packed buckets
    ``(rows, 128)``; the wire state keeps a leading agent axis of 1 (one
    ``(payload (1, rows, 128), scales (1, rows, 1))`` pair per bucket, the
    reference's ``_restore_lead``; a :class:`TopKWire` / :class:`RankWire`
    of ``(1, ...)`` fields; a :class:`WireRing` of ``(1, S, rows, 128)``
    slots with ``send_age (1,)`` and ``ages (1, A)``), as do the
    error-feedback residuals and the rank compressor's ``(1, 128, r)``
    warm start.

    * quantization and top-k compression seed agent ``rank``'s stream,
      ``wire_seed(step, agent=rank, bucket, rnd, payload)``:
      ``sr_quantize``'s counter is the index within the agent's own
      bucket, so the codes equal the stacked launch's codes for this agent
      bit for bit;
    * the exchange posts one transfer per non-identity shift (combination,
      on a factored mesh) of the step's schedule entry per bucket per wire
      field (the payload, the row scales of an int8 / fp8 wire, the three
      compact top-k fields, the two rank factors; unit scales are made
      locally) in one :func:`~repro_torch.core.collectives.ppermute`, and
      hands the fused kernels the received stencil in sender order with
      this agent's row of the step's weights restricted to its senders
      (:class:`_StencilPlan`); a top-k stack under ``sparse_update`` goes
      to the sparse kernels at one output agent as it arrived;
    * on the fault path the weights are this agent's row of the
      arrival-masked table (the stacked simulation's row, the masked
      senders' mass in the self weight), and the sender ships the slot of
      its ring that it selects, ``ring[min(send_age, S - 1)]``, a view:
      the ring deepens local state, never the wire;
    * :meth:`post_exchange` starts the exchange of a carried wire before
      the grad phase (overlap); :meth:`exchange_stage` waits on it;
    * the trivial program on an f32 / bf16 wire keeps the legacy dense form
      under the sync schedule: the stencil ``senders + self`` in ascending
      order with the dense row of ``Pi``.
    """

    def __init__(self, program: MixingProgram, mesh, plans,
                 fault_ops: Optional[_FaultOps] = None):
        super().__init__(program, pi=None, pi_q=None, fault_ops=fault_ops)
        self.name = program.strategy
        self.mesh = mesh
        self.plans = plans

    def _entry(self, step) -> int:
        if self.program.strategy != "time_varying":
            return 0
        if step is None:
            raise ValueError("time-varying mixing needs the optimizer step "
                             "to select Pi_t; exchange_stage(wire, step)")
        return step % self.program.schedule.period

    def _quantize_payloads(self, bufs, seed: int, rnd: int = 0):
        exchange = self.program.exchange
        agent = self.mesh.agent

        def quantize(bs, payload):
            out = []
            for bi, b in enumerate(bs):
                b = _as_lead(b)
                if exchange in ("f32", "bf16"):
                    out.append((_wire_payload(b, exchange),
                                torch.ones(b.shape[:-1] + (1,),
                                           dtype=torch.float32,
                                           device=b.device)))
                else:
                    out.append(sr_quantize(
                        b, wire_seed(seed, agent=agent, bucket=bi, rnd=rnd,
                                     payload=payload), exchange))
            return tuple(out)

        if self.program.momentum_mixing != "mixed":
            return quantize(bufs, 0)
        half = len(bufs) // 2
        return quantize(bufs[:half], 0) + quantize(bufs[half:], 1)

    def _compress(self, bufs, seed: int, qwarm):
        return _compress_wire_stacked([_as_lead(b) for b in bufs], seed,
                                      self.program, qwarm,
                                      agent=self.mesh.agent)

    def _qwarm_init(self, bufs) -> tuple:
        return _qwarm_init_stacked([_as_lead(b) for b in bufs], self.program)

    def _ring_select(self, ring: WireRing):
        """This agent's slot of its ring, ``min(send_age, S - 1)``, as a
        view of the slot (one ``(1, rows, 128)`` pair per bucket)."""
        sel = min(int(ring.send_age[0]), self.fault_ops.S - 1)
        return tuple((p[:, sel], sc[:, sel]) for p, sc in ring.slots)

    def _post(self, wire, t: int, source=None) -> _PostedWire:
        plan = self.plans[t]
        u = len(plan.shifts)
        quantized = self.program.exchange in ("int8", "fp8")
        items, outs, received = [], [], []
        for e in wire:
            fields = _wire_fields(e, quantized)
            stacks = [x.new_empty((u,) + tuple(x.shape)) for x in fields]
            items.extend(fields)
            outs.extend(list(st.unbind(0)) for st in stacks)
            if _is_compressed_entry(e):
                received.append(type(e)(*stacks))
            elif quantized:
                received.append(tuple(stacks))
            else:
                sc = e[1][0]
                received.append((stacks[0], torch.ones(
                    (u,) + tuple(sc.shape), dtype=torch.float32,
                    device=sc.device)))
        pending = collectives.ppermute(self.mesh, items, plan.shifts, out=outs)
        return _PostedWire(t, pending, received, source)

    def post_exchange(self, wire, step):
        source = wire
        if isinstance(wire, WireRing):
            wire = self._ring_select(wire)
        return self._post(wire, self._entry(step), source)

    def _exchange_t(self, wire, t: int):
        posted = wire if isinstance(wire, _PostedWire) else self._post(wire, t)
        if posted.entry != t:
            raise ValueError(f"the wire was posted for schedule entry "
                             f"{posted.entry}, consumed at entry {t}")
        posted.pending.wait()
        nbrs, scs = self._operands(posted.received)
        return nbrs, self.plans[t].weights_q, scs

    def advance_wire(self, bufs, old_wire, step: int):
        if isinstance(old_wire, _PostedWire):
            old_wire = old_wire.source
        return super().advance_wire(bufs, old_wire, step)

    def combine(self, nbrs, weights_q, scales, selfs):
        """The stacked :meth:`MixingStrategy.combine` of this agent's row:
        float64 over the senders in order, then the self term, rounded
        once."""
        out = []
        w = weights_q.double()
        for p, sc, sf in zip(nbrs, scales, selfs):
            mixed = w[1] * (p[0].float() * sc[0]).double()
            for k in range(1, p.shape[0]):
                mixed.addcmul_(w[1 + k], (p[k].float() * sc[k]).double())
            mixed.addcmul_(w[0], sf.double())
            out.append(mixed.to(sf.dtype))
        return out

    def gather(self, bufs, seed: int):
        exchange = self.program.exchange
        if self.program.momentum_mixing == "mixed" or not (
                self.program.is_trivial and exchange in ("f32", "bf16")):
            return super().gather(bufs, seed)
        plan = self.plans[0]
        me = plan.stencil.index(self.mesh.agent)
        where = [plan.stencil.index(j) for j in plan.senders]
        items, outs, stencils = [], [], []
        for b in bufs:
            x = _wire_payload(b, exchange)
            st = x.new_empty((len(plan.stencil),) + tuple(x.shape))
            st[me].copy_(x)
            items.append(x)
            outs.append([st[i] for i in where])
            stencils.append(st)
        collectives.ppermute(self.mesh, items, plan.shifts, out=outs).wait()
        return stencils, plan.weights, [None] * len(bufs), [None] * len(bufs)

    def residual_init(self, bufs):
        self._note_bufs(bufs)
        return tuple(torch.zeros(_as_lead(b).shape, dtype=torch.float32,
                                 device=b.device) for b in bufs)


def _sharded_fault_ops(program: MixingProgram, plans, agent: int,
                       device) -> _FaultOps:
    """Agent ``agent``'s share of :func:`_fault_tables`: per period step its
    row of the arrival-masked self-separated weights restricted to the
    step's senders in stencil order (the stacked row's values: masked
    senders weigh 0, their mass is in the self weight), its straggle
    column ``(P, 1)`` and its ages row ``(P, 1, A)``."""
    ft = _fault_tables(program)
    period = program.schedule.period
    tv = program.strategy == "time_varying"
    rows = []
    for t in range(ft["period"]):
        row = ft["weights"][t, agent]
        plan = plans[t % period if tv else 0]
        rows.append([row[0]] + [row[1 + j] for j in plan.senders])
    return _FaultOps(
        period=ft["period"], S=ft["S"],
        weights=tuple(torch.tensor(r, dtype=torch.float32, device=device)
                      for r in rows),
        straggle=torch.tensor(ft["straggle"][:, agent:agent + 1],
                              device=device),
        ages=torch.tensor(ft["ages"][:, agent:agent + 1], dtype=torch.int32,
                          device=device))


def sharded_flat_comm(topology: Topology, mesh, *, exchange: str = "f32",
                      program: Optional[MixingProgram] = None,
                      factors: Optional[Sequence[Tuple[str, Topology]]] = None
                      ) -> FlatComm:
    """FlatComm of agent ``mesh.agent`` of the sharded mode, circulant
    topologies only (the reference's ``sharded_flat_comm``): on a mesh with
    a ``model`` axis this rank packs its shard of the agent's params and
    exchanges it with the ranks of its ``model`` coordinate.

    ``factors`` (``[(axis, Topology)]``, one per agent axis of a factored
    mesh, :class:`FactoredMix`) replaces ``topology``'s one circulant
    factor on the mesh's one axis: each bucket then costs one transfer per
    non-identity shift combination, weighted by the product of the factor
    weights (``Pi = kron`` of the factors; ``topology`` is that product).
    ``program`` defaults to the trivial static program over ``topology``;
    a time-varying one exchanges each step along its entry's shifts only,
    and a fault-tolerant one weighs by this agent's row of the
    arrival-masked table.  Both need a single agent mesh axis."""
    if program is None:
        program = make_mixing_program(topology, exchange=exchange)
    if program.schedule.n_agents != mesh.n_agents:
        raise ValueError(f"the topology spans {program.schedule.n_agents} "
                         f"agents, the mesh {mesh.n_agents}")
    live = [a for a, t in (factors or ()) if t.n_agents > 1]
    if len(live) > 1:
        axes = [a for a, _ in factors]
        if program.strategy == "time_varying":
            raise ValueError(
                "time-varying mixing supports a single agent mesh axis "
                f"(got {axes}); factored multi-axis meshes need per-axis "
                "schedules, which are not implemented")
        if program.fault_tolerant:
            raise ValueError(
                "fault-tolerant mixing supports a single agent mesh axis "
                f"(got {axes}); factored multi-axis meshes need per-axis "
                "fault schedules, not implemented")
    if factors is None:
        if len(mesh.agent_axes) != 1:
            raise ValueError(f"the factored mesh {mesh.agent_axes} needs the "
                             "per-axis factors (FactoredMix)")
        plans = tuple(_stencil_plan(t.pi, [(mesh.agent_axes[0], t)], mesh,
                                    t.name)
                      for t in program.schedule.topologies)
    else:
        plans = (_stencil_plan(program.schedule.topologies[0].pi, factors,
                               mesh, topology.name),)
    fault_ops = (_sharded_fault_ops(program, plans, mesh.agent, mesh.device)
                 if program.fault_tolerant else None)
    strategy = ShardedMixing(program, mesh, plans, fault_ops)
    return FlatComm(lead=0, gather=strategy.gather, strategy=strategy,
                    program=program)


def make_sharded_mix_fn(topology: Topology, mesh,
                        axis: Optional[str] = None) -> Callable:
    """Per-leaf mixing of agent ``mesh.agent``'s tree, for the unfused
    optimizers, along the agent axis ``axis`` (None: the mesh's one axis).
    A circulant ``Pi``: ``sum_s w_s * shift_s(x)`` in shift order, in the
    leaf's dtype (the reference's ``_circulant_mix_leaf``), every leaf and
    shift in one posted permutation.  Otherwise an all-gather and this
    agent's row of ``Pi`` in float32 (``_general_mix_leaf``)."""
    n = topology.n_agents
    if n == 1:
        return lambda tree: tree
    shifts = topology.shift_weights()
    if shifts is not None:
        items = sorted(shifts.items())
        wire = [s for s, _ in items if s % n]

        def mix(tree):
            leaves, treedef = tree_flatten(tree)
            got = collectives.ppermute(
                mesh, [x.contiguous() for x in leaves], wire, axis=axis).wait()
            out = []
            for x, recv in zip(leaves, got):
                acc, k = None, 0
                for s, w in items:
                    w = torch.tensor(w, dtype=x.dtype, device=x.device)
                    if s % n == 0:
                        term = w * x
                    else:
                        term = w * recv[k]
                        k += 1
                    acc = term if acc is None else acc + term
                out.append(acc)
            return tree_unflatten(treedef, out)

        return mix
    if len(mesh.agent_axes) != 1:
        raise ValueError(f"topology {topology.name!r} on axis {axis!r} is not "
                         "circulant: a factored mesh mixes circulant factors")
    return make_gathered_mix_fn(topology, mesh)


def make_gathered_mix_fn(topology: Topology, mesh) -> Callable:
    """Per-leaf mixing of agent ``mesh.agent``'s tree for any ``Pi``: an
    all-gather of the leaf over the agent plane and this agent's row of
    ``Pi`` in float32 (the reference's ``_general_mix_leaf``;
    ``mixing="dense"``)."""
    row = torch.tensor(topology.pi[mesh.agent], dtype=torch.float32,
                       device=mesh.device)

    def mix(tree):
        def leaf(x):
            gathered = collectives.all_gather(mesh, x.contiguous())
            flat = gathered.reshape(gathered.shape[0], -1).float()
            return (row @ flat).to(x.dtype).reshape(x.shape)
        return tree_map(leaf, tree)

    return mix


@dataclasses.dataclass(frozen=True)
class FactoredMix:
    """A Kronecker-factored topology over the agent axes of a factored
    mesh (the reference's ``FactoredMix``): ``factors`` is ``((axis,
    Topology), ...)``; the agents interact by ``Pi = Pi_1 (x) Pi_2 (x)
    ...``, doubly stochastic and symmetric when the factors are, with
    ``lambda_2`` the largest factor ``lambda_2`` and ``lambda_n`` the
    product of the factors'.  :meth:`make_mix_fn` mixes per leaf, one
    factor (axis) after the other."""

    factors: Tuple[Tuple[str, Topology], ...]

    @property
    def n_agents(self) -> int:
        n = 1
        for _, t in self.factors:
            n *= t.n_agents
        return n

    def dense_pi(self) -> np.ndarray:
        pi = np.array([[1.0]])
        for _, t in self.factors:
            pi = np.kron(pi, t.pi)
        return pi

    def topology(self) -> Topology:
        """The product as one :class:`Topology` over the linearized agents
        (rank ``pod * n_data + data``)."""
        return Topology(name="factored(" + ",".join(
            f"{a}:{t.name}" for a, t in self.factors) + ")",
            pi=self.dense_pi())

    @property
    def lambda2(self) -> float:
        lams = [t.lambda2 for _, t in self.factors if t.n_agents > 1]
        return max(lams) if lams else 0.0

    @property
    def lambdan(self) -> float:
        prod = 1.0
        for _, t in self.factors:
            prod *= t.lambdan
        return prod

    def make_mix_fn(self, mesh) -> Callable:
        fns = [make_sharded_mix_fn(t, mesh, axis=a) for a, t in self.factors
               if t.n_agents > 1]

        def mix(tree):
            for f in fns:
                tree = f(tree)
            return tree

        return mix


def make_sharded_mean_fn(mesh) -> Callable:
    """The exact mean over the agents of each leaf (FedAvg's server,
    centralized SGD): one all-reduce for the whole tree."""

    def mean(tree):
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef,
                              collectives.all_reduce_mean(mesh, leaves))

    return mean


# --------------------------------------------------------------------------
# dense stacked mixing, wire accounting, diagnostics
# --------------------------------------------------------------------------


def mix_stacked(pi: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(Pi x)_j = sum_l pi_{jl} x_l`` for ``x`` of shape (N, ...)."""
    flat = x.reshape(x.shape[0], -1).float()
    mixed = pi.float() @ flat
    return mixed.to(x.dtype).reshape(x.shape)


def mix_pytree_stacked(pi: torch.Tensor, tree: PyTree) -> PyTree:
    """Apply :func:`mix_stacked` to every leaf of an agent-stacked tree."""
    return tree_map(lambda x: mix_stacked(pi, x), tree)


def program_bytes_per_neighbor(spec: flatbuf.FlatSpec,
                               program: Optional[MixingProgram],
                               exchange: str = "f32",
                               payloads: int = 1) -> int:
    """Bytes one whole-model transfer moves to ONE neighbor: every payload
    tree on the dense wire at the program's precision (int8 / fp8 add one
    f32 scale per 128-lane row); a compressed wire's carried fields —
    ``topk``: ``k_rows`` lane rows of 644 B per bucket (int8 values, int32
    indices, one f32 scale), ``rank:r``: the two f32 factors, ``(rows * r
    + r * 128) * 4`` per bucket.  ``program=None`` prices ``payloads``
    trees at ``exchange``."""
    if program is None:
        return int(spec.exchange_bytes(exchange) * payloads)
    kind, param = parse_compressor(program.compressor)
    if kind == "topk":
        total = sum(tk.topk_k_rows_for([b.rows for b in spec.buckets], param)
                    ) * tk.TOPK_LANE_ROW_BYTES
    elif kind == "rank":
        total = sum((b.rows * param + param * flatbuf.LANE) * 4
                    for b in spec.buckets)
    else:
        total = spec.exchange_bytes(program.exchange)
    return int(total * program.n_payloads)


def exchange_bytes_per_step(spec: flatbuf.FlatSpec, topology,
                            exchange: str = "f32", rounds: int = 1,
                            payloads: int = 1,
                            program: Optional[MixingProgram] = None) -> dict:
    """Per-step bytes-on-wire of the fused consensus exchange.

    The paper's fixed-topology cost model (eq. 5/6): each agent sends and
    receives ``degree`` whole-model transfers per step, priced by
    :func:`program_bytes_per_neighbor`.  ``topology`` may be a
    :class:`~repro_torch.core.topology.TopologySchedule` (degree = the mean
    over its period); ``rounds`` inner consensus rounds multiply every
    transfer; ``payloads`` counts the trees on the wire per transfer
    (``momentum_mixing="mixed"`` moves params + momentum = 2; a ``program``
    sets it, and ``exchange``, itself); error feedback moves zero extra.
    The keys are the JAX package's (a compressed program reports its
    compressor spec as ``exchange``).
    """
    per_neighbor = program_bytes_per_neighbor(spec, program, exchange,
                                              payloads)
    if program is not None:
        exchange = (program.compressor if program.compressed
                    else program.exchange)
        payloads = program.n_payloads
    if isinstance(topology, TopologySchedule):
        degree = topology.mean_degree()
    else:
        degree = topology.degree()
    return {
        "exchange": exchange,
        "degree": degree,
        "rounds": rounds,
        "payloads": payloads,
        "per_neighbor_bytes": per_neighbor,
        "per_step_bytes": int(per_neighbor * degree * rounds),
        "native_per_step_bytes": int(spec.exchange_bytes("f32") * payloads
                                     * degree * rounds),
    }


def mean_exchange_bytes_per_step(spec: flatbuf.FlatSpec, n_agents: int,
                                 period: int = 1, payloads: int = 1) -> dict:
    """Per-step bytes-on-wire of a *global-mean* optimizer (FedAvg).

    Its sync step is a ring all-reduce of the whole model, ``2 (N-1)/N``
    native-precision transfers per agent, paid once per ``period =
    local_steps`` and amortized over them; ``payloads`` counts the
    averaged trees (2 when the momentum is averaged too, ``mu != 0``).
    """
    native = spec.exchange_bytes("f32") * payloads
    per_sync = 2.0 * (n_agents - 1) / max(n_agents, 1) * native
    return {
        "exchange": "f32",
        "local_steps": period,
        "payloads": payloads,
        "per_sync_bytes": int(per_sync),
        "per_step_bytes": int(per_sync / max(period, 1)),
    }


def describe_exchange_cost(params: PyTree, topology, exchange: str = "f32",
                           *, lead: int = 1, rounds: int = 1,
                           payloads: int = 1,
                           program: Optional[MixingProgram] = None) -> str:
    """One-line human-readable :func:`exchange_bytes_per_step` report, in
    the JAX package's words."""
    spec = flatbuf.make_flat_spec(params, lead=lead)
    wire = exchange_bytes_per_step(spec, topology, exchange, rounds,
                                   payloads, program=program)
    per_round = "" if rounds == 1 else f" x {rounds} rounds"
    per_payload = "" if payloads == 1 else f" ({payloads} payload trees)"
    auto = ""
    if program is not None and program.compressor_kind == "topk" \
            and isinstance(program.compressor_param, tuple):
        # topk:auto:B — the per-bucket densities the budget solver chose
        rows_list = [b.rows for b in spec.buckets]
        k_list = tk.topk_k_rows_for(rows_list, program.compressor_param)
        dens = ", ".join(f"{k / r:.3g}" for k, r in zip(k_list, rows_list))
        auto = f"; auto per-bucket p=[{dens}]"
    return (f"exchange={wire['exchange']}: "
            f"{wire['per_step_bytes']:,} bytes/agent/step "
            f"on the wire ({wire['degree']:g} neighbors x "
            f"{wire['per_neighbor_bytes']:,} B{per_round}{per_payload}; native "
            f"{wire['native_per_step_bytes']:,} B){auto}")


def consensus_error_stacked(x: torch.Tensor) -> torch.Tensor:
    """``mean_j ||x_j - mean(x)||`` for an agent-stacked leaf (Prop. 1 LHS)."""
    diff = (x - x.mean(dim=0, keepdim=True)).reshape(x.shape[0], -1)
    return torch.mean(torch.linalg.vector_norm(diff.float(), dim=1))


def consensus_error_pytree(tree: PyTree) -> torch.Tensor:
    """Aggregate consensus error ``mean_j ||x_j - mean(x)||`` over all leaves."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    mean_sq = torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        d = (x - x.mean(dim=0, keepdim=True)).reshape(n, -1).float()
        mean_sq = mean_sq + torch.sum(d * d, dim=1)
    return torch.mean(torch.sqrt(mean_sq))
