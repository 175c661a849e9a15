"""An op counter over one executed (or ``meta``-traced) step: the port's
counterpart of :mod:`repro.analysis.hlo`.

The reference parses the compiled HLO of a step; the port has no HLO, so
it keeps the contract (:class:`StepStats` has :class:`repro.analysis.hlo.
HloStats`'s fields) and counts differently: :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten op the step dispatches.

* ``dot_flops`` — matrix products and convolutions at ``2 x output
  elements x contracted size`` (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``mv``, ``dot``, ``convolution`` and its backward, the fused attention
  ops), as ``hlo.py`` counts ``dot`` and ``convolution``.  A backward pass
  and remat's recompute are counted where they run, as HLO's while bodies
  are; under ``torch.func.vmap`` the ops see the batched tensors, so the
  count is the agent count times one agent's.
* ``traffic_bytes`` — the sum of each op's operand and result bytes (view
  ops and allocations move none).  Nothing is fused, so this is an upper
  bound, and it is NOT comparable to XLA's post-fusion traffic.
* ``collective_bytes`` / ``collective_count`` by the reference's kinds:
  the exchange's point-to-point transfers under ``"collective-permute"``
  (one per tensor per shift), all-gathers and all-reduces, reported by
  :mod:`repro_torch.core.collectives`.
* ``peak_live_bytes`` — the peak over the step of the bytes of live tensor
  storages the counter has seen (the inputs it was given and every op's
  operands and results, but no temporary of a kernel's plain version):
  the counter's figure, NOT the allocator's peak.
* ``trip_counts`` — empty: a step executes its loops, so there are no
  bodies to multiply.

The CUDA kernels are loaded through ``ctypes`` and never reach the
dispatcher, so each kernel's dispatcher reports the work its kernel does
(:func:`reported`), and the ops inside a kernel's wrapper or its plain
version are not counted again: a step counts the same on the card
(kernels) as on the CPU or ``meta`` (plain versions).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the counters now open (innermost last)
ACTIVE: list = []
# > 0 inside a reported region: its ops are the kernel's, already counted
_SUPPRESS = [0]

aten = torch.ops.aten

# ops that allocate without moving bytes
_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten.empty_strided.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.lift_fresh.default}


@dataclasses.dataclass
class StepStats:
    """Totals over one step, per device (one rank's step)."""

    collective_bytes: Dict[str, int]
    dot_flops: int
    traffic_bytes: int
    collective_count: Dict[str, int]
    trip_counts: Dict[str, int]
    peak_live_bytes: int = 0

    @property
    def total_collective_bytes(self) -> int:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _attn_flops(q, k, v) -> int:
    """``Q K^T`` and ``P V`` of ``(..., Sq, D)`` queries on ``(..., Sk, D)``
    keys (the batch dims of ``q``)."""
    lead = math.prod(q.shape[:-2])
    sq, d = q.shape[-2], q.shape[-1]
    sk, dv = k.shape[-2], v.shape[-1]
    return 2 * lead * sq * sk * (d + dv)


def _conv_flops(x_or_grad, weight, transposed, groups) -> int:
    """``2 x output elements x (input channels / groups x kernel size)``,
    HLO's rule for a convolution; a transposed one contracts over the
    output channels of its weight."""
    del groups   # the weight's shape already holds the grouped channels
    per_out = weight.numel() // weight.shape[1 if transposed else 0]
    return 2 * x_or_grad.numel() * per_out


def _dot_flops(func, args, out) -> int:
    if func in (aten.mm.default, aten.bmm.default):
        a, b = args[0], args[1]
        return 2 * a.numel() * b.shape[-1]
    if func in (aten.addmm.default, aten.baddbmm.default):
        a, b = args[1], args[2]
        return 2 * a.numel() * b.shape[-1]
    if func is aten.addbmm.default:
        a, b = args[1], args[2]
        return 2 * a.numel() * b.shape[-1]
    if func in (aten.mv.default, aten.dot.default, aten.vdot.default):
        return 2 * args[0].numel()
    if func is aten.addmv.default:
        return 2 * args[1].numel()
    if func is aten.convolution.default:
        transposed, groups = args[6], args[8]
        return _conv_flops(out if not transposed else args[0], args[1],
                           transposed, groups)
    if func is aten.convolution_backward.default:
        grad_out, x, weight = args[0], args[1], args[2]
        transposed, groups, mask = args[7], args[9], args[10]
        one = _conv_flops(grad_out if not transposed else x, weight,
                          transposed, groups)
        return one * (int(bool(mask[0])) + int(bool(mask[1])))
    name = str(func)
    if "_scaled_dot_product" in name:
        if "backward" in name:
            # (grad_out, q, k, v, ...): dQ, dK, dV and the recomputed P
            return 2 * _attn_flops(args[1], args[2], args[3])
        return _attn_flops(args[0], args[1], args[2])
    return 0


class OpCounter(TorchDispatchMode):
    """Count the dot FLOPs, traffic and (with ``track_live``) live bytes of
    the ops dispatched while it is open; :meth:`stats` returns the totals.

    ``roots`` are tensors that are live when the count starts (params,
    optimizer state, the batch): their storages count toward the live
    bytes from the start."""

    def __init__(self, *, track_live: bool = False, roots=()):
        super().__init__()
        self.dot_flops = 0
        self.traffic_bytes = 0
        self.collective_bytes = {c: 0 for c in COLLECTIVES}
        self.collective_count = {c: 0 for c in COLLECTIVES}
        self.track_live = track_live
        # storage key -> [live tensors seen on it, its bytes]
        self._storages: Dict[int, list] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._roots = _tensors(roots)

    # -- live bytes ------------------------------------------------------
    def _drop(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            del self._storages[key]
            self.live_bytes -= entry[1]

    def _see(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until every tensor seen on it is
        gone (a tensor held by autograd or a transform lives on with its
        Python object)."""
        if getattr(t, "_opcount_seen", None) is self:
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [0, st.nbytes()]
            self.live_bytes += entry[1]
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        entry[0] += 1
        try:
            t._opcount_seen = self
            weakref.finalize(t, self._drop, key)
        except (AttributeError, TypeError, RuntimeError):
            entry[0] -= 1

    # -- counting ----------------------------------------------------------
    def __enter__(self):
        ACTIVE.append(self)
        if self.track_live:
            for t in self._roots:
                self._see(t)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add(self, *, dot_flops: int = 0, traffic_bytes: int = 0,
            collective=None) -> None:
        """Add reported work (a kernel's, a collective's)."""
        self.dot_flops += int(dot_flops)
        self.traffic_bytes += int(traffic_bytes)
        if collective is not None:
            kind, nbytes, count = collective
            self.collective_bytes[kind] += int(nbytes)
            self.collective_count[kind] += int(count)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _SUPPRESS[0]:
            self.dot_flops += _dot_flops(func, args, out)
            if not func.is_view and func not in _FREE:
                self.traffic_bytes += sum(
                    _nbytes(t) for t in _tensors((args, kwargs)))
                self.traffic_bytes += sum(_nbytes(t) for t in _tensors(out))
        # a kernel's plain version allocates temporaries the kernel does not:
        # inside a reported region nothing new is counted live (what the
        # region returns is counted where the step next uses it)
        if self.track_live and not _SUPPRESS[0]:
            for t in _tensors((args, kwargs, out)):
                self._see(t)
        return out

    def stats(self) -> StepStats:
        return StepStats(collective_bytes=dict(self.collective_bytes),
                         dot_flops=self.dot_flops,
                         traffic_bytes=self.traffic_bytes,
                         collective_count=dict(self.collective_count),
                         trip_counts={},
                         peak_live_bytes=self.peak_live_bytes)


def counting() -> bool:
    """True while a counter is open (the dispatchers report only then)."""
    return bool(ACTIVE)


@contextlib.contextmanager
def reported(*, dot_flops: int = 0, traffic_bytes: int = 0, collective=None):
    """The work of one kernel launch or collective, ``(kind, bytes,
    count)``: every open counter adds it, and counts none of the ops
    dispatched inside (the wrapper's checks and allocations, or the plain
    version standing in for the kernel)."""
    for c in ACTIVE:
        c.add(dot_flops=dot_flops, traffic_bytes=traffic_bytes,
              collective=collective)
    _SUPPRESS[0] += 1
    try:
        yield
    finally:
        _SUPPRESS[0] -= 1


def count(fn, *args, track_live: bool = False, roots=None, **kwargs):
    """``(fn(*args, **kwargs), StepStats)``: one call under a fresh
    counter (``roots`` default to ``args``)."""
    with OpCounter(track_live=track_live,
                   roots=args if roots is None else roots) as c:
        out = fn(*args, **kwargs)
    return out, c.stats()
