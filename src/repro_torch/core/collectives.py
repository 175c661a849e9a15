"""Point-to-point and collective operations over the agent axis of the
sharded mode: one process per agent on ``torch.distributed``.

The counterparts of the reference's ``lax.ppermute`` / ``lax.all_gather`` /
``lax.pmean`` inside ``shard_map`` (:mod:`repro.core.consensus`):

* :func:`ppermute` — for every tensor ``x_i`` and every shift ``s`` this
  rank sends ``x_i`` to rank ``(r - s) mod n`` and receives the same-shaped
  tensor of rank ``(r + s) mod n`` (agent ``j`` receives from agent ``(j +
  s) mod n``, the reference's ``_shift_all``).  On a factored ``pod x
  data`` mesh a shift is an offset along one named axis, or a tuple of
  offsets, one per axis, moved as ONE transfer from the agent at that
  offset (:meth:`~repro_torch.launch.mesh.AgentMesh.peers`).  Every transfer of the call
  is posted in one ``dist.batch_isend_irecv``; :meth:`Pending.wait` waits
  on them.  Each (tensor, shift, chunk) message carries its own tag: gloo
  matches messages by peer, tag and order, and a fully connected graph or a
  ring of two sends several messages between one pair of ranks.
* :func:`all_gather` and :func:`all_reduce_mean` — the general
  (all-gather) mixing of the unfused path and the exact mean of the
  baselines, over every agent axis.

Every payload crosses as a flat ``uint8`` view of its bytes, so every wire
type (float32, bfloat16, int8, float8_e4m3fn) takes the same route.  Under
``gloo`` a CUDA payload is staged explicitly through pinned host buffers:
one per sent tensor and one per (tensor, shift) received, allocated on
first use and kept on the :class:`~repro_torch.launch.mesh.AgentMesh` for
the next step (so pinned memory holds one step's payloads, never more), and
moved in chunks of :data:`CHUNK_BYTES`; the received chunks are copied to
the device as they land, while later ones are still on the wire.  Under
``nccl`` (one card per rank) CUDA tensors go to the backend directly; CPU
tensors always do.

:class:`Census` counts what the calls posted (logical sends and receives,
wire messages, bytes, staging copies, host seconds) and logs the source
tensors of each post, for the tests, the wire-contract checker
(:mod:`repro_torch.analysis.staticcheck`) and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.analysis import opcount

#: bytes per wire message of a staged payload (each chunk one message)
CHUNK_BYTES = 256 << 20
#: tag layout: (item index, shift mod n) in the high bits, the chunk below
_CHUNK_BITS = 16


@dataclasses.dataclass
class Census:
    """What the exchanges posted, summed since the last :meth:`reset`.

    ``sends`` / ``recvs`` count logical transfers (one per tensor per
    peer), ``messages`` the wire messages sent (a staged payload of ``c``
    chunks is ``c`` of them), ``bytes_sent`` / ``bytes_received`` their
    payload bytes, ``staged_bytes`` the host staging copies both ways,
    ``collectives`` the all-gathers and all-reduces, ``seconds`` the host
    time spent posting and waiting.  ``events`` logs ``("post",
    [data_ptr of each sent tensor])`` and ``("wait",)`` in call order;
    callers may append their own markers."""

    sends: int = 0
    recvs: int = 0
    messages: int = 0
    bytes_sent: int = 0
    bytes_received: int = 0
    staged_bytes: int = 0
    collectives: int = 0
    posts: int = 0
    seconds: float = 0.0
    events: list = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        """Zero the counters and empty the event log (the same list)."""
        fresh = Census()
        for f in dataclasses.fields(self):
            if f.name != "events":
                setattr(self, f.name, getattr(fresh, f.name))
        self.events.clear()

    def snapshot(self) -> dict:
        """The counters (not the event log) as a plain dict."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "events"}


def _bytes_view(x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("the exchange moves contiguous tensors only")
    return x.reshape(-1).view(torch.uint8)


def _staged(mesh, x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and mesh.backend == "gloo"


def _pinned(mesh, key, nbytes: int) -> torch.Tensor:
    """The pinned host buffer ``key`` of at least ``nbytes`` bytes, kept on
    the mesh between steps (reallocated only when a payload grows)."""
    buf = mesh.pinned.get(key)
    if buf is None or buf.numel() < nbytes:
        mesh.pinned.pop(key, None)
        buf = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
        mesh.pinned[key] = buf
    return buf[:nbytes]


def _chunks(nbytes: int):
    return [(lo, min(lo + CHUNK_BYTES, nbytes))
            for lo in range(0, nbytes, CHUNK_BYTES)] or [(0, 0)]


@dataclasses.dataclass
class Pending:
    """One posted :func:`ppermute`: :meth:`wait` completes every transfer
    and returns ``out[i][k]``, tensor ``i`` received along shift ``k``."""

    mesh: object
    works: list
    out: List[List[torch.Tensor]]
    # (device bytes view, pinned bytes view, chunk ranges, works per chunk)
    landing: list
    done: bool = False

    def wait(self) -> List[List[torch.Tensor]]:
        if self.done:
            return self.out
        if opcount.counting():      # the staging copies are the transfer's
            with opcount.reported():
                return self._wait()
        return self._wait()

    def _wait(self) -> List[List[torch.Tensor]]:
        t0 = time.perf_counter()
        census = self.mesh.census
        for w in self.works:
            w.wait()
        for dev, host, ranges, works in self.landing:
            for (lo, hi), w in zip(ranges, works):
                w.wait()
                dev[lo:hi].copy_(host[lo:hi], non_blocking=True)
            census.staged_bytes += dev.numel()
        if self.landing:
            # the pinned receive buffers are reused by the next post: it
            # must not land bytes there before these copies have read them
            ev = torch.cuda.Event()
            ev.record()
            self.mesh.landed = ev
        census.events.append(("wait",))
        census.seconds += time.perf_counter() - t0
        self.done = True
        return self.out


def ppermute(mesh, tensors: Sequence[torch.Tensor], shifts: Sequence, *,
             out: Optional[List[List[torch.Tensor]]] = None,
             axis: Optional[str] = None) -> Pending:
    """Post the circulant permutations of ``tensors`` along ``shifts``.

    For every ``x_i`` and shift ``s_k`` (not the identity) this rank sends
    ``x_i`` to ``(rank - s_k) mod n`` and receives into ``out[i][k]``
    (allocated like ``x_i`` when ``out`` is None) from ``(rank + s_k) mod
    n``.  A shift is an int along ``axis`` (None: the mesh's one axis) or
    a tuple with one offset per agent axis.  The tensors must be
    contiguous and must not change until :meth:`Pending.wait` returns.

    ``meta`` tensors (a dry-run's trace) carry no data: the census counts
    the transfers and nothing is posted.  Under an open op counter
    (:mod:`repro_torch.analysis.opcount`) the call reports its transfers
    as ``collective-permute`` bytes, one per tensor per shift."""
    if not opcount.counting():
        return _ppermute(mesh, tensors, shifts, out, axis)
    nbytes = sum(x.numel() * x.element_size() for x in tensors) * len(shifts)
    with opcount.reported(collective=("collective-permute", nbytes,
                                      len(tensors) * len(shifts))):
        return _ppermute(mesh, tensors, shifts, out, axis)


def _ppermute(mesh, tensors, shifts, out, axis) -> Pending:
    t0 = time.perf_counter()
    n = mesh.size
    census = mesh.census
    keys = [mesh.shift_key(s, axis) for s in shifts]
    if 0 in keys:
        raise ValueError(f"shifts {list(shifts)} include the identity on "
                         f"{n} agents: the self term never crosses the wire")
    if out is None:
        out = [[torch.empty_like(x) for _ in shifts] for x in tensors]
    if mesh.pending is not None and not mesh.pending.done:
        raise RuntimeError("a posted exchange has not been waited on: its "
                           "buffers are still in use")
    if mesh.landed is not None:
        mesh.landed.synchronize()
        mesh.landed = None
    if any(x.device.type == "meta" for x in tensors):
        transfers = len(tensors) * len(shifts)
        nbytes = sum(x.numel() * x.element_size() for x in tensors) * len(shifts)
        census.sends += transfers
        census.recvs += transfers
        census.messages += transfers
        census.bytes_sent += nbytes
        census.bytes_received += nbytes
        census.events.append(("post", [x.data_ptr() for x in tensors]))
        census.posts += 1
        mesh.pending = Pending(mesh=mesh, works=[], out=out, landing=[])
        return mesh.pending
    ops, landing = [], []
    for i, x in enumerate(tensors):
        src = _bytes_view(x)
        nbytes = src.numel()
        staged = _staged(mesh, x)
        ranges = _chunks(nbytes) if staged else [(0, nbytes)]
        if staged:
            host = _pinned(mesh, ("send", i), nbytes)
            for lo, hi in ranges:
                host[lo:hi].copy_(src[lo:hi])
            census.staged_bytes += nbytes
            src = host
        for k, s in enumerate(shifts):
            # the tag names the shift by value: ranks order their shifts
            # differently (by sender), both ends must agree
            base = (i * n + keys[k]) << _CHUNK_BITS
            to, frm = mesh.peers(s, axis)
            dst = _bytes_view(out[i][k])
            if dst.numel() != nbytes:
                raise ValueError(f"receive buffer of {dst.numel()} bytes for a "
                                 f"{nbytes}-byte payload")
            land = _pinned(mesh, ("recv", i, k), nbytes) if staged else dst
            recv_ops = []
            for c, (lo, hi) in enumerate(ranges):
                ops.append(dist.P2POp(dist.isend, src[lo:hi], to,
                                      mesh.group, base + c))
                recv_ops.append(dist.P2POp(dist.irecv, land[lo:hi], frm,
                                           mesh.group, base + c))
            ops.extend(recv_ops)
            if staged:
                landing.append((dst, land, ranges, len(ops) - len(recv_ops)))
            census.sends += 1
            census.recvs += 1
            census.messages += len(ranges)
            census.bytes_sent += nbytes
            census.bytes_received += nbytes
    census.events.append(("post", [x.data_ptr() for x in tensors]))
    works = dist.batch_isend_irecv(ops) if ops else []
    if landing and len(works) != len(ops):
        raise RuntimeError(f"batch_isend_irecv returned {len(works)} requests "
                           f"for {len(ops)} staged operations")
    # the staged receives are waited chunk by chunk in wait(); the rest here
    staged_recvs = set()
    landing_works = []
    for dev, host, ranges, first in landing:
        idx = list(range(first, first + len(ranges)))
        staged_recvs.update(idx)
        landing_works.append((dev, host, ranges, [works[j] for j in idx]))
    others = [w for j, w in enumerate(works) if j not in staged_recvs]
    census.posts += 1
    census.seconds += time.perf_counter() - t0
    mesh.pending = Pending(mesh=mesh, works=others, out=out,
                           landing=landing_works)
    return mesh.pending


def all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """``(n, *x.shape)``: every rank's ``x`` in rank order (the general
    mixing's ``lax.all_gather``).  Under gloo a CUDA tensor is staged
    through host memory."""
    if opcount.counting():
        with opcount.reported(collective=("all-gather",
                                          x.numel() * x.element_size(), 1)):
            return _all_gather(mesh, x)
    return _all_gather(mesh, x)


def _all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    staged = _staged(mesh, x)
    src = _bytes_view(x.cpu() if staged else x)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.stack([p.view(x.dtype).reshape(x.shape) for p in parts])
    census = mesh.census
    census.collectives += 1
    if staged:
        census.staged_bytes += src.numel() * (1 + mesh.size)
        out = out.to(x.device)
    census.seconds += time.perf_counter() - t0
    return out


def all_reduce_mean(mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The exact mean over ranks of each tensor (the reference's
    ``lax.pmean``): one float32 all-reduce (sum) of the tensors laid end to
    end, divided by the rank count, each result in its tensor's dtype."""
    if opcount.counting() and tensors:
        nbytes = 4 * sum(t.numel() for t in tensors)
        with opcount.reported(collective=("all-reduce", nbytes, 1)):
            return _all_reduce_mean(mesh, tensors)
    return _all_reduce_mean(mesh, tensors)


def _all_reduce_mean(mesh, tensors) -> List[torch.Tensor]:
    t0 = time.perf_counter()
    if not tensors:
        return []
    device = tensors[0].device
    staged = device.type == "cuda" and mesh.backend == "gloo"
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if staged:
        flat = flat.cpu()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = (flat / mesh.size).to(device)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].reshape(t.shape).to(t.dtype))
        lo += t.numel()
    census = mesh.census
    census.collectives += 1
    if staged:
        census.staged_bytes += 2 * flat.numel() * 4
    census.seconds += time.perf_counter() - t0
    return out
