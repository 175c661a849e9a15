"""Top-k sparse and rank-r low-rank wire compressors for the flat buckets,
and the top-k threshold kernel's wrapper.

The two biased compressors of the compressor axis (``compressor="topk:p" |
"topk:auto:B" | "rank:r"``, see :mod:`repro_torch.core.consensus`), as in
:mod:`repro.kernels.consensus_update.topk`.  Both work on packed ``(rows,
128)`` buckets with the agent axis leading (``(A, rows, 128)``; a 2-D
bucket is one agent) and ride the error-feedback rail.

Top-k keeps the ``K = k_rows * 128`` largest-magnitude elements of each
agent's bucket and ships them as a compact ``(k_rows, 128)`` tile: int8
values stochastically rounded by :func:`~.consensus_update.sr_quantize`
(one launch for all agents, per-row scales), int32 flat positions ``row *
128 + lane`` sorted ascending, and the ``(k_rows, 1)`` f32 scales.

Selection is exact and deterministic, the reference's set on CPU and CUDA
alike: ``lax.top_k`` breaks magnitude ties toward the lower index, while
``torch.topk`` promises no tie order.  So :func:`topk_indices` takes the
K-th largest magnitude ``t`` from ``torch.topk``, keeps every ``|x| > t``,
then the first ``K - #(|x| > t)`` elements with ``|x| == t`` in index order,
and reads the indices off that mask in ascending order with a fixed-size
scatter (no host sync).  ``|-0.0| == 0.0``; an all-zero bucket keeps
positions ``0 .. K-1``.

Rank-r is one warm-started power iteration per step (PowerSGD):
``P = orth(M Q)``, ``Qt = P^T M``, ``Q' = orth(Qt^T)``; the wire carries
``(P, Qt)`` and ``Q'`` stays local (``OptState.qwarm``).  The products are
plain ``torch.matmul``, as the reference leaves them to XLA, accumulated
in float64 and rounded once to float32 so that the CPU and the card agree.  :func:`rank_init_q` draws the port's own
deterministic basis from a seeded CPU ``torch.Generator``: the reference
draws ``jax.random.normal``, which no PyTorch stream reproduces, so parity
tests hand the port the reference's basis.

:func:`topk_threshold` is the magnitude histogram that brackets the k-th
largest ``|x|`` (``topk_threshold_2d``): counts of ``|x| >= tau_b`` for
geometric thresholds ``tau_b = max(amax, 1e-30) * span^(b / (n_bins -
1))``, the smallest ``tau`` whose count is ``<= k``.  On CUDA tensors the
whole function runs on the device (``csrc/topk_threshold.cu``: one memset
and two launches, amax then the counts and the pick; the ratios are
rounded to float32 on the host once and passed by value, so the call
copies nothing to the device and waits for nothing).  On CPU tensors it
runs the plain version: :func:`threshold_taus`, the counts of
:func:`.ref.topk_threshold_counts_ref` and the pick in PyTorch, which
the kernels equal bit for bit.  The counts are exact integers (the
reference sums them in float32, exact only below 2^24 elements) and the
pick compares them exactly; they are returned as float32, as the
reference returns them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.analysis import opcount
from repro_torch.analysis.roofline import kernel_work
from repro_torch.kernels.consensus_update import consensus_update as cu
from repro_torch.kernels.consensus_update import ref

LANE = 128

# --------------------------------------------------------------------------
# static shape math (the single source the byte accounting prices from)
# --------------------------------------------------------------------------


def topk_k_rows(rows: int, p: float) -> int:
    """Lane-aligned compact row count for density ``p`` over ``rows * 128``:
    ``ceil(ceil(p * rows * 128) / 128)``, at least 1, at most ``rows``."""
    if not (0.0 < p <= 1.0):
        raise ValueError(f"top-k density must be in (0, 1], got {p!r}")
    k = max(1, math.ceil(p * rows * LANE))
    return min(rows, max(1, -(-k // LANE)))


#: wire bytes of ONE compact lane row: 128 int8 values, 128 int32 indices
#: and one f32 row scale
TOPK_LANE_ROW_BYTES = LANE * (1 + 4) + 4


def topk_auto_k_rows(rows_list, budget: int):
    """Per-bucket compact row counts meeting a total byte ``budget`` per
    neighbour (``topk:auto:B``): at least one lane row per bucket, rows
    spread proportionally to bucket size, the integer remainder handed
    greedily to the largest uncovered buckets (ties toward the lower
    index)."""
    rows_list = list(rows_list)
    n = len(rows_list)
    floor_bytes = n * TOPK_LANE_ROW_BYTES
    if budget < floor_bytes:
        raise ValueError(
            f"topk:auto budget {budget} B cannot cover one compact lane row "
            f"per bucket ({n} buckets x {TOPK_LANE_ROW_BYTES} B = "
            f"{floor_bytes} B minimum)")
    afford = budget // TOPK_LANE_ROW_BYTES
    k = [1] * n
    rem = afford - n
    frac = [r - 1 for r in rows_list]
    total_frac = sum(frac)
    if total_frac > 0:
        for i in range(n):
            k[i] += min(frac[i], rem * frac[i] // total_frac)
    while sum(k) < afford:
        cands = [(rows_list[i] - k[i], -i) for i in range(n)
                 if k[i] < rows_list[i]]
        if not cands:
            break                       # every bucket at full density
        _, neg_i = max(cands)
        k[-neg_i] += 1
    return k


def topk_k_rows_for(rows_list, param):
    """Per-bucket ``k_rows`` for a parsed ``topk`` parameter: a density
    ``p`` (each bucket alone) or ``("auto", budget_bytes)``."""
    if isinstance(param, tuple):
        kind, budget = param
        if kind != "auto":
            raise ValueError(f"unknown top-k parameter {param!r}")
        return topk_auto_k_rows(rows_list, budget)
    return [topk_k_rows(r, param) for r in rows_list]


# --------------------------------------------------------------------------
# the threshold kernel (one sweep)
# --------------------------------------------------------------------------


def _agents(x: torch.Tensor, name: str = "x") -> torch.Tensor:
    """``x`` as an ``(A, rows, 128)`` stack (a 2-D bucket is one agent)."""
    if not isinstance(x, torch.Tensor) or x.dim() not in (2, 3) \
            or x.shape[-1] != LANE:
        raise ValueError(f"{name} must be a (rows, 128) or (A, rows, 128) "
                         f"tensor, got {getattr(x, 'shape', type(x))}")
    return x[None] if x.dim() == 2 else x


@functools.cache
def _ratios(n_bins: int, span: float) -> np.ndarray:
    """``f32(span ** (b / (n_bins - 1)))``, computed in float64 and rounded
    once, as the reference builds them."""
    return np.asarray([span ** (b / max(n_bins - 1, 1)) for b in range(n_bins)],
                      np.float32)


@functools.cache
def _c_ratios(n_bins: int, span: float):
    """The ratios as a ctypes array (kept alive by the cache) and its
    address, for the kernel's by-value parameter."""
    arr = (ctypes.c_float * n_bins)(*_ratios(n_bins, span).tolist())
    return arr, ctypes.addressof(arr)


@functools.cache
def _threshold_fn():
    """The ``topk_threshold`` C function, its library built on first use."""
    return cu.library("topk_threshold").topk_threshold


def threshold_taus(x: torch.Tensor, n_bins: int = 16,
                   span: float = 1e-4) -> torch.Tensor:
    """The ``(A, n_bins)`` float32 thresholds ``max(amax_a, 1e-30) *
    f32(span ** (b / (n_bins - 1)))`` of ``x (A, rows, 128)`` (the plain
    version's)."""
    ratios = torch.from_numpy(_ratios(n_bins, span)).to(x.device)
    amax = x.float().abs().amax(dim=(1, 2))
    floor = torch.tensor(np.float32(1e-30), device=x.device)
    return torch.maximum(amax, floor)[:, None] * ratios[None]


def topk_threshold(x: torch.Tensor, k: int, *, n_bins: int = 16,
                   span: float = 1e-4):
    """Bracket the k-th largest ``|x|`` of each agent's bucket.

    ``x`` is ``(A, rows, 128)`` float32 (or one ``(rows, 128)`` bucket);
    ``n_bins`` is at most 16, the reference's count.  Returns ``(tau,
    counts)``: ``tau (A,)`` the smallest threshold whose count of ``|x| >=
    tau`` is ``<= k`` (the first, ``amax``, when none is),
    ``counts (A, n_bins)`` float32, nondecreasing in ``b``; for a 2-D
    ``x`` a scalar and ``(n_bins,)``.  CUDA tensors run the whole function
    on the device (one call: a memset and two launches, counted once, no
    copy to the device and no wait); CPU tensors run the plain version.
    Under an open op counter the call reports the bytes its kernel moves
    (:mod:`repro_torch.analysis.opcount`).
    """
    if not isinstance(x, torch.Tensor) or x.dim() not in (2, 3) \
            or x.shape[-1] != LANE:
        raise ValueError(f"x must be a (rows, 128) or (A, rows, 128) "
                         f"tensor, got {getattr(x, 'shape', type(x))}")
    if not 1 <= n_bins <= 16:
        raise ValueError(f"n_bins must be in [1, 16], got {n_bins}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    a_count = x.shape[0] if x.dim() == 3 else 1
    rows = x.shape[-2]
    if rows == 0:
        raise ValueError("x has no rows")
    if opcount.counting():
        nbytes, _ = kernel_work("topk_threshold", a_count, 0, rows)
        with opcount.reported(traffic_bytes=nbytes):
            return _topk_threshold(x, k, n_bins, span, a_count, rows)
    return _topk_threshold(x, k, n_bins, span, a_count, rows)


def _topk_threshold(x, k, n_bins, span, a_count, rows):
    device = x.device
    if device.type == "cuda":
        if x.data_ptr() % 16:
            raise ValueError("x is not 16-byte aligned")
        lead = x.shape[:-2]
        tau = x.new_empty(lead)
        counts = x.new_empty((*lead, n_bins))
        scratch = x.new_empty((a_count * 17 + 1,), dtype=torch.int32)
        rc = _threshold_fn()(
            x.data_ptr(), _c_ratios(n_bins, span)[1], tau.data_ptr(),
            counts.data_ptr(), scratch.data_ptr(), a_count, rows * LANE // 4,
            n_bins, k, device.index, cu._stream(device))
        cu._launch_check(rc, "topk_threshold")
        topk_threshold.launches += 1
        topk_threshold.launches_by_bucket["float32"] += 1
        return tau, counts
    if device.type not in cu.PLAIN_DEVICES:
        raise ValueError(f"no top-k threshold kernel for device {device}")
    xs = _agents(x)
    taus = threshold_taus(xs, n_bins, span)
    counts = ref.topk_threshold_counts_ref(xs, taus)
    ok = (counts <= k).sum(dim=1)
    idx = torch.clamp(ok - 1, min=0)
    tau = taus.gather(1, idx[:, None])[:, 0]
    counts = counts.float()
    if x.dim() == 2:
        return tau[0], counts[0]
    return tau, counts


cu.KERNELS["topk_threshold"] = topk_threshold
cu.reset_launch_counts()


# --------------------------------------------------------------------------
# top-k compress / decompress (exact selection)
# --------------------------------------------------------------------------


def _row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix counts along each row of an ``(A, n)`` bool
    mask, as ONE scan over the flattened mask minus each row's start: a
    row-wise CUDA cumsum over a long innermost axis runs one block per
    row (5 rows: milliseconds), a flat one a device-wide scan."""
    a_count, n = mask.shape
    flat = torch.cumsum(mask.reshape(-1), dim=0, dtype=torch.int32)
    flat = flat.view(a_count, n)
    start = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - start[:, None]


def topk_indices(x: torch.Tensor, kk: int) -> torch.Tensor:
    """The ``kk`` largest-magnitude positions of every row of ``x (A, n)``,
    sorted ascending, ties at the K-th magnitude broken toward the lower
    index (``lax.top_k``'s set): ``(A, kk)`` int32.  The rows are selected
    one at a time: the selection's temporaries take about 25 bytes an
    element (27 GB at once for 3 agents' 2-layer gemma3-1b buckets)."""
    if x.shape[0] > 1:
        return torch.cat([topk_indices(x[a:a + 1], kk)
                          for a in range(x.shape[0])])
    a_count, n = x.shape
    mag = x.float().abs()
    t = torch.topk(mag, kk, dim=1, sorted=False).values.amin(dim=1,
                                                             keepdim=True)
    above = mag > t
    ties = mag == t
    need = kk - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    keep = above | (ties & (_row_cumsum(ties) <= need))
    slot = _row_cumsum(keep) - 1
    # kept positions go to their rank; the rest to a spare slot kk, dropped
    target = torch.where(keep, slot, kk).long()
    out = torch.empty((a_count, kk + 1), dtype=torch.int32, device=x.device)
    src = torch.arange(n, dtype=torch.int32, device=x.device)
    src = src.expand(a_count, n)
    out.scatter_(1, target, src)
    return out[:, :kk].contiguous()


def topk_compress_2d(x: torch.Tensor, k_rows: int, seed: int, *,
                     agent_stride: int = 0):
    """Compress buckets to their lane-aligned top-K compact form.

    ``x`` is ``(A, rows, 128)`` (or one ``(rows, 128)`` bucket).  Returns
    ``(values, indices, scales)``: int8 ``(A, k_rows, 128)`` values (one
    :func:`~.consensus_update.sr_quantize` launch for all agents, agent
    ``a`` seeded ``seed + agent_stride * a``, wrapping), int32 ``(A,
    k_rows, 128)`` flat dense positions sorted ascending and ``(A, k_rows,
    1)`` f32 scales; without the agent axis for a 2-D ``x``.
    """
    xs = _agents(x)
    a_count, rows = xs.shape[0], xs.shape[1]
    if not 1 <= k_rows <= rows:
        raise ValueError(f"k_rows must be in [1, {rows}], got {k_rows}")
    flat = xs.reshape(a_count, rows * LANE).float()
    idx = topk_indices(flat, k_rows * LANE)
    vals = flat.gather(1, idx.long()).reshape(a_count, k_rows, LANE)
    q, sc = cu.sr_quantize(vals, seed, "int8", agent_stride=agent_stride)
    idx = idx.reshape(a_count, k_rows, LANE)
    if x.dim() == 2:
        return q[0], idx[0], sc[0]
    return q, idx, sc


def topk_decompress_2d(values: torch.Tensor, indices: torch.Tensor,
                       scales: torch.Tensor, rows: int) -> torch.Tensor:
    """Gather-dequant form: compact payloads (any leading axes) -> dense
    f32 ``(..., rows, 128)``, zero off the support (a scatter-set: the
    indices are unique)."""
    lead = values.shape[:-2]
    deq = (values.float() * scales).reshape(-1, values.shape[-2] * LANE)
    flat = torch.zeros((deq.shape[0], rows * LANE), dtype=torch.float32,
                       device=values.device)
    flat.scatter_(1, indices.reshape(deq.shape).long(), deq)
    return flat.reshape(tuple(lead) + (rows, LANE))


# --------------------------------------------------------------------------
# rank-r power-iteration compressor (PowerSGD)
# --------------------------------------------------------------------------


def _orthonormalize_cols(a: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Modified Gram-Schmidt over the columns of ``a (..., n, r)``; a
    numerically degenerate column collapses to zero instead of NaN.
    Computed in float64 and returned in float32 (see
    :func:`rank_compress_2d`)."""
    cols = []
    for i in range(a.shape[-1]):
        v = a[..., i].double()
        for u in cols:
            v = v - (u * v).sum(dim=-1, keepdim=True) * u
        nrm = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
        cols.append(torch.where(nrm > eps, v / torch.clamp(nrm, min=eps),
                                torch.zeros_like(v)))
    return torch.stack(cols, dim=-1).float()


def rank_init_q(r: int, seed: int = 0, device=None) -> torch.Tensor:
    """Deterministic orthonormal ``(128, r)`` warm-start basis, identical
    across agents and buckets: a seeded CPU ``torch.Generator``'s normals,
    orthonormalized (the reference draws ``jax.random.normal`` instead)."""
    if not isinstance(r, int) or r < 1 or r > LANE:
        raise ValueError(f"rank must be an int in [1, {LANE}], got {r!r}")
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((LANE, r), generator=gen, dtype=torch.float32)
    return _orthonormalize_cols(g).to(device)


def rank_compress_2d(m: torch.Tensor, q: torch.Tensor):
    """One warm-started power iteration: ``m (..., rows, 128)`` and ``q (...,
    128, r)`` -> ``(p (..., rows, r), qt (..., r, 128), q_next (..., 128,
    r))``, float32; the reconstruction is ``p @ qt``.

    The products (sums over 16,941 rows for the CNN's bucket) and
    Gram-Schmidt accumulate in float64 and round once to float32, so the
    CPU and the card, whose float32 sums run in different orders, give the
    same factors up to that last rounding."""
    m = m.double()
    p = _orthonormalize_cols(m @ q.double())
    qt = (p.double().transpose(-1, -2) @ m).float()
    q_next = _orthonormalize_cols(qt.transpose(-1, -2))
    return p, qt, q_next


def rank_decompress_2d(p: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """Reconstruct the dense f32 bucket from the two wire factors (the
    product in float64, rounded once)."""
    return (p.double() @ qt.double()).float()
