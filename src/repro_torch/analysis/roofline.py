"""Roofline terms of one step, on the card's published peaks.

The port of :mod:`repro.analysis.roofline`:

    compute term    = dot FLOPs        / peak FLOP/s
    memory term     = traffic bytes    / HBM rate
    collective term = collective bytes / link rate

with the FLOPs and bytes of one rank's step from the op counter
(:mod:`repro_torch.analysis.opcount`), per device; ``chips`` enters only
through the model-FLOPs ratios.  The card is :data:`HW_H100`, whose
figures also bound every kernel (:func:`kernel_bound`, the least time the
card could take for a kernel's work, which ``chip_smoke.py`` and the
kernel microbenchmark print beside each measured time).

:func:`consensus_update_cost` prices the two operand forms of the fused
update on a top-k wire and :func:`model_flops` is the analytic
``6 N_active D``, both as the reference computes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip, bf16 on the matrix units
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link, one direction
    hbm_bytes: float           # capacity per chip
    f32_flops: Optional[float] = None   # float32 outside the matrix units


# NVIDIA H100 SXM5 80 GB at its 700 W limit, from NVIDIA's H100 data sheet:
HW_H100 = Hardware(
    name="nvidia_h100_sxm5_80gb",
    peak_flops=989e12,         # bf16 tensor cores, dense (H100 SXM5 data sheet)
    hbm_bw=3.35e12,            # HBM3 (H100 SXM5 data sheet)
    ici_bw=450e9,              # NVLink 4, 900 GB/s both ways (H100 SXM5 data sheet)
    hbm_bytes=80e9,            # HBM3 capacity (H100 SXM5 data sheet)
    f32_flops=67e12,           # float32 outside the tensor cores (H100 SXM5 data sheet)
)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device seconds
    compute_s: float
    memory_s: float
    collective_s: float
    # raw inputs
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: float             # 6*N_active*D analytic
    xla_cost_flops: Optional[float] = None
    peak_memory_bytes: Optional[float] = None
    peak_flops: float = HW_H100.peak_flops   # the card's, for mfu_bound

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips): the remat and redundancy
        waste check."""
        denom = self.hlo_flops_per_device * self.chips
        return self.model_flops_total / denom if denom else float("nan")

    @property
    def mfu_bound(self) -> float:
        """Best-case MFU if the dominant term were fully overlapped."""
        t = self.step_time_lower_bound
        if t <= 0:
            return float("nan")
        return self.model_flops_total / (self.chips * self.peak_flops * t)

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "xla_cost_flops": self.xla_cost_flops,
            "peak_memory_bytes": self.peak_memory_bytes,
            "step_time_lower_bound_s": self.step_time_lower_bound,
        }


def roofline_from_stats(
    *, arch: str, shape: str, mesh: str, chips: int, stats,
    model_flops_total: float, hw: Hardware = HW_H100,
    xla_cost_flops: Optional[float] = None,
    peak_memory_bytes: Optional[float] = None,
) -> RooflineTerms:
    """The terms of ``stats`` (a :class:`~repro_torch.analysis.opcount.
    StepStats`, or anything with ``dot_flops``, ``traffic_bytes`` and
    ``total_collective_bytes``) on ``hw``.  ``xla_cost_flops`` has no
    source in the port and stays None unless given."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        compute_s=stats.dot_flops / hw.peak_flops,
        memory_s=stats.traffic_bytes / hw.hbm_bw,
        collective_s=stats.total_collective_bytes / hw.ici_bw,
        hlo_flops_per_device=float(stats.dot_flops),
        hlo_bytes_per_device=float(stats.traffic_bytes),
        collective_bytes_per_device=float(stats.total_collective_bytes),
        model_flops_total=model_flops_total,
        xla_cost_flops=xla_cost_flops,
        peak_memory_bytes=peak_memory_bytes,
        peak_flops=hw.peak_flops,
    )


def consensus_update_cost(spec, program, n_neighbors: int) -> Dict:
    """Analytic HBM bytes + FLOPs of the fused consensus update per step.

    Prices both operand forms of the top-k wire (``compressor="topk:..."``)
    from the :class:`~repro_torch.core.flatbuf.FlatSpec` bucket geometry,
    per agent per step:

    * **dense** (decompress-then-update): per neighbour the compact wire is
      read (``k_rows`` lane rows), a dense f32 bucket is written by the
      decompress and read back by the kernel, ``2 * 4 * rows * 128`` bytes
      of dense traffic per neighbour;
    * **sparse** (``sparse_update=True``): the kernel reads the compact
      fields directly, no dense neighbour traffic at all.

    Both forms share the self read, grad read and output write at the
    bucket's precision.  FLOPs count dequant + weight-multiply + accumulate
    per touched element.  Returns per-bucket rows plus the dense / sparse
    totals and their ratios (the reference's dict, key for key).
    """
    from repro_torch.kernels.consensus_update import topk as tk

    kind, param = program.compressor_kind, program.compressor_param
    if kind != "topk":
        raise ValueError(
            f"consensus_update_cost prices the top-k operand forms; program "
            f"has compressor={program.compressor!r}")
    rows_list = [b.rows for b in spec.buckets]
    k_list = tk.topk_k_rows_for(rows_list, param)
    per_bucket = []
    for b, k_rows in zip(spec.buckets, k_list):
        itemsize = b.bytes // b.n_padded
        elems = b.n_padded                       # rows * 128
        k_elems = k_rows * 128
        compact = k_rows * tk.TOPK_LANE_ROW_BYTES
        common = 3 * elems * itemsize            # self + grad reads, out write
        dense_b = common + n_neighbors * (compact + 2 * 4 * elems)
        sparse_b = common + n_neighbors * compact
        dense_f = 3 * elems + n_neighbors * (3 * elems + 2 * k_elems)
        sparse_f = 3 * elems + n_neighbors * 3 * k_elems
        per_bucket.append({
            "rows": b.rows, "k_rows": k_rows,
            "dense_bytes": dense_b, "sparse_bytes": sparse_b,
            "dense_flops": dense_f, "sparse_flops": sparse_f,
        })

    def tot(key):
        return sum(pb[key] for pb in per_bucket)

    out = {
        "n_neighbors": n_neighbors,
        "per_bucket": per_bucket,
        "dense_bytes": tot("dense_bytes"),
        "sparse_bytes": tot("sparse_bytes"),
        "dense_flops": tot("dense_flops"),
        "sparse_flops": tot("sparse_flops"),
    }
    out["bytes_ratio"] = (out["dense_bytes"] / out["sparse_bytes"]
                          if out["sparse_bytes"] else float("nan"))
    out["flops_ratio"] = (out["dense_flops"] / out["sparse_flops"]
                          if out["sparse_flops"] else float("nan"))
    return out


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D_new for
    decode (one token per request), 2*N_active*D for prefill."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


# --------------------------------------------------------------------------
# the kernels' bounds
# --------------------------------------------------------------------------

# per update family: per-agent streams of the bucket's type read or written
# besides the mix (G, out; + V, V'; + LOOK; Adam: G, M, V, out, M', V'), and
# the float32 operations per element after the mix
STATE = {"cdsgd": 2, "cdmsgd": 4, "nesterov": 5, "adam": 6}
TAIL_FLOPS = {"cdsgd": 2, "cdmsgd": 4, "nesterov": 6, "adam": 14}


def kernel_family(name: str) -> str:
    """The update family (a key of :data:`STATE`) of a kernel name."""
    if name.startswith("cdadam"):
        return "adam"
    if "nesterov" in name:
        return "nesterov"
    return "cdmsgd" if name.startswith("cdmsgd") else "cdsgd"


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kernel_work(name: str, a_out: int, s: int, rows: int,
                dtype: torch.dtype = torch.float32, k_rows: int = 0,
                bucket: torch.dtype = torch.float32) -> tuple:
    """``(bytes, float32 operations)`` one launch of the update, quantize or
    threshold kernel ``name`` must move and do: each input read once, each
    output written once.

    ``dtype`` is the neighbour / payload / code type; ``bucket`` the type of
    the self, gradient, momentum and output buffers (``sr_quantize``: of its
    input); weights and scales are float32.  The ``_qm`` forms read two
    payloads.  For ``sr_quantize`` ``a_out`` is the agent count (Philox's
    integer work is not counted: the card's table gives no int32 rate, and
    the float work alone is far under the byte time).  Adam's divisions and
    square root count one operation each.  The sparse forms read ``s``
    compact stacks of ``k_rows`` lane rows (int8 value, int32 index, f32 row
    scale) besides the self buffer and the state, and do one multiply per
    compact element and a multiply and an add per element and output agent.
    For ``topk_threshold`` ``a_out`` is the agent count; its compares count
    as float32 operations, its integer adds not."""
    n = rows * 128
    esize = _itemsize(dtype)
    bsize = _itemsize(bucket)
    state = STATE[kernel_family(name)]
    tail = TAIL_FLOPS[kernel_family(name)]
    payloads = 2 if name.endswith("_qm") else 1
    if name == "topk_threshold":
        nbytes = a_out * (4 * n + 2 * 4 * 16)
        flops = a_out * n * 16
    elif name.endswith("_sparse"):
        kk = k_rows * 128
        nbytes = (4 * a_out * (s + 1) + s * (5 * kk + 4 * k_rows)
                  + bsize * a_out * n + bsize * state * a_out * n)
        flops = a_out * n * (1 + tail) + s * kk * (1 + 2 * a_out)
    elif name == "sr_quantize":
        nbytes = a_out * (bsize * n + esize * n + 4 * rows)
        flops = a_out * n * 8      # |x|, max, divide, + u, floor, 2 clamps, cast
    elif name.endswith(("_q", "_qm")):
        nbytes = (4 * a_out * (s + 1) + bsize * a_out * n
                  + payloads * (esize * s * n + 4 * s * rows)
                  + bsize * state * a_out * n)
        flops = a_out * n * (payloads * (1 + 3 * s) + tail)
    else:
        nbytes = 4 * a_out * s + esize * s * n + bsize * state * a_out * n
        flops = a_out * n * (2 * s + tail)
    return nbytes, flops


def kernel_bound(name: str, a_out: int, s: int, rows: int,
                 dtype: torch.dtype = torch.float32, k_rows: int = 0,
                 bucket: torch.dtype = torch.float32,
                 hw: Hardware = HW_H100) -> tuple:
    """``(bound_ms, bound_by)``: the larger of :func:`kernel_work`'s bytes
    over ``hw``'s memory rate and its float32 operations over ``hw``'s
    float32 rate, and which of the two it is."""
    nbytes, flops = kernel_work(name, a_out, s, rows, dtype, k_rows, bucket)
    t_bytes, t_ops = nbytes / hw.hbm_bw, flops / hw.f32_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
