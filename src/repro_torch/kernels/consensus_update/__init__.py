"""Fused consensus updates and wire quantization: CUDA kernels, plain
versions, dispatch.

* :mod:`.consensus_update` — the wrappers of the hand-written CUDA kernels
  (``csrc/consensus_update.cu``, ``csrc/sr_quantize.cu``) and their launch
  counts;
* :mod:`.ref` — the plain PyTorch versions (CPU tensors, tests) and the
  port's stochastic-rounding stream;
* :mod:`.ops` — the bucket-level entry points the optimizers call
  (``SparseNeighbors`` selects the sparse operand form of the top-k wire);
* :mod:`.topk` — the top-k / rank-r wire compressors and the wrapper of the
  top-k threshold kernel (``csrc/topk_threshold.cu``).
"""

from repro_torch.kernels.consensus_update.consensus_update import (
    KERNELS,
    cdadam_update,
    cdadam_update_q,
    cdadam_update_qm,
    cdadam_update_sparse,
    cdmsgd_nesterov_update,
    cdmsgd_nesterov_update_q,
    cdmsgd_nesterov_update_qm,
    cdmsgd_nesterov_update_sparse,
    cdmsgd_update,
    cdmsgd_update_q,
    cdmsgd_update_qm,
    cdmsgd_update_sparse,
    cdsgd_update,
    cdsgd_update_q,
    cdsgd_update_sparse,
    launch_counts,
    reset_launch_counts,
    sr_quantize,
)
from repro_torch.kernels.consensus_update.ops import (
    SparseNeighbors,
    cdadam_update_flat,
    cdmsgd_nesterov_update_flat,
    cdmsgd_update_flat,
    cdsgd_update_flat,
)
from repro_torch.kernels.consensus_update.topk import topk_threshold

__all__ = ["KERNELS", "cdadam_update", "cdadam_update_q", "cdadam_update_qm",
           "cdadam_update_sparse", "cdmsgd_nesterov_update",
           "cdmsgd_nesterov_update_q", "cdmsgd_nesterov_update_qm",
           "cdmsgd_nesterov_update_sparse", "cdmsgd_update",
           "cdmsgd_update_q", "cdmsgd_update_qm", "cdmsgd_update_sparse",
           "cdsgd_update", "cdsgd_update_q", "cdsgd_update_sparse",
           "launch_counts", "reset_launch_counts", "sr_quantize",
           "topk_threshold", "SparseNeighbors",
           "cdadam_update_flat", "cdmsgd_nesterov_update_flat",
           "cdmsgd_update_flat", "cdsgd_update_flat"]
