"""Fused consensus updates and wire quantization: CUDA kernels, plain
versions, dispatch.

* :mod:`.consensus_update` — the wrappers of the hand-written CUDA kernels
  (``csrc/consensus_update.cu``, ``csrc/sr_quantize.cu``) and their launch
  counts;
* :mod:`.ref` — the plain PyTorch versions (CPU tensors, tests) and the
  port's stochastic-rounding stream;
* :mod:`.ops` — the bucket-level entry points the optimizers call.
"""

from repro_torch.kernels.consensus_update.consensus_update import (
    KERNELS,
    cdadam_update,
    cdadam_update_q,
    cdadam_update_qm,
    cdmsgd_nesterov_update,
    cdmsgd_nesterov_update_q,
    cdmsgd_nesterov_update_qm,
    cdmsgd_update,
    cdmsgd_update_q,
    cdmsgd_update_qm,
    cdsgd_update,
    cdsgd_update_q,
    launch_counts,
    reset_launch_counts,
    sr_quantize,
)
from repro_torch.kernels.consensus_update.ops import (
    cdadam_update_flat,
    cdmsgd_nesterov_update_flat,
    cdmsgd_update_flat,
    cdsgd_update_flat,
)

__all__ = ["KERNELS", "cdadam_update", "cdadam_update_q", "cdadam_update_qm",
           "cdmsgd_nesterov_update", "cdmsgd_nesterov_update_q",
           "cdmsgd_nesterov_update_qm", "cdmsgd_update", "cdmsgd_update_q",
           "cdmsgd_update_qm", "cdsgd_update", "cdsgd_update_q",
           "launch_counts", "reset_launch_counts", "sr_quantize",
           "cdadam_update_flat", "cdmsgd_nesterov_update_flat",
           "cdmsgd_update_flat", "cdsgd_update_flat"]
