"""Fused consensus-SGD update: CUDA kernels, plain versions, dispatch.

* :mod:`.consensus_update` — the wrappers of the hand-written CUDA kernels
  (``csrc/consensus_update.cu``) and their launch counts;
* :mod:`.ref` — the plain PyTorch versions (CPU tensors, tests);
* :mod:`.ops` — the bucket-level entry points the optimizers call.
"""

from repro_torch.kernels.consensus_update.consensus_update import (
    KERNELS,
    cdmsgd_update,
    cdsgd_update,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.consensus_update.ops import (
    cdmsgd_update_flat,
    cdsgd_update_flat,
)

__all__ = ["KERNELS", "cdmsgd_update", "cdsgd_update", "launch_counts",
           "reset_launch_counts", "cdmsgd_update_flat", "cdsgd_update_flat"]
