"""PyTorch + CUDA port of the collaborative deep learning reproduction.

Mirrors :mod:`repro`'s module layout so each counterpart is found at the
same path, but imports neither JAX nor anything of :mod:`repro`: it runs on
a machine with PyTorch alone.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).

The kernels on the training and serving paths are hand-written CUDA C++
for Hopper (``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use and bound
with ``ctypes`` (:mod:`repro_torch.kernels.build`).  On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
