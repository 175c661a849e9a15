"""Hand-written Hopper kernels of the port.

Per kernel family, as in :mod:`repro.kernels`: ``<name>.py`` wraps the CUDA
kernel (sources in ``src/repro_torch/csrc/``, built by :mod:`.build`),
``ref.py`` holds its plain PyTorch version, and ``ops.py`` is the entry
point the rest of the package calls.
"""
