"""Wrappers of the fused consensus-update CUDA kernels, with launch counts.

Per optimization step every agent computes, over its whole packed
parameter bucket (paper eq. 5, Algorithms 1-2),

    x' = sum_s w_s * neighbor_s  -  alpha * g                  (CDSGD)
    v' = mu v - alpha g ; x' = sum_s w_s * neighbor_s + v'     (CDMSGD)

The kernels live in ``src/repro_torch/csrc/consensus_update.cu`` (Hopper,
``sm_90a``) and replace the Pallas TPU kernels ``cdsgd_update_2d`` /
``cdmsgd_update_2d`` of :mod:`repro.kernels.consensus_update` in their
unquantized form.  Operand form: ``weights (A_out, S)``, ``neighbors
(S, rows, 128)``, per-output ``grad`` / ``momentum (A_out, rows, 128)``,
all float32 and contiguous on one device.  ``A_out = 1`` is one agent's
stencil; ``A_out = S = A`` with ``weights = Pi`` is the whole stacked
simulation in one launch.

Outputs are written **in place**: the new parameters into ``grad``'s
storage and ``v'`` into ``momentum``'s (the JAX kernels'
``input_output_aliases``); the wrappers return those same tensors.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (a
launch error raises), CPU tensors run the plain version in :mod:`.ref`.
Each wrapper counts its kernel launches in its ``launches`` attribute; the
CPU path launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.consensus_update import ref

LANE = 128

_P = ctypes.c_void_p
_SIGNATURES = {
    "cdsgd_update_f32": (ctypes.c_int, (_P, _P, _P, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_float,
                                        ctypes.c_int, _P)),
    "cdmsgd_update_f32": (ctypes.c_int, (_P, _P, _P, _P, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_float, ctypes.c_float,
                                         ctypes.c_int, _P)),
}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from the CUDA source on first use."""
    return build.load("consensus_update", _SIGNATURES)


def _f32(x) -> float:
    """The float32 value the kernel sees for a scalar operand."""
    return float(np.float32(x))


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (bf16 buckets are not ported "
                        f"yet), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check_operands(weights, neighbors, outs):
    """Validate the operand form; returns ``(a_out, s, rows, device)``."""
    if not isinstance(neighbors, torch.Tensor) or neighbors.dim() != 3 \
            or neighbors.shape[-1] != LANE:
        raise ValueError("neighbors must be a (S, rows, 128) tensor, got "
                         f"{getattr(neighbors, 'shape', type(neighbors))}")
    s, rows, _ = neighbors.shape
    device = neighbors.device
    if not isinstance(weights, torch.Tensor) or weights.dim() != 2:
        raise ValueError("weights must be an (A_out, S) tensor")
    a_out = weights.shape[0]
    _check("weights", weights, (a_out, s), device)
    _check("neighbors", neighbors, (s, rows, LANE), device)
    for name, t in outs:
        _check(name, t, (a_out, rows, LANE), device)
    # the outputs are written in place while every operand is read
    named = [("neighbors", neighbors), *outs]
    for i, (n1, t1) in enumerate(named):
        for n2, t2 in named[i + 1:]:
            (a0, a1), (b0, b1) = _span(t1), _span(t2)
            if a0 < b1 and b0 < a1:
                raise ValueError(f"{n1} and {n2} overlap in memory; the "
                                 f"update writes {n2} in place")
    if device.type == "cuda":
        for name, t in named:
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")
    elif device.type != "cpu":
        raise ValueError(f"no consensus-update kernel for device {device}")
    return a_out, s, rows, device


def _stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def _launch_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def cdsgd_update(weights: torch.Tensor, neighbors: torch.Tensor,
                 grad: torch.Tensor, alpha) -> torch.Tensor:
    """``grad[a] <- sum_s weights[a,s] neighbors[s] - alpha grad[a]``."""
    a_out, s, rows, device = _check_operands(weights, neighbors,
                                             [("grad", grad)])
    alpha = _f32(alpha)
    if device.type == "cpu":
        grad.copy_(ref.cdsgd_update_ref(weights, neighbors, grad, alpha))
        return grad
    if a_out == 0 or rows == 0:
        return grad
    rc = library().cdsgd_update_f32(
        weights.data_ptr(), neighbors.data_ptr(), grad.data_ptr(), a_out, s,
        rows * LANE // 4, alpha, device.index, _stream(device))
    _launch_check(rc, "cdsgd_update")
    cdsgd_update.launches += 1
    return grad


def cdmsgd_update(weights: torch.Tensor, neighbors: torch.Tensor,
                  grad: torch.Tensor, momentum: torch.Tensor, alpha, mu):
    """``momentum[a] <- mu momentum[a] - alpha grad[a]``;
    ``grad[a] <- sum_s weights[a,s] neighbors[s] + momentum[a]``.

    Returns ``(grad, momentum)``, both updated in place.
    """
    a_out, s, rows, device = _check_operands(
        weights, neighbors, [("grad", grad), ("momentum", momentum)])
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        out, new_v = ref.cdmsgd_update_ref(weights, neighbors, grad, momentum,
                                           alpha, mu)
        grad.copy_(out)
        momentum.copy_(new_v)
        return grad, momentum
    if a_out == 0 or rows == 0:
        return grad, momentum
    rc = library().cdmsgd_update_f32(
        weights.data_ptr(), neighbors.data_ptr(), grad.data_ptr(),
        momentum.data_ptr(), a_out, s, rows * LANE // 4, alpha, mu,
        device.index, _stream(device))
    _launch_check(rc, "cdmsgd_update")
    cdmsgd_update.launches += 1
    return grad, momentum


cdsgd_update.launches = 0
cdmsgd_update.launches = 0

#: every kernel wrapper of this module, by kernel name
KERNELS = {"cdsgd_update": cdsgd_update, "cdmsgd_update": cdmsgd_update}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
