"""Wrapper of the WKV6 CUDA kernel, with its launch count.

Replaces the Pallas TPU kernel :func:`repro.kernels.rwkv_scan.rwkv_scan.
wkv6_pallas`: the RWKV6 recurrence per batch x head from a zero state,

    y_t = r_t . (S_t + (u * k_t) v_t^T),   S_{t+1} = diag(w_t) S_t + k_t v_t^T,

returning ``y`` in ``r.dtype`` and the final state in float32 (source
``csrc/wkv6.cu``).  Two layouts: the reference's folded ``(BH, S, hs)``
with ``u (BH, hs)``, and the model's ``(B, S, NH, hs)`` with ``u (NH,
hs)`` shared over the batch; the kernel reads either in place (the hs axis
contiguous), so the model's projections need no fold and no cast.  r, k,
v are float32 or bfloat16 (one type), w and u float32 (the model's w is
float32); hs in {16, 32, 64}.  Unlike the reference kernel, any sequence length is
taken (the reference's needs a multiple of its chunk).  The kernel copies
rows of r, k, v and w into shared memory 16 bytes at a time; an operand
whose rows do not start on 16 bytes is first copied to a contiguous tensor
(:func:`_aligned16`; never on the model's path).

CUDA tensors launch the kernel (a launch error raises); CPU tensors run
the plain version :func:`.ref.wkv6_ref`.  There is no backward pass (the
reference has none): an operand that requires grad raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv_scan import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "wkv6": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  ctypes.POINTER(ctypes.c_longlong), _I, _P)),
}
#: r, k, v dtype -> the kernel's code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from its CUDA source on first use."""
    return build.load("wkv6", SIGNATURES)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` if each of its rows (all axes but the last, of size > 1) starts
    on 16 bytes, else a contiguous copy (a fresh allocation, aligned)."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            stride * size % 16 == 0
            for n, stride in zip(t.shape[:-1], t.stride()[:-1]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(r, k, v, w, u):
    """The kernel on ``(B, S, NH, hs)`` operands, ``u (B, NH, hs)`` (any
    strides but the unit hs axis); returns ``(y, state (B*NH, hs, hs))``."""
    b, s, nh, hs = r.shape
    device = r.device
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 r, k, v of one "
                        f"type, got {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32 {name}, got {t.dtype}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head sizes {HEAD_SIZES}, got {hs}")
    y = torch.empty((b, s, nh, hs), dtype=r.dtype, device=device)
    state = torch.empty((b * nh, hs, hs), dtype=torch.float32, device=device)
    if b * nh == 0:
        return y, state
    if s == 0:
        return y, state.zero_()
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head axis must be contiguous")
    r, k, v, w = (_aligned16(t) for t in (r, k, v, w))
    strides = (ctypes.c_longlong * 17)(
        *(x for t in (r, k, v, w, y) for x in (t.stride(0), t.stride(2),
                                                 t.stride(1))),
        u.stride(0), u.stride(1))
    rc = library().wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), state.data_ptr(), DTYPES[r.dtype], b, nh,
        s, hs, strides, device.index, build.current_stream(device))
    build.check_launch(rc, "wkv6")
    wkv6.launches += 1
    return y, state


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor):
    """WKV6 from a zero state.

    ``r, k, v, w (BH, S, hs)`` with ``u (BH, hs)`` -> ``(y (BH, S, hs),
    state (BH, hs, hs))``; or ``(B, S, NH, hs)`` with ``u (NH, hs)`` ->
    ``(y (B, S, NH, hs), state (B*NH, hs, hs))``.
    """
    if not isinstance(r, torch.Tensor) or r.dim() not in (3, 4):
        raise ValueError(f"r must be (BH, S, hs) or (B, S, NH, hs), got "
                         f"{getattr(r, 'shape', type(r))}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(r.shape)}")
    folded = r.dim() == 3
    want_u = (r.shape[0], r.shape[2]) if folded else (r.shape[2], r.shape[3])
    if tuple(u.shape) != want_u:
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {want_u}")
    build.forward_only("wkv6", r, k, v, w, u)
    device = r.device
    if any(t.device != device for t in (k, v, w, u)):
        raise ValueError("r, k, v, w and u must be on one device")
    if device.type == "cpu":
        if folded:
            y, state = ref.wkv6_ref(r, k, v, w, u)
            return y.to(r.dtype), state
        b, s, nh, hs = r.shape

        def fold(x):
            return x.transpose(1, 2).reshape(b * nh, s, hs)

        uf = u[None].expand(b, nh, hs).reshape(b * nh, hs)
        y, state = ref.wkv6_ref(fold(r), fold(k), fold(v), fold(w), uf)
        return y.reshape(b, nh, s, hs).transpose(1, 2).to(r.dtype), state
    if device.type != "cuda":
        raise ValueError(f"no WKV6 kernel for device {device}")
    if folded:
        y, state = _launch(r[:, :, None], k[:, :, None], v[:, :, None],
                           w[:, :, None], u[:, None])
        return y[:, :, 0], state
    return _launch(r, k, v, w, u[None].expand(r.shape[0], *u.shape))


wkv6.launches = 0
