"""Wrapper of the flash attention CUDA kernels, with their launch counts.

Replaces the Pallas TPU kernel :func:`repro.kernels.flash_attention.
flash_attention.flash_attention`: masked grouped-query attention with an
online softmax, q ``(B, H, Sq, D)`` and k, v ``(B, KV, Sk, D)``, output in
``q.dtype`` (source ``csrc/flash_attention.cu``).  Dispatch is by type:
bfloat16 operands run the tensor-core kernel (``flash_tc_kernel``: wgmma
and TMA, P rounded to bfloat16 before the PV product), float32 operands
the float32 kernel (``flash_kernel``, float32 arithmetic throughout; it
cuts the key loop of long query tiles over several blocks and combines
their partial results in a workspace that the wrapper allocates at the
size ``flash_attention_workspace`` returns: one launch, one count).

The operands may be strided views (the D axis contiguous): the model's
``(b, s, heads, D)`` projections are passed transposed, without a copy,
and the output is allocated with ``q``'s strides.  The kernels take D in
{64, 120, 128, 256} (120 runs the width-128 kernels with the last 8
columns zero-filled).

:func:`flash_attention` keeps the reference kernel's contract: at its
default blocks of :data:`BLOCK` rows, a length above ``BLOCK`` must be a
multiple of it, else :class:`ValueError` (on every device).
:func:`flash_attention_any_length` is the same launch without that check
(any ``Sq, Sk >= 1``: the kernels mask ragged tiles); the model path
(:func:`.ops.flash_attention_bshd`) calls it.  Both count their launches
on ``flash_attention.launches`` and, by kernel, on
``flash_attention.launches_by_variant`` (``"tc"``, ``"f32"``).

CUDA tensors launch a kernel (a launch error raises; a bfloat16 operand
the tensor-core kernel cannot take raises and never reaches the float32
kernel); CPU tensors run the plain version :func:`.ref.attention_ref`.
There is no backward pass (the reference has none): an operand that
requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
SIGNATURES = {
    "flash_attention": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.POINTER(_LL), _F, _I, _I, _P, _LL, _I,
                             _P)),
    "flash_attention_workspace": (_I, (_I, _I, _I, _I, _I, _I, _I, _I,
                                       ctypes.POINTER(_LL))),
}
#: operand dtype -> the kernel's code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: operand dtype -> the kernel that runs it (keys of ``launches_by_variant``)
VARIANTS = {torch.bfloat16: "tc", torch.float32: "f32"}
HEAD_DIMS = (64, 120, 128, 256)
#: the reference kernel's default block_q / block_k
BLOCK = 128


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from its CUDA source on first use."""
    return build.load("flash_attention", SIGNATURES)


def check_blocks(sq: int, sk: int) -> None:
    bq, bk = min(BLOCK, sq), min(BLOCK, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"seq lens ({sq},{sk}) must divide blocks ({bq},{bk}): "
                         f"a length above {BLOCK} must be a multiple of it")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q (B, H, Sq, D)`` over ``k, v (B, KV, Sk, D)``, at the
    reference kernel's lengths (:func:`check_blocks`)."""
    _check_shapes(q, k, v)
    check_blocks(q.shape[2], k.shape[2])
    return flash_attention_any_length(q, k, v, causal=causal, window=window,
                                      scale=scale)


def _check_shapes(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor, got "
                             f"{getattr(t, 'shape', type(t))}")
    b, h, _, d = q.shape
    kv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, KV, Sk, {d})")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")


def flash_attention_any_length(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               *, causal: bool = True,
                               window: Optional[int] = None,
                               scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` at any ``Sq, Sk >= 1``."""
    _check_shapes(q, k, v)
    d, sk = q.shape[3], k.shape[2]
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int or None, got {window}")
    build.forward_only("flash_attention", q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    device = q.device
    if k.device != device or v.device != device:
        raise ValueError("q, k and v must be on one device")
    if device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    out = torch.empty_like(q)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    esize = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if t.data_ptr() % 16 or any((s * esize) % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    b, h, sq, _ = q.shape
    lib = library()
    causal, window = int(bool(causal)), 0 if window is None else int(window)
    nbytes = 0 if q.dtype != torch.float32 else \
        _workspace_bytes(device.index, b, h, sq, sk, d, causal, window)
    # the float32 kernel's split units write partial results here
    ws = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None
    strides = (_LL * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                         *out.stride()[:3])
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, h, k.shape[1], sq, sk, d, strides,
        float(np.float32(scale)), causal, window,
        None if ws is None else ws.data_ptr(), nbytes, device.index,
        build.current_stream(device))
    build.check_launch(rc, f"flash_attention ({VARIANTS[q.dtype]})")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[VARIANTS[q.dtype]] += 1
    return out


@functools.lru_cache(maxsize=256)
def _workspace_bytes(device: int, b: int, h: int, sq: int, sk: int, d: int,
                     causal: int, window: int) -> int:
    """The float32 kernel's workspace bytes for one call's shape (its plan
    depends on the shape and the card only)."""
    nbytes = _LL(0)
    build.check_launch(library().flash_attention_workspace(
        b, h, sq, sk, d, causal, window, device, ctypes.byref(nbytes)),
        "flash_attention_workspace")
    return nbytes.value


def reset_launches() -> None:
    """Set the launch count and the per-kernel counts to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_variant = {name: 0 for name in VARIANTS.values()}


reset_launches()
