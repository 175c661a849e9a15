"""The flash kernel in the model's layout ``(b, s, heads, d)``, as
:mod:`repro.kernels.flash_attention.ops`."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import opcount
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_any_length


def attention_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the mask keeps: every pair unmasked, or under
    the causal mask (and a window) those of rows ``i`` with keys ``lo_i ..
    min(i, sk - 1)``."""
    if not causal:
        return sq * sk
    rows = np.arange(sq, dtype=np.int64)
    lo = np.zeros_like(rows) if window is None else np.maximum(rows - window + 1, 0)
    return int(np.maximum(np.minimum(rows, sk - 1) - lo + 1, 0).sum())


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q ``(b, s, H, d)``, k and v ``(b, s, KV, d)`` -> ``(b, s, H, d)``, at
    any sequence length (the kernels mask ragged tiles).

    The kernel reads the transposed views in place; the result is a view
    of an output laid out like ``q``.  CPU tensors take the plain version.
    Under an open op counter (:mod:`repro_torch.analysis.opcount`) the call
    reports the kernel's work: ``Q K^T`` and ``P V`` over the pairs the
    mask keeps, and q, k, v read and the output written once.
    """
    def call():
        out = flash_attention_any_length(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), causal=causal,
                                         window=window)
        return out.transpose(1, 2)

    if not opcount.counting():
        return call()
    b, sq, h, d = q.shape
    pairs = attention_pairs(sq, k.shape[1], causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    with opcount.reported(dot_flops=2 * b * h * pairs * (d + v.shape[-1]),
                          traffic_bytes=nbytes):
        return call()
