"""The flash kernel in the model's layout ``(b, s, heads, d)``, as
:mod:`repro.kernels.flash_attention.ops`."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_any_length


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q ``(b, s, H, d)``, k and v ``(b, s, KV, d)`` -> ``(b, s, H, d)``, at
    any sequence length (the kernels mask ragged tiles).

    The kernel reads the transposed views in place; the result is a view
    of an output laid out like ``q``.  CPU tensors take the plain version.
    """
    out = flash_attention_any_length(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)
