"""Plain PyTorch version of the flash attention kernel (materializes the
scores), as :mod:`repro.kernels.flash_attention.ref`."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q ``(B, H, Sq, D)``; k, v ``(B, KV, Sk, D)``; output in ``q.dtype``.

    Query head ``h`` reads KV group ``h // (H // KV)``; ``causal`` allows
    ``col <= row`` and ``window`` allows ``col > row - window``, from global
    indices.  Scores, softmax and products in float32.
    """
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, kv, g, sq, d).float() * scale
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float())
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    allowed = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= cols <= rows
    if window is not None:
        allowed &= cols > rows - window
    s = torch.where(allowed, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)
