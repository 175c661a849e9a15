"""Grouped-query attention for prefill and cached decode, as the GQA part of
:mod:`repro.nn.attention`.

* Prefill (:func:`gqa_attention`, causal self-attention) runs the flash
  kernel (:func:`repro_torch.kernels.flash_attention.ops.
  flash_attention_bshd`) with the layer's static window: a sliding-window
  layer and a global one are the same kernel with and without ``window``.
  The reference computes the same function with ``banded_attention``
  (static window below ``s``) or ``blockwise_attention`` (otherwise).
  Any length is taken: the kernel masks ragged tiles (the reference's
  ``blockwise_attention`` pads KV to its chunk).  bfloat16 runs the
  tensor-core kernel, float32 the float32 one; nothing falls back to
  plain code.
* Decode (:func:`gqa_decode`) writes the new token's K/V into the cache
  **in place** and attends over it with :func:`decode_attention`, a plain
  einsum pair as in the reference (no kernel there either).

GQA groups query heads over KV heads; no KV repetition is materialized.
The reference's ``blockwise_attention`` and ``banded_attention`` as
functions of their own, MLA, cross-attention and context parallelism are
not ported yet (ROADMAP A17).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.nn.layers import apply_rope
from repro_torch.nn.param import ParamDef

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_index: int, *, window: Optional[int] = None) -> torch.Tensor:
    """q ``(b, 1, H, hd)`` against caches ``(b, S, KV, hd)``; keys at
    positions ``<= cur_index`` (and ``> cur_index - window``) count."""
    b, _, h, hd = q.shape
    s, kv, hdv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    group = h // kv
    qg = q.reshape(b, kv, group, hd).float() * (1.0 / math.sqrt(hd))
    logits = torch.einsum("bngd,bsnd->bngs", qg, k_cache.float())
    k_pos = torch.arange(s, device=q.device)
    allowed = k_pos <= cur_index
    if window is not None:
        allowed &= k_pos > (cur_index - window)
    logits = torch.where(allowed[None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bsne->bnge", p, v_cache.float())
    return out.reshape(b, 1, h, hdv).to(q.dtype)


def gqa_template(d: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype=torch.float32) -> Dict[str, ParamDef]:
    return {
        "wq": ParamDef((d, n_heads, head_dim), ("fsdp", "tp", None), init="scaled", dtype=dtype),
        "wk": ParamDef((d, n_kv, head_dim), ("fsdp", "tp", None), init="scaled", dtype=dtype),
        "wv": ParamDef((d, n_kv, head_dim), ("fsdp", "tp", None), init="scaled", dtype=dtype),
        "wo": ParamDef((n_heads, head_dim, d), ("tp", None, "fsdp"), init="scaled", dtype=dtype),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    return torch.matmul(o.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def gqa_attention(params, x: torch.Tensor, positions: torch.Tensor, *,
                  window: Optional[int] = None,
                  rope_theta: float = 1e4) -> torch.Tensor:
    """Causal self-attention of ``x (b, s, d)``; ``window`` None (global) or
    a static int (sliding window).  The mask is built from position indices
    ``0 .. s-1`` (the forward's ``positions``); rope reads ``positions``."""
    q = apply_rope(_project(x, params["wq"]), positions, rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, rope_theta)
    v = _project(x, params["wv"])
    out = flash_ops.flash_attention_bshd(q, k, v, causal=True, window=window)
    return _out(out, params["wo"])


def gqa_init_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                   dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
    }


def gqa_decode(params, cache: Dict[str, torch.Tensor], x: torch.Tensor,
               cur_index: int, *, window: Optional[int] = None,
               rope_theta: float = 1e4) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token ``x (b, 1, d)`` at position ``cur_index``.  Its K/V are
    written into ``cache`` in place; returns ``(y (b, 1, d), cache)``."""
    pos = torch.full((1,), cur_index, dtype=torch.int32, device=x.device)
    q = apply_rope(_project(x, params["wq"]), pos, rope_theta)
    k = apply_rope(_project(x, params["wk"]), pos, rope_theta)
    v = _project(x, params["wv"])
    cache["k"][:, cur_index] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, cur_index] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], cur_index, window=window)
    return _out(out, params["wo"]), cache
