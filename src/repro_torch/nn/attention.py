"""Grouped-query attention for prefill, training and cached decode, as the
GQA part of :mod:`repro.nn.attention`.

* Prefill (:func:`gqa_attention`) runs the flash kernel
  (:func:`repro_torch.kernels.flash_attention.ops.flash_attention_bshd`)
  with the layer's static window: a sliding-window layer and a global one
  are the same kernel with and without ``window``; an encoder's
  self-attention (``causal=False``) and cross-attention (``kv_x``: queries
  over another sequence, Sq != Sk) are the kernel without the causal mask.
  Any length is taken: the kernel masks ragged tiles.  bfloat16 runs the
  tensor-core kernel, float32 the float32 one (a bfloat16 query over
  float32 K/V, from seamless's float32 encoder, runs the float32 kernel
  and casts the result back, as the reference's float32 attention does);
  nothing falls back to plain code.  The kernel is forward-only, as the
  reference's is.
* Training (``gqa_attention(..., differentiable=True)``, which the LM
  loss asks for) computes the reference's own training attention in plain,
  differentiable PyTorch, with the reference's choice between them:
  :func:`banded_attention` when the window is static and below ``s`` and
  ``s`` is a multiple of the chunk (causal self-attention only),
  :func:`blockwise_attention` (online softmax over KV chunks, KV padded to
  a chunk multiple) otherwise.  Both compute in float32 and cast to the
  query's dtype, as the reference does.  A decoder's cross-attention in
  decode takes the same plain :func:`blockwise_attention` (decode launches
  no kernel).
* Decode (:func:`gqa_decode`) writes the new token's K/V into the cache
  **in place** and attends over it with :func:`decode_attention`, a plain
  einsum pair as in the reference (no kernel there either).

GQA groups query heads over KV heads; no KV repetition is materialized.

MLA (DeepSeek-V2's multi-head latent attention, :func:`mla_attention`)
expands the compressed ``c_kv`` into per-head K/V and runs
:func:`blockwise_attention` at qk width ``nope + rope`` and v width
``v_head``, in prefill as in training: the reference runs it plain too, and
the flash kernel takes one width for q, k and v.  Its decode
(:func:`mla_decode`) caches ``c_kv`` and the rotated ``k_rope`` only and
attends in the absorbed form, in float32.

Under a tensor-parallel context (``tp``,
:class:`repro_torch.nn.tensor_parallel.TensorParallel`; the dense family's
sharded serve and training modes) :func:`gqa_attention` and
:func:`gqa_decode` project to this rank's query heads (all of them when
the heads replicate) and take the KV heads those queries read: the local
ones when KV divides ``model``, else the needed ones of the replicated K/V
(:func:`~repro_torch.nn.tensor_parallel.kv_for_heads`).  Prefill runs the
flash kernel on the local heads, training the plain training attention;
the output projection's partial sums are reduced over ``model``.  In
training the replicated input's gradient is summed over ``model``, and so
is a replicated ``wk`` / ``wv``'s: each rank's ``dK``, ``dV`` come from
its own query heads only.  Decode over a cache whose KV heads are sharded
(or that is not sequence-sharded) needs no combine.  Over a
sequence-sharded cache the owner of ``cur_index`` writes the new K/V in
place, every rank computes the softmax partials (max, sum, output) of
every query head (the query heads gathered over ``model``) over its
positions (:func:`decode_attention_partial`, honouring ``window`` and
``cur_index``), and the partials, gathered over the axes that shard the
sequence, are combined in float32 for the local heads.  Context
parallelism (a sequence-sharded prefill) is ROADMAP A16.2.4.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.nn.layers import apply_rope, matmul
from repro_torch.nn.param import ParamDef
from repro_torch.nn.tensor_parallel import combine_partials, kv_for_heads

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


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cur_index: int, *,
                             window: Optional[int] = None,
                             offset: int = 0) -> torch.Tensor:
    """The softmax partials of ``q (b, 1, H, hd)`` over a block of caches
    ``(b, S, KV, hd)`` holding positions ``offset .. offset + S - 1``
    (:func:`decode_attention`'s mask): ``(b, H, hd + 2)`` float32, the
    unnormalized output, the max logit and the sum of ``exp(logit - max)``
    of each head (:func:`~repro_torch.nn.tensor_parallel.combine_partials`
    combines blocks)."""
    b, _, h, hd = q.shape
    s, kv, hdv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    group = h // kv
    qg = q.reshape(b, kv, group, hd).float() * (1.0 / math.sqrt(hd))
    logits = torch.einsum("bngd,bsnd->bngs", qg, k_cache.float())
    k_pos = offset + torch.arange(s, device=q.device)
    allowed = k_pos <= cur_index
    if window is not None:
        allowed &= k_pos > (cur_index - window)
    logits = torch.where(allowed[None, None, None, :], logits, NEG_INF)
    m = torch.amax(logits, dim=-1)
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bngs,bsne->bnge", p, v_cache.float())
    out = torch.cat([o, m[..., None], torch.sum(p, dim=-1)[..., None]], dim=-1)
    return out.reshape(b, h, hdv + 2)


def _allowed_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                  window) -> torch.Tensor:
    """``(q, k)`` bool mask from position indices."""
    allowed = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                         device=q_pos.device)
    if causal:
        allowed = allowed & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        allowed = allowed & (k_pos[None, :] > (q_pos[:, None] - window))
    return allowed


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_positions: Optional[torch.Tensor] = None,
                        k_positions: Optional[torch.Tensor] = None,
                        chunk: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention of ``q (b, sq, H, hd)`` over ``k (b, sk, KV,
    hd)`` / ``v (b, sk, KV, hdv)`` in KV chunks of ``chunk`` (the last
    padded; padded keys are masked out), float32 throughout, differentiable:
    the reference's ``blockwise_attention`` step by step (running max
    ``m``, running sum ``l``, accumulator, chunks in order).  ``scale``
    defaults to ``1 / sqrt(hd)``."""
    b, sq, h, hd = q.shape
    sk, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
    group = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    q_pos = q_positions if q_positions is not None else torch.arange(sq, device=dev)
    k_pos = k_positions if k_positions is not None else torch.arange(sk, device=dev)
    chunk = min(chunk, sk)
    n_chunks, rem = divmod(sk, chunk)
    if rem:
        pad = chunk - rem
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), 2**31 - 2,
                                             dtype=k_pos.dtype, device=dev)])
        n_chunks += 1
    qg = q.reshape(b, sq, kv, group, hd).float() * scale
    kf, vf = k.float(), v.float()
    m = torch.full((b, sq, kv, group), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kv, group), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kv, group, hdv), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = torch.einsum("bqngd,bcnd->bqngc", qg, kf[:, sl])
        allowed = _allowed_mask(q_pos, k_pos[sl], causal=causal, window=window)
        lg = torch.where(allowed[None, :, None, None, :], logits, NEG_INF)
        m_new = torch.maximum(m, torch.amax(lg, dim=-1))
        p = torch.exp(lg - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqngc,bcne->bqnge", p, vf[:, sl])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hdv).to(q.dtype)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, q_chunk: int = 512) -> torch.Tensor:
    """Causal sliding-window attention that computes only the band: per
    query chunk, the KV span ``[chunk_end - span, chunk_end)`` with ``span
    = q_chunk + ceil(window / q_chunk) q_chunk`` (at most ``s``), float32,
    differentiable (the reference's ``banded_attention``).  Needs a static
    ``window`` and ``s % q_chunk == 0``."""
    b, s, h, hd = q.shape
    kv, hdv = k.shape[2], v.shape[3]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"seq {s} must divide q_chunk {q_chunk}")
    n_ch = s // q_chunk
    span = min(q_chunk + -(-window // q_chunk) * q_chunk, s)
    starts = [max(0, (i + 1) * q_chunk - span) for i in range(n_ch)]
    k_sp = torch.stack([k[:, st:st + span] for st in starts], dim=1)
    v_sp = torch.stack([v[:, st:st + span] for st in starts], dim=1)
    qc = q.reshape(b, n_ch, q_chunk, kv, g, hd).float() * scale
    logits = torch.einsum("bmqngd,bmcnd->bmngqc", qc, k_sp.float())
    dev = q.device
    q_pos = (torch.arange(n_ch, device=dev) * q_chunk)[:, None] \
        + torch.arange(q_chunk, device=dev)[None]
    # the window starts, made on the device (a tensor built from a list
    # cannot be made on ``meta`` inside a grad transform)
    k_start = torch.clamp(torch.arange(n_ch, device=dev) * q_chunk
                          + (q_chunk - span), min=0)
    k_pos = k_start[:, None] + torch.arange(span, device=dev)[None]
    allowed = (k_pos[:, None, :] <= q_pos[:, :, None]) \
        & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    logits = torch.where(allowed[None, :, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bmngqc,bmcne->bmqnge", p, v_sp.float())
    return out.reshape(b, s, h, hdv).to(q.dtype)


def gqa_template(d: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype=torch.float32) -> Dict[str, ParamDef]:
    return {
        "wq": ParamDef((d, n_heads, head_dim), ("fsdp", "tp", None), init="scaled", dtype=dtype),
        "wk": ParamDef((d, n_kv, head_dim), ("fsdp", "tp", None), init="scaled", dtype=dtype),
        "wv": ParamDef((d, n_kv, head_dim), ("fsdp", "tp", None), init="scaled", dtype=dtype),
        "wo": ParamDef((n_heads, head_dim, d), ("tp", None, "fsdp"), init="scaled", dtype=dtype),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product (promoting)."""
    return matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product (promoting)."""
    return matmul(o.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
           window: Optional[int]) -> torch.Tensor:
    """The flash kernel on ``(b, s, heads, d)`` operands; mixed dtypes
    (bfloat16 queries over float32 K/V) run the wider kernel on widened
    operands, the result in the query's dtype."""
    wide = torch.promote_types(q.dtype, k.dtype)
    out = flash_ops.flash_attention_bshd(q.to(wide), k.to(wide), v.to(wide),
                                         causal=causal, window=window)
    return out.to(q.dtype)


def gqa_attention(params, x: torch.Tensor, positions: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  rope_theta: float = 1e4, kv_x: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None, use_rope: bool = True,
                  chunk: int = 512, differentiable: bool = False,
                  tp=None) -> torch.Tensor:
    """Attention of ``x (b, s, d)`` over itself (``kv_x`` None; ``causal``,
    ``window`` None (global) or a static int (sliding window)) or over
    ``kv_x (b, sk, d)`` (cross-attention: never causal); rope, when
    ``use_rope``, reads ``positions`` for the queries and ``kv_positions``
    (default: ``positions`` for self-attention, ``0 .. sk-1`` for
    ``kv_x``) for the keys.

    ``differentiable=False`` (prefill) runs the forward-only flash kernel,
    its mask built from position indices ``0 .. s-1`` (and ``0 .. sk-1``).
    ``differentiable=True`` (training, and cross-attention in decode)
    computes the reference's plain attention: :func:`banded_attention` for
    causal self-attention with a window below ``s`` when ``s`` is a
    multiple of ``min(chunk, s)``, else :func:`blockwise_attention` over
    the positions, both with ``chunk``.  ``tp``: this rank's query heads
    (see the module docstring), self-attention only."""
    wk, wv = params["wk"], params["wv"]
    if tp is not None and differentiable and tp.heads:
        # the gradients of the replicated input (and K/V projections) are
        # partial on each rank: summed over model in the backward pass
        if tp.kv:
            x = tp.copy(x)
        else:
            x, wk, wv = tp.copy(x, wk, wv)
    src = x if kv_x is None else kv_x
    q = _project(x, params["wq"])
    k = _project(src, wk)
    v = _project(src, wv)
    kp = kv_positions if kv_positions is not None else (
        positions if kv_x is None else torch.arange(src.shape[1], device=x.device))
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kp, rope_theta)
    if tp is not None and tp.heads and not tp.kv:
        k, v = kv_for_heads(k, v, *tp.head_range(q.shape[2]))
    causal = causal and kv_x is None
    s = x.shape[1]
    if not differentiable:
        out = _flash(q, k, v, causal=causal, window=window)
    elif kv_x is None and causal and window and s % min(chunk, s) == 0 and window < s:
        out = banded_attention(q, k, v, window=window, q_chunk=chunk)
    else:
        out = blockwise_attention(q, k, v, causal=causal, window=window,
                                  q_positions=positions, k_positions=kp, chunk=chunk)
    if tp is not None:
        return _tp_out(out, params["wo"], tp)
    return _out(out, params["wo"])


def gqa_init_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                   dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
    }


def gqa_decode(params, cache: Dict[str, torch.Tensor], x: torch.Tensor,
               cur_index: int, *, window: Optional[int] = None,
               rope_theta: float = 1e4,
               tp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token ``x (b, 1, d)`` at position ``cur_index``.  Its K/V are
    written into ``cache`` in place; returns ``(y (b, 1, d), cache)``.
    ``tp``: this rank's query heads over its block of the cache (see the
    module docstring)."""
    pos = torch.full((1,), cur_index, dtype=torch.int32, device=x.device)
    q = apply_rope(_project(x, params["wq"]), pos, rope_theta)
    k = apply_rope(_project(x, params["wk"]), pos, rope_theta)
    v = _project(x, params["wv"])
    if tp is not None:
        return _sharded_decode(params, cache, q, k, v, cur_index, window, tp), cache
    cache["k"][:, cur_index] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, cur_index] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], cur_index, window=window)
    return _out(out, params["wo"]), cache


def _sharded_decode(params, cache, q, k, v, cur_index: int, window, tp):
    """:func:`gqa_decode`'s attention on this rank's query heads ``q`` over
    its block of ``cache``, with the new token's ``k``, ``v`` (its local
    KV heads when the weights split them)."""
    h0, h1, n_heads = tp.head_range(q.shape[2])
    if tp.seq_axes is None:
        # whole sequences: the local KV heads, or a replica of every one
        cache["k"][:, cur_index] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, cur_index] = v[:, 0].to(cache["v"].dtype)
        kc, vc = cache["k"], cache["v"]
        if tp.heads and not tp.kv_cache:
            kc, vc = kv_for_heads(kc, vc, h0, h1, n_heads)
        out = decode_attention(q, kc, vc, cur_index, window=window)
    else:
        # a block of positions of every KV head: the owner of cur_index
        # writes, every rank's partials over every query head combine
        if tp.kv:
            k, v = tp.gather_model(k, dim=2), tp.gather_model(v, dim=2)
        s_loc = cache["k"].shape[1]
        off = tp.seq_offset(s_loc)
        if off <= cur_index < off + s_loc:
            cache["k"][:, cur_index - off] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, cur_index - off] = v[:, 0].to(cache["v"].dtype)
        q_all = tp.gather_model(q, dim=2) if tp.heads else q
        part = decode_attention_partial(q_all, cache["k"], cache["v"], cur_index,
                                        window=window, offset=off)
        parts = tp.gather_over(part, tp.seq_axes)[:, :, h0:h1]
        out = combine_partials(parts)[:, None].to(q.dtype)
    return _tp_out(out, params["wo"], tp)


def _tp_out(o: torch.Tensor, wo: torch.Tensor, tp) -> torch.Tensor:
    """:func:`_out` on this rank's heads: row-parallel over ``model`` when
    the heads are split."""
    if not tp.heads:
        return _out(o, wo)
    return tp.row_parallel(o.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def gqa_cross_decode(params, enc_kv: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """Cross-attention of one decode token ``x (b, 1, d)`` over precomputed
    encoder K/V ``{"k", "v"} (b, sk, KV, hd)`` (every key allowed, no
    rope), as the reference's ``gqa_cross_decode``."""
    q = _project(x, params["wq"])
    out = decode_attention(q, enc_kv["k"], enc_kv["v"], enc_kv["k"].shape[1] - 1)
    return _out(out, params["wo"])


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------


def mla_template(d: int, n_heads: int, *, kv_lora: int, q_lora: int, qk_nope: int,
                 qk_rope: int, v_head: int, dtype=torch.float32) -> Dict[str, ParamDef]:
    t: Dict[str, ParamDef] = {
        "wdkv": ParamDef((d, kv_lora), ("fsdp", None), init="scaled", dtype=dtype),
        "wkr": ParamDef((d, qk_rope), ("fsdp", None), init="scaled", dtype=dtype),
        "wuk": ParamDef((kv_lora, n_heads, qk_nope), (None, "tp", None),
                        init="scaled", dtype=dtype),
        "wuv": ParamDef((kv_lora, n_heads, v_head), (None, "tp", None),
                        init="scaled", dtype=dtype),
        "wo": ParamDef((n_heads, v_head, d), ("tp", None, "fsdp"), init="scaled",
                       dtype=dtype),
    }
    if q_lora:
        t["wdq"] = ParamDef((d, q_lora), ("fsdp", None), init="scaled", dtype=dtype)
        t["wuq"] = ParamDef((q_lora, n_heads, qk_nope + qk_rope), (None, "tp", None),
                            init="scaled", dtype=dtype)
    else:
        t["wq"] = ParamDef((d, n_heads, qk_nope + qk_rope), ("fsdp", "tp", None),
                           init="scaled", dtype=dtype)
    return t


def _mla_q(params, x: torch.Tensor, positions: torch.Tensor, qk_nope: int,
           rope_theta: float):
    """``(q_nope, q_rope)`` of ``x (b, s, d)``, through the low-rank query
    path when the template has one; rope on the ``q_rope`` part."""
    if "wdq" in params:
        q = _project(torch.matmul(x, params["wdq"]), params["wuq"])
    else:
        q = _project(x, params["wq"])
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    return q_nope, apply_rope(q_rope, positions, rope_theta)


def _mla_k_rope(params, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float) -> torch.Tensor:
    """The shared rotated key part, ``(b, s, 1, qk_rope)``."""
    return apply_rope(torch.matmul(x, params["wkr"])[:, :, None, :], positions,
                      rope_theta)


def mla_attention(params, x: torch.Tensor, positions: torch.Tensor, *, qk_nope: int,
                  qk_rope: int, rope_theta: float = 1e4,
                  chunk: int = 512) -> torch.Tensor:
    """Causal MLA of ``x (b, s, d)`` (prefill and training): ``c_kv``
    expanded to per-head K (nope part, plus the shared rope part) and V,
    then :func:`blockwise_attention` with scale ``1 / sqrt(nope + rope)``."""
    q_nope, q_rope = _mla_q(params, x, positions, qk_nope, rope_theta)
    c = torch.matmul(x, params["wdkv"])                          # compressed kv
    k_rope = _mla_k_rope(params, x, positions, rope_theta)
    k_nope = _project(c, params["wuk"])
    v = _project(c, params["wuv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], qk_rope)], dim=-1)
    out = blockwise_attention(q, k, v, causal=True, q_positions=positions,
                              k_positions=positions, chunk=chunk,
                              scale=1.0 / math.sqrt(qk_nope + qk_rope))
    return _out(out, params["wo"])


def mla_init_cache(batch: int, max_len: int, kv_lora: int, qk_rope: int,
                   dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return {
        "c": torch.zeros((batch, max_len, kv_lora), dtype=dtype, device=device),
        "kr": torch.zeros((batch, max_len, qk_rope), dtype=dtype, device=device),
    }


def mla_decode(params, cache: Dict[str, torch.Tensor], x: torch.Tensor,
               cur_index: int, *, qk_nope: int, qk_rope: int,
               rope_theta: float = 1e4) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed decode of one token ``x (b, 1, d)`` at ``cur_index``: its
    ``c_kv`` and rotated ``k_rope`` are written into ``cache`` in place, then
    ``logits_h(s) = <q_nope_h W_uk_h, c_s> + <q_rope_h, k_rope_s>`` and
    ``out_h = (sum_s p_h(s) c_s) W_uv_h``, in float32 (the reference's:
    bf16 would round the reassociated product visibly off the prefill's)."""
    pos = torch.full((1,), cur_index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(params, x, pos, qk_nope, rope_theta)
    c_new = torch.matmul(x, params["wdkv"])
    kr_new = _mla_k_rope(params, x, pos, rope_theta)[:, :, 0, :]
    cache["c"][:, cur_index] = c_new[:, 0].to(cache["c"].dtype)
    cache["kr"][:, cur_index] = kr_new[:, 0].to(cache["kr"].dtype)

    f32 = torch.float32
    q_c = torch.einsum("bshk,rhk->bshr", q_nope.to(f32), params["wuk"].to(f32))
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    c_all, kr_all = cache["c"].to(f32), cache["kr"].to(f32)
    logits = (torch.einsum("bthr,bsr->bths", q_c, c_all)
              + torch.einsum("bthk,bsk->bths", q_rope.to(f32), kr_all)) * scale
    allowed = torch.arange(c_all.shape[1], device=x.device) <= cur_index
    logits = torch.where(allowed[None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bths,bsr->bthr", p, c_all)               # weighted c
    out = torch.einsum("bthr,rhe->bthe", ctx, params["wuv"].to(f32))
    return _out(out.to(x.dtype), params["wo"]), cache
