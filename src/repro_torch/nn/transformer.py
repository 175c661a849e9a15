"""Model assembly for the ported families, as :mod:`repro.nn.transformer`:
templates, prefill forward, loss, and cached decode.

Ported: dense GQA transformers with local/global sliding windows
(gemma3-1b) and RWKV6 (rwkv6-1.6b).  The parameter tree has the
reference's layout exactly (so the JAX package's weights carry over):
layers stacked on a leading ``layers`` axis per homogeneous group, gemma's
local/global interleave regrouped into period-sized super-blocks
(``lg_super``, each holding ``period`` stacked layers with a static window
per sub-layer) and a tail (``lg_tail``).  Where the reference scans over a
stack (``lax.scan``) the port loops over its layer slices in Python.

Prefill attention runs the flash kernel and the RWKV6 prefill the WKV6
kernel (see :mod:`.attention`, :mod:`.ssm`); both are forward-only.  The
loss is the training path: :func:`loss_fn` asks the layers for the
reference's differentiable attention (banded / blockwise) and WKV
(chunked / scan), in plain PyTorch.  Decode carries per-layer
caches with the same stacked layout; the port writes them **in place**
(views of the stacked tensors) and returns the same tree.  MoE, hybrid,
encoder-decoder, MLA and frontend families raise ``NotImplementedError``
(ROADMAP A17).

Public API:
  model_template(cfg)                       -> ParamDef tree
  forward(cfg, params, batch)               -> (logits, aux)  [prefill]
  loss_fn(cfg, params, batch)               -> (scalar, metrics)  [training]
  init_cache(cfg, batch, max_len)           -> cache tree
  decode_step(cfg, params, cache, tok, idx) -> (logits, cache)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.nn import attention as attn
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn.layers import (
    embed,
    embedding_template,
    make_norm,
    mlp,
    mlp_template,
    unembed,
    unembed_template,
)
from repro_torch.nn.param import stack_layers
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


def _unported(cfg, what: str):
    return NotImplementedError(
        f"{cfg.name}: {what} is not ported yet (ROADMAP A17); the port runs "
        "dense GQA (full / sliding-window / local-global) and RWKV6 models")


def _check_family(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise _unported(cfg, "the encoder-decoder family")
    if cfg.is_moe:
        raise _unported(cfg, "the MoE family")
    if cfg.hybrid:
        raise _unported(cfg, "the hybrid (attention + mamba) family")
    if cfg.modality != "text":
        raise _unported(cfg, f"the {cfg.modality} frontend")
    if cfg.attn_kind == "mla":
        raise _unported(cfg, "MLA")
    if cfg.ssm_kind not in ("none", "rwkv6"):
        raise _unported(cfg, f"the {cfg.ssm_kind} SSM")


def _norm(cfg):
    return make_norm(cfg.norm_kind)


def _static_window(cfg) -> Optional[int]:
    """The attention window of a plain dense stack (None = global)."""
    return cfg.window if cfg.attn_kind == "swa" else None


# --------------------------------------------------------------------------
# templates
# --------------------------------------------------------------------------


def dense_block_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    return {
        "ln1": nt(cfg.d_model, cfg.dtype),
        "attn": attn.gqa_template(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim_, dtype=cfg.dtype),
        "ln2": nt(cfg.d_model, cfg.dtype),
        "mlp": mlp_template(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated, dtype=cfg.dtype),
    }


def rwkv_block_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    hs = min(64, cfg.d_model)
    t = ssm_lib.rwkv6_template(cfg.d_model, cfg.d_ff, head_size=hs, dtype=cfg.dtype)
    return {"ln1": nt(cfg.d_model, cfg.dtype), "ln2": nt(cfg.d_model, cfg.dtype), **t}


def layer_groups(cfg):
    """Ordered ``(name, count, template_fn)`` of the homogeneous stacks.

    local_global archs are regrouped into period-sized super-blocks
    (``lg_super``: ``period`` stacked layers, the last global, the others
    local) and a tail of local layers (``lg_tail``); layer order is kept.
    """
    _check_family(cfg)
    if cfg.attn_kind == "local_global" and cfg.local_global_period > 1:
        p = cfg.local_global_period
        n_super, tail = divmod(cfg.n_layers, p)
        groups = []
        if n_super:
            groups.append(("lg_super", n_super,
                           lambda c: stack_layers(dense_block_template(c), p)))
        if tail:
            groups.append(("lg_tail", tail, dense_block_template))
        return groups
    if cfg.ssm_kind == "rwkv6":
        return [("rwkv", cfg.n_layers, rwkv_block_template)]
    return [("dense", cfg.n_layers, dense_block_template)]


def model_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    t: Dict[str, Any] = {
        "embed": embedding_template(cfg.vocab_size, cfg.d_model, cfg.dtype),
        "final_norm": nt(cfg.d_model, cfg.dtype),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = unembed_template(cfg.d_model, cfg.vocab_size, cfg.dtype)
    t["groups"] = {name: stack_layers(tmpl_fn(cfg), count)
                   for name, count, tmpl_fn in layer_groups(cfg) if count > 0}
    return t


def _layer(tree: PyTree, i: int) -> PyTree:
    """Slice ``i`` of every leaf of a stacked tree (views)."""
    return tree_map(lambda t: t[i], tree)


def _sublayers(cfg, name: str, stacked: PyTree):
    """``(params or cache slice, window)`` of every layer of a group, in
    model order."""
    n = tree_leaves(stacked)[0].shape[0]
    for j in range(n):
        block = _layer(stacked, j)
        if name == "lg_super":
            for i in range(cfg.local_global_period):
                yield _layer(block, i), (None if cfg.layer_is_global(i) else cfg.window)
        elif name == "lg_tail":
            yield block, cfg.window
        else:
            yield block, _static_window(cfg)


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------


def _block_apply(cfg, group: str, params, x, positions, window,
                 differentiable: bool):
    _, norm = _norm(cfg)
    if group == "rwkv":
        y, _ = ssm_lib.rwkv6_time_mix(params["time_mix"], norm(params["ln1"], x),
                                      head_size=min(64, cfg.d_model),
                                      differentiable=differentiable)
        x = x + y
        y, _ = ssm_lib.rwkv6_channel_mix(params["channel_mix"], norm(params["ln2"], x))
        return x + y
    h = norm(params["ln1"], x)
    x = x + attn.gqa_attention(params["attn"], h, positions, window=window,
                               rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                               differentiable=differentiable)
    return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act)


def _logits(cfg, params, x):
    _, norm = _norm(cfg)
    x = norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"]["table"].t())
    return unembed(params["unembed"], x)


def forward(cfg, params, batch, *, differentiable: bool = False):
    """Forward of ``batch["inputs"] (b, s)`` tokens.  Returns ``(logits (b,
    s, vocab), aux)``; ``aux["moe_aux"]`` is 0 (no MoE).  Prefill
    (``differentiable=False``) runs the forward-only attention and WKV6
    kernels; ``differentiable=True`` (the loss) their plain, differentiable
    training forms."""
    x = embed(params["embed"], batch["inputs"])
    pos = torch.arange(x.shape[1], device=x.device)
    for name, count, _ in layer_groups(cfg):
        if count == 0:
            continue
        group = "rwkv" if name == "rwkv" else "dense"
        for p, window in _sublayers(cfg, name, params["groups"][name]):
            x = _block_apply(cfg, group, p, x, pos, window, differentiable)
    logits = _logits(cfg, params, x)
    return logits, {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(cfg, params, batch):
    """``(loss, metrics)``: mean next-token cross entropy over the batch,
    through the differentiable (training) forward."""
    logits, aux = forward(cfg, params, batch, differentiable=True)
    loss = cross_entropy(logits, batch["targets"], batch.get("mask"))
    return loss, {"ce": loss, "moe_aux": aux["moe_aux"]}


# --------------------------------------------------------------------------
# decode (serve): KV caches / recurrent state per layer group
# --------------------------------------------------------------------------


def _block_cache_init(cfg, group: str, batch: int, max_len: int, device):
    dt = cfg.dtype
    if group == "rwkv":
        return ssm_lib.rwkv6_init_state(batch, cfg.d_model, head_size=min(64, cfg.d_model),
                                        dtype=dt, device=device)
    single = attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim_,
                                 dtype=dt, device=device)
    if group == "lg_super":
        p = cfg.local_global_period
        return tree_map(lambda t: t[None].repeat(p, *([1] * t.dim())), single)
    return single


def init_cache(cfg, batch: int, max_len: int, device=None):
    """Zeroed caches, stacked over each group's layers (the reference's
    layout): K/V ``(layers[, period], b, max_len, KV, hd)`` for attention,
    ``{"tm": {"shift", "S"}, "cm"}`` for RWKV6."""
    cache: Dict[str, Any] = {}
    for name, count, _ in layer_groups(cfg):
        if count == 0:
            continue
        single = _block_cache_init(cfg, name, batch, max_len, device)
        cache[name] = tree_map(
            lambda t: t[None].repeat(count, *([1] * t.dim())), single)
    return cache


def _block_decode(cfg, group: str, params, cache, x, cur_index: int, window):
    """One token through one block; ``cache`` (views) updated in place."""
    _, norm = _norm(cfg)
    if group == "rwkv":
        h = norm(params["ln1"], x)
        y, tm = ssm_lib.rwkv6_time_mix(params["time_mix"], h,
                                       head_size=min(64, cfg.d_model), state=cache["tm"])
        x = x + y
        h = norm(params["ln2"], x)
        y, cm = ssm_lib.rwkv6_channel_mix(params["channel_mix"], h, state=cache["cm"])
        for view, new in zip(tree_leaves(cache), tree_leaves({"tm": tm, "cm": cm})):
            view.copy_(new)
        return x + y
    h = norm(params["ln1"], x)
    a, _ = attn.gqa_decode(params["attn"], cache, h, cur_index, window=window,
                           rope_theta=cfg.rope_theta)
    x = x + a
    return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act)


def decode_step(cfg, params, cache, tokens: torch.Tensor, cur_index: int):
    """One decode step.  ``tokens (b, 1)``; returns ``(logits (b, vocab),
    cache)``, the cache updated in place."""
    x = embed(params["embed"], tokens)
    for name, count, _ in layer_groups(cfg):
        if count == 0:
            continue
        group = "rwkv" if name == "rwkv" else "dense"
        for (p, window), (c, _) in zip(_sublayers(cfg, name, params["groups"][name]),
                                       _sublayers(cfg, name, cache[name])):
            x = _block_decode(cfg, group, p, c, x, int(cur_index), window)
    return _logits(cfg, params, x)[:, 0, :], cache
