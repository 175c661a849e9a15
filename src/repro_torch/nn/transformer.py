"""Model assembly for the ported families, as :mod:`repro.nn.transformer`:
templates, prefill forward, loss, and cached decode.

Every family of the reference: dense GQA transformers with local/global
sliding windows (gemma3-1b and the other dense configs), RWKV6
(rwkv6-1.6b), MoE blocks with GQA (kimi-k2-1t-a32b) or MLA
(deepseek-v2-236b) attention after ``n_dense_layers`` dense blocks, the VLM
frontend (internvl2-2b: a projector over the batch's stub patch
embeddings, prepended to the token embeddings), the hybrid (hymba-1.5b:
sliding-window attention and a mamba head on the same normed input, each
normed, averaged into the residual) and the encoder-decoder (seamless-m4t-
medium: a non-causal encoder over the projected stub audio frames, a
decoder of causal self-attention, cross-attention over the encoder's
output without rope, and an MLP).  The parameter tree has the reference's
layout exactly (so the JAX package's weights carry over): layers stacked on
a leading ``layers`` axis per homogeneous group (``dense`` then ``moe`` for
an MoE model, ``enc`` then ``dec`` for an encoder-decoder), gemma's
local/global interleave regrouped into period-sized super-blocks
(``lg_super``, each holding ``period`` stacked layers with a static window
per sub-layer) and a tail (``lg_tail``).  Where the reference scans over a
stack (``lax.scan``) the port loops over its layer slices in Python.

Prefill attention runs the flash kernel and the RWKV6 prefill the WKV6
kernel (see :mod:`.attention`, :mod:`.ssm`); both are forward-only.  MLA,
the MoE layer and mamba are plain PyTorch, as they are XLA in the
reference.  The encoder follows its frontend's dtype: the reference's CLIs
feed float32 frames, which promote the encoder to float32 against bfloat16
weights (JAX's promotion, by hand: :func:`repro_torch.nn.layers.matmul`);
the decoder stays in the weights' dtype.  The loss is the training path:
:func:`loss_fn` asks the layers for the reference's differentiable
attention (banded / blockwise) and WKV (chunked / scan), in plain PyTorch,
and adds ``router_aux_weight`` times the MoE layers' load-balance term.
``remat=True`` recomputes each block (a gemma super-block as one unit) in
the backward pass instead of keeping its
activations, as the reference's ``jax.checkpoint`` of each scanned block
does; the gradients are the same bits (a decoder block takes the encoder's
output as an input of its unit, so its gradient reaches the encoder).
Decode carries per-layer caches with the same stacked layout; the port
writes them **in place** (views of the stacked tensors) and returns the
same tree; an encoder-decoder's cache also holds ``enc_out``, the encoder's
output (:func:`encode_for_decode`), which every cross-attention reads.

:func:`forward`, :func:`loss_fn` and :func:`decode_step` take a
tensor-parallel context (``tp``,
:class:`repro_torch.nn.tensor_parallel.TensorParallel`) for the dense
family's sharded serve and training modes: ``params`` and the cache are
then this rank's blocks, each block's ``fsdp`` shards are gathered just
before it runs and dropped after (serving; training has none), and the
layers run on the rank's heads, ``d_ff`` and vocabulary
(:func:`repro_torch.launch.sharding.local_cache` allocates a rank's block
of the cache); the loss's collectives over ``model`` have their backward
passes, also under remat (every rank reruns a block's forward collectives
in the same order).  Without a context they run as before.  A sharded call
for any other family raises (ROADMAP A16.2.3).

Public API:
  model_template(cfg)                       -> ParamDef tree
  forward(cfg, params, batch)               -> (logits, aux)  [prefill]
  loss_fn(cfg, params, batch)               -> (scalar, metrics)  [training]
  init_cache(cfg, batch, max_len[, enc_len]) -> cache tree
  decode_step(cfg, params, cache, tok, idx) -> (logits, cache)
  encode_for_decode(cfg, params, frontend)  -> enc_out  [encoder-decoder]
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.func import vjp

from repro_torch.nn import attention as attn
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn.layers import (
    embed,
    embedding_template,
    make_norm,
    matmul,
    mlp,
    mlp_template,
    unembed,
    unembed_template,
    vocab_logits,
)
from repro_torch.nn.param import SERVE_FAMILIES_ITEM, ParamDef, stack_layers
from repro_torch.nn.tensor_parallel import vocab_parallel_cross_entropy
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any


def is_dense_family(cfg) -> bool:
    """A text-only stack of GQA blocks with dense MLPs (gemma3-1b,
    granite-3-8b, h2o-danube-3-4b, starcoder2-7b)."""
    return (cfg.modality == "text" and not cfg.is_moe and cfg.attn_kind != "mla"
            and cfg.ssm_kind == "none" and not cfg.hybrid
            and not cfg.is_encoder_decoder)


def _check_family(cfg, sharded: bool = False) -> None:
    """Raise on a combination the reference's zoo has no model for: an
    unknown modality or SSM kind, mamba outside the hybrid family, or a
    hybrid without mamba; ``sharded``: on any family but the dense one
    (its serve mode and training over the model axis, and MoE's expert
    split, are ROADMAP A16.2.3)."""
    if sharded and not is_dense_family(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the sharded mode over a model axis (serving, and "
            "training with tp / expert over model) runs the dense family "
            "(GQA blocks, dense MLPs, text only); rwkv6, MoE's expert split, "
            f"MLA, hymba, seamless and internvl2's frontend are "
            f"{SERVE_FAMILIES_ITEM}")
    if cfg.modality not in ("text", "vlm", "audio"):
        raise ValueError(f"{cfg.name}: no {cfg.modality!r} frontend in the zoo")
    if cfg.ssm_kind not in ("none", "rwkv6", "mamba"):
        raise ValueError(f"{cfg.name}: no {cfg.ssm_kind!r} SSM in the zoo")
    if cfg.hybrid != (cfg.ssm_kind == "mamba"):
        raise ValueError(f"{cfg.name}: the zoo runs mamba only as the hybrid "
                         f"family's heads (hybrid={cfg.hybrid}, "
                         f"ssm_kind={cfg.ssm_kind!r})")


def _norm(cfg):
    return make_norm(cfg.norm_kind)


def _static_window(cfg) -> Optional[int]:
    """The attention window of a plain dense stack (None = global)."""
    return cfg.window if cfg.attn_kind == "swa" else None


def _has_frontend(cfg) -> bool:
    return cfg.modality in ("audio", "vlm") and not cfg.is_encoder_decoder


# --------------------------------------------------------------------------
# templates
# --------------------------------------------------------------------------


def _attn_template(cfg):
    if cfg.attn_kind == "mla":
        return attn.mla_template(
            cfg.d_model, cfg.n_heads, kv_lora=cfg.kv_lora_rank,
            q_lora=cfg.q_lora_rank, qk_nope=cfg.qk_nope_head_dim,
            qk_rope=cfg.qk_rope_head_dim, v_head=cfg.v_head_dim, dtype=cfg.dtype)
    return attn.gqa_template(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim_, dtype=cfg.dtype)


def dense_block_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    return {
        "ln1": nt(cfg.d_model, cfg.dtype),
        "attn": _attn_template(cfg),
        "ln2": nt(cfg.d_model, cfg.dtype),
        "mlp": mlp_template(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated, dtype=cfg.dtype),
    }


def moe_block_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    return {
        "ln1": nt(cfg.d_model, cfg.dtype),
        "attn": _attn_template(cfg),
        "ln2": nt(cfg.d_model, cfg.dtype),
        "moe": moe_lib.moe_template(cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                                    n_shared=cfg.n_shared_experts,
                                    gated=cfg.mlp_gated, dtype=cfg.dtype),
    }


def rwkv_block_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    hs = min(64, cfg.d_model)
    t = ssm_lib.rwkv6_template(cfg.d_model, cfg.d_ff, head_size=hs, dtype=cfg.dtype)
    return {"ln1": nt(cfg.d_model, cfg.dtype), "ln2": nt(cfg.d_model, cfg.dtype), **t}


def hymba_block_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    return {
        "ln1": nt(cfg.d_model, cfg.dtype),
        "attn": _attn_template(cfg),
        "mamba": ssm_lib.mamba_template(cfg.d_model, n_state=cfg.ssm_state,
                                        dtype=cfg.dtype),
        "ln_a": nt(cfg.d_model, cfg.dtype),     # per-path output norms (the fusion)
        "ln_s": nt(cfg.d_model, cfg.dtype),
        "ln2": nt(cfg.d_model, cfg.dtype),
        "mlp": mlp_template(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated, dtype=cfg.dtype),
    }


# an encoder block holds a dense block's leaves (the reference's own template)
encoder_block_template = dense_block_template


def decoder_xattn_block_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    return {
        "ln1": nt(cfg.d_model, cfg.dtype),
        "attn": _attn_template(cfg),
        "ln_x": nt(cfg.d_model, cfg.dtype),
        "xattn": attn.gqa_template(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype=cfg.dtype),
        "ln2": nt(cfg.d_model, cfg.dtype),
        "mlp": mlp_template(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated, dtype=cfg.dtype),
    }


def layer_groups(cfg):
    """Ordered ``(name, count, template_fn)`` of the homogeneous stacks.

    local_global archs are regrouped into period-sized super-blocks
    (``lg_super``: ``period`` stacked layers, the last global, the others
    local) and a tail of local layers (``lg_tail``); an encoder-decoder is
    ``enc`` then ``dec``; an MoE model is ``n_dense_layers`` dense blocks
    then MoE blocks; layer order is kept.
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
    if cfg.is_encoder_decoder:
        return [("enc", cfg.enc_layers, encoder_block_template),
                ("dec", cfg.n_layers, decoder_xattn_block_template)]
    if cfg.is_moe:
        groups = []
        if cfg.n_dense_layers:
            groups.append(("dense", cfg.n_dense_layers, dense_block_template))
        groups.append(("moe", cfg.n_layers - cfg.n_dense_layers, moe_block_template))
        return groups
    if cfg.ssm_kind == "rwkv6":
        return [("rwkv", cfg.n_layers, rwkv_block_template)]
    if cfg.hybrid:
        return [("hymba", cfg.n_layers, hymba_block_template)]
    return [("dense", cfg.n_layers, dense_block_template)]


def model_template(cfg) -> Dict[str, Any]:
    nt, _ = _norm(cfg)
    t: Dict[str, Any] = {
        "embed": embedding_template(cfg.vocab_size, cfg.d_model, cfg.dtype),
        "final_norm": nt(cfg.d_model, cfg.dtype),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = unembed_template(cfg.d_model, cfg.vocab_size, cfg.dtype)
    groups = layer_groups(cfg)
    if cfg.modality in ("audio", "vlm"):
        # projector from the stub frontend's embeddings into d_model
        t["frontend_proj"] = {
            "w": ParamDef((cfg.frontend_dim, cfg.d_model), (None, "fsdp"),
                          init="scaled", dtype=cfg.dtype)}
    t["groups"] = {name: stack_layers(tmpl_fn(cfg), count)
                   for name, count, tmpl_fn in groups if count > 0}
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


def _self_attention(cfg, params, x, positions, window, differentiable: bool,
                    tp=None):
    if cfg.attn_kind == "mla":
        return attn.mla_attention(params, x, positions, qk_nope=cfg.qk_nope_head_dim,
                                  qk_rope=cfg.qk_rope_head_dim,
                                  rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk)
    return attn.gqa_attention(params, x, positions, window=window,
                              rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                              differentiable=differentiable, tp=tp)


def _block_apply(cfg, group: str, params, x, positions, window,
                 differentiable: bool, tp=None):
    """One block; returns ``(x, aux)``: an MoE block's load-balance term
    (float32), ``None`` for the others.  ``tp``: a dense block on this
    rank's blocks, its ``fsdp`` shards gathered here."""
    _, norm = _norm(cfg)
    if tp is not None:
        params = tp.gather_block(params)
    if group == "rwkv":
        y, _ = ssm_lib.rwkv6_time_mix(params["time_mix"], norm(params["ln1"], x),
                                      head_size=min(64, cfg.d_model),
                                      differentiable=differentiable)
        x = x + y
        y, _ = ssm_lib.rwkv6_channel_mix(params["channel_mix"], norm(params["ln2"], x))
        return x + y, None
    if group == "hymba":
        h = norm(params["ln1"], x)
        a = _self_attention(cfg, params["attn"], h, positions, window, differentiable)
        s, _ = ssm_lib.mamba_apply(params["mamba"], h)
        x = x + 0.5 * (norm(params["ln_a"], a) + norm(params["ln_s"], s))
        return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act), None
    if group == "enc":
        h = norm(params["ln1"], x)
        x = x + attn.gqa_attention(params["attn"], h, positions, causal=False,
                                   rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                                   differentiable=differentiable)
        return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act), None
    h = norm(params["ln1"], x)
    x = x + _self_attention(cfg, params["attn"], h, positions, window, differentiable,
                            tp)
    if group == "moe":
        y, aux = moe_lib.moe_apply(params["moe"], norm(params["ln2"], x),
                                   top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + y, aux
    return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act, tp=tp), None


def _dec_block_apply(cfg, params, x, positions, enc_out, enc_positions,
                     differentiable: bool):
    """A decoder block: causal self-attention with rope, cross-attention
    over ``enc_out`` without rope, the MLP."""
    _, norm = _norm(cfg)
    h = norm(params["ln1"], x)
    x = x + _self_attention(cfg, params["attn"], h, positions, None, differentiable)
    h = norm(params["ln_x"], x)
    x = x + attn.gqa_attention(params["xattn"], h, positions, kv_x=enc_out,
                               kv_positions=enc_positions, use_rope=False,
                               chunk=cfg.attn_chunk, differentiable=differentiable)
    return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act)


def _unit_fn(cfg, name: str, positions, differentiable: bool, tp=None) -> Callable:
    """``fn(x, unit) -> (x, aux)`` of one slice of group ``name``'s stack:
    a block, or a gemma super-block (its ``period`` dense layers in order,
    no aux).  A decoder block's unit is ``{"p": block, "enc": enc_out}``:
    the encoder's output is one of its inputs, so a rematerialized unit
    returns its gradient.  ``positions`` None: ``0 .. s-1`` made inside
    ``fn`` (a rematerialized unit closes over no tensor: one made outside
    the autograd Function belongs to another functorch level)."""

    def pos(x):
        return positions if positions is not None else \
            torch.arange(x.shape[1], device=x.device)

    if name == "dec":
        def dec_block(x, unit):
            enc = unit["enc"]
            return _dec_block_apply(cfg, unit["p"], x, pos(x), enc,
                                    torch.arange(enc.shape[1], device=enc.device),
                                    differentiable), None
        return dec_block
    if name == "lg_super":
        def super_block(x, unit):
            positions_ = pos(x)
            for i in range(cfg.local_global_period):
                window = None if cfg.layer_is_global(i) else cfg.window
                x, _ = _block_apply(cfg, "dense", _layer(unit, i), x, positions_,
                                    window, differentiable, tp)
            return x, None
        return super_block
    group = "dense" if name.startswith("lg_") else name
    window = cfg.window if name == "lg_tail" else _static_window(cfg)

    def block(x, unit):
        return _block_apply(cfg, group, unit, x, pos(x), window, differentiable, tp)
    return block


class _Remat(torch.autograd.Function):
    """``fn(x, unit)`` whose backward recomputes the forward (with
    ``torch.func.vjp``) instead of keeping its activations: the port's
    ``jax.checkpoint``.  Only the unit's inputs are saved.  The unit's
    parameter leaves are explicit tensor arguments (flattened), so the
    generated vmap rule sees them under the stacked trainer's ``vmap``;
    ``fn`` closes over static settings only, no tensor.

    ``torch.func.grad`` runs its backward with ``create_graph=True``, which
    would record the recompute in the outer graph and keep every unit's
    activations to the end: the recompute runs under ``no_grad`` (the
    outer level records nothing), its pullback with the outer backward's
    ``create_graph`` (the same backward formulas, so the same bits, as
    without remat), and
    the cotangents leave detached (nothing holds the recompute once the
    unit's backward returns).  So remat does not support a second
    derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, treedef, x, *leaves):
        return fn(x, tree_unflatten(treedef, leaves))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, treedef, *tensors = inputs
        ctx.fn, ctx.treedef = fn, treedef
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        fn, treedef = ctx.fn, ctx.treedef

        def recompute(x, *leaves):
            return fn(x, tree_unflatten(treedef, leaves))

        # the engine runs a backward in grad mode exactly when it creates a graph
        create_graph = torch.is_grad_enabled()
        with torch.no_grad():
            _, pullback = vjp(recompute, *ctx.saved_tensors)
            cots = pullback(grads[0] if len(grads) == 1 else grads,
                            create_graph=create_graph)
        return (None, None, *(c.detach() for c in cots))


def _apply_unit(fn: Callable, x, unit, remat: bool, has_aux: bool):
    """``fn(x, unit)``, through :class:`_Remat` when ``remat``; ``(x,
    aux)`` (``aux`` None unless ``has_aux``)."""
    if not remat:
        return fn(x, unit)
    leaves, treedef = tree_flatten(unit)
    if has_aux:
        return _Remat.apply(fn, treedef, x, *leaves)
    return _Remat.apply(lambda h, u: fn(h, u)[0], treedef, x, *leaves), None


def _run_group(cfg, name: str, stacked, x, pos, differentiable: bool, remat: bool,
               enc_out=None, tp=None):
    """``x`` through every slice of group ``name``'s stack, in order
    (``enc_out`` into each decoder block); returns ``(x, aux)``, the MoE
    load-balance terms summed (None without MoE)."""
    fn = _unit_fn(cfg, name, None if remat else pos, differentiable, tp)
    aux_total = None
    for j in range(tree_leaves(stacked)[0].shape[0]):
        unit = _layer(stacked, j)
        if enc_out is not None:
            # a view per block: the backward sums the block's own gradients
            # to ``enc_out`` before adding them to the other blocks', as the
            # rematerialized unit (which returns their sum) does: the same bits
            unit = {"p": unit, "enc": enc_out.view_as(enc_out)}
        x, aux = _apply_unit(fn, x, unit, remat, name == "moe")
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


def _encode(cfg, params, frontend: torch.Tensor, differentiable: bool,
            remat: bool) -> torch.Tensor:
    """The encoder over the projected stub frames ``(b, frames,
    frontend_dim)``, in the frames' dtype promoted against the weights'
    (float32 frames: a float32 encoder), no final norm."""
    fe = matmul(frontend, params["frontend_proj"]["w"])
    pos = torch.arange(fe.shape[1], device=fe.device)
    enc_out, _ = _run_group(cfg, "enc", params["groups"]["enc"], fe, pos,
                            differentiable, remat)
    return enc_out


def _embed_inputs(cfg, params, batch, embedding, tp=None):
    """Token embeddings (``embedding``: the embedding's params), behind the
    projected frontend embeddings for a VLM (``batch["frontend"] (b,
    frontend_tokens, frontend_dim)``).  Returns ``(x, positions)``,
    positions over frontend plus text."""
    x = embed(embedding, batch["inputs"], tp)
    if _has_frontend(cfg):
        fe = torch.matmul(batch["frontend"].to(x.dtype), params["frontend_proj"]["w"])
        x = torch.cat([fe, x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def _embedding(params, tp=None):
    """The embedding's params: under ``tp`` gathered over ``fsdp`` once a
    step, for the embedding and a tied head."""
    return params["embed"] if tp is None else tp.gather_top(params["embed"], "embed")


def _logits(cfg, params, x, embedding, tp=None, gather: bool = True):
    """The final norm and the head: tied (on ``embedding``) or untied
    (``gather=False``: this rank's block of a sharded vocabulary)."""
    _, norm = _norm(cfg)
    top = (lambda name: params[name]) if tp is None else \
        (lambda name: tp.gather_top(params[name], name))
    x = norm(top("final_norm"), x)
    if cfg.tie_embeddings:
        return vocab_logits(x, embedding["table"].t(), tp, gather)
    return unembed(top("unembed"), x, tp, gather)


def forward(cfg, params, batch, *, differentiable: bool = False, remat: bool = False,
            tp=None, last_only: bool = False, gather: bool = True):
    """Forward of ``batch["inputs"] (b, s)`` tokens (behind ``batch
    ["frontend"]`` for a VLM; an encoder-decoder's decoder over them, its
    encoder over ``batch["frontend"]``).  Returns ``(logits (b, [frontend
    +] s, vocab), aux)``; ``aux["moe_aux"]`` sums the MoE layers'
    load-balance terms (0 without MoE).  Prefill (``differentiable=False``)
    runs the forward-only attention and WKV6 kernels;
    ``differentiable=True`` (the loss) their plain, differentiable training
    forms.  ``remat=True`` recomputes each block in the backward pass.
    ``tp``: the dense family's sharded prefill or training forward on this
    rank's blocks (see the module docstring; ``gather=False``: this rank's
    block of a vocabulary sharded over ``model``).  ``last_only``: the
    logits of the last position only, ``(b, 1, vocab)`` (a prefill's)."""
    if tp is not None:
        _check_family(cfg, sharded=True)
    emb = _embedding(params, tp)
    if cfg.is_encoder_decoder:
        enc_out = _encode(cfg, params, batch["frontend"], differentiable, remat)
        x = embed(emb, batch["inputs"])
        pos = torch.arange(x.shape[1], device=x.device)
        groups = [("dec", enc_out)]
    else:
        x, pos = _embed_inputs(cfg, params, batch, emb, tp)
        groups = [(name, None) for name, count, _ in layer_groups(cfg) if count]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, enc_out in groups:
        x, aux = _run_group(cfg, name, params["groups"][name], x, pos,
                            differentiable, remat, enc_out, tp)
        if aux is not None:
            aux_total = aux_total + aux
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x, emb, tp, gather), {"moe_aux": aux_total}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask=None,
                  tp=None) -> torch.Tensor:
    """The mean (masked) next-token cross entropy in float32; ``tp`` with a
    vocabulary sharded over ``model``: ``logits`` are this rank's block,
    reduced without a gather
    (:func:`~repro_torch.nn.tensor_parallel.vocab_parallel_cross_entropy`)."""
    if tp is not None and tp.vocab:
        return vocab_parallel_cross_entropy(logits, targets, tp, mask)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(cfg, params, batch, *, remat: bool = False, tp=None):
    """``(loss, metrics)``: the mean next-token cross entropy over the batch
    (a VLM's text tail only: frontend positions carry no targets; every
    position of an encoder-decoder's decoder) plus
    ``router_aux_weight`` times the MoE load-balance term, through the
    differentiable (training) forward; ``remat`` as in :func:`forward`.
    ``tp``: the dense family's training on this rank's blocks over
    ``model`` (the logits never gathered: a vocabulary-parallel cross
    entropy)."""
    logits, aux = forward(cfg, params, batch, differentiable=True, remat=remat,
                          tp=tp, gather=False)
    tgt = batch["targets"]
    if _has_frontend(cfg):
        logits = logits[:, -tgt.shape[1]:, :]
    ce = cross_entropy(logits, tgt, batch.get("mask"), tp)
    total = ce + cfg.router_aux_weight * aux["moe_aux"]
    return total, {"ce": ce, "moe_aux": aux["moe_aux"]}


# --------------------------------------------------------------------------
# decode (serve): KV caches / recurrent state per layer group
# --------------------------------------------------------------------------


def _block_cache_init(cfg, group: str, batch: int, max_len: int, device):
    dt = cfg.dtype
    if group == "rwkv":
        return ssm_lib.rwkv6_init_state(batch, cfg.d_model, head_size=min(64, cfg.d_model),
                                        dtype=dt, device=device)
    if group == "hymba":
        return {"attn": attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads,
                                            cfg.head_dim_, dtype=dt, device=device),
                "mamba": ssm_lib.mamba_init_state(batch, cfg.d_model, cfg.ssm_state,
                                                  device=device)}
    if cfg.attn_kind == "mla":
        return attn.mla_init_cache(batch, max_len, cfg.kv_lora_rank,
                                   cfg.qk_rope_head_dim, dtype=dt, device=device)
    single = attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim_,
                                 dtype=dt, device=device)
    if group == "lg_super":
        p = cfg.local_global_period
        return tree_map(lambda t: t[None].repeat(p, *([1] * t.dim())), single)
    return single


def init_cache(cfg, batch: int, max_len: int, enc_len: int = 0, device=None):
    """Zeroed caches, stacked over each group's layers (the reference's
    layout): K/V ``(layers[, period], b, max_len, KV, hd)`` for attention,
    ``{"c", "kr"}`` ``(layers, b, max_len, kv_lora | qk_rope)`` for MLA,
    ``{"tm": {"shift", "S"}, "cm"}`` for RWKV6, ``{"attn": K/V, "mamba":
    (layers, b, d, ssm_state) float32}`` for hymba; an encoder-decoder's
    decoder K/V and ``enc_out (b, enc_len, d)`` (the encoder runs once,
    :func:`encode_for_decode`, and keeps no cache)."""
    cache: Dict[str, Any] = {}
    for name, count, _ in layer_groups(cfg):
        if count == 0 or name == "enc":
            continue
        single = _block_cache_init(cfg, name, batch, max_len, device)
        cache[name] = tree_map(
            lambda t: t[None].repeat(count, *([1] * t.dim())), single)
        if name == "dec":
            cache["enc_out"] = torch.zeros((batch, enc_len, cfg.d_model),
                                           dtype=cfg.dtype, device=device)
    return cache


def _block_decode(cfg, group: str, params, cache, x, cur_index: int, window,
                  tp=None):
    """One token through one block; ``cache`` (views) updated in place.
    ``tp``: a dense block on this rank's blocks, its ``fsdp`` shards
    gathered here."""
    _, norm = _norm(cfg)
    if tp is not None:
        params = tp.gather_block(params)
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
    if group == "hymba":
        h = norm(params["ln1"], x)
        a, _ = attn.gqa_decode(params["attn"], cache["attn"], h, cur_index,
                               window=window, rope_theta=cfg.rope_theta)
        s, state = ssm_lib.mamba_apply(params["mamba"], h, state=cache["mamba"])
        cache["mamba"].copy_(state)
        x = x + 0.5 * (norm(params["ln_a"], a) + norm(params["ln_s"], s))
        return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act)
    h = norm(params["ln1"], x)
    if cfg.attn_kind == "mla":
        a, _ = attn.mla_decode(params["attn"], cache, h, cur_index,
                               qk_nope=cfg.qk_nope_head_dim,
                               qk_rope=cfg.qk_rope_head_dim, rope_theta=cfg.rope_theta)
    else:
        a, _ = attn.gqa_decode(params["attn"], cache, h, cur_index, window=window,
                               rope_theta=cfg.rope_theta, tp=tp)
    x = x + a
    if group == "moe":
        y, _ = moe_lib.moe_apply(params["moe"], norm(params["ln2"], x), top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + y
    return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act, tp=tp)


def _dec_block_decode(cfg, params, cache, x, cur_index: int, enc_out):
    """One token through a decoder block: self-attention on the cache
    (written in place), then cross-attention over ``enc_out`` in the
    reference's plain blockwise form (no kernel in decode)."""
    _, norm = _norm(cfg)
    h = norm(params["ln1"], x)
    a, _ = attn.gqa_decode(params["attn"], cache, h, cur_index, rope_theta=cfg.rope_theta)
    x = x + a
    h = norm(params["ln_x"], x)
    x = x + attn.gqa_attention(
        params["xattn"], h, torch.full((1,), cur_index, dtype=torch.int32, device=x.device),
        causal=False, kv_x=enc_out,
        kv_positions=torch.arange(enc_out.shape[1], device=x.device),
        use_rope=False, chunk=cfg.attn_chunk, differentiable=True)
    return x + mlp(params["mlp"], norm(params["ln2"], x), act=cfg.act)


def decode_step(cfg, params, cache, tokens: torch.Tensor, cur_index: int, tp=None):
    """One decode step.  ``tokens (b, 1)``; returns ``(logits (b, vocab),
    cache)``, the cache updated in place.  A VLM decodes text tokens only,
    without its frontend, as the reference does; an encoder-decoder's
    decoder reads ``cache["enc_out"]``.  ``tp``: the dense family's sharded
    decode on this rank's blocks of the params and the cache (its batch
    rows of ``tokens``; the logits of the whole vocabulary)."""
    if tp is not None:
        _check_family(cfg, sharded=True)
    emb = _embedding(params, tp)
    x = embed(emb, tokens, tp)
    if cfg.is_encoder_decoder:
        for (p, _), (c, _) in zip(_sublayers(cfg, "dec", params["groups"]["dec"]),
                                  _sublayers(cfg, "dec", cache["dec"])):
            x = _dec_block_decode(cfg, p, c, x, int(cur_index), cache["enc_out"])
        return _logits(cfg, params, x, emb)[:, 0, :], cache
    for name, count, _ in layer_groups(cfg):
        if count == 0:
            continue
        group = "dense" if name.startswith("lg_") else name
        for (p, window), (c, _) in zip(_sublayers(cfg, name, params["groups"][name]),
                                       _sublayers(cfg, name, cache[name])):
            x = _block_decode(cfg, group, p, c, x, int(cur_index), window, tp)
    return _logits(cfg, params, x, emb, tp)[:, 0, :], cache


def encode_for_decode(cfg, params, frontend: torch.Tensor) -> torch.Tensor:
    """Run the encoder once over ``frontend (b, frames, frontend_dim)``
    (prefill: the flash kernel, non-causal); the result goes into the
    decode cache as ``cache["enc_out"]`` (assigned, not copied: float32
    frames give a float32 ``enc_out``, as in the reference)."""
    return _encode(cfg, params, frontend, differentiable=False, remat=False)
