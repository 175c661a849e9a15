"""Basic layers as functions on tensors + their parameter templates, as
:mod:`repro.nn.layers`: norms, embedding / unembedding, the MLP and rotary
position embeddings.  The float32 upcasts sit where the reference has
them (norm statistics and affine, rope's rotation).  A matrix product of a
float32 activation and bfloat16 weights (seamless's float32 encoder) takes
JAX's promotion to float32 (:func:`matmul`): ``torch.matmul`` raises on
mixed dtypes.

Under a tensor-parallel context (``tp``,
:class:`repro_torch.nn.tensor_parallel.TensorParallel`) the embedding,
the logits and the MLP run on this rank's blocks: a vocabulary-sharded
table looks up the tokens it holds and sums over ``model``; the logits of
a sharded vocabulary are gathered along it, so the argmax and the logits
are the unsharded ones (the loss takes this rank's block, ``gather=False``,
and a vocabulary-parallel cross entropy); the MLP is column-parallel in
``wi`` / ``wg`` and row-parallel in ``wo`` when ``d_ff`` is split.  A
column-parallel product's replicated input goes through
:meth:`~repro_torch.nn.tensor_parallel.TensorParallel.copy`, whose
backward sums its gradient over ``model``."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.nn.param import ParamDef


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` with ``jnp.einsum``'s dtype promotion: operands of
    different dtypes are both cast to the promoted one (bfloat16 against
    float32 computes in float32)."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return torch.matmul(a, b)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm_template(d: int, dtype=torch.float32) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d,), (None,), init="ones", dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_template(d: int, dtype=torch.float32) -> Dict[str, ParamDef]:
    return {
        "scale": ParamDef((d,), (None,), init="ones", dtype=dtype),
        "bias": ParamDef((d,), (None,), init="zeros", dtype=dtype),
    }


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_template, rmsnorm
    if kind == "layernorm":
        return layernorm_template, layernorm
    raise ValueError(f"unknown norm {kind!r}")


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------


def embedding_template(vocab: int, d: int, dtype=torch.float32) -> Dict[str, ParamDef]:
    return {"table": ParamDef((vocab, d), ("tp", "fsdp"), init="embed", dtype=dtype)}


def embed(params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    table = params["table"]
    if tp is None or not tp.vocab:
        return table[tokens]
    n = table.shape[0]                   # this rank's rows of the vocabulary
    local = tokens - tp.model_rank * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.psum(torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                  device=rows.device)))


def vocab_logits(x: torch.Tensor, w: torch.Tensor, tp=None,
                 gather: bool = True) -> torch.Tensor:
    """``x @ w`` over a ``(d, vocab)`` head; a vocabulary sharded over
    ``model`` is gathered along it (``gather=False``: this rank's block)."""
    if tp is not None and tp.vocab:
        logits = torch.matmul(tp.copy(x), w)
        return tp.gather_model(logits, dim=-1) if gather else logits
    return torch.matmul(x, w)


def unembed_template(d: int, vocab: int, dtype=torch.float32) -> Dict[str, ParamDef]:
    return {"w": ParamDef((d, vocab), ("fsdp", "tp"), init="scaled", dtype=dtype)}


def unembed(params, x: torch.Tensor, tp=None, gather: bool = True) -> torch.Tensor:
    return vocab_logits(x, params["w"], tp, gather)


# --------------------------------------------------------------------------
# MLP (gated or plain)
# --------------------------------------------------------------------------


def mlp_template(d: int, ff: int, *, gated: bool = True,
                 dtype=torch.float32) -> Dict[str, ParamDef]:
    t = {
        "wi": ParamDef((d, ff), ("fsdp", "tp"), init="scaled", dtype=dtype),
        "wo": ParamDef((ff, d), ("tp", "fsdp"), init="scaled", dtype=dtype),
    }
    if gated:
        t["wg"] = ParamDef((d, ff), ("fsdp", "tp"), init="scaled", dtype=dtype)
    return t


def _act(name: str):
    return {
        "silu": F.silu,
        "gelu": F.gelu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


def mlp(params, x: torch.Tensor, *, act: str = "silu", tp=None) -> torch.Tensor:
    if tp is not None and tp.ff:
        x = tp.copy(x)
    h = matmul(x, params["wi"])
    if "wg" in params:
        h = _act(act)(matmul(x, params["wg"])) * h
    else:
        h = _act(act)(h)
    if tp is not None and tp.ff:
        return tp.row_parallel(h, params["wo"])
    return matmul(h, params["wo"])


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (half,)
    angles = positions[..., :, None, None].float() * freqs          # (..., s, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
