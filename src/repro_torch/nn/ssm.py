"""RWKV6 ("Finch") time mix and channel mix, as the RWKV6 part of
:mod:`repro.nn.ssm` (with the reference's simplifications: static
token-shift coefficients, an RMS output norm; the data-dependent decay
LoRA kept).

A stateless prefill (``state is None``) runs the WKV recurrence through
the CUDA kernel (:func:`repro_torch.kernels.rwkv_scan.ops.wkv6_bsnh`);
where the reference takes its chunked matmul form (``wkv6_chunked``) for
long sequences, the kernel computes the same recurrence step by step.  A
carried state (decode) takes :func:`wkv6_scan` in plain PyTorch, as in the
reference (it has no kernel there either).  ``wkv6_chunked`` and the
Mamba layers are not ported yet (ROADMAP A17).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv_scan import ops as wkv_ops
from repro_torch.nn.layers import rmsnorm, rmsnorm_template
from repro_torch.nn.param import ParamDef


def rwkv6_template(d: int, d_ff: int, *, head_size: int = 64, decay_lora: int = 64,
                   dtype=torch.float32) -> Dict[str, Any]:
    n_h = d // head_size
    tm = {
        "mu_r": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "mu_k": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "mu_v": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "mu_w": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "mu_g": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "wr": ParamDef((d, d), ("fsdp", "tp"), init="scaled", dtype=dtype),
        "wk": ParamDef((d, d), ("fsdp", "tp"), init="scaled", dtype=dtype),
        "wv": ParamDef((d, d), ("fsdp", "tp"), init="scaled", dtype=dtype),
        "wg": ParamDef((d, d), ("fsdp", "tp"), init="scaled", dtype=dtype),
        "wo": ParamDef((d, d), ("tp", "fsdp"), init="scaled", dtype=dtype),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x_w A) B))
        "w0": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "wA": ParamDef((d, decay_lora), ("fsdp", None), init="scaled", dtype=dtype),
        "wB": ParamDef((decay_lora, d), (None, "fsdp"), init="scaled", scale=0.1, dtype=dtype),
        "u": ParamDef((n_h, head_size), (None, None), init="zeros", dtype=dtype),  # bonus
        "ln_out": rmsnorm_template(d, dtype),
    }
    cm = {
        "mu_ck": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "mu_cr": ParamDef((d,), (None,), init="zeros", dtype=dtype),
        "wck": ParamDef((d, d_ff), ("fsdp", "tp"), init="scaled", dtype=dtype),
        "wcv": ParamDef((d_ff, d), ("tp", "fsdp"), init="scaled", dtype=dtype),
        "wcr": ParamDef((d, d), ("fsdp", None), init="scaled", dtype=dtype),
    }
    return {"time_mix": tm, "channel_mix": cm}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x[t] -> x[t-1]; the first position takes ``prev`` (or zeros)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def wkv6_scan(r, k, v, w, u, state0=None):
    """The WKV6 recurrence in plain PyTorch (float32).

    r, k, v, w ``(b, s, n_h, hs)``; u ``(n_h, hs)``; state ``(b, n_h, hs,
    hs)``.  Returns ``(y (b, s, n_h, hs) float32, final state)``.
    """
    b, s, n_h, hs = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    S = (torch.zeros((b, n_h, hs, hs), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    ys = torch.empty((b, s, n_h, hs), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (b, n_h, hs, hs)
        ys[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv)
        S = w[:, t, :, :, None] * S + kv
    return ys, S


def rwkv6_time_mix(params, x: torch.Tensor, *, head_size: int = 64,
                   state: Optional[Dict[str, torch.Tensor]] = None):
    """Returns ``(y, new_state)``; state = ``{"shift": (b, d), "S": (b, n_h,
    hs, hs)}``."""
    b, s, d = x.shape
    n_h = d // head_size
    prev = None if state is None else state["shift"]
    xp = _token_shift(x, prev)
    xr = _lerp(x, xp, params["mu_r"])
    xk = _lerp(x, xp, params["mu_k"])
    xv = _lerp(x, xp, params["mu_v"])
    xw = _lerp(x, xp, params["mu_w"])
    xg = _lerp(x, xp, params["mu_g"])

    r = torch.matmul(xr, params["wr"]).reshape(b, s, n_h, head_size)
    k = torch.matmul(xk, params["wk"]).reshape(b, s, n_h, head_size)
    v = torch.matmul(xv, params["wv"]).reshape(b, s, n_h, head_size)
    g = F.silu(torch.matmul(xg, params["wg"]))

    dd = torch.matmul(torch.tanh(torch.matmul(xw, params["wA"])), params["wB"])
    w = torch.exp(-torch.exp(params["w0"].float() + dd.float()))
    w = w.reshape(b, s, n_h, head_size)

    u = params["u"].float()
    if state is None:
        y, S = wkv_ops.wkv6_bsnh(r, k, v, w, u)
    else:
        y, S = wkv6_scan(r, k, v, w, u, state["S"])
    y = rmsnorm(params["ln_out"], y.reshape(b, s, d).to(x.dtype)) * g
    out = torch.matmul(y, params["wo"])
    return out, {"shift": x[:, -1, :], "S": S}


def rwkv6_channel_mix(params, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """state = ``(b, d)`` previous token.  Returns ``(y, new_state)``."""
    xp = _token_shift(x, state)
    xk = _lerp(x, xp, params["mu_ck"])
    xr = _lerp(x, xp, params["mu_cr"])
    k = torch.square(F.relu(torch.matmul(xk, params["wck"])))
    kv = torch.matmul(k, params["wcv"])
    r = torch.sigmoid(torch.matmul(xr, params["wcr"]))
    return r * kv, x[:, -1, :]


def rwkv6_init_state(batch: int, d: int, *, head_size: int = 64,
                     dtype=torch.float32, device=None):
    n_h = d // head_size
    return {
        "tm": {"shift": torch.zeros((batch, d), dtype=dtype, device=device),
               "S": torch.zeros((batch, n_h, head_size, head_size),
                                dtype=torch.float32, device=device)},
        "cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }
