"""RWKV6 ("Finch") time mix and channel mix, and the selective SSM
(Mamba-style) of the Hymba hybrid heads, as :mod:`repro.nn.ssm` (with the
reference's RWKV6 simplifications: static token-shift coefficients, an RMS
output norm; the data-dependent decay LoRA kept).

The WKV recurrence takes one of three forms:

* a stateless prefill (``state is None``) runs the forward-only CUDA
  kernel (:func:`repro_torch.kernels.rwkv_scan.ops.wkv6_bsnh`), step by
  step at any length;
* training (``differentiable=True``, which the LM loss asks for) takes
  the reference's own choice in plain, differentiable PyTorch:
  :func:`wkv6_chunked` (the chunked matmul form) when ``s >= 64`` and ``s``
  is a multiple of the chunk, :func:`wkv6_scan` otherwise;
* a carried state (decode) takes :func:`wkv6_scan`, as in the reference
  (it has no kernel there either).

Mamba (:func:`mamba_apply`) is plain PyTorch in prefill, training and
decode, as it is XLA in the reference: :func:`mamba_chunked` (chunks of 32
steps composed step by step, every chunk at once) when ``s >= 64`` and
``s % 32 == 0``, the step recurrence :func:`mamba_scan` otherwise (decode:
one step on the carried float32 state).  Both are out of place, so they run under the
stacked trainer's ``vmap(grad_and_value(...))``.
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
    ys = []                       # stacked, not written in place: vmap-able
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (b, n_h, hs, hs)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6_chunked(r, k, v, w, u, state0=None, *, chunk: int = 32):
    """The WKV6 recurrence in the reference's chunked matmul form (float32,
    differentiable): chunks of ``chunk`` steps carry the state, and within
    a chunk ``sub``-step blocks (16, or the largest divisor of ``chunk``
    below it) use cumulative decays ``A_t = prod_{tau <= t} w_tau`` in log
    space, shifted by the block's middle step:

        y_t = (r_t A_{t-1}) . S_0 + sum_{tau < t} [(r_t A_{t-1} / A_tau) .
              k_tau] v_tau + (r_t . (u k_t)) v_t
        S'  = diag(A_C) S_0 + sum_tau diag(A_C / A_tau) k_tau v_tau^T

    ``r, k, v, w (b, s, n_h, hs)`` with ``s % chunk == 0``; returns ``(y
    (b, s, n_h, hs), final state)``.
    """
    b, s, n_h, hs = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}")
    sub = min(16, chunk)
    while chunk % sub:
        sub -= 1
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    S = (torch.zeros((b, n_h, hs, hs), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    mask = torch.tril(torch.ones((sub, sub), dtype=torch.bool, device=r.device), -1)
    ys = []
    for t0 in range(0, s, sub):              # the chunks' sub-blocks, in order
        sl = slice(t0, t0 + sub)
        rb, kb, vb, wb = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
        lw = torch.log(torch.clamp(wb, min=1e-38))
        l_inc = torch.cumsum(lw, dim=1)              # log A_t (inclusive)
        mid = l_inc[:, sub // 2: sub // 2 + 1]       # per-(b, h, hs) shift
        a_inc = torch.exp(l_inc - mid)
        a_exc = torch.exp(l_inc - lw - mid)          # A_{t-1} (exclusive)
        r_dec = rb * a_exc
        k_dec = kb / a_inc
        s_shift = torch.exp(mid[:, 0])[..., None] * S
        y_inter = torch.einsum("bchi,bhij->bchj", r_dec, s_shift)
        p = torch.einsum("bthi,bchi->bhtc", r_dec, k_dec)
        p = torch.where(mask[None, None], p, 0.0)
        y_intra = torch.einsum("bhtc,bchj->bthj", p, vb)
        y_diag = vb * torch.sum(rb * u[None, None] * kb, -1, keepdim=True)
        ys.append(y_inter + y_intra + y_diag)
        a_last = torch.exp(l_inc[:, -1])             # (b, n_h, hs)
        k_scaled = kb * (a_inc[:, -1:] / a_inc)
        S = a_last[..., None] * S + torch.einsum("bchi,bchj->bhij", k_scaled, vb)
    return torch.cat(ys, dim=1), S


def rwkv6_time_mix(params, x: torch.Tensor, *, head_size: int = 64,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   chunk: int = 32, differentiable: bool = False):
    """Returns ``(y, new_state)``; state = ``{"shift": (b, d), "S": (b, n_h,
    hs, hs)}``.  ``differentiable=True`` (training) takes
    :func:`wkv6_chunked` when ``s >= 64`` and ``s % chunk == 0``, else
    :func:`wkv6_scan`; otherwise a stateless call runs the WKV6 kernel."""
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
    s0 = None if state is None else state["S"]
    if differentiable and s >= 64 and s % chunk == 0:
        y, S = wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    elif differentiable or state is not None:
        y, S = wkv6_scan(r, k, v, w, u, s0)
    else:
        y, S = wkv_ops.wkv6_bsnh(r, k, v, w, u)
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


# --------------------------------------------------------------------------
# Selective SSM (Mamba-style) for the Hymba hybrid heads
# --------------------------------------------------------------------------


def mamba_template(d: int, *, d_inner: Optional[int] = None, n_state: int = 16,
                   dtype=torch.float32) -> Dict[str, ParamDef]:
    di = d_inner or d
    return {
        "w_in": ParamDef((d, 2 * di), ("fsdp", "tp"), init="scaled", dtype=dtype),
        "w_dt": ParamDef((d, di), ("fsdp", "tp"), init="scaled", scale=0.1, dtype=dtype),
        "dt_bias": ParamDef((di,), ("tp",), init="zeros", dtype=dtype),
        "w_b": ParamDef((d, n_state), ("fsdp", None), init="scaled", dtype=dtype),
        "w_c": ParamDef((d, n_state), ("fsdp", None), init="scaled", dtype=dtype),
        "a_log": ParamDef((di, n_state), ("tp", None), init="zeros", dtype=dtype),
        "d_skip": ParamDef((di,), ("tp",), init="ones", dtype=dtype),
        "w_out": ParamDef((di, d), ("tp", "fsdp"), init="scaled", dtype=dtype),
    }


def mamba_scan(u, dt, b_in, c_in, a, state0=None):
    """``h_t = exp(dt_t A) h_{t-1} + dt_t (B_t outer u_t)``, ``y_t = h_t .
    C_t``, step by step in float32.

    u, dt ``(b, s, di)``; b_in, c_in ``(b, s, n)``; a ``(di, n)``; state
    ``(b, di, n)``.  Returns ``(y (b, s, di), final state)``.
    """
    bsz, s, di = u.shape
    u, dt, b_in, c_in = (t.float() for t in (u, dt, b_in, c_in))
    a = a.float()
    h = (torch.zeros((bsz, di, b_in.shape[-1]), dtype=torch.float32, device=u.device)
         if state0 is None else state0.float())
    ys = []                       # stacked, not written in place: vmap-able
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * a[None])             # (b, di, n); a <= 0
        h = decay * h + (dt[:, t] * u[:, t])[..., None] * b_in[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_in[:, t]))
    return torch.stack(ys, dim=1), h


def _compose_steps(decay: torch.Tensor, g: torch.Tensor):
    """Inclusive scan along dim 0 of the recurrence ``h' = a h + g``
    composed (``(a1, g1) o (a2, g2) = (a1 a2, a2 g1 + g2)``, no division):
    ``P_t = a_t P_{t-1}``, ``Z_t = a_t Z_{t-1} + g_t``, step by step on
    contiguous slices; out of place.  The reference composes in
    ``lax.associative_scan``'s tree order: the same products, rounded in
    another order.  The steps are taken by ``unbind`` (its backward stacks
    the slices' gradients once; indexing would zero-fill a whole-size
    gradient for every step)."""
    ds, gs = decay.unbind(0), g.unbind(0)
    ps, zs = [ds[0]], [gs[0]]                            # stacked, not written in place
    for t in range(1, len(gs)):
        ps.append(ds[t] * ps[-1])
        zs.append(torch.addcmul(gs[t], ds[t], zs[-1]))
    return torch.stack(ps), torch.stack(zs)


def mamba_chunked(u, dt, b_in, c_in, a, state0=None, *, chunk: int = 32):
    """The selective scan in the reference's chunked form (float32,
    differentiable): within a chunk, the per-step decays ``a_t = exp(dt_t
    A)`` and drives ``g_t = dt_t u_t (x) B_t`` compose into ``(P_t, Z_t)``
    (:func:`_compose_steps`, steps first, every chunk at once), and ``h_t =
    P_t h_0 + Z_t`` from the state ``h_0`` the previous chunk carried.
    ``s % chunk == 0``; returns ``(y (b, s, di), final state)``.
    """
    bsz, s, di = u.shape
    n = b_in.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    n_chunks = s // chunk
    u, dt, b_in, c_in = (t.float() for t in (u, dt, b_in, c_in))
    a = a.float()
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
         if state0 is None else state0.float())

    def to_steps(t):                                     # (C, b, n_chunks, ...)
        return t.reshape(bsz, n_chunks, chunk, *t.shape[2:]).movedim(2, 0).contiguous()

    uc, dtc, bc, cc = (to_steps(t) for t in (u, dt, b_in, c_in))
    decay = torch.exp(dtc[..., None] * a)                # (C, b, nc, di, n)
    g = (dtc * uc)[..., None] * bc[..., None, :]         # (C, b, nc, di, n)
    p_inc, z = _compose_steps(decay, g)
    starts = []                                          # each chunk's h_0, in order
    for p_c, z_c in zip(p_inc[-1].unbind(1), z[-1].unbind(1)):
        starts.append(h)
        h = torch.addcmul(z_c, p_c, h)
    h_t = torch.addcmul(z, p_inc, torch.stack(starts, dim=1))
    y = torch.einsum("cbkdn,cbkn->bkcd", h_t, cc)
    return y.reshape(bsz, s, di), h


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


def mamba_apply(params, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Returns ``(y (b, s, d), new state (b, di, n) float32)``: the chunked
    scan when ``s >= 64`` and ``s % 32 == 0``, else the step recurrence."""
    xz = torch.matmul(x, params["w_in"])
    u, z = torch.chunk(xz, 2, dim=-1)
    u = F.silu(u)
    dt = _softplus(torch.matmul(x, params["w_dt"]) + params["dt_bias"])
    b_in = torch.matmul(x, params["w_b"])
    c_in = torch.matmul(x, params["w_c"])
    a = -torch.exp(params["a_log"].float())              # negative definite
    s = x.shape[1]
    if s >= 64 and s % 32 == 0:
        y, h = mamba_chunked(u, dt, b_in, c_in, a, state, chunk=32)
    else:
        y, h = mamba_scan(u, dt, b_in, c_in, a, state)
    y = (y.to(x.dtype) + params["d_skip"] * u) * F.silu(z)
    return torch.matmul(y, params["w_out"]), h


def mamba_init_state(batch: int, d_inner: int, n_state: int, device=None) -> torch.Tensor:
    """The decode state ``(batch, d_inner, n_state)``, float32 whatever the
    parameters' dtype (the reference's)."""
    return torch.zeros((batch, d_inner, n_state), dtype=torch.float32, device=device)
