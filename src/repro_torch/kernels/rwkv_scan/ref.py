"""Plain PyTorch version of the WKV6 kernel, as
:mod:`repro.kernels.rwkv_scan.ref`: the sequential recurrence in float32."""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u):
    """r, k, v, w ``(BH, S, hs)``; u ``(BH, hs)``.

    Returns ``(y (BH, S, hs) float32, final state (BH, hs, hs) float32)``
    with a zero initial state:
    ``y_t = r_t . (S_t + (u * k_t) v_t^T)``, ``S_{t+1} = diag(w_t) S_t +
    k_t v_t^T``.
    """
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    bh, s, hs = r.shape
    state = torch.zeros((bh, hs, hs), dtype=torch.float32, device=r.device)
    ys = torch.empty((bh, s, hs), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys[:, t] = torch.einsum("bi,bij->bj", r[:, t], state + u[:, :, None] * kv)
        state = w[:, t, :, None] * state + kv
    return ys, state
