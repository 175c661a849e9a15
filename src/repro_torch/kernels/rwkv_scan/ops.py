"""The WKV6 kernel in the model's layout ``(b, s, n_h, hs)``, as
:mod:`repro.kernels.rwkv_scan.ops`."""

from __future__ import annotations

import torch

from repro_torch.kernels.rwkv_scan.rwkv_scan import wkv6


def wkv6_bsnh(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """r, k, v, w ``(b, s, n_h, hs)``; u ``(n_h, hs)``.

    Returns ``(y (b, s, n_h, hs), state (b, n_h, hs, hs))``: the same
    function as :func:`repro_torch.nn.ssm.wkv6_scan` with a zero initial
    state.  On the card the kernel reads the operands in place (no fold of
    batch and heads, ``u`` read per head); CPU tensors fold, broadcast ``u``
    over the batch and take the plain version, as the reference does.
    """
    b, _, n_h, hs = r.shape
    y, state = wkv6(r, k, v, w, u)
    return y, state.reshape(b, n_h, hs, hs)
