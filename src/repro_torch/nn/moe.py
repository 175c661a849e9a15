"""Mixture-of-Experts: top-k routing into capacity buffers, batched expert
FFNs and shared experts, as :mod:`repro.nn.moe`.

Tokens are scattered into a per-expert capacity buffer ``(E, C, d)`` by
integer slot (the position of each ``(token, k)`` pair within its expert,
in token-major order), the expert FFNs run as batched
products over the expert axis, and the results are gathered back and
combined with the router's gates.  Pairs routed past an expert's capacity
are dropped for that expert (GShard); the load-balance auxiliary loss is
returned beside the output.

The reference computes all of this in XLA (no Pallas kernel), so the port
is plain PyTorch.  Two choices keep it the reference's function:

* top-k is a stable descending sort, so tied probabilities go to the lower
  expert index first, as ``jax.lax.top_k`` does (``torch.topk`` promises
  no order on ties);
* a pair's slot is its rank among its expert's pairs, from a stable sort
  by expert: the same integers as the reference's exclusive cumsum over a
  ``(t*k, E)`` one-hot, which scans 25 M int64 entries per kimi-k2 layer
  at 4 x 2048 tokens (26 ms of its 51 ms MoE layer on an H100);
* the scatter copies the kept pairs into their slots out of place, every
  dropped pair to one spare row past the ``E * C`` slots, so a dropped
  pair never writes a kept one (the reference adds zeros at ``(0, 0)``).

Everything is out of place, so :func:`moe_apply` runs under
``torch.func.vmap`` (the stacked trainer's agent axis) and ``grad``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.nn.layers import _act, mlp, mlp_template
from repro_torch.nn.param import ParamDef


def moe_template(d: int, d_ff_expert: int, n_experts: int, *, n_shared: int = 0,
                 gated: bool = True, dtype=torch.float32) -> Dict[str, Any]:
    """The router is ``(d, E)`` float32 whatever ``dtype`` (a second
    parameter bucket in a bf16 model); ``wi`` / ``wg`` / ``wo`` stack the
    experts; ``shared`` is one MLP of width ``n_shared * d_ff_expert``."""
    t: Dict[str, Any] = {
        "router": ParamDef((d, n_experts), ("fsdp", None), init="scaled",
                           dtype=torch.float32),
        "wi": ParamDef((n_experts, d, d_ff_expert), ("expert", "fsdp", None),
                       init="scaled", dtype=dtype),
        "wo": ParamDef((n_experts, d_ff_expert, d), ("expert", None, "fsdp"),
                       init="scaled", dtype=dtype),
    }
    if gated:
        t["wg"] = ParamDef((n_experts, d, d_ff_expert), ("expert", "fsdp", None),
                           init="scaled", dtype=dtype)
    if n_shared:
        t["shared"] = mlp_template(d, n_shared * d_ff_expert, gated=gated, dtype=dtype)
    return t


def capacity(tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    """Slots per expert: ``ceil(tokens * top_k * factor / E)`` rounded up
    to a multiple of 8, at least 8."""
    c = int(math.ceil(tokens * top_k * factor / n_experts))
    return max(8, -(-c // 8) * 8)


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """``(probs (t, E) float32, gate_vals (t, k), expert_idx (t, k))``: the
    softmax router, its top-k by a stable descending sort (ties to the
    lower index), the gates renormalized over the k chosen."""
    probs = torch.softmax(torch.matmul(xf.float(), router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot`` as a comparison (``F.one_hot`` checks its values on
    the host, which ``vmap`` refuses)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def slots(flat_expert: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The position of each entry of ``flat_expert`` among the entries with
    its expert, in order: ``(cumsum(onehot) - onehot)[i, flat_expert[i]]``,
    from a stable sort by expert (``O(n log n)``, no ``(n, E)`` buffer)."""
    order = torch.argsort(flat_expert, stable=True)
    counts = torch.zeros(n_experts, dtype=flat_expert.dtype,
                         device=flat_expert.device).index_add(
        0, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, dim=0) - counts                 # exclusive
    rank = torch.arange(flat_expert.shape[0], device=flat_expert.device) \
        - starts[flat_expert[order]]
    return torch.zeros_like(flat_expert).scatter(0, order, rank)


def moe_apply(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (b, s, d)`` -> ``(y (b, s, d), aux)``: the routed experts plus
    the shared expert, and the GShard load-balance loss ``E * sum_e
    frac_e / k * mean_prob_e`` (float32 scalar)."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    cap = capacity(t, top_k, e, capacity_factor)

    xf = x.reshape(t, d)
    probs, gate_vals, expert_idx = route(params["router"], xf, top_k)

    # the slot of each (token, k) within its expert, in token order
    flat_expert = expert_idx.reshape(-1)                         # (t*k,)
    slot = slots(flat_expert, e)
    keep = slot < cap
    # kept pairs to row e * cap + slot, dropped ones to the spare row e * cap
    row = torch.where(keep, flat_expert * cap + slot, torch.full_like(slot, e * cap))

    src = xf.repeat_interleave(top_k, dim=0)                     # (t*k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, row, src)[:-1].reshape(e, cap, d)

    # the experts' FFN over the expert axis
    h = torch.bmm(buf, params["wi"])
    if "wg" in params:
        h = _act(act)(torch.bmm(buf, params["wg"])) * h
    else:
        h = _act(act)(h)
    out_buf = torch.bmm(h, params["wo"]).reshape(e * cap, d)

    # gather back (a dropped pair reads zeros) + gate combine
    gathered = out_buf[torch.clamp(row, max=e * cap - 1)]        # (t*k, d)
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                device=x.device))
    gates = gate_vals.reshape(-1)[:, None].to(gathered.dtype)
    y = (gathered * gates).reshape(t, top_k, d).sum(dim=1)

    if "shared" in params:
        y = y + mlp(params["shared"], xf, act=act)

    frac = torch.mean(_one_hot(expert_idx, e, torch.float32).sum(1), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = e * torch.sum(frac / top_k * mean_prob)
    return y.reshape(b, s, d), aux
