"""Plain PyTorch versions of the consensus-update and wire-quantize kernels.

Same operand forms as the CUDA kernels (``csrc/consensus_update.cu``,
``csrc/sr_quantize.cu``), the same float32 operations in the same order, so
kernel and plain version agree to the last bit:

* ``cdsgd_update_ref`` / ``cdmsgd_update_ref`` — ``weights (A_out, S)``,
  ``neighbors (S, rows, 128)`` (float32 or bfloat16), per-output ``grad`` /
  ``momentum (A_out, rows, 128)``.  The mixing sum starts from zero and
  adds one product per stencil entry ``s = 0 .. S-1``, as the Pallas
  kernels (``_mix_stencil``) accumulate.
* ``cdsgd_update_q_ref`` / ``cdmsgd_update_q_ref`` — the self-separated
  (quantized-wire) form: ``weights (A_out, S+1)``, the native ``self
  (A_out, rows, 128)`` at ``weights[:, 0]``, the wire ``payload (S, rows,
  128)`` (int8, float8_e4m3fn, bfloat16 or float32) dequantized with
  ``scales (S, rows, 1)`` at ``weights[:, 1:]``:
  ``acc = w0 * self``, then ``acc += w_{s+1} * (float(q_s) * scale_s)``.
* ``cdmsgd_update_qm_ref`` — the mixed-momentum form: the momentum
  buffer crossed the wire too (``mom_payload``, ``mom_scales``), and the
  local ``momentum`` is its self tile at ``weights[:, 0]``:
  ``v' = mu mix_q(momentum, mom_payload) - alpha G``.
* ``cdmsgd_nesterov_update{,_q,_qm}_ref`` — CDMSGD that also returns the
  next Nesterov lookahead ``look = x' + mu v'``.
* ``cdadam_update{,_q,_qm}_ref`` — mixing plus a local Adam step:
  ``m' = b1 m + (1 - b1) G``, ``v' = b2 v + ((1 - b2) G) G``,
  ``x' = mix - alpha ((m' / bc1) / (sqrt(v' / bc2) + eps))``, in the
  order of the Pallas bodies (``_cdadam_body``) as XLA compiles them: its
  algebraic simplifier folds ``(A / B) / C`` into ``A / (B * C)``, so the
  step is ``m' / (bc1 (sqrt(v' / bc2) + eps))``; ``_qm`` mixes ``m``.
  The bias corrections ``bc = 1 - beta^t`` come in as operands.
* ``sr_quantize_ref`` — per-128-lane-row scaled quantization for the wire
  (``_quantize_math`` of the JAX package): ``scale = amax * (1 / qmax)``
  (1.0 for an all-zero row); int8 rounds stochastically,
  ``floor(x / scale + u)`` clipped to +-127; fp8 e4m3 rounds to nearest.
  The JAX source writes ``amax / qmax``; XLA, compiling the JAX trainer's
  step, folds that division by a literal into a multiply by the float32
  reciprocal, and the port follows the compiled arithmetic, so its wire
  bits equal the JAX trainer's.  ``x / scale`` stays a true division.

The stochastic-rounding uniforms come from :func:`uniforms`, the port's own
random stream: Philox4x32-10 keyed by the agent's 32-bit wire seed, with
the float4 index within the agent's bucket as the counter, so one Philox
call gives the four uniforms of one float4 whatever the launch shape.  The
CUDA kernel computes the same stream in registers; this module computes it
with int64 tensors.  Every draw goes through :func:`uniforms`, so a test
can substitute another stream (the JAX package's ``jax.random`` draws).

A bfloat16 parameter bucket (every update form, and ``sr_quantize_ref``)
is widened exactly by ``.float()``; the same float32 operations follow,
and each output is rounded once to the bucket's dtype (``.to(grad.dtype)``:
round to nearest even), as the Pallas kernels store into ``out_ref.dtype``
and the CUDA kernels round with ``__float2bfloat16_rn``.  An output that
feeds another (Nesterov's ``x'`` and ``v'`` in the lookahead, Adam's
``m'`` and ``v'`` in the step) enters it unrounded, as in the Pallas
bodies.  The top-k compact values are int8 with float32 scales whatever
the bucket (the wire compresses a float32 copy of it).

Scalars enter as float32 (``1 - b1`` is a float32 subtraction).  A
division by a scalar divides by a float32 tensor on the operand's device:
PyTorch's CUDA ``tensor / python_scalar`` multiplies by the reciprocal,
which is not the kernel's correctly rounded division.  Square roots go
through :func:`sqrt_rn`: PyTorch's vectorized CPU ``torch.sqrt`` on
float32 is not correctly rounded (about 0.6% of inputs come out one ulp
low on an AVX-512 host), while the kernel's ``__fsqrt_rn`` and CUDA's
``torch.sqrt`` are.

These are pure: they return new tensors.  The wrappers in
:mod:`repro_torch.kernels.consensus_update.consensus_update` call them for
CPU tensors and copy the results into the in-place outputs; the CUDA path
never calls them.
"""

from __future__ import annotations

import numpy as np
import torch

QMAX = {"int8": 127.0, "fp8": 448.0}
QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
#: 1 / qmax rounded to float32, as XLA folds the constant
INV_QMAX = {k: float(np.float32(1.0) / np.float32(q)) for k, q in QMAX.items()}

_MASK32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Salmon et al., SC 2011)
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * x`` for uint32 values held in int64.

    The 64-bit product overflows int64, so ``x`` is split into 16-bit
    halves: ``m * x = m * x_lo + (m * x_hi) << 16`` with both partial
    products below 2^48.
    """
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    t = (a & _MASK32) + ((b & 0xFFFF) << 16)
    return (a >> 32) + (b >> 16) + (t >> 32), t & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter words ``c0..c3`` (int64 tensors holding
    uint32 values) under the key ``(k0, k1)``: four uint32 words."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: int, n4: int, offset: int = 0,
                    device=None) -> torch.Tensor:
    """Uniforms in [0, 1) of float4s ``offset .. offset + n4`` of the stream
    keyed by ``seed``: shape ``(n4, 4)``, float32.

    Counter ``(p mod 2^32, p >> 32, 0, 0)`` for float4 index ``p``, key
    ``(seed mod 2^32, 0)``; each 32-bit word ``b`` becomes
    ``(b >> 8) * 2^-24``, exact in float32 and strictly below 1.
    """
    p = torch.arange(offset, offset + n4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(p)
    words = philox4x32(p & _MASK32, p >> 32, zero, zero, seed & _MASK32, 0)
    bits = torch.stack(words, dim=-1) >> 8
    return bits.to(torch.float32) * (1.0 / 16777216.0)


def uniforms(seed: int, shape, device=None) -> torch.Tensor:
    """The stochastic-rounding uniforms of one agent's bucket of ``shape``
    (row-major, a multiple of 4 elements), drawn from wire seed ``seed``."""
    n = 1
    for d in shape:
        n *= d
    return philox_uniforms(seed, n // 4, device=device).reshape(shape)


def as_int32(x: int) -> int:
    """``x`` wrapped to a signed 32-bit int (two's complement)."""
    x &= _MASK32
    return x - (1 << 32) if x >> 31 else x


def quantize_math(xf: torch.Tensor, u, exchange: str):
    """Per-row scale and rounding of float32 ``xf (..., 128)``; ``u`` is the
    uniform draw of the same shape (int8) or None (nearest rounding)."""
    qmax = QMAX[exchange]
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_QMAX[exchange],
                        torch.ones_like(amax))
    scaled = xf / scale
    if u is not None:
        scaled = torch.clamp(torch.floor(scaled + u), -qmax, qmax)
    return scaled.to(QDTYPE[exchange]), scale


def sr_quantize_ref(x: torch.Tensor, seed: int, exchange: str,
                    agent_stride: int = 0):
    """``x (A, rows, 128)`` -> ``(q (A, rows, 128), scales (A, rows, 1))``;
    agent ``a`` draws its uniforms from seed ``seed + agent_stride * a``
    (int32 wraparound)."""
    a_count, rows, lane = x.shape
    u = None
    if exchange == "int8":
        u = torch.stack([uniforms(as_int32(seed + agent_stride * a),
                                  (rows, lane), device=x.device)
                         for a in range(a_count)])
    return quantize_math(x.float(), u, exchange)


def _mix(weights: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """``acc[a] = sum_s w[a, s] * x[s]`` in f32, stencil order."""
    w = weights.float()
    x = neighbors.float()
    acc = torch.zeros((w.shape[0],) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    for s in range(x.shape[0]):
        acc = acc + w[:, s, None, None] * x[s]
    return acc


def _mix_q(weights, self_buf, payload, scales) -> torch.Tensor:
    """``acc[a] = w[a,0] self[a] + sum_s w[a,1+s] (float(q[s]) * scale[s])``."""
    w = weights.float()
    acc = w[:, 0, None, None] * self_buf.float()
    for s in range(payload.shape[0]):
        acc = acc + w[:, s + 1, None, None] * (payload[s].float() * scales[s])
    return acc


def cdsgd_update_ref(weights, neighbors, grad, alpha: float) -> torch.Tensor:
    """``out[a] = sum_s W[a,s] X[s] - alpha G[a]`` (paper eq. 5, Algorithm 1)."""
    out = _mix(weights, neighbors) - alpha * grad.float()
    return out.to(grad.dtype)


def cdmsgd_update_ref(weights, neighbors, grad, momentum, alpha: float,
                      mu: float):
    """``v' = mu V[a] - alpha G[a]``; ``out[a] = sum_s W[a,s] X[s] + v'``."""
    v = mu * momentum.float() - alpha * grad.float()
    out = _mix(weights, neighbors) + v
    return out.to(grad.dtype), v.to(momentum.dtype)


def cdsgd_update_q_ref(weights, self_buf, payload, scales, grad,
                       alpha: float) -> torch.Tensor:
    """Self-separated CDSGD: ``out[a] = mix_q[a] - alpha G[a]``."""
    out = _mix_q(weights, self_buf, payload, scales) - alpha * grad.float()
    return out.to(grad.dtype)


def cdmsgd_update_q_ref(weights, self_buf, payload, scales, grad, momentum,
                        alpha: float, mu: float):
    """Self-separated CDMSGD: ``v' = mu V[a] - alpha G[a]``;
    ``out[a] = mix_q[a] + v'``."""
    v = mu * momentum.float() - alpha * grad.float()
    out = _mix_q(weights, self_buf, payload, scales) + v
    return out.to(grad.dtype), v.to(momentum.dtype)


def _mom_step(vin, grad, alpha: float, mu: float) -> torch.Tensor:
    """``v' = mu vin - alpha G`` in float32."""
    return mu * vin.float() - alpha * grad.float()


def cdmsgd_update_qm_ref(weights, self_buf, payload, scales, mom_payload,
                         mom_scales, grad, momentum, alpha: float, mu: float):
    """Mixed-momentum CDMSGD: ``v' = mu mix_q(V, mom_payload) - alpha G``;
    ``out[a] = mix_q[a] + v'``."""
    v = _mom_step(_mix_q(weights, momentum, mom_payload, mom_scales), grad,
                  alpha, mu)
    out = _mix_q(weights, self_buf, payload, scales) + v
    return out.to(grad.dtype), v.to(momentum.dtype)


def _nesterov(acc, vin, grad, momentum, alpha: float, mu: float):
    v = _mom_step(vin, grad, alpha, mu)
    x = acc + v
    look = x + mu * v
    return x.to(grad.dtype), v.to(momentum.dtype), look.to(grad.dtype)


def cdmsgd_nesterov_update_ref(weights, neighbors, grad, momentum,
                               alpha: float, mu: float):
    """CDMSGD plus the next lookahead: ``(x', v', x' + mu v')``."""
    return _nesterov(_mix(weights, neighbors), momentum, grad, momentum,
                     alpha, mu)


def cdmsgd_nesterov_update_q_ref(weights, self_buf, payload, scales, grad,
                                 momentum, alpha: float, mu: float):
    """Self-separated Nesterov CDMSGD: ``(x', v', x' + mu v')``."""
    return _nesterov(_mix_q(weights, self_buf, payload, scales), momentum,
                     grad, momentum, alpha, mu)


def cdmsgd_nesterov_update_qm_ref(weights, self_buf, payload, scales,
                                  mom_payload, mom_scales, grad, momentum,
                                  alpha: float, mu: float):
    """Mixed-momentum Nesterov CDMSGD: the momentum mix feeds ``v'`` and
    the lookahead."""
    return _nesterov(_mix_q(weights, self_buf, payload, scales),
                     _mix_q(weights, momentum, mom_payload, mom_scales),
                     grad, momentum, alpha, mu)


def _f32(x) -> float:
    return float(np.float32(x))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on any device: a float64
    root (53 bits, enough that rounding it to 24 bits rounds once) cast
    back to float32."""
    return torch.sqrt(x.double()).to(torch.float32)


def _adam(acc, m_in, grad, m, v, alpha, b1, b2, eps, bc1, bc2):
    alpha, b1, b2, eps = _f32(alpha), _f32(b1), _f32(b2), _f32(eps)
    omb1 = float(np.float32(1.0) - np.float32(b1))
    omb2 = float(np.float32(1.0) - np.float32(b2))
    g = grad.float()
    new_m = b1 * m_in.float() + omb1 * g
    new_v = b2 * v.float() + (omb2 * g) * g
    dev = g.device
    bc1_t = torch.tensor(_f32(bc1), dtype=torch.float32, device=dev)
    bc2_t = torch.tensor(_f32(bc2), dtype=torch.float32, device=dev)
    # the Pallas body's (m'/bc1) / (sqrt(v'/bc2) + eps) as XLA compiles it
    # (its simplifier folds (A / B) / C into A / (B * C)), a difference by
    # design from the TPU kernel, which Mosaic compiles as written
    step_dir = new_m / (bc1_t * (sqrt_rn(new_v / bc2_t) + eps))
    out = acc - alpha * step_dir
    return out.to(grad.dtype), new_m.to(m.dtype), new_v.to(v.dtype)


def cdadam_update_ref(weights, neighbors, grad, m, v, alpha, b1, b2, eps,
                      bc1, bc2):
    """Mixing plus a local Adam step: ``(x', m', v')``."""
    return _adam(_mix(weights, neighbors), m, grad, m, v, alpha, b1, b2,
                 eps, bc1, bc2)


def cdadam_update_q_ref(weights, self_buf, payload, scales, grad, m, v,
                        alpha, b1, b2, eps, bc1, bc2):
    """Self-separated CDAdam: ``(x', m', v')``."""
    return _adam(_mix_q(weights, self_buf, payload, scales), m, grad, m, v,
                 alpha, b1, b2, eps, bc1, bc2)


def cdadam_update_qm_ref(weights, self_buf, payload, scales, mom_payload,
                         mom_scales, grad, m, v, alpha, b1, b2, eps, bc1,
                         bc2):
    """Mixed-momentum CDAdam: ``m' = b1 mix_q(M, mom_payload) + (1-b1) G``;
    the second moment stays local."""
    return _adam(_mix_q(weights, self_buf, payload, scales),
                 _mix_q(weights, m, mom_payload, mom_scales), grad, m, v,
                 alpha, b1, b2, eps, bc1, bc2)


def _mix_sparse(weights, self_buf, values, indices, scales) -> torch.Tensor:
    """The sparse operand form (top-k wire) of :func:`_mix_q`:
    ``acc[a] = w[a,0] self[a]``, then for ``s = 0 .. S-1`` one
    ``index_add_`` of ``w[a,1+s] (float(values[s]) * scales[s])`` at the
    flat dense positions ``indices[s]`` (``_sparse_stencil``, stencil
    order)."""
    w = weights.float()
    a_out = w.shape[0]
    acc = (w[:, 0, None, None] * self_buf.float()).reshape(a_out, -1)
    for s in range(values.shape[0]):
        deq = (values[s].float() * scales[s]).reshape(-1)
        acc.index_add_(1, indices[s].reshape(-1).long(),
                       w[:, s + 1, None] * deq[None])
    return acc.reshape(self_buf.shape)


def cdsgd_update_sparse_ref(weights, self_buf, values, indices, scales, grad,
                            alpha: float) -> torch.Tensor:
    """Sparse-operand CDSGD: ``out[a] = mix_sparse[a] - alpha G[a]``."""
    out = (_mix_sparse(weights, self_buf, values, indices, scales)
           - alpha * grad.float())
    return out.to(grad.dtype)


def cdmsgd_update_sparse_ref(weights, self_buf, values, indices, scales, grad,
                             momentum, alpha: float, mu: float):
    """Sparse-operand CDMSGD: ``v' = mu V[a] - alpha G[a]``;
    ``out[a] = mix_sparse[a] + v'``."""
    v = _mom_step(momentum, grad, alpha, mu)
    out = _mix_sparse(weights, self_buf, values, indices, scales) + v
    return out.to(grad.dtype), v.to(momentum.dtype)


def cdmsgd_nesterov_update_sparse_ref(weights, self_buf, values, indices,
                                      scales, grad, momentum, alpha: float,
                                      mu: float):
    """Sparse-operand Nesterov CDMSGD: ``(x', v', x' + mu v')``."""
    return _nesterov(_mix_sparse(weights, self_buf, values, indices, scales),
                     momentum, grad, momentum, alpha, mu)


def cdadam_update_sparse_ref(weights, self_buf, values, indices, scales, grad,
                             m, v, alpha, b1, b2, eps, bc1, bc2):
    """Sparse-operand CDAdam, local moments: ``(x', m', v')``."""
    return _adam(_mix_sparse(weights, self_buf, values, indices, scales), m,
                 grad, m, v, alpha, b1, b2, eps, bc1, bc2)


def topk_threshold_counts_ref(x: torch.Tensor,
                              taus: torch.Tensor) -> torch.Tensor:
    """``counts[a, b] = #{e : |x[a][e]| >= taus[a, b]}`` for ``x (A, rows,
    128)`` float32 and ``taus (A, n_bins)``: exact int64 counts (the
    threshold kernel's sweep, ``_threshold_count_kernel``)."""
    ax = x.float().abs().reshape(x.shape[0], -1)
    return torch.stack([(ax >= taus[:, b, None]).sum(dim=1)
                        for b in range(taus.shape[1])], dim=1)
