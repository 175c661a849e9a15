"""Wrappers of the consensus-update and wire-quantize CUDA kernels, with
launch counts.

Per optimization step every agent computes, over its whole packed
parameter bucket (paper eq. 5, Algorithms 1-2),

    x' = sum_s w_s * neighbor_s  -  alpha * g                  (CDSGD)
    v' = mu v - alpha g ; x' = sum_s w_s * neighbor_s + v'     (CDMSGD)
    CDMSGD, and look = x' + mu v'                              (Nesterov)
    m' = b1 m + (1-b1) g ; v' = b2 v + (1-b2) g^2 ;
    x' = sum_s w_s * neighbor_s - alpha (m'/bc1) / (sqrt(v'/bc2) + eps)
                                                               (CDAdam)

and, on a quantized wire, first quantizes its bucket for the neighbors.
The kernels live in ``src/repro_torch/csrc/`` (Hopper, ``sm_90a``) and
replace the Pallas TPU kernels of :mod:`repro.kernels.consensus_update`:

* :func:`cdsgd_update` / :func:`cdmsgd_update` — ``cdsgd_update_2d`` /
  ``cdmsgd_update_2d`` in their dense form: ``weights (A_out, S)``,
  ``neighbors (S, rows, 128)`` in float32 or bfloat16 (the bf16 legacy
  wire casts the whole stack, self included);
* :func:`cdsgd_update_q` / :func:`cdmsgd_update_q` — their self-separated
  (``_q``) form: ``weights (A_out, S+1)``, the native ``self (A_out, rows,
  128)`` at ``weights[:, 0]``, the wire ``payload (S, rows, 128)`` in
  int8, float8_e4m3fn, bfloat16 or float32 with ``scales (S, rows, 1)``;
* :func:`cdmsgd_update_qm` — the mixed-momentum (``_qm``) form of
  ``cdmsgd_update_2d``: the momentum rode the wire as a second payload
  ``mom_payload`` / ``mom_scales`` of the payload's dtype, and the local
  ``momentum`` is its self tile: ``v' = mu mix_q(momentum, mom_payload) -
  alpha g``;
* :func:`cdmsgd_nesterov_update` (``_q``, ``_qm``) —
  ``cdmsgd_nesterov_update_2d``: CDMSGD that also returns the next
  lookahead ``x' + mu v'`` in a new buffer;
* :func:`cdadam_update` (``_q``, ``_qm``) — ``cdadam_update_2d``: the
  mixing with a local Adam step; ``_qm`` mixes the first moment;
* :func:`cdsgd_update_sparse` (and ``cdmsgd_`` / ``cdmsgd_nesterov_`` /
  ``cdadam_update_sparse``) — ``*_update_sparse_2d``: the ``_q`` forms'
  arithmetic with the neighbours as top-k compact stacks (``values (S,
  k_rows, 128)`` int8, ``indices`` int32 flat dense positions, sorted and
  unique per neighbour, ``scales (S, k_rows, 1)``), scatter-accumulated
  in stencil order;
* :func:`sr_quantize` — ``sr_quantize_2d``: ``x (A, rows, 128)`` to int8
  (stochastic rounding) or float8_e4m3fn (nearest) codes and per-row
  scales, one launch for all agents of a bucket.

The top-k threshold kernel's wrapper lives in :mod:`.topk` with the rest of
the compressor; its library is built from here like the others.

Gradient, momentum, moment, lookahead and self buffers are the parameter
bucket's type, float32 or bfloat16, in every form and in
:func:`sr_quantize` (:data:`BUCKET_DTYPES`; the kernels compute in float32
and round each output once to bf16, as the Pallas kernels store into the
bucket's dtype).  Every operand is contiguous and on one device.
``A_out = 1`` is one agent's stencil; ``A_out = S = A`` is the whole
stacked simulation in one launch.

Update outputs are written **in place**: the new parameters into
``grad``'s storage, ``v'`` into ``momentum``'s and Adam's ``m'`` / ``v'``
into ``m``'s / ``v``'s (the JAX kernels' ``input_output_aliases``); the
wrappers return those same tensors.  Nesterov's lookahead is the one new
output, allocated by the wrapper.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (a
launch error raises), CPU tensors run the plain version in :mod:`.ref`.
Each wrapper counts its kernel launches in its ``launches`` attribute, and
by bucket type in ``launches_by_bucket``; the CPU path launches nothing and
counts nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.consensus_update import ref

LANE = 128

#: rows (of 128 lanes, all agents) one ``sr_quantize`` launch takes: the
#: kernel counts rows in 32-bit integers
MAX_QUANTIZE_ROWS = 2**31 - 1
#: payload / neighbor dtype -> the kernels' kind code
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
         torch.float8_e4m3fn: 3}
NEIGHBOR_DTYPES = (torch.float32, torch.bfloat16)
F32 = (torch.float32,)
#: parameter bucket types
BUCKET_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
#: library name (``csrc/<name>.cu``) -> its C functions' signatures
LIBRARIES = {
    "consensus_update": {
        "cdsgd_update": (_I, (_P, _P, _I, _P, _I, _I, _I, _LL, _F, _I, _P)),
        "cdmsgd_update": (_I, (_P, _P, _I, _P, _P, _I, _I, _I, _LL, _F, _F, _I,
                               _P)),
        "cdsgd_update_q": (_I, (_P, _P, _P, _I, _P, _P, _I, _I, _I, _LL, _F, _I,
                                _P)),
        "cdmsgd_update_q": (_I, (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _LL,
                                 _F, _F, _I, _P)),
        "cdmsgd_update_qm": (_I, (_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                  _I, _LL, _F, _F, _I, _P)),
        "cdmsgd_nesterov_update": (_I, (_P, _P, _I, _P, _P, _P, _I, _I, _I,
                                        _LL, _F, _F, _I, _P)),
        "cdmsgd_nesterov_update_q": (_I, (_P, _P, _P, _I, _P, _P, _P, _P, _I,
                                          _I, _I, _LL, _F, _F, _I, _P)),
        "cdmsgd_nesterov_update_qm": (_I, (_P, _P, _P, _P, _I, _P, _P, _P, _P,
                                           _P, _I, _I, _I, _LL, _F, _F, _I,
                                           _P)),
        "cdadam_update": (_I, (_P, _P, _I, _P, _P, _P, _I, _I, _I, _LL,
                               _F, _F, _F, _F, _F, _F, _I, _P)),
        "cdadam_update_q": (_I, (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                                 _LL, _F, _F, _F, _F, _F, _F, _I, _P)),
        "cdadam_update_qm": (_I, (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _LL, _F, _F, _F, _F, _F, _F, _I,
                                  _P)),
        "cdsgd_update_sparse": (_I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _LL,
                                     _LL, _F, _I, _P)),
        "cdmsgd_update_sparse": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _LL, _LL, _F, _F, _I, _P)),
        "cdmsgd_nesterov_update_sparse": (_I, (_P, _P, _P, _P, _P, _P, _P, _P,
                                               _I, _I, _I, _LL, _LL, _F, _F,
                                               _I, _P)),
        "cdadam_update_sparse": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _LL, _LL, _F, _F, _F, _F, _F, _F,
                                      _I, _P)),
    },
    "sr_quantize": {
        "sr_quantize": (_I, (_P, _I, _P, _I, _P, _LL, _LL, _U, _U, _I, _P)),
    },
    "topk_threshold": {
        "topk_threshold": (_I, (_P, _P, _P, _P, _P, _I, _LL, _I, _LL, _I,
                                _P)),
    },
}


def library(name: str = "consensus_update") -> ctypes.CDLL:
    """A kernels' shared library, built from its CUDA source on first use."""
    return build.load(name, LIBRARIES[name])


def build_libraries() -> dict:
    """Build every kernel library (one ``nvcc`` per source, all at once)."""
    build.build_all(LIBRARIES)
    return {name: library(name) for name in LIBRARIES}


def _f32(x) -> float:
    """The float32 value the kernel sees for a scalar operand."""
    return float(np.float32(x))


def _check(name: str, t: torch.Tensor, shape, device: torch.device,
           dtypes=F32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _bucket_of(outs) -> tuple:
    """The one bucket type every output (and the self buffer) must have:
    ``grad``'s when it is one of :data:`BUCKET_DTYPES`, else both (whose
    check then names what ``grad`` should be)."""
    g = outs[0][1]
    if isinstance(g, torch.Tensor) and g.dtype in BUCKET_DTYPES:
        return (g.dtype,)
    return BUCKET_DTYPES


def _stack(name: str, t) -> tuple:
    """``(S, rows)`` of a ``(S, rows, 128)`` stack operand."""
    if not isinstance(t, torch.Tensor) or t.dim() != 3 or t.shape[-1] != LANE:
        raise ValueError(f"{name} must be a (S, rows, 128) tensor, got "
                         f"{getattr(t, 'shape', type(t))}")
    return t.shape[0], t.shape[1]


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check_placement(reads, outs, device: torch.device) -> None:
    """No output overlaps any operand (the outputs are written in place
    while every operand is read); 16-byte alignment on the card."""
    for j, (n_out, t_out) in enumerate(outs):
        for n, t in [*reads, *outs[:j]]:
            (a0, a1), (b0, b1) = _span(t), _span(t_out)
            if a0 < b1 and b0 < a1:
                raise ValueError(f"{n} and {n_out} overlap in memory; the "
                                 f"update writes {n_out} in place")
    if device.type == "cuda":
        for name, t in [*reads, *outs]:
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")
    elif device.type != "cpu":
        raise ValueError(f"no consensus-update kernel for device {device}")


def _check_operands(weights, neighbors, outs):
    """Validate the dense operand form; returns ``(a_out, s, rows,
    device)``."""
    s, rows = _stack("neighbors", neighbors)
    device = neighbors.device
    if not isinstance(weights, torch.Tensor) or weights.dim() != 2:
        raise ValueError("weights must be an (A_out, S) tensor")
    a_out = weights.shape[0]
    _check("weights", weights, (a_out, s), device)
    _check("neighbors", neighbors, (s, rows, LANE), device, NEIGHBOR_DTYPES)
    bucket = _bucket_of(outs)
    for name, t in outs:
        _check(name, t, (a_out, rows, LANE), device, bucket)
    _check_placement([("weights", weights), ("neighbors", neighbors)], outs,
                     device)
    return a_out, s, rows, device


def _check_q_operands(weights, self_buf, payload, scales, outs,
                      mom_payload=None, mom_scales=None):
    """Validate the self-separated operand form (with the momentum payload
    of the ``_qm`` form when given); returns ``(a_out, s, rows,
    device)``."""
    s, rows = _stack("payload", payload)
    device = payload.device
    if not isinstance(weights, torch.Tensor) or weights.dim() != 2:
        raise ValueError("weights must be an (A_out, S+1) tensor")
    a_out = weights.shape[0]
    _check("weights", weights, (a_out, s + 1), device)
    _check("payload", payload, (s, rows, LANE), device, tuple(KINDS))
    _check("scales", scales, (s, rows, 1), device)
    bucket = _bucket_of(outs)
    _check("self_buf", self_buf, (a_out, rows, LANE), device, bucket)
    reads = [("weights", weights), ("self_buf", self_buf),
             ("payload", payload), ("scales", scales)]
    if mom_payload is not None:
        _check("mom_payload", mom_payload, (s, rows, LANE), device,
               (payload.dtype,))
        _check("mom_scales", mom_scales, (s, rows, 1), device)
        reads += [("mom_payload", mom_payload), ("mom_scales", mom_scales)]
    for name, t in outs:
        _check(name, t, (a_out, rows, LANE), device, bucket)
    _check_placement(reads, outs, device)
    return a_out, s, rows, device


_stream = build.current_stream
_launch_check = build.check_launch


def _count(fn, bucket: torch.dtype) -> None:
    """One launch of ``fn``'s kernel on a ``bucket`` bucket."""
    fn.launches += 1
    fn.launches_by_bucket[str(bucket)[6:]] += 1


def cdsgd_update(weights: torch.Tensor, neighbors: torch.Tensor,
                 grad: torch.Tensor, alpha) -> torch.Tensor:
    """``grad[a] <- sum_s weights[a,s] neighbors[s] - alpha grad[a]``."""
    a_out, s, rows, device = _check_operands(weights, neighbors,
                                             [("grad", grad)])
    alpha = _f32(alpha)
    if device.type == "cpu":
        grad.copy_(ref.cdsgd_update_ref(weights, neighbors, grad, alpha))
        return grad
    if a_out == 0 or rows == 0:
        return grad
    rc = library().cdsgd_update(
        weights.data_ptr(), neighbors.data_ptr(), KINDS[neighbors.dtype],
        grad.data_ptr(), KINDS[grad.dtype], a_out, s, rows * LANE // 4, alpha,
        device.index, _stream(device))
    _launch_check(rc, "cdsgd_update")
    _count(cdsgd_update, grad.dtype)
    return grad


def cdmsgd_update(weights: torch.Tensor, neighbors: torch.Tensor,
                  grad: torch.Tensor, momentum: torch.Tensor, alpha, mu):
    """``momentum[a] <- mu momentum[a] - alpha grad[a]``;
    ``grad[a] <- sum_s weights[a,s] neighbors[s] + momentum[a]``.

    Returns ``(grad, momentum)``, both updated in place.
    """
    a_out, s, rows, device = _check_operands(
        weights, neighbors, [("grad", grad), ("momentum", momentum)])
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        out, new_v = ref.cdmsgd_update_ref(weights, neighbors, grad, momentum,
                                           alpha, mu)
        grad.copy_(out)
        momentum.copy_(new_v)
        return grad, momentum
    if a_out == 0 or rows == 0:
        return grad, momentum
    rc = library().cdmsgd_update(
        weights.data_ptr(), neighbors.data_ptr(), KINDS[neighbors.dtype],
        grad.data_ptr(), momentum.data_ptr(), KINDS[grad.dtype], a_out, s,
        rows * LANE // 4, alpha, mu, device.index, _stream(device))
    _launch_check(rc, "cdmsgd_update")
    _count(cdmsgd_update, grad.dtype)
    return grad, momentum


def cdsgd_update_q(weights: torch.Tensor, self_buf: torch.Tensor,
                   payload: torch.Tensor, scales: torch.Tensor,
                   grad: torch.Tensor, alpha) -> torch.Tensor:
    """``grad[a] <- w[a,0] self[a] + sum_s w[a,1+s] (payload[s] * scales[s])
    - alpha grad[a]``."""
    a_out, s, rows, device = _check_q_operands(
        weights, self_buf, payload, scales, [("grad", grad)])
    alpha = _f32(alpha)
    if device.type == "cpu":
        grad.copy_(ref.cdsgd_update_q_ref(weights, self_buf, payload, scales,
                                          grad, alpha))
        return grad
    if a_out == 0 or rows == 0:
        return grad
    rc = library().cdsgd_update_q(
        weights.data_ptr(), self_buf.data_ptr(), payload.data_ptr(),
        KINDS[payload.dtype], scales.data_ptr(), grad.data_ptr(),
        KINDS[grad.dtype], a_out, s, rows, alpha, device.index,
        _stream(device))
    _launch_check(rc, "cdsgd_update_q")
    _count(cdsgd_update_q, grad.dtype)
    return grad


def cdmsgd_update_q(weights: torch.Tensor, self_buf: torch.Tensor,
                    payload: torch.Tensor, scales: torch.Tensor,
                    grad: torch.Tensor, momentum: torch.Tensor, alpha, mu):
    """``momentum[a] <- mu momentum[a] - alpha grad[a]``;
    ``grad[a] <- w[a,0] self[a] + sum_s w[a,1+s] (payload[s] * scales[s])
    + momentum[a]``.  Returns ``(grad, momentum)``, both updated in place.
    """
    a_out, s, rows, device = _check_q_operands(
        weights, self_buf, payload, scales,
        [("grad", grad), ("momentum", momentum)])
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        out, new_v = ref.cdmsgd_update_q_ref(weights, self_buf, payload,
                                             scales, grad, momentum, alpha, mu)
        grad.copy_(out)
        momentum.copy_(new_v)
        return grad, momentum
    if a_out == 0 or rows == 0:
        return grad, momentum
    rc = library().cdmsgd_update_q(
        weights.data_ptr(), self_buf.data_ptr(), payload.data_ptr(),
        KINDS[payload.dtype], scales.data_ptr(), grad.data_ptr(),
        momentum.data_ptr(), KINDS[grad.dtype], a_out, s, rows, alpha, mu,
        device.index, _stream(device))
    _launch_check(rc, "cdmsgd_update_q")
    _count(cdmsgd_update_q, grad.dtype)
    return grad, momentum


def cdmsgd_update_qm(weights: torch.Tensor, self_buf: torch.Tensor,
                     payload: torch.Tensor, scales: torch.Tensor,
                     mom_payload: torch.Tensor, mom_scales: torch.Tensor,
                     grad: torch.Tensor, momentum: torch.Tensor, alpha, mu):
    """``momentum[a] <- mu (w[a,0] momentum[a] + sum_s w[a,1+s]
    (mom_payload[s] * mom_scales[s])) - alpha grad[a]``;
    ``grad[a] <- w[a,0] self[a] + sum_s w[a,1+s] (payload[s] * scales[s])
    + momentum[a]``.  Returns ``(grad, momentum)``, both updated in place.
    """
    a_out, s, rows, device = _check_q_operands(
        weights, self_buf, payload, scales,
        [("grad", grad), ("momentum", momentum)], mom_payload, mom_scales)
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        out, new_v = ref.cdmsgd_update_qm_ref(
            weights, self_buf, payload, scales, mom_payload, mom_scales,
            grad, momentum, alpha, mu)
        grad.copy_(out)
        momentum.copy_(new_v)
        return grad, momentum
    if a_out == 0 or rows == 0:
        return grad, momentum
    rc = library().cdmsgd_update_qm(
        weights.data_ptr(), self_buf.data_ptr(), payload.data_ptr(),
        mom_payload.data_ptr(), KINDS[payload.dtype], scales.data_ptr(),
        mom_scales.data_ptr(), grad.data_ptr(), momentum.data_ptr(),
        KINDS[grad.dtype], a_out, s, rows, alpha, mu, device.index,
        _stream(device))
    _launch_check(rc, "cdmsgd_update_qm")
    _count(cdmsgd_update_qm, grad.dtype)
    return grad, momentum


def _finish(outs, results) -> tuple:
    """Copy a plain version's results into the in-place outputs; a result
    without an output buffer (the lookahead) is returned as it is."""
    done = []
    for i, r in enumerate(results):
        if i < len(outs):
            outs[i].copy_(r)
            done.append(outs[i])
        else:
            done.append(r)
    return tuple(done)


def cdmsgd_nesterov_update(weights: torch.Tensor, neighbors: torch.Tensor,
                           grad: torch.Tensor, momentum: torch.Tensor,
                           alpha, mu):
    """:func:`cdmsgd_update` that also returns the next lookahead
    ``grad' + mu momentum'``.  Returns ``(grad, momentum, look)``: the
    first two updated in place, ``look`` new."""
    a_out, s, rows, device = _check_operands(
        weights, neighbors, [("grad", grad), ("momentum", momentum)])
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        return _finish([grad, momentum], ref.cdmsgd_nesterov_update_ref(
            weights, neighbors, grad, momentum, alpha, mu))
    look = torch.empty_like(grad)
    if a_out == 0 or rows == 0:
        return grad, momentum, look
    rc = library().cdmsgd_nesterov_update(
        weights.data_ptr(), neighbors.data_ptr(), KINDS[neighbors.dtype],
        grad.data_ptr(), momentum.data_ptr(), look.data_ptr(),
        KINDS[grad.dtype], a_out, s, rows * LANE // 4, alpha, mu, device.index,
        _stream(device))
    _launch_check(rc, "cdmsgd_nesterov_update")
    _count(cdmsgd_nesterov_update, grad.dtype)
    return grad, momentum, look


def cdmsgd_nesterov_update_q(weights: torch.Tensor, self_buf: torch.Tensor,
                             payload: torch.Tensor, scales: torch.Tensor,
                             grad: torch.Tensor, momentum: torch.Tensor,
                             alpha, mu):
    """:func:`cdmsgd_update_q` plus the lookahead; returns
    ``(grad, momentum, look)``."""
    a_out, s, rows, device = _check_q_operands(
        weights, self_buf, payload, scales,
        [("grad", grad), ("momentum", momentum)])
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        return _finish([grad, momentum], ref.cdmsgd_nesterov_update_q_ref(
            weights, self_buf, payload, scales, grad, momentum, alpha, mu))
    look = torch.empty_like(grad)
    if a_out == 0 or rows == 0:
        return grad, momentum, look
    rc = library().cdmsgd_nesterov_update_q(
        weights.data_ptr(), self_buf.data_ptr(), payload.data_ptr(),
        KINDS[payload.dtype], scales.data_ptr(), grad.data_ptr(),
        momentum.data_ptr(), look.data_ptr(), KINDS[grad.dtype], a_out, s,
        rows, alpha, mu, device.index, _stream(device))
    _launch_check(rc, "cdmsgd_nesterov_update_q")
    _count(cdmsgd_nesterov_update_q, grad.dtype)
    return grad, momentum, look


def cdmsgd_nesterov_update_qm(weights: torch.Tensor, self_buf: torch.Tensor,
                              payload: torch.Tensor, scales: torch.Tensor,
                              mom_payload: torch.Tensor,
                              mom_scales: torch.Tensor, grad: torch.Tensor,
                              momentum: torch.Tensor, alpha, mu):
    """:func:`cdmsgd_update_qm` plus the lookahead; returns
    ``(grad, momentum, look)``."""
    a_out, s, rows, device = _check_q_operands(
        weights, self_buf, payload, scales,
        [("grad", grad), ("momentum", momentum)], mom_payload, mom_scales)
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        return _finish([grad, momentum], ref.cdmsgd_nesterov_update_qm_ref(
            weights, self_buf, payload, scales, mom_payload, mom_scales, grad,
            momentum, alpha, mu))
    look = torch.empty_like(grad)
    if a_out == 0 or rows == 0:
        return grad, momentum, look
    rc = library().cdmsgd_nesterov_update_qm(
        weights.data_ptr(), self_buf.data_ptr(), payload.data_ptr(),
        mom_payload.data_ptr(), KINDS[payload.dtype], scales.data_ptr(),
        mom_scales.data_ptr(), grad.data_ptr(), momentum.data_ptr(),
        look.data_ptr(), KINDS[grad.dtype], a_out, s, rows, alpha, mu,
        device.index, _stream(device))
    _launch_check(rc, "cdmsgd_nesterov_update_qm")
    _count(cdmsgd_nesterov_update_qm, grad.dtype)
    return grad, momentum, look


def _adam_scalars(alpha, b1, b2, eps, bc1, bc2) -> tuple:
    return tuple(_f32(x) for x in (alpha, b1, b2, eps, bc1, bc2))


def cdadam_update(weights: torch.Tensor, neighbors: torch.Tensor,
                  grad: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                  alpha, b1, b2, eps, bc1, bc2):
    """``m <- b1 m + (1-b1) grad``; ``v <- b2 v + ((1-b2) grad) grad``;
    ``grad <- sum_s weights[a,s] neighbors[s] - alpha ((m/bc1) /
    (sqrt(v/bc2) + eps))``.  Returns ``(grad, m, v)``, all in place."""
    a_out, s, rows, device = _check_operands(
        weights, neighbors, [("grad", grad), ("m", m), ("v", v)])
    scal = _adam_scalars(alpha, b1, b2, eps, bc1, bc2)
    if device.type == "cpu":
        return _finish([grad, m, v], ref.cdadam_update_ref(
            weights, neighbors, grad, m, v, *scal))
    if a_out == 0 or rows == 0:
        return grad, m, v
    rc = library().cdadam_update(
        weights.data_ptr(), neighbors.data_ptr(), KINDS[neighbors.dtype],
        grad.data_ptr(), m.data_ptr(), v.data_ptr(), KINDS[grad.dtype], a_out,
        s, rows * LANE // 4, *scal, device.index, _stream(device))
    _launch_check(rc, "cdadam_update")
    _count(cdadam_update, grad.dtype)
    return grad, m, v


def cdadam_update_q(weights: torch.Tensor, self_buf: torch.Tensor,
                    payload: torch.Tensor, scales: torch.Tensor,
                    grad: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    alpha, b1, b2, eps, bc1, bc2):
    """Self-separated :func:`cdadam_update`; returns ``(grad, m, v)``."""
    a_out, s, rows, device = _check_q_operands(
        weights, self_buf, payload, scales,
        [("grad", grad), ("m", m), ("v", v)])
    scal = _adam_scalars(alpha, b1, b2, eps, bc1, bc2)
    if device.type == "cpu":
        return _finish([grad, m, v], ref.cdadam_update_q_ref(
            weights, self_buf, payload, scales, grad, m, v, *scal))
    if a_out == 0 or rows == 0:
        return grad, m, v
    rc = library().cdadam_update_q(
        weights.data_ptr(), self_buf.data_ptr(), payload.data_ptr(),
        KINDS[payload.dtype], scales.data_ptr(), grad.data_ptr(),
        m.data_ptr(), v.data_ptr(), KINDS[grad.dtype], a_out, s, rows, *scal,
        device.index, _stream(device))
    _launch_check(rc, "cdadam_update_q")
    _count(cdadam_update_q, grad.dtype)
    return grad, m, v


def cdadam_update_qm(weights: torch.Tensor, self_buf: torch.Tensor,
                     payload: torch.Tensor, scales: torch.Tensor,
                     mom_payload: torch.Tensor, mom_scales: torch.Tensor,
                     grad: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     alpha, b1, b2, eps, bc1, bc2):
    """Mixed-momentum :func:`cdadam_update_q`: the first moment ``m`` is the
    self tile of its wire payload ``mom_payload``; returns ``(grad, m, v)``.
    """
    a_out, s, rows, device = _check_q_operands(
        weights, self_buf, payload, scales,
        [("grad", grad), ("m", m), ("v", v)], mom_payload, mom_scales)
    scal = _adam_scalars(alpha, b1, b2, eps, bc1, bc2)
    if device.type == "cpu":
        return _finish([grad, m, v], ref.cdadam_update_qm_ref(
            weights, self_buf, payload, scales, mom_payload, mom_scales, grad,
            m, v, *scal))
    if a_out == 0 or rows == 0:
        return grad, m, v
    rc = library().cdadam_update_qm(
        weights.data_ptr(), self_buf.data_ptr(), payload.data_ptr(),
        mom_payload.data_ptr(), KINDS[payload.dtype], scales.data_ptr(),
        mom_scales.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
        KINDS[grad.dtype], a_out, s, rows, *scal, device.index,
        _stream(device))
    _launch_check(rc, "cdadam_update_qm")
    _count(cdadam_update_qm, grad.dtype)
    return grad, m, v


def _check_sparse_operands(weights, self_buf, values, indices, scales, outs):
    """Validate the sparse (top-k wire) operand form; returns ``(a_out, s,
    k_rows, rows, device)``."""
    s, k_rows = _stack("values", values)
    device = values.device
    if not isinstance(weights, torch.Tensor) or weights.dim() != 2:
        raise ValueError("weights must be an (A_out, S+1) tensor")
    a_out = weights.shape[0]
    _check("weights", weights, (a_out, s + 1), device)
    _check("values", values, (s, k_rows, LANE), device, (torch.int8,))
    _check("indices", indices, (s, k_rows, LANE), device, (torch.int32,))
    _check("scales", scales, (s, k_rows, 1), device)
    if not isinstance(self_buf, torch.Tensor) or self_buf.dim() != 3:
        raise ValueError("self_buf must be an (A_out, rows, 128) tensor")
    rows = self_buf.shape[1]
    bucket = _bucket_of(outs)
    _check("self_buf", self_buf, (a_out, rows, LANE), device, bucket)
    if k_rows > rows:
        raise ValueError(f"{k_rows} compact rows for a bucket of {rows} rows")
    for name, t in outs:
        _check(name, t, (a_out, rows, LANE), device, bucket)
    _check_placement([("weights", weights), ("self_buf", self_buf),
                      ("values", values), ("indices", indices),
                      ("scales", scales)], outs, device)
    return a_out, s, k_rows, rows, device


def _sparse_ptrs(weights, self_buf, values, indices, scales) -> tuple:
    return (weights.data_ptr(), self_buf.data_ptr(), values.data_ptr(),
            indices.data_ptr(), scales.data_ptr())


def cdsgd_update_sparse(weights: torch.Tensor, self_buf: torch.Tensor,
                        values: torch.Tensor, indices: torch.Tensor,
                        scales: torch.Tensor, grad: torch.Tensor,
                        alpha) -> torch.Tensor:
    """The sparse operand form of :func:`cdsgd_update_q`: the neighbours
    are top-k compact stacks, ``values (S, k_rows, 128)`` int8 at the flat
    dense positions ``indices`` (int32, sorted and unique per neighbour)
    with ``scales (S, k_rows, 1)``:
    ``grad[a] <- w[a,0] self[a] + sum_s scatter(w[a,1+s] (values[s] *
    scales[s]) @ indices[s]) - alpha grad[a]``."""
    a_out, s, k_rows, rows, device = _check_sparse_operands(
        weights, self_buf, values, indices, scales, [("grad", grad)])
    alpha = _f32(alpha)
    if device.type == "cpu":
        grad.copy_(ref.cdsgd_update_sparse_ref(weights, self_buf, values,
                                               indices, scales, grad, alpha))
        return grad
    if a_out == 0 or rows == 0:
        return grad
    rc = library().cdsgd_update_sparse(
        *_sparse_ptrs(weights, self_buf, values, indices, scales),
        grad.data_ptr(), KINDS[grad.dtype], a_out, s, k_rows, rows, alpha,
        device.index, _stream(device))
    _launch_check(rc, "cdsgd_update_sparse")
    _count(cdsgd_update_sparse, grad.dtype)
    return grad


def cdmsgd_update_sparse(weights: torch.Tensor, self_buf: torch.Tensor,
                         values: torch.Tensor, indices: torch.Tensor,
                         scales: torch.Tensor, grad: torch.Tensor,
                         momentum: torch.Tensor, alpha, mu):
    """Sparse-operand :func:`cdmsgd_update_q`; returns ``(grad, momentum)``,
    both updated in place."""
    a_out, s, k_rows, rows, device = _check_sparse_operands(
        weights, self_buf, values, indices, scales,
        [("grad", grad), ("momentum", momentum)])
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        return _finish([grad, momentum], ref.cdmsgd_update_sparse_ref(
            weights, self_buf, values, indices, scales, grad, momentum,
            alpha, mu))
    if a_out == 0 or rows == 0:
        return grad, momentum
    rc = library().cdmsgd_update_sparse(
        *_sparse_ptrs(weights, self_buf, values, indices, scales),
        grad.data_ptr(), momentum.data_ptr(), KINDS[grad.dtype], a_out, s,
        k_rows, rows, alpha, mu, device.index, _stream(device))
    _launch_check(rc, "cdmsgd_update_sparse")
    _count(cdmsgd_update_sparse, grad.dtype)
    return grad, momentum


def cdmsgd_nesterov_update_sparse(weights: torch.Tensor,
                                  self_buf: torch.Tensor,
                                  values: torch.Tensor, indices: torch.Tensor,
                                  scales: torch.Tensor, grad: torch.Tensor,
                                  momentum: torch.Tensor, alpha, mu):
    """Sparse-operand :func:`cdmsgd_nesterov_update_q`; returns ``(grad,
    momentum, look)``: the first two in place, ``look`` new."""
    a_out, s, k_rows, rows, device = _check_sparse_operands(
        weights, self_buf, values, indices, scales,
        [("grad", grad), ("momentum", momentum)])
    alpha, mu = _f32(alpha), _f32(mu)
    if device.type == "cpu":
        return _finish([grad, momentum], ref.cdmsgd_nesterov_update_sparse_ref(
            weights, self_buf, values, indices, scales, grad, momentum,
            alpha, mu))
    look = torch.empty_like(grad)
    if a_out == 0 or rows == 0:
        return grad, momentum, look
    rc = library().cdmsgd_nesterov_update_sparse(
        *_sparse_ptrs(weights, self_buf, values, indices, scales),
        grad.data_ptr(), momentum.data_ptr(), look.data_ptr(),
        KINDS[grad.dtype], a_out, s, k_rows, rows, alpha, mu, device.index,
        _stream(device))
    _launch_check(rc, "cdmsgd_nesterov_update_sparse")
    _count(cdmsgd_nesterov_update_sparse, grad.dtype)
    return grad, momentum, look


def cdadam_update_sparse(weights: torch.Tensor, self_buf: torch.Tensor,
                         values: torch.Tensor, indices: torch.Tensor,
                         scales: torch.Tensor, grad: torch.Tensor,
                         m: torch.Tensor, v: torch.Tensor,
                         alpha, b1, b2, eps, bc1, bc2):
    """Sparse-operand :func:`cdadam_update_q` (local moments); returns
    ``(grad, m, v)``, all in place."""
    a_out, s, k_rows, rows, device = _check_sparse_operands(
        weights, self_buf, values, indices, scales,
        [("grad", grad), ("m", m), ("v", v)])
    scal = _adam_scalars(alpha, b1, b2, eps, bc1, bc2)
    if device.type == "cpu":
        return _finish([grad, m, v], ref.cdadam_update_sparse_ref(
            weights, self_buf, values, indices, scales, grad, m, v, *scal))
    if a_out == 0 or rows == 0:
        return grad, m, v
    rc = library().cdadam_update_sparse(
        *_sparse_ptrs(weights, self_buf, values, indices, scales),
        grad.data_ptr(), m.data_ptr(), v.data_ptr(), KINDS[grad.dtype], a_out,
        s, k_rows, rows, *scal, device.index, _stream(device))
    _launch_check(rc, "cdadam_update_sparse")
    _count(cdadam_update_sparse, grad.dtype)
    return grad, m, v


def sr_quantize(x: torch.Tensor, seed: int, exchange: str, *,
                agent_stride: int = 0):
    """Quantize ``x (A, rows, 128)`` float32 or bfloat16 for the wire (a
    bf16 bucket is widened exactly: the codes and scales of the float32
    bucket of the same values).

    Returns ``(q, scales)``: ``q (A, rows, 128)`` int8 (``exchange="int8"``,
    stochastic rounding) or float8_e4m3fn (``"fp8"``, nearest), ``scales
    (A, rows, 1)`` float32, one per 128-lane row.  Agent ``a`` draws its
    stochastic-rounding stream from the 32-bit seed ``seed + agent_stride *
    a`` (wrapping); fp8 draws nothing.

    The kernel runs for about 20 microseconds at the training path's shape,
    so the host work per call is kept to the checks, two allocations and
    the launch: the C function is resolved once (:func:`_sr_quantize_fn`),
    the outputs are allocated ``like`` ``x`` (cheaper than ``torch.empty``
    with a device), and the library selects the device only when it is not
    current.
    """
    qdtype = ref.QDTYPE.get(exchange)
    if qdtype is None:
        raise ValueError(f"sr_quantize takes exchange 'int8' or 'fp8', got "
                         f"{exchange!r}")
    a_count, rows = _stack("x", x)
    device = x.device
    _check("x", x, (a_count, rows, LANE), device, BUCKET_DTYPES)
    if a_count * rows > MAX_QUANTIZE_ROWS:
        raise ValueError(f"sr_quantize takes at most {MAX_QUANTIZE_ROWS} rows "
                         f"per launch, got {a_count * rows}")
    if device.type == "cpu":
        return ref.sr_quantize_ref(x, seed, exchange, agent_stride)
    _check_placement([("x", x)], [], device)
    q = torch.empty_like(x, dtype=qdtype)
    scales = x.new_empty((a_count, rows, 1), dtype=torch.float32)
    if a_count == 0 or rows == 0:
        return q, scales
    rc = _sr_quantize_fn()(
        x.data_ptr(), KINDS[x.dtype], q.data_ptr(), KINDS[qdtype],
        scales.data_ptr(), a_count * rows, rows, seed & 0xFFFFFFFF,
        agent_stride & 0xFFFFFFFF, device.index, _stream(device))
    _launch_check(rc, "sr_quantize")
    _count(sr_quantize, x.dtype)
    return q, scales


@functools.cache
def _sr_quantize_fn():
    """The ``sr_quantize`` C function, its library built and its argtypes
    set on first use."""
    return library("sr_quantize").sr_quantize


#: every kernel wrapper of this module, by kernel name
KERNELS = {"cdsgd_update": cdsgd_update, "cdmsgd_update": cdmsgd_update,
           "sr_quantize": sr_quantize, "cdsgd_update_q": cdsgd_update_q,
           "cdmsgd_update_q": cdmsgd_update_q,
           "cdmsgd_update_qm": cdmsgd_update_qm,
           "cdmsgd_nesterov_update": cdmsgd_nesterov_update,
           "cdmsgd_nesterov_update_q": cdmsgd_nesterov_update_q,
           "cdmsgd_nesterov_update_qm": cdmsgd_nesterov_update_qm,
           "cdadam_update": cdadam_update, "cdadam_update_q": cdadam_update_q,
           "cdadam_update_qm": cdadam_update_qm,
           "cdsgd_update_sparse": cdsgd_update_sparse,
           "cdmsgd_update_sparse": cdmsgd_update_sparse,
           "cdmsgd_nesterov_update_sparse": cdmsgd_nesterov_update_sparse,
           "cdadam_update_sparse": cdadam_update_sparse}
# (topk_threshold, in .topk, adds itself to this table when the package
# is imported, before any caller can read it)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_bucket = {str(d)[6:]: 0 for d in BUCKET_DTYPES}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def bucket_launch_counts() -> dict:
    """``{kernel: {"float32": n, "bfloat16": m}}`` of every kernel."""
    return {name: dict(fn.launches_by_bucket) for name, fn in KERNELS.items()}


reset_launch_counts()
