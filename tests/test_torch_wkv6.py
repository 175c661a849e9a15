"""Port parity: the WKV6 kernel's plain version, its model-layout entry
point and the model's ``wkv6_scan`` against the JAX package.

The same numpy inputs go through the JAX Pallas kernel (``interpret=True``)
and ``wkv6_ref`` and through the port's ``wkv6`` on CPU tensors (its plain
version), on the shapes of the reference's kernel sweep; ``wkv6_bsnh``
against JAX ``wkv6_scan``; the port's ``wkv6_scan`` with a carried
``state0`` (the decode path) against JAX's.  A mirror of the CUDA kernel's
arithmetic order (``_kernel_order``: the bonus term as one scalar per step,
each row group's y partial summed in sequence, the groups as a tree) is
held against the same references, so that its rounding is known off the
card.  Tolerance: the reference's 1e-4 abs and rel.  ``pytest -s`` prints
the gaps.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv_scan.ref import wkv6_ref as j_ref  # noqa: E402
from repro.kernels.rwkv_scan.rwkv_scan import wkv6_pallas  # noqa: E402
from repro.nn.ssm import wkv6_scan as j_scan  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops  # noqa: E402
from repro_torch.kernels.rwkv_scan import rwkv_scan as rs  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.nn.ssm import wkv6_scan  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's kernel sweep: (bh, s, hs, chunk)
SWEEP = [(4, 128, 64, 32), (2, 96, 32, 32), (1, 256, 64, 128), (8, 64, 16, 16)]


def _inputs(shape, u_shape, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.normal(size=shape))) * 0.5 + 0.45).astype(np.float32)
    u = (0.1 * rng.normal(size=u_shape)).astype(np.float32)
    return r, k, v, w, u


def _gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("bh,s,hs,chunk", SWEEP)
def test_plain_version_matches_pallas_kernel_and_ref(bh, s, hs, chunk):
    x = _inputs((bh, s, hs), (bh, hs), seed=s + hs)
    jy, jst = wkv6_pallas(*map(jnp.asarray, x), chunk=chunk, interpret=True)
    ry, rst = j_ref(*map(jnp.asarray, x))
    y, st = rs.wkv6(*map(torch.from_numpy, x))
    assert rs.wkv6.launches == 0 and y.dtype == torch.float32
    print(f"wkv6 ({bh},{s},{hs}): port plain vs Pallas interpret y "
          f"{_gap(y.numpy(), jy):.3e} state {_gap(st.numpy(), jst):.3e}; vs JAX "
          f"wkv6_ref y {_gap(y.numpy(), ry):.3e} state {_gap(st.numpy(), rst):.3e}")
    for got, want in ((y, jy), (st, jst), (y, ry), (st, rst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    direct_y, direct_st = wkv6_ref(*map(torch.from_numpy, x))
    assert torch.equal(direct_y, y) and torch.equal(direct_st, st)


def _fma(a, b, c):
    """``fmaf``: a * b + c rounded once to float32 (a float64 holds the
    float32 product exactly; the sum's double rounding is rarely off by
    one float32 step)."""
    return (a.double() * b.double() + c.double()).float()


def _tree(parts):
    """Sum over axis 1 as the kernel's tree: neighbours first, then pairs
    of pairs (its xor shuffles and its shared-memory reduction)."""
    parts = list(parts.unbind(1))
    step = 1
    while step < len(parts):
        for q in range(0, len(parts), 2 * step):
            parts[q] = parts[q] + parts[q + step]
        step *= 2
    return parts[0]


def _kernel_order(r, k, v, w, u):
    """WKV6 in ``csrc/wkv6.cu``'s arithmetic order, float32.

    Per step: ``b_t`` summed by the staging threads (SR rows each, in
    sequence, ``fmaf(r, u k, b)``), then as a tree over the SL threads of
    the step; each row group of 4 rows sums ``fmaf(r, S, acc)`` in sequence
    with S before the update; y = ``fmaf(v, b, tree of the hs / 4 groups)``;
    the state ``fmaf(w, S, k v)`` with k v rounded."""
    r, k, v, w, u = (torch.from_numpy(x) for x in (r, k, v, w, u))
    bh, s, hs = r.shape
    lanes = {64: 8, 32: 2, 16: 1}[hs]       # SL: staging threads per step
    groups = hs // 4
    state = torch.zeros((bh, hs, hs))
    ys = torch.empty((bh, s, hs))
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        rl, ukl = rt.reshape(bh, lanes, -1), (u * kt).reshape(bh, lanes, -1)
        bonus = torch.zeros((bh, lanes))
        for i in range(hs // lanes):
            bonus = _fma(rl[:, :, i], ukl[:, :, i], bonus)
        rg = rt.reshape(bh, groups, -1)
        sg = state.reshape(bh, groups, -1, hs)
        acc = torch.zeros((bh, groups, hs))
        for i in range(4):
            acc = _fma(rg[:, :, i, None], sg[:, :, i], acc)
        ys[:, t] = _fma(vt, _tree(bonus)[:, None], _tree(acc))
        state = _fma(wt[:, :, None], state, kt[:, :, None] * vt[:, None, :])
    return ys, state


@pytest.mark.parametrize("bh,s,hs,chunk", SWEEP)
def test_kernel_order_matches_pallas_kernel_and_ref(bh, s, hs, chunk):
    """The CUDA kernel's summation order against the Pallas kernel, JAX's
    ``wkv6_ref`` and the port's plain version: the reordering's rounding."""
    x = _inputs((bh, s, hs), (bh, hs), seed=s + hs)
    y, st = _kernel_order(*x)
    jy, jst = wkv6_pallas(*map(jnp.asarray, x), chunk=chunk, interpret=True)
    ry, rst = j_ref(*map(jnp.asarray, x))
    py, pst = wkv6_ref(*map(torch.from_numpy, x))
    print(f"wkv6 kernel order ({bh},{s},{hs}), max |y| {float(py.abs().max()):.3g}: "
          f"vs Pallas interpret y {_gap(y.numpy(), jy):.3e} state "
          f"{_gap(st.numpy(), jst):.3e}; vs JAX wkv6_ref y {_gap(y.numpy(), ry):.3e} "
          f"state {_gap(st.numpy(), rst):.3e}; vs the port's plain version y "
          f"{_gap(y, py):.3e} state {_gap(st, pst):.3e}")
    for got, want in ((y, jy), (st, jst), (y, ry), (st, rst), (y, py), (st, pst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_misaligned_operands_are_copied_for_the_kernel():
    """The kernel copies rows 16 bytes at a time: an operand whose rows do
    not start on 16 bytes is handed over as an aligned contiguous copy, an
    aligned one (the model's layout, the folded view) as it is."""
    base = torch.arange(2 * 8 * 4 * 16 + 1, dtype=torch.float32)
    aligned = base[:-1].view(2, 8, 4, 16)
    assert rs._aligned16(aligned) is aligned
    folded = aligned.reshape(16, 4, 16)[:, :, None]
    assert rs._aligned16(folded) is folded
    shifted = base[1:].view(2, 8, 4, 16)
    copy = rs._aligned16(shifted)
    assert copy is not shifted and copy.data_ptr() % 16 == 0
    assert torch.equal(copy, shifted)
    padded = torch.zeros((3, 5, 24))[:, :, :16]     # 96-byte row stride: aligned
    assert rs._aligned16(padded) is padded
    padded = torch.zeros((3, 5, 22))[:, :, :16]     # 88-byte row stride
    copy = rs._aligned16(padded)
    assert copy.stride() == (80, 16, 1) and torch.equal(copy, padded)


def test_bsnh_wrapper_matches_model_scan():
    b, s, n_h, hs = 2, 64, 2, 32
    x = _inputs((b, s, n_h, hs), (n_h, hs), seed=7)
    y, st = ops.wkv6_bsnh(*map(torch.from_numpy, x))
    jy, jst = j_scan(*map(jnp.asarray, x))
    print(f"wkv6_bsnh vs JAX wkv6_scan: y {_gap(y.numpy(), jy):.3e} "
          f"state {_gap(st.numpy(), jst):.3e}")
    assert y.shape == (b, s, n_h, hs) and st.shape == (b, n_h, hs, hs)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("s", [1, 5])
def test_model_scan_with_carried_state_matches_jax(s):
    b, n_h, hs = 2, 4, 64
    x = _inputs((b, s, n_h, hs), (n_h, hs), seed=11 + s)
    state0 = np.random.default_rng(3).normal(size=(b, n_h, hs, hs)).astype(np.float32)
    y, st = wkv6_scan(*map(torch.from_numpy, x), state0=torch.from_numpy(state0))
    jy, jst = j_scan(*map(jnp.asarray, x), state0=jnp.asarray(state0))
    print(f"wkv6_scan s={s} with state0 vs JAX: y {_gap(y.numpy(), jy):.3e} "
          f"state {_gap(st.numpy(), jst):.3e}")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_state_carry_equals_two_halves():
    """A carried state: the second half from the first's state equals one scan."""
    b, s, n_h, hs = 1, 64, 2, 32
    r, k, v, w, u = map(torch.from_numpy, _inputs((b, s, n_h, hs), (n_h, hs), seed=5))
    y_one, st_one = ops.wkv6_bsnh(r, k, v, w, u)
    h = s // 2
    y1, st1 = ops.wkv6_bsnh(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)
    y2, st2 = wkv6_scan(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, state0=st1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_one, **TOL)
    torch.testing.assert_close(st2, st_one, **TOL)


def test_any_length_and_bf16_operands_take_the_plain_version_on_cpu():
    """The port's kernel takes any length (the reference's needs a multiple
    of its chunk); bf16 r, k, v give a bf16 y, the state stays float32."""
    r, k, v, w, u = map(torch.from_numpy, _inputs((3, 50, 16), (3, 16), seed=2))
    y, st = rs.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    want_y, want_st = wkv6_ref(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    assert torch.equal(y, want_y.bfloat16()) and torch.equal(st, want_st)


def test_forward_only_and_shape_checks():
    r = torch.zeros((2, 8, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rs.wkv6(r, r, r, r, torch.zeros((2, 16)))
    with pytest.raises(ValueError, match="u has shape"):
        rs.wkv6(r.detach(), r.detach(), r.detach(), r.detach(), torch.zeros((3, 16)))
