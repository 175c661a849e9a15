"""Port parity: the wire quantizer ``sr_quantize`` against the JAX package.

The JAX package's ``sr_quantize_2d(..., interpret=True)`` never reaches its
``pallas_call`` on the CPU: its interpret branch returns early through
``_quantize_math`` with ``jax.random`` uniforms.  So the oracle here is
``_quantize_math`` under ``jax.jit``, as the JAX trainer runs it (compiled,
XLA computes the scale ``amax / qmax`` as ``amax * f32(1 / qmax)``; eager
JAX divides and differs in the last bit of some scales), fed the same
inputs:

* fp8 (nearest rounding, no randomness) is held bitwise, codes and scales,
  including rows whose largest element maps to exactly +-448, e4m3fn
  subnormals (2^-9), an all-zero row (scale 1.0) and a ragged row count;
* int8 is held bitwise when both sides draw the same uniforms: the port's
  stream is replaced by JAX's (``ref.uniforms`` patched), which makes the
  wrapper's output equal ``sr_quantize_2d``'s.

The port's own stream (Philox4x32-10, ``ref.uniforms``) is held to what a
stochastic-rounding stream must give: error below one scale per element,
unbiased means over 200 seeds (the bounds of the JAX package's
``test_sr_quantize_is_unbiased``), seed determinism, and bits that do not
depend on how the counter space is cut.
"""

import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.consensus_update.consensus_update import (  # noqa: E402
    _quantize_math,
    sr_quantize_2d,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402


def _to_torch(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _rows(rows=37, seed=0):
    """(rows, 128) f32 with row scales over six decades, an all-zero row, a
    row with a negative maximum and a row of e4m3fn subnormals."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 128)) * (10.0 ** rng.uniform(-3, 3, (rows, 1)))
    x = x.astype(np.float32)
    x[3] = 0.0
    x[4, 7] = -1000.0                                   # max |x| negative
    sub = np.zeros(128, np.float32)
    sub[:8] = [448.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, -(2.0 ** -9),
               1.5 * 2.0 ** -9, 2.0 ** -7, -448.0]
    x[5] = sub                                          # scale 1.0: subnormals
    return x


def _jax_sr_quantize(exchange):
    return jax.jit(functools.partial(sr_quantize_2d, exchange=exchange,
                                     interpret=True))


def test_fp8_matches_jax_bitwise():
    x = _rows()
    jq, js = _jax_sr_quantize("fp8")(jnp.asarray(x), 0)
    q, s = cu.sr_quantize(torch.from_numpy(x)[None], 0, "fp8")
    np.testing.assert_array_equal(_bytes(q[0]), np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(js))
    assert float(s[0, 3, 0]) == 1.0                    # all-zero row
    codes = q[0].float()
    # every nonzero row's largest element maps to exactly +-448
    assert torch.all(codes.abs().amax(dim=1)[torch.arange(37) != 3] == 448.0)
    assert float(codes[5, 1]) == 2.0 ** -9              # a subnormal code
    print(f"fp8: {x.shape[0]} rows bitwise equal (codes and scales)")


def test_int8_quantize_math_matches_jax_with_same_uniforms():
    x = _rows(rows=11, seed=1)
    rng = np.random.default_rng(2)
    u = (rng.integers(0, 2 ** 24, size=x.shape) / 2.0 ** 24).astype(np.float32)
    jq, js = jax.jit(lambda a, b: _quantize_math(a, b, 127.0, jnp.int8))(
        jnp.asarray(x), jnp.asarray(u))
    q, s = ref.quantize_math(torch.from_numpy(x), torch.from_numpy(u), "int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("seed", [-1, 0, 7, 2 ** 31 - 1])
def test_int8_wrapper_matches_sr_quantize_2d_with_jax_uniforms(monkeypatch,
                                                               seed):
    """The wrapper (seed plumbing included) equals the JAX quantizer bit for
    bit once it draws JAX's uniforms."""
    def jax_uniforms(s, shape, device=None):
        key = jax.random.PRNGKey(jnp.asarray(s, jnp.int32))
        return _to_torch(jax.random.uniform(key, tuple(shape), jnp.float32))

    monkeypatch.setattr(ref, "uniforms", jax_uniforms)
    x = _rows(rows=19, seed=3)
    jq, js = _jax_sr_quantize("int8")(jnp.asarray(x), jnp.int32(seed))
    q, s = cu.sr_quantize(torch.from_numpy(x)[None], seed, "int8")
    np.testing.assert_array_equal(q[0].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(js))


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = ref.philox4x32(*(t(c) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_stream_does_not_depend_on_chunking():
    whole = ref.philox_uniforms(12345, 1000)
    for cut in (1, 333, 999):
        parts = torch.cat([ref.philox_uniforms(12345, cut),
                           ref.philox_uniforms(12345, 1000 - cut, offset=cut)])
        assert torch.equal(whole, parts)
    assert torch.equal(ref.uniforms(12345, (2, 128)).reshape(-1, 4),
                       whole[:64])
    assert float(whole.min()) >= 0.0 and float(whole.max()) < 1.0
    # the stacked launch is the per-agent launches, one seed each
    x = torch.from_numpy(_rows(rows=9, seed=4)).reshape(3, 3, 128)
    q, s = cu.sr_quantize(x, 41, "int8", agent_stride=104729)
    for a in range(3):
        qa, sa = cu.sr_quantize(x[a:a + 1].contiguous(), 41 + 104729 * a,
                                "int8")
        assert torch.equal(q[a], qa[0]) and torch.equal(s[a], sa[0])


def test_int8_error_below_one_scale_and_seed_determinism():
    x = torch.from_numpy(_rows(rows=16, seed=5))[None]
    q1, s1 = cu.sr_quantize(x, 42, "int8")
    q2, s2 = cu.sr_quantize(x, 42, "int8")
    q3, _ = cu.sr_quantize(x, 43, "int8")
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert bool(torch.any(q1 != q3)), "seed must matter"
    err = (q1.float() * s1 - x).abs()
    assert bool(torch.all(err <= s1 * (1 + 1e-6))), float((err / s1).max())


def test_int8_rounding_is_unbiased_over_200_seeds():
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (8, 128), jnp.float32)))
    draws = []
    for seed in range(200):
        q, s = cu.sr_quantize(x[None], seed, "int8")
        draws.append(q[0].float() * s[0])
    mean = torch.stack(draws).mean(dim=0).numpy()
    scale = float(x.abs().amax(dim=-1).max()) / 127.0
    np.testing.assert_allclose(mean, x.numpy(), atol=scale * 0.25)
    bias = np.abs(mean - x.numpy()).mean()
    print(f"int8 SR mean |bias| over 200 seeds: {bias / scale:.4f} scale")
    assert bias < scale * 0.05, f"rounding is biased: {bias}"


def test_sr_quantize_rejects_bad_operands():
    x = torch.zeros(2, 3, 128)
    with pytest.raises(ValueError, match="int8' or 'fp8"):
        cu.sr_quantize(x, 0, "bf16")
    with pytest.raises(TypeError, match="float32"):
        cu.sr_quantize(x.double(), 0, "int8")
    with pytest.raises(ValueError, match=r"\(S, rows, 128\)"):
        cu.sr_quantize(x[..., :64], 0, "int8")
    with pytest.raises(ValueError, match="contiguous"):
        cu.sr_quantize(x.transpose(0, 1), 0, "int8")
    before = cu.launch_counts()
    cu.sr_quantize(x, 0, "int8")
    assert cu.launch_counts() == before          # the CPU path launches nothing


@pytest.mark.parametrize("a,rows", [(2**31, 1), (1, 2**31), (3, 2**30)])
def test_sr_quantize_refuses_more_rows_than_a_launch_counts(a, rows):
    """The kernel counts rows in 32-bit integers: the wrapper refuses more
    than 2^31 - 1 rows on every device (shape-only meta tensors here)."""
    x = torch.empty((a, rows, 128), device="meta")
    with pytest.raises(ValueError, match="at most 2147483647 rows"):
        cu.sr_quantize(x, 0, "int8")


class _Elsewhere(torch.Tensor):
    """Shapes on a device with no kernel and no plain version (no data)."""

    @staticmethod
    def __new__(cls, shape, device):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=torch.float32,
                                                   device=device)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def test_sr_quantize_has_no_kernel_for_other_devices():
    """A device other than the card raises, but ``meta``, which takes the
    plain version (the op counter's and the dry-run's traces: shapes
    only)."""
    x = _Elsewhere((2, 3, 128), torch.device("xpu"))
    with pytest.raises(ValueError, match="no consensus-update kernel for device xpu"):
        cu.sr_quantize(x, 0, "fp8")
    q, sc = cu.sr_quantize(torch.empty((2, 3, 128), device="meta"), 0, "fp8")
    assert q.device.type == "meta" and q.dtype == torch.float8_e4m3fn
    assert sc.shape == (2, 3, 1)


def test_launch_helpers_resolve_once_and_read_the_raw_stream(monkeypatch):
    """The wrapper's host path: the C function is looked up once per process
    (not per call), and the stream handle is the raw current stream of the
    tensors' device index."""
    looked_up = []
    monkeypatch.setattr(cu, "library", lambda name: looked_up.append(name)
                        or type("Lib", (), {"sr_quantize": name})())
    cu._sr_quantize_fn.cache_clear()
    try:
        assert cu._sr_quantize_fn() == cu._sr_quantize_fn() == "sr_quantize"
        assert looked_up == ["sr_quantize"]
    finally:
        cu._sr_quantize_fn.cache_clear()
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    assert build.current_stream(torch.device("cuda", 3)) == 1003
