"""Port parity: the compressor axis's parser, shape math and compressors,
and the top-k threshold kernel's plain version, against the JAX package.

* ``parse_compressor``: the same ``(kind, param)`` for every valid spec of
  ``tests/test_compressor.py`` and ``tests/test_sparse_update.py``, the
  same exception type for every malformed one;
* ``topk_k_rows`` / ``topk_auto_k_rows`` / ``topk_k_rows_for``: equal to
  the JAX package's over a grid of rows, densities and budgets, the
  budget floor's error included;
* ``topk_compress_2d``: the indices bit for bit against ``lax.top_k``'s
  set (ties at the K-th magnitude broken toward the lower index) on
  inputs with deliberate ties, ``-0.0``, an all-zero bucket, a one-row
  bucket and ``p`` clamped to one row; values and scales bit for bit with
  JAX's uniforms injected into the port (``ref.uniforms``), against the
  compiled JAX function (XLA multiplies by ``f32(1 / 127)`` where eager
  JAX divides, and the port follows the compiled form);
* ``topk_decompress_2d`` bit for bit;
* ``_orthonormalize_cols`` and ``rank_compress_2d`` fed JAX's ``(128,
  r)`` basis, within 1e-5, a zero column included (the port draws its own
  basis: ``rank_init_q`` is checked for determinism and orthonormality);
* the threshold: ``tau`` bit for bit and the counts exact against
  ``topk_threshold_2d`` in interpret mode, on the bracketing, all-zero
  and all-ties cases of the JAX package's tests.

``pytest -s`` prints the measured gaps.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.kernels.consensus_update import topk as jtk  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.kernels.consensus_update import topk as ttk  # noqa: E402

RANK_ATOL = 1e-5

VALID_SPECS = ["none", "int8", "fp8", "topk:0.01", "topk:1", "rank:1",
               "rank:16", "topk:auto:65536", "topk:0.1", "topk:auto:6500"]
BAD_SPECS = ["gzip", "topk", "rank", "topk:0", "topk:1.5", "topk:x",
             "rank:0", "rank:-1", "rank:1.5", "int8:4", "none:1",
             "topk:auto", "topk:auto:", "topk:auto:x", "topk:auto:0",
             "topk:auto:-1", "topk:auto:1.5", 3]


def _bytes(t) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@functools.lru_cache(maxsize=None)
def _jax_uniform_fn(shape):
    return jax.jit(lambda s: jax.random.uniform(jax.random.PRNGKey(s), shape,
                                                jnp.float32))


def jax_uniforms(seed, shape, device=None):
    """The uniforms the JAX package draws on the CPU for one agent's tile."""
    return torch.from_numpy(np.array(_jax_uniform_fn(tuple(shape))(
        jnp.int32(seed))))


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_parse_compressor_matches_jax(spec):
    assert tcons.parse_compressor(spec) == jcons.parse_compressor(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_compressor_rejects_like_jax(spec):
    with pytest.raises(Exception) as jerr:
        jcons.parse_compressor(spec)
    with pytest.raises(jerr.type):
        tcons.parse_compressor(spec)


def test_k_rows_shape_math_matches_jax():
    grid = [1, 2, 6, 40, 100, 16941]
    for rows in grid:
        for p in (1e-6, 0.001, 0.01, 0.1, 0.25, 0.5, 1.0):
            assert ttk.topk_k_rows(rows, p) == jtk.topk_k_rows(rows, p)
    assert ttk.TOPK_LANE_ROW_BYTES == jtk.TOPK_LANE_ROW_BYTES == 644
    lane = jtk.TOPK_LANE_ROW_BYTES
    for rows_list in ([40, 1], [64, 64], [7, 3, 90], [16941], [4, 1]):
        for budget in (len(rows_list) * lane, len(rows_list) * lane + 17,
                       6500, 20_000, 131072, 10_000 * lane):
            want = jtk.topk_auto_k_rows(rows_list, budget)
            assert ttk.topk_auto_k_rows(rows_list, budget) == want
            assert ttk.topk_k_rows_for(rows_list, ("auto", budget)) == want
        for p in (0.01, 0.1):
            assert ttk.topk_k_rows_for(rows_list, p) == \
                jtk.topk_k_rows_for(rows_list, p)
    # below the floor: the same error
    with pytest.raises(ValueError, match="bucket"):
        jtk.topk_auto_k_rows([40, 1], lane)
    with pytest.raises(ValueError, match="bucket"):
        ttk.topk_auto_k_rows([40, 1], lane)
    with pytest.raises(ValueError):
        ttk.topk_k_rows(10, 0.0)
    assert ttk.topk_auto_k_rows([16941], 131072) == [203]


def _ties(rows, seed):
    """Few magnitude levels (ties at the K-th place), signed zeros."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (rows, 128)).astype(np.float32)
    x[0, :7] = -0.0
    return x


CASES = {
    "ties": (lambda: _ties(6, 0), 2),
    "ties-one-row": (lambda: _ties(6, 1), 1),
    "normal": (lambda: np.random.default_rng(2).standard_normal(
        (24, 128)).astype(np.float32), 3),
    "all-zero": (lambda: np.zeros((4, 128), np.float32), 1),
    "signed-zero": (lambda: np.where(np.arange(512).reshape(4, 128) % 3 == 0,
                                     np.float32(-0.0), np.float32(0.0)), 2),
    "one-row": (lambda: np.random.default_rng(3).standard_normal(
        (1, 128)).astype(np.float32), 1),
    "clamped-p": (lambda: np.random.default_rng(4).standard_normal(
        (100, 128)).astype(np.float32), jtk.topk_k_rows(100, 0.001)),
    "full": (lambda: _ties(3, 5), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_topk_compress_bitwise_matches_jax(case, monkeypatch):
    make, k_rows = CASES[case]
    x = make()
    seed = 7
    jv, ji, js = jax.jit(lambda a, s: jtk.topk_compress_2d(
        a, k_rows, s, interpret=True))(jnp.asarray(x), jnp.int32(seed))
    monkeypatch.setattr(ref, "uniforms", jax_uniforms)
    tv, ti, ts = ttk.topk_compress_2d(torch.from_numpy(x.copy()), k_rows, seed)
    assert ti.dtype == torch.int32 and tv.dtype == torch.int8
    assert tuple(ti.shape) == (k_rows, 128) and tuple(ts.shape) == (k_rows, 1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bytes(tv), np.asarray(jv).view(np.uint8))
    np.testing.assert_array_equal(_bytes(ts), np.asarray(js).view(np.uint8))
    idx = ti.numpy().ravel()
    assert np.all(np.diff(idx) > 0)
    # the dense gather-dequant form, bitwise
    rows = x.shape[0]
    jd = jtk.topk_decompress_2d(jv, ji, js, rows)
    td = ttk.topk_decompress_2d(tv, ti, ts, rows)
    np.testing.assert_array_equal(_bytes(td), np.asarray(jd).view(np.uint8))
    print(f"topk {case}: rows {rows} k_rows {k_rows}: indices, values, "
          "scales and decompression equal bit for bit")


def test_topk_compress_stacked_agents_match_per_agent_jax(monkeypatch):
    """The port's one-launch form over an agent stack: agent ``a`` seeded
    ``seed + stride * a``, as the JAX package's vmap seeds its agents."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 10, 128)).astype(np.float32)
    x[1] = np.round(x[1])                               # ties
    seed, stride, k_rows = 1000003, 104729, 2
    monkeypatch.setattr(ref, "uniforms", jax_uniforms)
    tv, ti, ts = ttk.topk_compress_2d(torch.from_numpy(x), k_rows, seed,
                                      agent_stride=stride)
    fn = jax.jit(lambda a, s: jtk.topk_compress_2d(a, k_rows, s,
                                                   interpret=True))
    for a in range(3):
        jv, ji, js = fn(jnp.asarray(x[a]), jnp.int32(seed + stride * a))
        np.testing.assert_array_equal(ti[a].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(_bytes(tv[a]), np.asarray(jv).view(np.uint8))
        np.testing.assert_array_equal(_bytes(ts[a]), np.asarray(js).view(np.uint8))


def _gap(t, j) -> float:
    return float(np.max(np.abs(t.numpy() - np.asarray(j)), initial=0.0))


def test_orthonormalize_cols_matches_jax_with_zero_column():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 4)).astype(np.float32)
    a[:, 2] = 0.0                                   # degenerate column
    a[:, 3] *= 1e-10                                # norm below eps
    j = jtk._orthonormalize_cols(jnp.asarray(a))
    t = ttk._orthonormalize_cols(torch.from_numpy(a))
    gap = _gap(t, j)
    print(f"_orthonormalize_cols: max gap {gap:.2e}")
    assert gap <= RANK_ATOL
    assert np.all(t.numpy()[:, 2] == 0.0) and np.all(t.numpy()[:, 3] == 0.0)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_rank_compress_matches_jax_on_jax_basis(r):
    rng = np.random.default_rng(r)
    m = rng.standard_normal((3, 40, 128)).astype(np.float32)
    m[2] = 0.0                                      # all-zero agent bucket
    q = np.asarray(jtk.rank_init_q(r))
    qs = np.broadcast_to(q, (3,) + q.shape).copy()
    jp, jqt, jq2 = jax.vmap(jtk.rank_compress_2d)(jnp.asarray(m),
                                                   jnp.asarray(qs))
    tp, tqt, tq2 = ttk.rank_compress_2d(torch.from_numpy(m),
                                        torch.from_numpy(qs))
    gaps = [_gap(tp, jp), _gap(tqt, jqt), _gap(tq2, jq2)]
    recon = _gap(ttk.rank_decompress_2d(tp, tqt),
                 jtk.rank_decompress_2d(jp, jqt))
    print(f"rank:{r} compress: max gap p {gaps[0]:.2e} qt {gaps[1]:.2e} "
          f"q' {gaps[2]:.2e} reconstruction {recon:.2e}")
    assert max(gaps + [recon]) <= RANK_ATOL


def test_rank_init_q_deterministic_orthonormal():
    q = ttk.rank_init_q(4)
    assert tuple(q.shape) == (128, 4) and q.dtype == torch.float32
    assert torch.equal(q, ttk.rank_init_q(4))
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(4), atol=1e-5)
    for bad in (0, 129, 1.5):
        with pytest.raises(ValueError):
            ttk.rank_init_q(bad)


THRESHOLD_CASES = {
    "bracket": (lambda: np.random.default_rng(0).standard_normal(
        (24, 128)).astype(np.float32), (1, 50, 700, 24 * 128)),
    "all-zero": (lambda: np.zeros((4, 128), np.float32), (8,)),
    "ties": (lambda: np.ones((4, 128), np.float32), (128,)),
    "ties-levels": (lambda: _ties(6, 3), (1, 100, 256, 768)),
}


@pytest.mark.parametrize("case", list(THRESHOLD_CASES))
def test_threshold_matches_pallas_interpret(case):
    make, ks = THRESHOLD_CASES[case]
    x = make()
    for k in ks:
        jtau, jcounts = jtk.topk_threshold_2d(jnp.asarray(x), k,
                                              interpret=True)
        ttau, tcounts = ttk.topk_threshold(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
        assert np.float32(ttau.item()).tobytes() == \
            np.asarray(jtau, np.float32).tobytes(), (k, ttau, jtau)
    print(f"threshold {case}: tau bitwise and counts exact for k in {ks}")


def _on_taus(rows, seed, bins=(0, 2, 7, 11, 15)):
    """A bucket with elements placed exactly on several thresholds tau_b
    (both signs; tau_0 is the bucket's own amax), negative zeros and ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    amax = np.float32(np.abs(x).max())
    ratios = np.asarray([1e-4 ** (b / 15) for b in range(16)], np.float32)
    taus = np.maximum(amax, np.float32(1e-30)) * ratios
    for i, b in enumerate(bins):
        x[1, 8 * i:8 * i + 4] = taus[b]
        x[2, 8 * i:8 * i + 3] = -taus[b]
    x[3, :5] = -0.0
    return x


def _stacked(seed):
    """Four agents six decades apart in magnitude, the third all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 9, 128)).astype(np.float32)
    x *= np.asarray([1e-3, 1.0, 0.0, 1e3], np.float32)[:, None, None]
    return x


THRESHOLD_DEVICE_CASES = {   # x, n_bins, ks
    "on-taus": (lambda: _on_taus(10, 3), 16, (1, 9, 40, 640, 1280)),
    "n_bins-1": (lambda: _on_taus(6, 4), 1, (0, 1, 768)),
    "n_bins-5": (lambda: _on_taus(6, 5), 5, (1, 30, 300)),
    "n_bins-16": (lambda: _on_taus(6, 6), 16, (2, 64, 500)),
    "stacked-magnitudes": (lambda: _stacked(7), 16, (1, 100, 1152)),
}


@pytest.mark.parametrize("case", list(THRESHOLD_DEVICE_CASES))
def test_threshold_function_matches_pallas_at_edges(case):
    """The threshold function the card now runs whole (amax, thresholds,
    counts, pick), held on its edges against ``topk_threshold_2d`` in
    interpret mode, agent by agent: elements exactly on tau_b (an element
    equal to tau_b counts for b), 1, 5 and 16 bins, and stacked agents of
    different magnitudes with an all-zero one.  tau and counts bit for
    bit."""
    make, n_bins, ks = THRESHOLD_DEVICE_CASES[case]
    x = make()
    xs = x if x.ndim == 3 else x[None]
    for k in ks:
        tau, counts = ttk.topk_threshold(torch.from_numpy(xs), k, n_bins=n_bins)
        assert tuple(counts.shape) == (xs.shape[0], n_bins)
        for a in range(xs.shape[0]):
            jtau, jcounts = jtk.topk_threshold_2d(jnp.asarray(xs[a]), k,
                                                  n_bins=n_bins, interpret=True)
            np.testing.assert_array_equal(counts[a].numpy(), np.asarray(jcounts))
            assert np.float32(tau[a].item()).tobytes() == \
                np.asarray(jtau, np.float32).tobytes(), (case, k, a)
    print(f"threshold {case}: tau bitwise and counts exact for k in {ks}")


def test_threshold_stacked_agents_and_bracketing():
    """Per-agent thresholds from one call; tau selects <= k and the K-th
    magnitude lies within one geometric bin below it."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 20, 128)).astype(np.float32)
    x[2] = 0.0
    k = 300
    tau, counts = ttk.topk_threshold(torch.from_numpy(x), k)
    assert tuple(tau.shape) == (3,) and tuple(counts.shape) == (3, 16)
    for a in range(3):
        jtau, jcounts = jtk.topk_threshold_2d(jnp.asarray(x[a]), k,
                                              interpret=True)
        np.testing.assert_array_equal(counts[a].numpy(), np.asarray(jcounts))
        assert float(tau[a]) == float(jtau)
    mag = np.abs(x[0]).ravel()
    kth = np.sort(mag)[::-1][k - 1]
    assert np.sum(mag >= float(tau[0])) <= k
    assert float(tau[0]) * 1e-4 ** (1 / 15) <= kth <= float(tau[0])
    with pytest.raises(ValueError, match="n_bins"):
        ttk.topk_threshold(torch.from_numpy(x), k, n_bins=17)
