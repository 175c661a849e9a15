"""Port parity: the hybrid family (hymba-1.5b: sliding-window attention and
a mamba head on the same normed input) against the JAX package.

* The mamba functions on numpy-drawn inputs (harsh decays: ``dt`` a
  softplus of unit normals): ``mamba_scan`` and ``mamba_chunked`` (chunks
  of 32, composed step by step) with and without a carried state, in
  float32, within 1e-5 of max |y| of JAX's (JAX composes in
  ``lax.associative_scan``'s tree order: the same products rounded in
  another order, not bit for bit), and ``mamba_chunked`` within 1e-4
  (``tests/test_perf_paths.py``'s bound) of the port's own ``mamba_scan``;
  ``mamba_apply`` on both of its branches (64 steps: chunked; 40: the
  scan) within 1e-5 of max |y| in float32 and 2e-2 in bfloat16 (one-ulp
  differences of the bf16 matrix products, measured 0.6-1.1%).
* The reduced config (``torch_zoo_carry.carried`` weights; window 8,
  chunk 16): ``forward`` logits within 1e-5 of max |logit| in float32 at
  80 tokens (attention banded in JAX, the flash kernel's plain version in
  the port; mamba's scan); ``loss_fn`` at 64 (mamba chunked) within 1e-5
  (relative); ``decode_step`` over 12 positions (past the window)
  within 1e-5 of JAX's decode and of the port's own forward, its caches
  (bf16 K/V, float32 mamba state) shaped and typed as the reference's.  In
  bfloat16 the forward's distance from the float32 forward is held to at
  most twice JAX's own (through a whole model, bf16 rounding differences
  amplify to 2-5% of max |logit|: not comparable directly).
* A hymba-shaped config with a real GQA group of 5 (10 query heads on 2,
  head dim 32; ``reduced()`` clips hymba's 5 KV heads to a group of 1):
  ``forward`` at 64 tokens (mamba chunked) within 1e-5, float32.
* ``loss_fn(..., remat=True)`` under the stacked trainer's grad phase
  (``vmap`` of ``grad_and_value``): every gradient bit for bit with
  ``remat=False``, float32 and bfloat16, at 64 tokens (mamba chunked).

JAX functions are jitted once per module.  ``pytest -s`` prints the gaps.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_zoo_carry import carried, draw, one_torch_thread, rel  # noqa: E402, F401

from repro.nn import ssm as jssm  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.nn import ssm  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

NAME = "hymba-1.5b"
GROUP5 = {"n_heads": 10, "n_kv_heads": 2, "head_dim": 32}
B = 2


def _scan_inputs(s, seed, di=24, n=16, state=False):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, s, di))
    dt = np.logaddexp(rng.normal(size=(B, s, di)), 0.0)          # harsh decays
    bi, ci = rng.normal(size=(B, s, n)), rng.normal(size=(B, s, n))
    a = -np.exp(0.3 * rng.normal(size=(di, n)))
    h0 = rng.normal(size=(B, di, n)) if state else None
    arrays = [x.astype(np.float32) for x in (u, dt, bi, ci, a)]
    return arrays, None if h0 is None else h0.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _j_scan_fn(kind: str):
    fn = jssm.mamba_scan if kind == "scan" else jssm.mamba_chunked
    return jax.jit(fn)


@pytest.mark.parametrize("state", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("kind", ["scan", "chunked"])
def test_mamba_scans_match_jax(kind, state):
    arrays, h0 = _scan_inputs(96, seed=1, state=state)
    want_y, want_h = _j_scan_fn(kind)(*map(jnp.asarray, arrays),
                                      None if h0 is None else jnp.asarray(h0))
    fn = ssm.mamba_scan if kind == "scan" else ssm.mamba_chunked
    t = [torch.from_numpy(x) for x in arrays]
    t0 = None if h0 is None else torch.from_numpy(h0)
    got_y, got_h = fn(*t, t0)
    if state:                             # the carried state shows in the output
        assert float((got_y - fn(*t, None)[0]).abs()[:, 0].max()) > 1e-1
    gaps = rel(got_y.numpy(), want_y), rel(got_h.numpy(), want_h)
    line = f"mamba_{kind} ({'carried' if state else 'zero'} state) vs JAX: y {gaps[0]:.3e}, " \
           f"h {gaps[1]:.3e} of max"
    if kind == "chunked":
        ref_y, ref_h = ssm.mamba_scan(*t, t0)
        own = (float((got_y - ref_y).abs().max()), float((got_h - ref_h).abs().max()))
        line += f"; vs the port's mamba_scan {own[0]:.3e}, {own[1]:.3e} (abs)"
        torch.testing.assert_close(got_y, ref_y, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got_h, ref_h, rtol=1e-4, atol=1e-4)
    print(line)
    assert got_y.dtype == got_h.dtype == torch.float32 and got_h.shape == (B, 24, 16)
    assert max(gaps) <= 1e-5


def test_associative_scan_matches_lax_at_odd_lengths():
    """The chunk's step composition (``_compose_steps``: a running product
    and a step loop) at lengths 7 and 12 against ``lax.associative_scan`` of
    the same composition (its tree order leaves an odd element on some
    level at both)."""
    rng = np.random.default_rng(5)

    def combine(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]

    for n in (7, 12):
        a = np.exp(-np.abs(rng.normal(size=(n, 3, 4)))).astype(np.float32)
        g = rng.normal(size=(n, 3, 4)).astype(np.float32)
        wa, wg = jax.jit(lambda a, g: jax.lax.associative_scan(combine, (a, g), axis=0))(a, g)
        ga, gg = ssm._compose_steps(torch.from_numpy(a), torch.from_numpy(g))
        assert rel(ga.numpy(), wa) <= 1e-6 and rel(gg.numpy(), wg) <= 1e-6, n


def _mamba_case(dtype, s, seed=2):
    jp = draw({"m": jssm.mamba_template(64, n_state=16, dtype=jnp.dtype(dtype))}, seed)["m"]
    x = np.random.default_rng(seed + 1).normal(size=(B, s, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), jx, \
        params_from_numpy(np.asarray(jx), "cpu")


@functools.lru_cache(maxsize=None)
def _j_mamba_apply():
    return jax.jit(jssm.mamba_apply)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("s", [64, 40], ids=["chunked", "scan"])
def test_mamba_apply_matches_jax(s, dtype, tol):
    jp, tp, jx, tx = _mamba_case(dtype, s)
    want_y, want_h = _j_mamba_apply()(jp, jx)
    with torch.no_grad():
        got_y, got_h = ssm.mamba_apply(tp, tx)
    assert got_y.dtype == tx.dtype and got_h.dtype == torch.float32
    gaps = rel(got_y.float().numpy(), want_y), rel(got_h.numpy(), want_h)
    print(f"mamba_apply {dtype} s={s} ({'chunked' if s == 64 else 'scan'}): y {gaps[0]:.3e}, "
          f"state {gaps[1]:.3e} of max (tol {tol:g})")
    assert max(gaps) <= tol


def _tokens(cfg, s, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(1, cfg.vocab_size, (B, s)).astype(np.int32)
            for k in ("inputs", "targets")}


@functools.lru_cache(maxsize=None)
def _j_forward(jc):
    return jax.jit(lambda p, t: jt.forward(jc, p, {"inputs": t})[0])


def _forwards(changes, dtype, s):
    jc, tc, jp, tp = carried(NAME, dtype, **changes)
    toks = _tokens(tc, s)["inputs"]
    want = _j_forward(jc)(jp, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tt.forward(tc, tp, {"inputs": torch.from_numpy(toks)})
    assert got.shape == (B, s, tc.vocab_size) and got.dtype == tc.dtype
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert float(aux["moe_aux"]) == 0.0
    return got, want


FORWARD_CASES = [({}, 80), (GROUP5, 64)]


@pytest.mark.parametrize("changes,s", FORWARD_CASES, ids=["reduced-s80", "group5-s64"])
def test_forward_matches_jax(changes, s):
    tc = carried(NAME, "float32", **changes)[1]
    assert tc.n_heads // tc.n_kv_heads == (5 if changes else 1)
    got, want = _forwards(changes, "float32", s)
    gap = rel(got.numpy(), want)
    print(f"forward {NAME} reduced {changes or ''} s={s} float32: max |logit diff| / "
          f"max |logit| {gap:.3e} (tol 1e-5)")
    assert gap <= 1e-5


def test_bf16_forward_stays_as_close_to_float32_as_jax():
    got16, want16 = _forwards({}, "bfloat16", 80)
    got32, want32 = _forwards({}, "float32", 80)
    port, ref = rel(got16.float().numpy(), got32.numpy()), rel(want16, want32)
    print(f"forward {NAME} reduced bf16 vs float32: port {port:.3e}, JAX {ref:.3e}; port "
          f"vs JAX in bf16 {rel(got16.float().numpy(), want16):.3e} (not held)")
    assert port <= 2 * ref


def test_loss_matches_jax():
    jc, tc, jp, tp = carried(NAME, "float32")
    batch = _tokens(tc, 64, seed=2)
    want, wm = jax.jit(lambda p, b: jt.loss_fn(jc, p, b))(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, gm = tt.loss_fn(tc, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    gap = abs(float(got) - float(want)) / abs(float(want))
    print(f"loss {NAME} reduced: {float(got):.6f} (JAX {float(want):.6f}), relative "
          f"gap {gap:.2e}")
    assert gap <= 1e-5 and float(gm["moe_aux"]) == 0.0


DECODE_POS = 12                       # past the reduced window of 8


@pytest.fixture(scope="module")
def decoded():
    jc, tc, jp, tp = carried(NAME, "float32")
    toks = _tokens(tc, DECODE_POS, seed=3)["inputs"]
    step = jax.jit(lambda p, c, t, i: jt.decode_step(jc, p, c, t, i))
    cache = jt.init_cache(jc, B, DECODE_POS)
    want = []
    for t in range(DECODE_POS):
        logits, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        want.append(np.asarray(logits))
    tcache = tt.init_cache(tc, B, DECODE_POS, device="cpu")
    got = []
    with torch.no_grad():
        for t in range(DECODE_POS):
            logits, tcache = tt.decode_step(tc, tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
            got.append(logits.numpy().copy())
        fwd, _ = tt.forward(tc, tp, {"inputs": torch.from_numpy(toks)})
    return np.stack(got, 1), np.stack(want, 1), fwd.numpy(), tcache, cache


def test_decode_matches_jax_past_the_window(decoded):
    got, want, fwd, tcache, jcache = decoded
    window = carried(NAME, "float32")[1].window
    assert window < DECODE_POS
    gaps = rel(got, want), rel(got, fwd)
    state = rel(tcache["hymba"]["mamba"].numpy(), jcache["hymba"]["mamba"])
    print(f"decode {NAME} reduced over {DECODE_POS} positions (window "
          f"{window}): vs JAX {gaps[0]:.3e}, vs the port's forward "
          f"{gaps[1]:.3e}; final mamba state vs JAX {state:.3e}")
    assert max(gaps + (state,)) <= 1e-5


def test_cache_layout_matches_the_reference():
    jc, tc = carried(NAME, "bfloat16")[:2]
    jleaves = jax.tree_util.tree_leaves_with_path(jt.init_cache(jc, B, 16))
    tcache = tt.init_cache(tc, B, 16, device="cpu")
    assert tcache["hymba"]["mamba"].dtype == torch.float32
    assert tcache["hymba"]["attn"]["k"].dtype == torch.bfloat16
    tleaves = tree_leaves(tcache)
    assert len(tleaves) == len(jleaves)
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and \
            str(t.dtype).removeprefix("torch.") == str(j.dtype), path


def _stacked(tp, seed=0):
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: torch.stack([t, (t.float() * (1 + 0.01 * torch.from_numpy(
        rng.normal(size=t.shape).astype(np.float32)))).to(t.dtype)]), tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_phase_with_remat_is_bitwise(dtype):
    _, tc, _, tp = carried(NAME, dtype)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(1, tc.vocab_size, (2, B, 64)).astype(np.int32))
             for k in ("inputs", "targets")}
    gp = _stacked(tp)
    out = {}
    for remat in (False, True):
        phase = engine.make_grad_phase(lambda p, b, r=remat: tt.loss_fn(tc, p, b, remat=r), 1)
        out[remat] = phase(gp, batch)
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    leaves0, leaves1 = tree_leaves(g0), tree_leaves(g1)
    assert len(leaves1) == len(tree_leaves(tp))
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(leaves0, leaves1))
    mamba = g1["groups"]["hymba"]["mamba"]
    assert all(float(mamba[k].float().abs().max()) > 0 for k in ("a_log", "w_in", "w_dt"))
    print(f"remat {NAME} {dtype}: {len(leaves1)} gradients bit for bit, losses "
          f"{l1.reshape(-1).tolist()}")
