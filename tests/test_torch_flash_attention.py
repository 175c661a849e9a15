"""Port parity: the flash attention kernel's plain version and its model-
layout entry point against the JAX package.

The same numpy inputs go through the JAX Pallas kernel (``interpret=True``)
and its ``attention_ref`` and through the port's ``flash_attention`` on CPU
tensors (its plain version, ``attention_ref``), on the five cases of the
reference's kernel sweep (causal, non-causal, windows 64 and 32, GQA 4:1
and 8:2, bfloat16).  ``flash_attention_bshd`` is held against the model's
``blockwise_attention`` and ``banded_attention``, also at ragged lengths
(above 128 and not a multiple of it), which the public ``flash_attention``
refuses as the reference kernel does and ``flash_attention_any_length``
(the model path's launch) takes: there it is held against JAX's
``attention_ref`` and, for the causal self-attention the model runs,
against the Pallas kernel on inputs padded to its blocks and cropped.
Tolerances are the reference's own: ``tol_for`` (2e-5 float32, 2e-2
bfloat16, abs and rel) and 3e-5 for the model-layout wrapper.  ``pytest
-s`` prints the gaps.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_ref  # noqa: E402
from repro.nn.attention import banded_attention, blockwise_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402

CASES = [
    dict(b=2, h=4, kv=2, s=256, d=64, causal=True, window=None, dt="float32"),
    dict(b=1, h=4, kv=1, s=256, d=128, causal=True, window=64, dt="float32"),
    dict(b=1, h=2, kv=2, s=128, d=64, causal=False, window=None, dt="float32"),
    dict(b=1, h=8, kv=2, s=128, d=64, causal=True, window=32, dt="float32"),
    dict(b=1, h=4, kv=4, s=256, d=64, causal=True, window=None, dt="bfloat16"),
]


def tol_for(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(case["b"], case["h"], case["s"], case["d"])] + \
        [(case["b"], case["kv"], case["s"], case["d"])] * 2
    jx = [jnp.asarray(rng.normal(size=sh).astype(np.float32), case["dt"])
          for sh in shapes]
    tx = [params_from_numpy(np.asarray(x), "cpu") for x in jx]
    return jx, tx


def _gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['dt']}-h{c['h']}kv{c['kv']}"
                         f"-s{c['s']}-w{c['window']}-{'causal' if c['causal'] else 'full'}")
def test_plain_version_matches_pallas_kernel_and_ref(case):
    (jq, jk, jv), (tq, tk, tv) = _inputs(case)
    kw = dict(causal=case["causal"], window=case["window"])
    want_kernel = j_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    want_ref = j_ref(jq, jk, jv, **kw)
    got = fa.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and fa.flash_attention.launches == 0
    got = got.float().numpy()
    g_kernel, g_ref = _gap(got, want_kernel), _gap(got, want_ref)
    print(f"flash {case}: port plain vs Pallas interpret {g_kernel:.3e}, "
          f"vs JAX attention_ref {g_ref:.3e}")
    np.testing.assert_allclose(got, np.asarray(want_kernel, np.float32), **tol_for(case["dt"]))
    np.testing.assert_allclose(got, np.asarray(want_ref, np.float32), **tol_for(case["dt"]))
    # the plain version itself, called directly, is the same function
    direct = attention_ref(tq, tk, tv, **kw).float().numpy()
    np.testing.assert_array_equal(direct, got)


@pytest.mark.parametrize("window", [None, 48])
def test_bshd_wrapper_matches_model_blockwise(window):
    b, s, h, kv, d = 2, 128, 4, 2, 64
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, kv, kv))
    got = ops.flash_attention_bshd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=True, window=window)
    want = blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, chunk=64)
    print(f"flash_attention_bshd window={window} vs blockwise_attention: "
          f"{_gap(got.numpy(), want):.3e}")
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_bshd_wrapper_matches_model_banded():
    """A static window below s: the reference's model takes banded_attention."""
    b, s, h, kv, d, window = 1, 64, 4, 1, 64, 8
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, kv, kv))
    got = ops.flash_attention_bshd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=True, window=window)
    want = banded_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            window=window, q_chunk=16)
    print(f"flash_attention_bshd window={window} vs banded_attention: "
          f"{_gap(got.numpy(), want):.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("s", [130, 200, 320])
def test_rejects_ragged_blocks_on_every_device(s):
    """A length above 128 that is not a multiple of it (the reference
    kernel's blocks) raises in the public ``flash_attention``, also when
    only one of the two lengths is ragged; the model layout takes it."""
    q = torch.zeros((1, 2, s, 64))
    with pytest.raises(ValueError, match="must divide blocks"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="must divide blocks"):
        fa.flash_attention(torch.zeros((1, 2, 128, 64)), q, q, causal=False)
    t = q.transpose(1, 2)
    assert ops.flash_attention_bshd(t, t, t).shape == t.shape


RAGGED = [   # sq, sk, causal, window, dtype
    (130, 130, True, None, "float32"),
    (200, 200, True, 48, "float32"),
    (320, 320, True, None, "bfloat16"),
    (200, 200, True, 512, "bfloat16"),
    (100, 200, False, 40, "float32"),
    (200, 130, True, None, "float32"),
]


def _ragged_inputs(sq, sk, dt, h=4, kv=2, d=64, seed=5):
    rng = np.random.default_rng(seed)
    shapes = [(1, h, sq, d), (1, kv, sk, d), (1, kv, sk, d)]
    jx = [jnp.asarray(rng.normal(size=sh).astype(np.float32), dt) for sh in shapes]
    return jx, [params_from_numpy(np.asarray(x), "cpu") for x in jx]


@pytest.mark.parametrize("sq,sk,causal,window,dt", RAGGED)
def test_any_length_matches_ref_at_ragged_lengths(sq, sk, causal, window, dt):
    (jq, jk, jv), (tq, tk, tv) = _ragged_inputs(sq, sk, dt)
    kw = dict(causal=causal, window=window)
    n = fa.flash_attention.launches
    got = fa.flash_attention_any_length(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and fa.flash_attention.launches == n
    got = got.float().numpy()
    want = np.asarray(j_ref(jq, jk, jv, **kw), np.float32)
    gaps = [_gap(got, want)]
    np.testing.assert_allclose(got, want, **tol_for(dt))
    if causal and sq == sk:
        # the model's case: padded keys lie right of every real row's
        # diagonal, so the Pallas kernel on padded inputs, cropped, is the
        # same function
        pad = -sq % 128
        jp = [jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (jq, jk, jv)]
        kernel = j_flash(*jp, interpret=True, **kw)[:, :, :sq]
        gaps.append(_gap(got, kernel))
        np.testing.assert_allclose(got, np.asarray(kernel, np.float32), **tol_for(dt))
    print(f"flash_attention_any_length sq={sq} sk={sk} causal={causal} "
          f"window={window} {dt}: vs JAX attention_ref"
          f"{' and the padded Pallas kernel' if len(gaps) > 1 else ''} "
          + ", ".join(f"{x:.3e}" for x in gaps))


@pytest.mark.parametrize("window", [512, None])
@pytest.mark.parametrize("s", [640, 704, 200])
def test_float32_at_lengths_split_unevenly(s, window):
    """float32 at lengths whose query tiles the card's kernel cuts into
    key splits of unequal sizes (640: 10 key tiles of 64 in the last query
    tile; 704: 11; 200: a ragged last tile), the 512 window and the global
    mask, against the Pallas kernel in interpret mode (blocks of 64, or
    padded to 128 and cropped where 64 does not divide the length)."""
    (jq, jk, jv), (tq, tk, tv) = _ragged_inputs(s, s, "float32", h=4, kv=1, seed=s)
    got = fa.flash_attention_any_length(tq, tk, tv, window=window).numpy()
    if s % 64 == 0:
        kernel = j_flash(jq, jk, jv, window=window, block_q=64, block_k=64,
                         interpret=True)
    else:
        pad = -s % 128
        jp = [jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (jq, jk, jv)]
        kernel = j_flash(*jp, window=window, interpret=True)[:, :, :s]
    print(f"flash float32 s={s} window={window}: port vs Pallas interpret "
          f"{_gap(got, kernel):.3e}")
    np.testing.assert_allclose(got, np.asarray(kernel, np.float32), **tol_for("float32"))


@pytest.mark.parametrize("s", [130, 200, 320])
@pytest.mark.parametrize("window", [None, 48])
def test_bshd_wrapper_matches_model_blockwise_at_ragged_lengths(s, window):
    """The model layout at the lengths the reference's model serves through
    ``blockwise_attention`` (which pads KV to its chunk)."""
    b, h, kv, d = 1, 4, 1, 64
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, kv, kv))
    got = ops.flash_attention_bshd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=True, window=window)
    want = blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, chunk=128)
    print(f"flash_attention_bshd s={s} window={window} vs blockwise_attention "
          f"(chunk 128, padded): {_gap(got.numpy(), want):.3e}")
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_short_and_block_multiple_lengths_are_taken():
    """s <= 128 (one block) and multiples of 128 pass the block check."""
    for s in (1, 37, 128, 384):
        q = torch.randn((1, 2, s, 64))
        assert fa.flash_attention(q, q, q).shape == q.shape


def test_forward_only():
    q = torch.zeros((1, 2, 8, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, q, q)
    with torch.no_grad():
        assert fa.flash_attention(q, q, q).shape == q.shape
