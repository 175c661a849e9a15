"""Port parity: the encoder-decoder family (seamless-m4t-medium, reduced:
2 encoder and 2 decoder layers over 8 stub audio frames of dim 64)
against the JAX package, on ``torch_zoo_carry.carried`` weights.

* ``forward`` of 16 text tokens behind the frames: in float32 within 1e-5
  of max |logit|; on the config's bfloat16 weights with float32 frames
  (the reference's CLIs: JAX promotes the encoder to float32, the decoder
  stays bf16) and with bfloat16 frames (the prefill specs), within the
  reference's 2e-2, the logits' dtype JAX's in each case.
* ``loss_fn`` scores every text position: within 1e-5 (relative) of JAX's,
  and equal to the cross entropy of the (training) forward.
* ``encode_for_decode``: float32 frames give a float32 ``enc_out`` also
  for bfloat16 weights, bf16 frames a bf16 one (JAX's dtypes), within
  1e-5 of max |enc_out| where both are float32.
* ``decode_step`` over 6 teacher-forced positions on ``enc_out``: within
  1e-5 of max |logit| of JAX's decode and of the port's own forward; the
  cache (``dec`` K/V and ``enc_out``) shaped and typed as the reference's.
* ``loss_fn(..., remat=True)`` under the stacked trainer's grad phase:
  every gradient bit for bit with ``remat=False`` (the encoder's included:
  the decoder blocks' units carry ``enc_out`` as an input), float32 and
  bfloat16, the frames float32 ones as the train CLI feeds them.
* ``serve`` (the encoder once, then greedy decode) gives JAX's tokens on
  the same float32 weights, and the CLI runs at its tiny preset.
* ``gqa_cross_decode`` (one token over precomputed encoder K/V) within
  1e-5 of max |y| of JAX's.

JAX functions are jitted once per module.  ``pytest -s`` prints the gaps.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_zoo_carry import carried, one_torch_thread, rel  # noqa: E402, F401

from repro.nn import attention as jattn  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

NAME = "seamless-m4t-medium"
B, S = 2, 16


def _batch(cfg, frames_dtype=np.float32, seed=1):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            "frontend": rng.normal(size=(B, cfg.frontend_tokens, cfg.frontend_dim))
            .astype(np.float32)}


def _frames(x, dtype: str):
    """(JAX, port) frames of ``dtype`` from float32 numpy."""
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _j_forward(jc):
    return jax.jit(lambda p, b: jt.forward(jc, p, b)[0])


@functools.lru_cache(maxsize=None)
def _j_encode(jc):
    return jax.jit(lambda p, f: jt.encode_for_decode(jc, p, f))


FORWARD_CASES = [("float32", "float32", 1e-5), ("bfloat16", "float32", 2e-2),
                 ("bfloat16", "bfloat16", 2e-2)]


@pytest.mark.parametrize("dtype,frames,tol", FORWARD_CASES,
                         ids=[f"{d}-weights-{f}-frames" for d, f, _ in FORWARD_CASES])
def test_forward_matches_jax(dtype, frames, tol):
    jc, tc, jp, tp = carried(NAME, dtype)
    batch = _batch(tc)
    jf, tf = _frames(batch["frontend"], frames)
    want = _j_forward(jc)(jp, {"inputs": jnp.asarray(batch["inputs"]), "frontend": jf})
    with torch.no_grad():
        got, aux = tt.forward(tc, tp, {"inputs": torch.from_numpy(batch["inputs"]),
                                       "frontend": tf})
    assert got.shape == (B, S, tc.vocab_size) and float(aux["moe_aux"]) == 0.0
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == dtype
    gap = rel(got.float().numpy(), want)
    print(f"forward {NAME} reduced, {dtype} weights, {frames} frames: logits "
          f"{want.dtype}, max |logit diff| / max |logit| {gap:.3e} (tol {tol:g})")
    assert gap <= tol


def test_loss_scores_every_text_position():
    jc, tc, jp, tp = carried(NAME, "float32")
    batch = _batch(tc, seed=2)
    want, wm = jax.jit(lambda p, b: jt.loss_fn(jc, p, b))(jp, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got, gm = tt.loss_fn(tc, tp, tb)
        logits, _ = tt.forward(tc, tp, tb, differentiable=True)
    gap = abs(float(got) - float(want)) / abs(float(want))
    print(f"loss {NAME} reduced: {float(got):.6f} (JAX {float(want):.6f}), relative "
          f"gap {gap:.2e}")
    assert logits.shape[1] == S and gap <= 1e-5
    assert float(got) == float(gm["ce"]) == float(tt.cross_entropy(logits, tb["targets"]))


ENCODE_CASES = [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("dtype,frames", ENCODE_CASES,
                         ids=[f"{d}-weights-{f}-frames" for d, f in ENCODE_CASES])
def test_encode_for_decode_matches_jax(dtype, frames):
    jc, tc, jp, tp = carried(NAME, dtype)
    jf, tf = _frames(_batch(tc)["frontend"], frames)
    want = _j_encode(jc)(jp, jf)
    with torch.no_grad():
        got = tt.encode_for_decode(tc, tp, tf)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == frames
    assert got.shape == (B, tc.frontend_tokens, tc.d_model)
    gap = rel(got.float().numpy(), want)
    tol = 1e-5 if frames == "float32" else 2e-2
    print(f"encode_for_decode {dtype} weights, {frames} frames: enc_out {want.dtype}, "
          f"{gap:.3e} of max (tol {tol:g})")
    assert gap <= tol


DECODE_POS = 6


@pytest.fixture(scope="module")
def decoded():
    jc, tc, jp, tp = carried(NAME, "float32")
    batch = _batch(tc, seed=3)
    toks = batch["inputs"][:, :DECODE_POS]
    frames = batch["frontend"]
    step = jax.jit(lambda p, c, t, i: jt.decode_step(jc, p, c, t, i))
    jcache = jt.init_cache(jc, B, DECODE_POS, enc_len=tc.frontend_tokens)
    jcache["enc_out"] = _j_encode(jc)(jp, jnp.asarray(frames))
    want = []
    for t in range(DECODE_POS):
        logits, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        want.append(np.asarray(logits))
    tcache = tt.init_cache(tc, B, DECODE_POS, enc_len=tc.frontend_tokens, device="cpu")
    got = []
    with torch.no_grad():
        tcache["enc_out"] = tt.encode_for_decode(tc, tp, torch.from_numpy(frames))
        for t in range(DECODE_POS):
            logits, tcache = tt.decode_step(tc, tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
            got.append(logits.numpy().copy())
        fwd, _ = tt.forward(tc, tp, {"inputs": torch.from_numpy(toks),
                                     "frontend": torch.from_numpy(frames)})
    return np.stack(got, 1), np.stack(want, 1), fwd.numpy()


def test_decode_step_matches_jax(decoded):
    got, want, fwd = decoded
    gaps = rel(got, want), rel(got, fwd)
    print(f"decode {NAME} reduced over {DECODE_POS} positions: vs JAX {gaps[0]:.3e}, vs "
          f"the port's forward {gaps[1]:.3e} (tol 1e-5)")
    assert max(gaps) <= 1e-5


def test_cache_layout_matches_the_reference():
    jc, tc = carried(NAME, "bfloat16")[:2]
    jcache = jt.init_cache(jc, B, 12, enc_len=tc.frontend_tokens)
    tcache = tt.init_cache(tc, B, 12, enc_len=tc.frontend_tokens, device="cpu")
    assert sorted(tcache) == sorted(jcache) == ["dec", "enc_out"]
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
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
    batch = {k: torch.from_numpy(rng.integers(1, tc.vocab_size, (2, B, S)).astype(np.int32))
             for k in ("inputs", "targets")}
    batch["frontend"] = torch.ones((2, B, tc.frontend_tokens, tc.frontend_dim))
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
    enc = tree_leaves(g1["groups"]["enc"]) + [g1["frontend_proj"]["w"]]
    assert all(float(t.float().abs().max()) > 0 for t in enc)
    print(f"remat {NAME} {dtype}: {len(leaves1)} gradients bit for bit ({len(enc)} of "
          f"them the encoder's and the projector's, all nonzero), losses "
          f"{l1.reshape(-1).tolist()}")


def test_serve_gives_jaxs_tokens():
    jc, tc, jp, tp = carried(NAME, "float32")
    prompt = serve_lib.make_prompt(tc, B, 4, seed=5)
    seqs, stats = serve_lib.serve(tc, tp, prompt, 4, device="cpu")
    step = jax.jit(lambda p, c, t, i: jt.decode_step(jc, p, c, t, i))
    cache = jt.init_cache(jc, B, 8, enc_len=jc.frontend_tokens)
    cache["enc_out"] = _j_encode(jc)(jp, jnp.ones((B, jc.frontend_tokens, jc.frontend_dim)))
    tok, want = jnp.asarray(prompt[:, :1], jnp.int32), [prompt[:, :1]]
    for i in range(7):
        logits, cache = step(jp, cache, tok, jnp.int32(i))
        tok = (jnp.asarray(prompt[:, i + 1:i + 2], jnp.int32) if i + 1 < 4
               else jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
        want.append(np.asarray(tok))
    print(f"serve {NAME} reduced: {seqs[0].tolist()} (JAX {np.concatenate(want, 1)[0].tolist()})")
    assert stats["decode_steps"] == 7
    np.testing.assert_array_equal(seqs, np.concatenate(want, 1))


def test_serve_cli_at_the_tiny_preset(capsys):
    serve_lib.main(["--arch", NAME, "--preset", "tiny", "--device", "cpu", "--batch", "2",
                    "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"{NAME}-reduced: decoded 2x11 tokens" in out and "[serve] first sequence" in out


def test_gqa_cross_decode_matches_jax():
    jc, tc, jp, tp = carried(NAME, "float32")
    jx = jax.tree.map(lambda t: t[0], jp["groups"]["dec"]["xattn"])
    tx = {k: v[0] for k, v in tp["groups"]["dec"]["xattn"].items()}
    rng = np.random.default_rng(6)
    kv = {k: rng.normal(size=(B, tc.frontend_tokens, tc.n_kv_heads, tc.head_dim_))
          .astype(np.float32) for k in ("k", "v")}
    x = rng.normal(size=(B, 1, tc.d_model)).astype(np.float32)
    want = jattn.gqa_cross_decode(jx, jax.tree.map(jnp.asarray, kv), jnp.asarray(x))
    with torch.no_grad():
        got = attn.gqa_cross_decode(tx, {k: torch.from_numpy(v) for k, v in kv.items()},
                                    torch.from_numpy(x))
    gap = rel(got.numpy(), want)
    print(f"gqa_cross_decode over {tc.frontend_tokens} encoder positions: {gap:.3e} of max")
    assert got.shape == (B, 1, tc.d_model) and gap <= 1e-5
