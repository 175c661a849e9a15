"""Port parity: DeepSeek-V2's multi-head latent attention against the JAX
package.

On numpy-drawn weights (``torch_zoo_carry.draw``: the up-projections at
variance 1 / rank) and inputs, with and without the low-rank query path:

* ``mla_attention`` (prefill and training: ``c_kv`` expanded to per-head
  K/V, ``blockwise_attention`` at qk width 48 and v width 32, KV chunks of
  16 with a padded last chunk) within 1e-5 of max |y| in float32 and the
  reference's 2e-2 in bfloat16;
* the absorbed ``mla_decode`` over teacher-forced positions (its caches
  ``c`` / ``kr`` updated in place) within 1e-5 of max |y| of JAX's, and of
  the port's own ``mla_attention`` on the same tokens (the absorbed
  product reassociates the expanded one).

``pytest -s`` prints the gaps.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_zoo_carry import draw, one_torch_thread, rel  # noqa: E402, F401

from repro.nn import attention as jattn  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402

D, H, RANK, NOPE, ROPE, V = 64, 4, 32, 32, 16, 32
B, S, CHUNK, THETA = 2, 24, 16, 1e4


def _case(q_lora, dtype, seed=0):
    tmpl = jattn.mla_template(D, H, kv_lora=RANK, q_lora=q_lora, qk_nope=NOPE,
                              qk_rope=ROPE, v_head=V, dtype=jnp.dtype(dtype))
    jp = draw({"attn": tmpl}, seed)["attn"]
    x = np.random.default_rng(seed + 1).normal(size=(B, S, D)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), jx, \
        params_from_numpy(np.asarray(jx), "cpu")


@functools.lru_cache(maxsize=None)
def _j_mla():
    return jax.jit(lambda p, x: jattn.mla_attention(
        p, x, jnp.arange(S), qk_nope=NOPE, qk_rope=ROPE, rope_theta=THETA, chunk=CHUNK))


def _t_mla(tp, tx):
    with torch.no_grad():
        return attn.mla_attention(tp, tx, torch.arange(S), qk_nope=NOPE, qk_rope=ROPE,
                                  rope_theta=THETA, chunk=CHUNK)


CASES = [(32, "float32", 1e-5), (0, "float32", 1e-5), (32, "bfloat16", 2e-2)]


@pytest.mark.parametrize("q_lora,dtype,tol", CASES)
def test_mla_attention_matches_jax(q_lora, dtype, tol):
    jp, tp, jx, tx = _case(q_lora, dtype)
    assert ("wdq" in tp) == bool(q_lora) and ("wq" in tp) != bool(q_lora)
    want = _j_mla()(jp, jx)
    got = _t_mla(tp, tx)
    assert got.shape == (B, S, D) and got.dtype == tx.dtype
    gap = rel(got.float().numpy(), want)
    print(f"mla_attention q_lora={q_lora} {dtype}: max |y diff| / max |y| {gap:.3e} "
          f"(tol {tol:g})")
    assert gap <= tol


def _decode(fn, params, x, cache, n):
    outs = []
    for t in range(n):
        y, cache = fn(params, cache, x[:, t:t + 1], t)
        outs.append(np.asarray(y, np.float32) if not isinstance(y, torch.Tensor)
                    else y.float().numpy())
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("q_lora", [32, 0])
def test_mla_decode_matches_jax_and_the_expanded_form(q_lora):
    jp, tp, jx, tx = _case(q_lora, "float32", seed=2)
    n = 8
    j_step = jax.jit(lambda p, c, x, i: jattn.mla_decode(
        p, c, x, i, qk_nope=NOPE, qk_rope=ROPE, rope_theta=THETA))
    want, jcache = _decode(lambda p, c, x, i: j_step(p, c, x, jnp.int32(i)), jp, jx,
                           jattn.mla_init_cache(B, n, RANK, ROPE), n)
    tcache = attn.mla_init_cache(B, n, RANK, ROPE, device="cpu")
    with torch.no_grad():
        got, tcache2 = _decode(lambda p, c, x, i: attn.mla_decode(
            p, c, x, i, qk_nope=NOPE, qk_rope=ROPE, rope_theta=THETA), tp, tx, tcache, n)
    assert tcache2 is tcache
    gap = rel(got, want)
    cache_gap = max(rel(tcache[k].numpy(), jcache[k]) for k in ("c", "kr"))
    expanded = _t_mla(tp, tx)[:, :n].numpy()
    own_gap = rel(got, expanded)
    print(f"mla_decode q_lora={q_lora}, {n} positions: vs JAX {gap:.3e}, caches "
          f"{cache_gap:.3e}; vs the port's mla_attention {own_gap:.3e} (tol 1e-5)")
    assert gap <= 1e-5 and cache_gap <= 1e-6 and own_gap <= 1e-5
