"""Port parity: the model zoo's serving path (gemma3-1b, rwkv6-1.6b,
reduced) against the JAX package on carried weights.

Weights are drawn with numpy from a seed for every leaf of the reference's
template, the zero-initialised ones too (``u``, ``mu_*``, ``w0``, norm
biases), so the bonus and token-shift terms are live.  Matrices have
variance 1 / (contraction size).  The template's own ``scaled`` init reads
the head axis of the ``(d, heads, hd)`` attention projections as their
fan-in (std 0.5 at 4 heads), which makes the reduced gemma's attention
nearly one-hot and its forward ill-conditioned: summation order alone
moves its logits by more than 1e-5 (the JAX package's own jitted and
eager forwards disagree), so no port could be held to 1e-5 there.  The
weights go to JAX as arrays of the template's dtype and to the port with
``params_from_numpy`` (bfloat16 bit for bit).  Checked: the template tree and ``param_count``;
``forward`` logits at float32 within 1e-5 of max |logit| (rwkv6 at s = 128
within 1e-4: JAX takes its chunked matmul form there, which rounds
differently; gemma3 also at the ragged prefill lengths 130, 200 and 320)
and at bfloat16 within the reference's 2e-2; the loss;
``decode_step`` over 8 teacher-forced tokens against JAX's; the port's
decode against its own forward at the reference's 5e-2; the ``serve``
loop's greedy tokens against the JAX loop's.  ``pytest -s`` prints the
gaps.
"""

import dataclasses
import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.synthetic import lm_batches as j_lm_batches  # noqa: E402
from repro.data.synthetic import make_lm_tokens as j_make_lm_tokens  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.configs import ArchConfig, get_config  # noqa: E402
from repro_torch.data import lm_batches, make_lm_tokens  # noqa: E402
from repro_torch.launch.serve import make_prompt, serve  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import ParamDef, params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ["gemma3-1b", "rwkv6-1.6b"]
B = 2


def _configs(name, **changes):
    jc = dataclasses.replace(j_get_config(name + "-reduced"), **changes)
    tc = dataclasses.replace(get_config(name + "-reduced"), **changes)
    return jc, tc


def _leaf_value(rng, path, pd):
    """A draw for every leaf, zero-initialised ones included."""
    name = str(getattr(path[-1], "key", path[-1]))
    if pd.init == "ones":
        return 1.0 + 0.1 * rng.normal(size=pd.shape)
    if pd.init == "zeros":
        if name.startswith("mu_"):
            return rng.uniform(0.0, 1.0, size=pd.shape)
        if name == "w0":
            return rng.normal(-0.5, 0.3, size=pd.shape)
        return 0.3 * rng.normal(size=pd.shape)             # u, norm biases
    if pd.init == "normal":
        return 0.02 * rng.normal(size=pd.shape)
    if pd.init == "embed":
        return 0.05 * rng.normal(size=pd.shape)
    # variance 1 / (contraction size): the attention projections contract
    # over d (wq/wk/wv, (..., d, heads, hd)) or heads x hd (wo, (..., heads,
    # hd, d)); the leading axes are the layer stacks
    fan_in = pd.shape[-2]
    if str(getattr(path[-2], "key", "")) == "attn":
        fan_in = pd.shape[-3] * (pd.shape[-2] if name == "wo" else 1)
    return pd.scale / math.sqrt(fan_in) * rng.normal(size=pd.shape)


@functools.lru_cache(maxsize=None)
def _carried(name, n_layers=2, param_dtype="bfloat16", seed=0, attn_kind=None):
    changes = {} if attn_kind is None else {"attn_kind": attn_kind}
    jc, tc = _configs(name, n_layers=n_layers, param_dtype=param_dtype, **changes)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        jt.model_template(jc), is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(_leaf_value(rng, path, pd).astype(np.float32), pd.dtype)
              for path, pd in flat]
    jp = jax.tree.unflatten(treedef, leaves)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _tokens(cfg, s, seed=1, b=B):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def _j_forward(jc):
    return jax.jit(lambda p, x: jt.forward(jc, p, {"inputs": x})[0])


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_template_tree_and_param_count_match(name, reduced):
    jc = j_get_config(name + ("-reduced" if reduced else ""))
    tc = get_config(name + ("-reduced" if reduced else ""))
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jt.model_template(jc), is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    tleaves = tree_leaves(tt.model_template(tc))
    assert len(jflat) == len(tleaves)
    for (path, jd), td in zip(jflat, tleaves):
        assert isinstance(td, ParamDef)
        assert (td.shape, td.axes, td.init, td.scale) == (jd.shape, jd.axes, jd.init,
                                                          jd.scale), path
        assert str(td.dtype).removeprefix("torch.") == jnp.dtype(jd.dtype).name, path
    assert tc.param_count() == jc.param_count()
    assert tc.layer_is_global(5) == jc.layer_is_global(5)
    assert tc.head_dim_ == jc.head_dim_


FORWARD_CASES = [   # name, n_layers, dtype, s, tolerance (relative to max |logit|)
    ("gemma3-1b", 2, "float32", 32, 1e-5),
    ("gemma3-1b", 3, "float32", 32, 1e-5),      # a tail group (lg_tail)
    ("gemma3-1b", 2, "bfloat16", 32, 2e-2),
    ("rwkv6-1.6b", 2, "float32", 32, 1e-5),
    ("rwkv6-1.6b", 2, "float32", 128, 1e-4),    # JAX: the chunked WKV form
    ("rwkv6-1.6b", 2, "bfloat16", 32, 2e-2),
    # one plain dense stack: every layer global, or every layer in the window
    ("gemma3-1b:full", 2, "float32", 32, 1e-5),
    ("gemma3-1b:swa", 2, "float32", 32, 1e-5),
    # ragged prefill lengths (above 128, not a multiple of it): JAX takes
    # banded_attention (window 8 < s) and blockwise_attention (padded KV)
    ("gemma3-1b", 2, "float32", 130, 1e-5),
    ("gemma3-1b", 2, "float32", 200, 1e-5),
    ("gemma3-1b", 2, "float32", 320, 1e-5),
    ("gemma3-1b", 2, "bfloat16", 200, 2e-2),
]


@pytest.mark.parametrize("name,n_layers,dtype,s,tol", FORWARD_CASES)
def test_forward_matches_jax(name, n_layers, dtype, s, tol):
    name, _, attn_kind = name.partition(":")
    jc, tc, jp, tp = _carried(name, n_layers, dtype, attn_kind=attn_kind or None)
    if attn_kind:
        assert [g[0] for g in tt.layer_groups(tc)] == ["dense"]
    x = _tokens(jc, s)
    want = _j_forward(jc)(jp, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tt.forward(tc, tp, {"inputs": torch.from_numpy(x)})
    assert got.shape == (B, s, jc.vocab_size) and got.dtype == tc.dtype
    assert float(aux["moe_aux"]) == 0.0
    rel = _rel(got.float().numpy(), want)
    print(f"forward {name} {attn_kind or jc.attn_kind} {n_layers}L {dtype} s={s}: "
          f"max |logit diff| / max "
          f"|logit| = {rel:.3e} (tol {tol:g})")
    assert rel <= tol


def test_groups_of_the_three_layer_gemma():
    jc, tc, _, tp = _carried("gemma3-1b", 3, "float32")
    assert [g[:2] for g in tt.layer_groups(tc)] == [g[:2] for g in jt.layer_groups(jc)] \
        == [("lg_super", 1), ("lg_tail", 1)]
    assert sorted(tp["groups"]) == ["lg_super", "lg_tail"]


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches_jax(name):
    jc, tc, jp, tp = _carried(name, 2, "float32")
    x, y = _tokens(jc, 16, seed=2), _tokens(jc, 16, seed=3)
    mask = (np.arange(16)[None] < np.array([[16], [9]])).astype(np.float32)
    for m in (None, mask):
        batch = {"inputs": x, "targets": y}
        if m is not None:
            batch["mask"] = m
        want, _ = jt.loss_fn(jc, jp, jax.tree.map(jnp.asarray, batch))
        with torch.no_grad():
            got, metrics = tt.loss_fn(tc, tp, {k: torch.from_numpy(v)
                                               for k, v in batch.items()})
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        assert float(metrics["ce"]) == float(got)


def test_lm_token_streams_are_identical():
    a, b = make_lm_tokens(4096, vocab=300, seed=4), j_make_lm_tokens(4096, vocab=300, seed=4)
    np.testing.assert_array_equal(a, b)
    for got, want, _ in zip(lm_batches(a, 3, 17, seed=5), j_lm_batches(b, 3, 17, seed=5),
                            range(3)):
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(got[key], want[key])


def test_registry_holds_the_ported_archs_only():
    """Every config of the JAX package's registry is registered in the port
    under its name (and its ``-reduced`` form); an unknown name raises
    ``KeyError``, and a family the zoo has no model for (mamba outside the
    hybrid family, an unknown frontend) raises at its template."""
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro_torch.configs import ARCH_CONFIGS, list_archs
    assert sorted(ARCH_CONFIGS) == list_archs() == sorted(J_ARCHS)
    assert len(ARCH_CONFIGS) == 10
    for name in J_ARCHS:
        assert get_config(name).name == name
        assert get_config(name + "-reduced").n_layers == 2
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")
    moe = ArchConfig(name="moe", family="moe", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab_size=64, n_experts=4, top_k=2,
                     d_ff_expert=32)
    assert "moe" in tt.model_template(moe)["groups"]
    hybrid = dataclasses.replace(moe, family="hybrid", n_experts=0, hybrid=True,
                                 ssm_kind="mamba", ssm_state=4)
    assert list(tt.model_template(hybrid)["groups"]) == ["hymba"]
    for bad in (dataclasses.replace(hybrid, hybrid=False),
                dataclasses.replace(moe, modality="video")):
        with pytest.raises(ValueError, match="zoo"):
            tt.model_template(bad)


def _j_decode_logits(jc, jp, toks):
    step = jax.jit(lambda p, c, t, i: jt.decode_step(jc, p, c, t, i))
    cache = jt.init_cache(jc, toks.shape[0], toks.shape[1])
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        outs.append(np.asarray(logits, np.float32))
    return np.stack(outs, axis=1)


def _t_decode_logits(tc, tp, toks):
    cache = tt.init_cache(tc, toks.shape[0], toks.shape[1], device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, cache = tt.decode_step(tc, tp, cache,
                                           torch.from_numpy(toks[:, t:t + 1]), t)
            outs.append(logits.float().numpy())
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_jax(name):
    jc, tc, jp, tp = _carried(name, 2, "float32")
    toks = _tokens(jc, 8, seed=6)
    jcache, tcache = jt.init_cache(jc, B, 8), tt.init_cache(tc, B, 8, device="cpu")
    assert [tuple(x.shape) for x in jax.tree.leaves(jcache)] == \
        [tuple(t.shape) for t in tree_leaves(tcache)]
    rel = _rel(_t_decode_logits(tc, tp, toks), _j_decode_logits(jc, jp, toks))
    print(f"decode_step {name} f32, 8 teacher-forced tokens: max |logit diff| / "
          f"max |logit| = {rel:.3e} (tol 1e-5)")
    assert rel <= 1e-5


@pytest.mark.parametrize("name", ARCHS)
def test_port_decode_matches_its_own_forward(name):
    """The reference's own check (tests/test_models.py), on the port: bf16."""
    _, tc, _, tp = _carried(name, 2, "bfloat16")
    toks = _tokens(tc, 16, seed=7)
    with torch.no_grad():
        fwd, _ = tt.forward(tc, tp, {"inputs": torch.from_numpy(toks)})
    rel = _rel(_t_decode_logits(tc, tp, toks), fwd.float().numpy())
    print(f"port decode vs port forward {name} bf16, 16 tokens: {rel:.3e} (tol 5e-2)")
    assert rel < 5e-2


def _j_serve(jc, jp, prompt, new_tokens):
    """The reference's serve loop (``repro.launch.serve.main``) on given
    weights and prompt."""
    step = jax.jit(lambda p, c, t, i: jt.decode_step(jc, p, c, t, i))
    batch, prompt_len = prompt.shape
    max_len = prompt_len + new_tokens
    cache = jt.init_cache(jc, batch, max_len)
    tok = jnp.asarray(prompt[:, :1], jnp.int32)
    out = [np.asarray(tok)]
    for i in range(max_len - 1):
        logits, cache = step(jp, cache, tok, jnp.int32(i))
        if i + 1 < prompt_len:
            tok = jnp.asarray(prompt[:, i + 1: i + 2], jnp.int32)
        else:
            tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_greedy_tokens_match_jax(name):
    jc, tc, jp, tp = _carried(name, 2, "float32")
    prompt = make_prompt(tc, 3, 5, seed=8)
    got, stats = serve(tc, tp, prompt, 7, device="cpu")
    want = _j_serve(jc, jp, prompt, 7)
    print(f"serve {name} f32: port tokens {got[0].tolist()}, JAX {want[0].tolist()}")
    assert got.shape == (3, 12) and stats["decode_steps"] == 11
    np.testing.assert_array_equal(got[:, :5], prompt)
    np.testing.assert_array_equal(got, want)


def test_serve_reports_the_references_rate():
    """``tokens_per_s`` is the reference loop's figure, batch x max_len
    over the loop's seconds; ``decode_tokens_per_s`` counts the max_len - 1
    tokens per sequence that went through ``decode_step``."""
    _, tc, _, tp = _carried("rwkv6-1.6b", 2, "float32")
    batch, prompt_len, new_tokens = 3, 5, 4
    prompt = make_prompt(tc, batch, prompt_len, seed=9)
    _, stats = serve(tc, tp, prompt, new_tokens, device="cpu")
    max_len = prompt_len + new_tokens
    assert stats["decode_steps"] == max_len - 1
    assert stats["tokens_per_s"] * stats["seconds"] == pytest.approx(batch * max_len, rel=1e-9)
    assert stats["decode_tokens_per_s"] * stats["seconds"] == pytest.approx(
        batch * (max_len - 1), rel=1e-9)


def _serve_cli(*args):
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=str(root))


def test_serve_cli_on_the_cpu():
    out = _serve_cli("--arch", "rwkv6-1.6b", "--preset", "tiny", "--device", "cpu",
                     "--batch", "2", "--new-tokens", "4")
    assert out.returncode == 0, out.stderr
    assert "rwkv6-1.6b-reduced: decoded 2x12 tokens" in out.stdout
    assert " tok/s, " in out.stdout and " decode tok/s on CPU" in out.stdout
    if not torch.cuda.is_available():          # the default device is the card
        out = _serve_cli("--arch", "gemma3-1b")
        assert out.returncode != 0 and "CUDA is not available" in out.stderr
