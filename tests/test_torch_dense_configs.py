"""Port parity: the model zoo's other dense configs (h2o-danube-3-4b,
granite-3-8b, starcoder2-7b) against the JAX package, and the flash
attention's plain version at h2o-danube's head dim of 120.

* The configs: every field the port's ``ArchConfig`` has equals the
  reference's (``source`` included), the template trees and parameter
  counts are the reference's, reduced and at published size; so too for
  internvl2-2b, kimi-k2-1t-a32b, deepseek-v2-236b, hymba-1.5b and
  seamless-m4t-medium (their published sizes also against the counts the
  JAX package gives: 1,891,244,032, 1,028,298,994,688, 235,741,312,000,
  1,474,872,000 and 878,204,928; hymba's and seamless's reduced sizes
  2,125,056 and 2,905,600).
* The forward: reduced, on weights drawn with numpy for every leaf of the
  reference's template (``test_torch_lm_models._leaf_value``: matrices at
  variance 1 / (contraction size)), the JAX and the port's ``forward``
  logits within 1e-5 of max |logit| in float32 (bfloat16 within the
  reference's 2e-2).  h2o-danube is a sliding-window stack (reduced, a
  window of 8 below the 32 tokens: JAX takes ``banded_attention``),
  granite global attention with tied embeddings, starcoder2 LayerNorm and
  a plain GELU MLP.  One reduced h2o variant keeps the published head dim,
  120.
* Flash attention at D = 120: the port's ``flash_attention`` on CPU
  tensors (its plain version) against the Pallas kernel in interpret mode,
  at the reference's ``tol_for`` (2e-5 float32, 2e-2 bfloat16, abs and
  rel), causal with GQA 4:1 and with a window.

``pytest -s`` prints the gaps.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_lm_models import _leaf_value  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import ParamDef, params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ["h2o-danube-3-4b", "granite-3-8b", "starcoder2-7b"]
# the MoE / MLA / VLM / hybrid / encoder-decoder configs (their forwards:
# test_torch_moe.py, test_torch_vlm.py, test_torch_hymba.py, test_torch_seamless.py)
CONFIG_ARCHS = ARCHS + ["internvl2-2b", "kimi-k2-1t-a32b", "deepseek-v2-236b",
                        "hymba-1.5b", "seamless-m4t-medium"]
PUBLISHED = {"internvl2-2b": 1_891_244_032, "kimi-k2-1t-a32b": 1_028_298_994_688,
             "deepseek-v2-236b": 235_741_312_000, "hymba-1.5b": 1_474_872_000,
             "seamless-m4t-medium": 878_204_928}
REDUCED = {"hymba-1.5b": 2_125_056, "seamless-m4t-medium": 2_905_600}
B, S = 2, 32


@pytest.mark.parametrize("name", CONFIG_ARCHS)
def test_config_fields_are_the_references(name):
    jc, tc = j_get_config(name), get_config(name)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.head_dim_ == jc.head_dim_


@pytest.mark.parametrize("name", CONFIG_ARCHS)
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
    if not reduced and name in PUBLISHED:
        assert tc.param_count() == PUBLISHED[name]
    if reduced and name in REDUCED:
        assert tc.param_count() == REDUCED[name]


def _carried(name, param_dtype, **changes):
    """The reduced configs (with ``changes``) and weights drawn for every
    leaf: JAX arrays of the template's dtype, and the same values as port
    tensors (bfloat16 bit for bit)."""
    jc = dataclasses.replace(j_get_config(name + "-reduced"),
                             param_dtype=param_dtype, **changes)
    tc = dataclasses.replace(get_config(name + "-reduced"),
                             param_dtype=param_dtype, **changes)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        jt.model_template(jc), is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    rng = np.random.default_rng(len(name))
    jp = jax.tree.unflatten(treedef, [
        jnp.asarray(_leaf_value(rng, path, pd).astype(np.float32), pd.dtype)
        for path, pd in flat])
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


FORWARD_CASES = [(name, {}, "float32", 1e-5) for name in ARCHS] + [
    ("h2o-danube-3-4b", {"head_dim": 120}, "float32", 1e-5),
    ("h2o-danube-3-4b", {"head_dim": 120}, "bfloat16", 2e-2),
]


@pytest.mark.parametrize(
    "name,changes,dtype,tol", FORWARD_CASES,
    ids=[f"{c[0]}{'-hd120' if c[1] else ''}-{c[2]}" for c in FORWARD_CASES])
def test_forward_matches_jax(name, changes, dtype, tol):
    jc, tc, jp, tp = _carried(name, dtype, **changes)
    assert tc.head_dim_ == changes.get("head_dim", 64)
    x = np.random.default_rng(1).integers(1, jc.vocab_size, (B, S)).astype(np.int32)
    want = jax.jit(lambda p, t: jt.forward(jc, p, {"inputs": t})[0])(jp, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tt.forward(tc, tp, {"inputs": torch.from_numpy(x)})
    assert got.shape == (B, S, jc.vocab_size) and got.dtype == tc.dtype
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    rel = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))
    print(f"forward {name} {changes or ''} {dtype}: max |logit diff| / max "
          f"|logit| = {rel:.3e} (tol {tol:g})")
    assert rel <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_plain_version_at_head_dim_120_matches_pallas(dtype, window):
    b, h, kv, s, d = 1, 8, 2, 256, 120
    rng = np.random.default_rng(120)
    jx = [jnp.asarray(rng.normal(size=sh).astype(np.float32), dtype)
          for sh in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]
    tx = [params_from_numpy(np.asarray(x), "cpu") for x in jx]
    want = j_flash(*jx, causal=True, window=window, block_q=64, block_k=64,
                   interpret=True)
    got = fa.flash_attention(*tx, causal=True, window=window)
    assert got.shape == (b, h, s, d) and fa.flash_attention.launches == 0
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    print(f"flash D=120 {dtype} window={window}: port plain vs Pallas interpret "
          f"{float(np.max(np.abs(got - want))):.3e}")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
