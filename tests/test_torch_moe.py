"""Port parity: the MoE layer and the MoE configs (kimi-k2-1t-a32b with GQA,
deepseek-v2-236b with MLA, reduced) against the JAX package.

* ``moe.slots`` equals the reference's exclusive cumsum of a one-hot.
* ``moe_apply``: output and load-balance term against the reference's on
  the same numpy-drawn weights and inputs, float32 within 1e-6 (abs) and
  bfloat16 within 2e-2 (of max |y|), also at a capacity that drops pairs
  (asserted to drop) and on tied router probabilities (a zero router:
  every expert ties, and both packages pick the lowest indices).  At the
  other shapes no two of a token's top ``k + 1`` probabilities tie
  (asserted), so the routing is the same function whatever the order of
  ties.
* The reduced configs (``torch_zoo_carry.carried`` weights), in float32:
  ``forward`` logits within 1e-5 of max |logit|, ``moe_aux`` within 1e-5
  (relative); ``loss_fn``'s total, ``ce`` and ``moe_aux`` within 1e-5
  (relative); ``decode_step`` over 6 teacher-forced positions within 1e-5
  of max |logit|, the MLA cache in its ``(c, kr)`` layout.  bfloat16 is
  held at the layer (``moe_apply`` above), not through the model: with 4
  experts and top-2 a token's 2nd and 3rd router probabilities come within
  bf16's rounding of the layer's input (a margin of 0.0022 in the reduced
  deepseek-v2), and there 31 of 32 tokens route alike in bf16 and the one
  flipped route moves the logits by 0.15 of max |logit| (measured): a
  discrete change, not a drift.

JAX functions are jitted once per module (an uncompiled reduced MoE
forward takes seconds here).  ``pytest -s`` prints the gaps.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_zoo_carry import carried, draw, one_torch_thread, rel  # noqa: E402, F401

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ["kimi-k2-1t-a32b", "deepseek-v2-236b"]
D, FF, E, K = 32, 16, 4, 2
B, S = 2, 16


def _moe_case(dtype, seed, n_shared=1, router_scale=1.0):
    tmpl = jmoe.moe_template(D, FF, E, n_shared=n_shared, dtype=jnp.dtype(dtype))
    jp = draw(tmpl, seed)
    jp["router"] = jp["router"] * router_scale
    rng = np.random.default_rng(seed + 100)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), jx, \
        params_from_numpy(np.asarray(jx), "cpu")


@functools.lru_cache(maxsize=None)
def _j_moe(factor):
    return jax.jit(lambda p, x: jmoe.moe_apply(p, x, top_k=K, capacity_factor=factor))


def _drops(tp, tx, factor) -> int:
    """Pairs past their expert's capacity, counted from the port's routing."""
    t = B * S
    _, _, idx = moe.route(tp["router"], tx.reshape(t, D), K)
    counts = np.bincount(idx.reshape(-1).numpy(), minlength=E)
    return int(np.maximum(counts - moe.capacity(t, K, E, factor), 0).sum())


def _top_ties(tp, tx) -> int:
    probs, _, _ = moe.route(tp["router"], tx.reshape(B * S, D).float(), K)
    top = torch.sort(probs, dim=-1, descending=True).values[:, :K + 1]
    return int((top[:, 1:] == top[:, :-1]).sum())


MOE_CASES = [   # dtype, capacity factor, tolerance, drops expected
    ("float32", 1.25, 1e-6, False),
    ("float32", 0.5, 1e-6, True),
    ("bfloat16", 1.25, 2e-2, False),
    ("bfloat16", 0.5, 2e-2, True),
]


@pytest.mark.parametrize("dtype,factor,tol,drops", MOE_CASES)
def test_moe_apply_matches_jax(dtype, factor, tol, drops):
    jp, tp, jx, tx = _moe_case(dtype, seed=3)
    want_y, want_aux = _j_moe(factor)(jp, jx)
    with torch.no_grad():
        got_y, got_aux = moe.moe_apply(tp, tx, top_k=K, capacity_factor=factor)
    n_drop, ties = _drops(tp, tx, factor), _top_ties(tp, tx)
    assert (n_drop > 0) == drops and ties == 0
    assert got_y.shape == (B, S, D) and got_y.dtype == tx.dtype
    y_gap = float(np.max(np.abs(got_y.float().numpy() - np.asarray(want_y, np.float32))))
    aux_gap = abs(float(got_aux) - float(want_aux))
    top = float(np.max(np.abs(np.asarray(want_y, np.float32))))
    print(f"moe_apply {dtype} capacity factor {factor}: {n_drop} of {B * S * K} pairs "
          f"dropped, ties among the top {K + 1} probabilities: {ties}; max |y diff| "
          f"{y_gap:.3e} (max |y| {top:.3f}), aux {float(got_aux):.6f} vs "
          f"{float(want_aux):.6f}")
    bound = tol if dtype == "float32" else tol * top
    assert y_gap <= bound and aux_gap <= 1e-6


def test_moe_tied_router_picks_the_lowest_experts():
    jp, tp, jx, tx = _moe_case("float32", seed=4, router_scale=0.0)
    _, _, idx = moe.route(tp["router"], tx.reshape(B * S, D), K)
    assert (idx == torch.arange(K)).all()
    want_y, want_aux = _j_moe(1.25)(jp, jx)
    with torch.no_grad():
        got_y, got_aux = moe.moe_apply(tp, tx, top_k=K)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("n,e", [(64, 4), (1000, 7), (4096, 384)])
def test_slots_are_the_exclusive_cumsum(n, e):
    """``moe.slots`` (a stable sort by expert) gives the reference's
    ``(cumsum(onehot) - onehot)[i, expert_i]``, also under ``vmap``."""
    rng = np.random.default_rng(n)
    experts = rng.integers(0, e, size=(3, n))
    experts[1] = 0                                       # one expert takes all
    onehot = np.eye(e, dtype=np.int64)[experts]
    want = np.take_along_axis(np.cumsum(onehot, axis=1) - onehot,
                              experts[..., None], axis=2)[..., 0]
    t = torch.from_numpy(experts)
    np.testing.assert_array_equal(moe.slots(t[0], e).numpy(), want[0])
    np.testing.assert_array_equal(torch.vmap(lambda x: moe.slots(x, e))(t).numpy(), want)


def test_capacity_is_the_references():
    for t, k, e, f in [(16, 2, 4, 1.25), (8192, 8, 384, 1.25), (8192, 6, 160, 1.25),
                       (1, 2, 4, 1.25), (100, 3, 7, 0.5)]:
        assert moe.capacity(t, k, e, f) == jmoe.capacity(t, k, e, f)


def _tokens(cfg, s, seed, b=B):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _j_forward(jc):
    return jax.jit(lambda p, x: jt.forward(jc, p, {"inputs": x}))


@pytest.mark.parametrize("name", ARCHS)
def test_groups_and_template_of_the_moe_configs(name):
    jc, tc, _, tp = carried(name)
    assert [g[:2] for g in tt.layer_groups(tc)] == [g[:2] for g in jt.layer_groups(jc)] \
        == [("dense", 1), ("moe", 1)]
    assert tp["groups"]["moe"]["moe"]["router"].dtype == torch.float32
    assert tc.active_param_count() == jc.active_param_count()
    full_t, full_j = get_config(name), j_get_config(name)
    assert full_t.active_param_count() == full_j.active_param_count()


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(name):
    dtype, tol = "float32", 1e-5
    jc, tc, jp, tp = carried(name, dtype)
    x = _tokens(jc, S, seed=1)
    want, jaux = _j_forward(jc)(jp, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tt.forward(tc, tp, {"inputs": torch.from_numpy(x)})
    assert got.shape == (B, S, jc.vocab_size) and got.dtype == tc.dtype
    gap = rel(got.float().numpy(), want)
    aux_gap = abs(float(aux["moe_aux"]) - float(jaux["moe_aux"]))
    print(f"forward {name} {dtype}: max |logit diff| / max |logit| {gap:.3e} (tol "
          f"{tol:g}); moe_aux {float(aux['moe_aux']):.6f} vs "
          f"{float(jaux['moe_aux']):.6f}")
    assert gap <= tol and aux_gap <= tol * abs(float(jaux["moe_aux"]))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches_jax(name):
    jc, tc, jp, tp = carried(name)
    batch = {"inputs": _tokens(jc, S, seed=2), "targets": _tokens(jc, S, seed=3)}
    want, wm = jax.jit(lambda p, b: jt.loss_fn(jc, p, b))(
        jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, gm = tt.loss_fn(tc, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    gaps = {k: abs(float(g) - float(w)) / abs(float(w)) for k, g, w in
            [("total", got, want), ("ce", gm["ce"], wm["ce"]),
             ("moe_aux", gm["moe_aux"], wm["moe_aux"])]}
    print(f"loss {name}: total {float(got):.6f} (JAX {float(want):.6f}), ce "
          f"{float(gm['ce']):.6f}, moe_aux {float(gm['moe_aux']):.6f}; relative gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert float(gm["moe_aux"]) > 0
    assert float(got) == pytest.approx(float(gm["ce"]) + tc.router_aux_weight
                                       * float(gm["moe_aux"]), rel=1e-6)
    assert all(v <= 1e-5 for v in gaps.values())


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_jax(name):
    jc, tc, jp, tp = carried(name)
    n = 6
    toks = _tokens(jc, n, seed=6)
    jcache, tcache = jt.init_cache(jc, B, n), tt.init_cache(tc, B, n, device="cpu")
    assert [tuple(x.shape) for x in jax.tree.leaves(jcache)] == \
        [tuple(t.shape) for t in tree_leaves(tcache)]
    step = jax.jit(lambda p, c, t, i: jt.decode_step(jc, p, c, t, i))
    want, got = [], []
    with torch.no_grad():
        for t in range(n):
            lj, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            lt, tcache = tt.decode_step(tc, tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
            want.append(np.asarray(lj, np.float32))
            got.append(lt.float().numpy())
    gap = rel(np.stack(got, 1), np.stack(want, 1))
    cache_gap = max(rel(t.numpy(), x) for t, x in
                    zip(tree_leaves(tcache), jax.tree.leaves(jcache)))
    print(f"decode_step {name} f32, {n} teacher-forced tokens: max |logit diff| / max "
          f"|logit| {gap:.3e}; caches {cache_gap:.3e} (tol 1e-5)")
    assert gap <= 1e-5 and cache_gap <= 1e-5


def test_moe_decode_matches_its_own_forward():
    """The reference's own check (tests/test_models.py) on the port, bf16, at
    a capacity factor of E / k: no pair is dropped in the forward.  At the
    configured 1.25 the 24-token forward drops 6 pairs of its most loaded
    expert (22 of 16 slots) and decode, one token a step, drops none: the
    logits then differ by design (0.21 of max |logit|, in float32 too)."""
    _, tc, _, tp = carried("kimi-k2-1t-a32b", "bfloat16")
    tc = dataclasses.replace(tc, capacity_factor=tc.n_experts / tc.top_k)
    toks = _tokens(tc, 12, seed=7)
    with torch.no_grad():
        fwd, _ = tt.forward(tc, tp, {"inputs": torch.from_numpy(toks)})
        cache = tt.init_cache(tc, B, 12, device="cpu")
        steps = []
        for t in range(12):
            logits, cache = tt.decode_step(tc, tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
            steps.append(logits.float().numpy())
    gap = rel(np.stack(steps, 1), fwd.float().numpy())
    print(f"port decode vs port forward kimi-k2 bf16, 12 tokens: {gap:.3e} (tol 5e-2)")
    assert gap < 5e-2


def test_moe_config_through_the_train_cli(capsys):
    """``launch.train`` on the CPU: two buckets (bf16 weights, f32 routers),
    a finite loss."""
    from repro_torch.launch import train as lm_train
    tr = lm_train.main(["--arch", "deepseek-v2-236b", "--preset", "tiny", "--device",
                        "cpu", "--agents", "2", "--steps", "2", "--batch", "1",
                        "--seq", "16", "--optimizer", "cdmsgd", "--exchange", "int8",
                        "--log-every", "0"])
    dtypes = {t.dtype for t in tree_leaves(tr.state.params)}
    assert dtypes == {torch.bfloat16, torch.float32}
    assert np.isfinite(tr.history.rows[-1]["loss"])
    assert "deepseek-v2-236b-reduced" in capsys.readouterr().out


def test_moe_dataclass_fields_reduce_as_the_reference():
    for name in ARCHS:
        jc, tc = j_get_config(name).reduced(), get_config(name).reduced()
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)
