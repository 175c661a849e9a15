"""Port parity: the paper's MLP/CNN from carried-over JAX parameters.

Logits, loss, accuracy and per-leaf gradients of the port against the JAX
package on the same parameters and inputs, at small sizes (CNN hw=8).
Tolerances: 1e-5 abs on logits/loss/grads — both sides run float32 on the
CPU, but XLA and PyTorch sum convolutions and matmuls in different orders,
so bitwise equality is not expected.  Measured gaps (printed with
``pytest -s``): logits up to 2.4e-6, gradients up to 3.6e-7.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value  # noqa: E402

from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn import param as tparam  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ATOL = 1e-5

CASES = {
    "mlp": (functools.partial(jpm.mlp_classifier_template, 12, 10, width=16, depth=11),
            functools.partial(tpm.mlp_classifier_template, 12, 10, width=16, depth=11),
            jpm.mlp_classifier_apply, tpm.mlp_classifier_apply, (12,)),
    "cnn": (functools.partial(jpm.cnn_classifier_template, 8, 3, 10),
            functools.partial(tpm.cnn_classifier_template, 8, 3, 10),
            jpm.cnn_classifier_apply, tpm.cnn_classifier_apply, (8, 8, 3)),
    "cnn_odd": (functools.partial(jpm.cnn_classifier_template, 10, 3, 10),
                functools.partial(tpm.cnn_classifier_template, 10, 3, 10),
                jpm.cnn_classifier_apply, tpm.cnn_classifier_apply, (10, 10, 3)),
}


def _setup(case, batch=16, seed=0):
    jt, tt, japply, tapply, in_shape = CASES[case]
    jp = jparam.init_params(jt(), jax.random.PRNGKey(seed))
    # non-zero biases so the bias paths are exercised too
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda x: x + jnp.asarray(
        0.05 * rng.normal(size=x.shape), x.dtype), jp)
    tp = tparam.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(batch,) + in_shape).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int32)
    return jp, tp, japply, tapply, x, y


@pytest.mark.parametrize("case", list(CASES))
def test_logits_loss_acc_match(case):
    jp, tp, japply, tapply, x, y = _setup(case)
    jl = np.asarray(jax.jit(japply)(jp, jnp.asarray(x)))
    tl = tapply(tp, torch.from_numpy(x)).numpy()
    print(f"{case}: max logit gap {np.max(np.abs(tl - jl)):.2e}")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    jloss, jm = jax.jit(functools.partial(jpm.classifier_loss, japply))(
        jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tloss, tm = tpm.classifier_loss(tapply, tp, {"x": torch.from_numpy(x),
                                                  "y": torch.from_numpy(y)})
    assert abs(float(tloss) - float(jloss)) <= ATOL
    assert float(tm["acc"]) == float(jm["acc"])


@pytest.mark.parametrize("case", list(CASES))
def test_per_leaf_grads_match(case):
    jp, tp, japply, tapply, x, y = _setup(case, seed=1)
    jg = jax.jit(jax.grad(lambda p: jpm.classifier_loss(
        japply, p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})[0]))(jp)
    tg, _ = grad_and_value(lambda p: tpm.classifier_loss(
        tapply, p, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}),
        has_aux=True)(tp)
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    print(f"{case}: max grad gap "
          f"{max(float(np.max(np.abs(b.numpy() - np.asarray(a)))) for a, b in zip(jl, tl)):.2e}")
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)


def test_cnn_full_width_template_and_param_count():
    jt = jpm.cnn_classifier_template(32, 3, 10)
    tt = tpm.cnn_classifier_template(32, 3, 10)
    assert tparam.count_params(tt) == jparam.count_params(jt) == 2_168_362
    shapes = lambda t: [tuple(l.shape) for l in tree_leaves(t)]
    assert shapes(tt) == [tuple(l.shape) for l in
                          jax.tree.leaves(jt, is_leaf=lambda d: isinstance(d, jparam.ParamDef))]


def test_init_params_seeded_and_scaled():
    t = tpm.cnn_classifier_template(8, 3, 10)
    a = tparam.init_params(t, 0)
    b = tparam.init_params(t, torch.Generator().manual_seed(0))
    c = tparam.init_params(t, 1)
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    assert not torch.equal(a["c1"]["w"], c["c1"]["w"])
    assert torch.count_nonzero(a["fc"]["b"]) == 0           # zeros init
    # conv_scaled: std = 1/sqrt(H*W*I) within sampling noise (n = 9216)
    std = float(a["c3"]["w"].std())
    assert abs(std - 1 / np.sqrt(3 * 3 * 32)) < 0.01
    with pytest.raises(ValueError, match="rank mismatch"):
        tparam.ParamDef((2, 2), (None,))
