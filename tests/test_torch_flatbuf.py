"""Port parity: flat-buffer packing is bitwise equal to the JAX package's.

Same leaves, same order (JAX's sorted dict keys: ``h10`` before ``h2``),
same dtype buckets, offsets and tail padding, so the packed buffers must
be equal bit for bit (tolerance 0) and the slot metadata identical.
"""

import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import flatbuf as jfb  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.core import flatbuf as tfb  # noqa: E402
from repro_torch.nn.param import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_flatten, tree_flatten_with_path, tree_leaves, tree_unflatten)


def _bits(x) -> np.ndarray:
    """Raw bit pattern of a JAX array or a tensor, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view(torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _mlp(depth=12):
    t = jpm.mlp_classifier_template(16, 10, width=8, depth=depth)
    return jinit(t, jax.random.PRNGKey(1))


def _cnn():
    return jinit(jpm.cnn_classifier_template(8, 3, 10), jax.random.PRNGKey(2))


def _mixed():
    rng = np.random.default_rng(3)
    return {
        "emb": jnp.asarray(rng.normal(size=(7, 5)), jnp.bfloat16),
        "gain": jnp.asarray(rng.normal(size=(5,)), jnp.float32),
        "blocks": [
            {"w": jnp.asarray(rng.normal(size=(5, 9)), jnp.bfloat16),
             "b": jnp.asarray(rng.normal(size=(9,)), jnp.float32)},
            {"w": jnp.asarray(rng.normal(size=(9, 3)), jnp.bfloat16),
             "b": jnp.asarray(rng.normal(size=(3,)), jnp.float32)},
        ],
        "aligned": jnp.asarray(rng.normal(size=(2, 128)), jnp.float32),
    }


def _stack(tree, n):
    rng = np.random.default_rng(9)
    return jax.tree.map(
        lambda x: (x[None] + jnp.asarray(rng.normal(size=(n,) + x.shape), x.dtype)
                   ).astype(x.dtype), tree)


def _assert_same_spec(js, ts):
    assert js.n_leaves == ts.n_leaves and js.lead == ts.lead
    assert len(js.buckets) == len(ts.buckets)
    for jb, tb in zip(js.buckets, ts.buckets):
        assert jnp.dtype(jb.dtype).name == str(tb.dtype).replace("torch.", "")
        assert jb.rows == tb.rows and jb.n_real == tb.n_real
        assert jb.bytes == tb.bytes
        assert [(s.index, s.shape, s.size, s.offset) for s in jb.slots] == \
            [(s.index, s.shape, s.size, s.offset) for s in tb.slots]
    for exch in jfb.EXCHANGE_DTYPES:
        assert js.exchange_bytes(exch) == ts.exchange_bytes(exch)


@pytest.mark.parametrize("make", [_mlp, _cnn, _mixed], ids=["mlp", "cnn", "mixed"])
@pytest.mark.parametrize("lead", [0, 1])
def test_pack_bitwise_equal_and_same_slots(make, lead):
    tree = make()
    if lead:
        tree = _stack(tree, 5)
    ttree = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    js = jfb.make_flat_spec(tree, lead=lead)
    ts = tfb.make_flat_spec(ttree, lead=lead)
    _assert_same_spec(js, ts)
    jbufs = jfb.pack(tree, js)
    tbufs = tfb.pack(ttree, ts)
    assert len(jbufs) == len(tbufs)
    for jb, tb in zip(jbufs, tbufs):
        assert tuple(jb.shape) == tuple(tb.shape)
        np.testing.assert_array_equal(_bits(jb), _bits(tb))      # bitwise
    back = tfb.unpack(tbufs, ts)
    for a, b in zip(tree_leaves(ttree), tree_leaves(back)):
        assert torch.equal(a, b)


def test_leaf_order_is_jax_order():
    tree = _mlp(depth=12)
    ttree = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths.index("['h10']['b']") < paths.index("['h2']['b']")
    for a, b in zip(jax.tree.leaves(tree), tree_flatten(ttree)[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pack_rejects_wrong_structure_and_shape():
    ttree = params_from_numpy(jax.tree.map(np.asarray, _mlp(depth=2)), "cpu")
    spec = tfb.make_flat_spec(ttree)
    with pytest.raises(ValueError, match="structure"):
        tfb.pack({"h0": ttree["h0"]}, spec)
    bad = dict(ttree, out={"w": torch.zeros(3, 3), "b": ttree["out"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        tfb.pack(bad, spec)
    with pytest.raises(ValueError, match="buckets"):
        tfb.unpack([], spec)


def test_unpack_returns_views_and_carry_over_round_trips():
    tree = _stack(_mixed(), 3)
    ttree = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    spec = tfb.make_flat_spec(ttree, lead=1)
    bufs = tfb.pack(ttree, spec)
    back = tfb.unpack(bufs, spec)
    spans = [(b.data_ptr(), b.data_ptr() + b.numel() * b.element_size())
             for b in bufs]
    for leaf in tree_leaves(back):          # views into the packed buffers
        assert any(p <= leaf.data_ptr() < e for p, e in spans)
    host = params_to_numpy(back)
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(host)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("walk", [
    lambda t: tree_flatten(t)[0],
    lambda t: tree_unflatten(tree_flatten(t)[1], tree_flatten(t)[0]),
    tree_flatten_with_path,
], ids=["flatten", "unflatten", "with_path"])
def test_tree_walks_free_their_leaves_by_refcount(walk):
    """A walk holds no reference to its leaves once its result is dropped,
    with the cyclic collector off: a recursive closure over its own name
    and its accumulator is a reference cycle that kept a step's parameter
    views, and so whole buckets, alive until the collector ran."""
    tree = {"b": [torch.ones(3), {"c": torch.zeros(2)}],
            "a": (torch.ones(1), None)}
    refs = [weakref.ref(x) for x in tree_leaves(tree)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = walk(tree)
        assert out
        del out, tree
        assert [r() for r in refs] == [None] * 3
    finally:
        if enabled:
            gc.enable()
