"""Port parity: the consensus-update plain versions against the Pallas kernels.

The JAX kernels ``cdsgd_update_2d`` / ``cdmsgd_update_2d`` run in Pallas
interpret mode on the CPU (as the JAX package's own tests run them); the
port's wrappers run their plain PyTorch version on CPU tensors.  Both sum
in float32 in stencil order, so the tolerance is 1e-6 abs (a few ulp at
the unit-scale values used; XLA may still contract a multiply-add).  Both
weight forms are covered — one agent's ``(S,)`` stencil and the stacked
``(A, A)`` form — at ragged row counts (not a multiple of the Pallas block
of 256 rows).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import flatbuf as jfb  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.kernels.consensus_update import ops as jops  # noqa: E402
from repro.kernels.consensus_update.consensus_update import (  # noqa: E402
    cdmsgd_update_2d,
    cdsgd_update_2d,
)
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import flatbuf as tfb  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.optim import stacked_comm_ops  # noqa: E402
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ATOL = 1e-6
ALPHA, MU = 0.05, 0.9


def _operands(a_out, s, rows, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((a_out, s)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    x = rng.normal(size=(s, rows, 128)).astype(np.float32)
    g = rng.normal(size=(a_out, rows, 128)).astype(np.float32)
    v = rng.normal(size=(a_out, rows, 128)).astype(np.float32)
    return w, x, g, v


@pytest.mark.parametrize("rows", [3, 300])
@pytest.mark.parametrize("s", [1, 3, 5])
def test_stencil_form_matches_pallas(s, rows):
    w, x, g, v = _operands(1, s, rows, seed=s + rows)
    jo = cdsgd_update_2d(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(g[0]),
                         ALPHA, alias=False, interpret=True)
    to = tops.cdsgd_update_flat(torch.from_numpy(x), torch.from_numpy(w[0]),
                                torch.from_numpy(g[0].copy()), ALPHA)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    jp, jv = cdmsgd_update_2d(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(g[0]),
                              jnp.asarray(v[0]), ALPHA, MU, alias=False,
                              interpret=True)
    tp, tv = tops.cdmsgd_update_flat(torch.from_numpy(x), torch.from_numpy(w[0]),
                                     torch.from_numpy(g[0].copy()),
                                     torch.from_numpy(v[0].copy()), ALPHA, MU)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)


@pytest.mark.parametrize("rows", [5, 261])
@pytest.mark.parametrize("agents", [2, 5])
def test_stacked_form_matches_pallas(agents, rows):
    w, x, g, v = _operands(agents, agents, rows, seed=agents * rows)
    jo = jops.cdsgd_update_flat(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                                ALPHA, interpret=True)
    to = tops.cdsgd_update_flat(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(g.copy()), ALPHA)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    jp, jv = jops.cdmsgd_update_flat(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                                     jnp.asarray(v), ALPHA, MU, interpret=True)
    tp, tv = tops.cdmsgd_update_flat(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(g.copy()),
                                     torch.from_numpy(v.copy()), ALPHA, MU)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)


def test_ref_matches_jax_ref_oracle():
    from repro.kernels.consensus_update import ref as jref

    w, x, g, v = _operands(1, 4, 17, seed=11)
    want = jref.cdsgd_update_ref(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(g[0]), ALPHA)
    got = ref.cdsgd_update_ref(torch.from_numpy(w), torch.from_numpy(x),
                               torch.from_numpy(g), ALPHA)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    wp, wv = jref.cdmsgd_update_ref(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(g[0]),
                                    jnp.asarray(v[0]), ALPHA, MU)
    gp, gv = ref.cdmsgd_update_ref(torch.from_numpy(w), torch.from_numpy(x),
                                   torch.from_numpy(g), torch.from_numpy(v), ALPHA, MU)
    np.testing.assert_allclose(gp[0].numpy(), np.asarray(wp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(gv[0].numpy(), np.asarray(wv), rtol=0, atol=ATOL)


@pytest.mark.parametrize("stacked", [True, False])
def test_outputs_written_in_place(stacked):
    w, x, g, v = (torch.from_numpy(a) for a in _operands(3, 3, 7))
    if not stacked:
        w, g, v = w[0], g[0].clone(), v[0].clone()
    gp, vp = g.data_ptr(), v.data_ptr()
    before = cu.launch_counts()
    out = tops.cdsgd_update_flat(x, w, g, ALPHA)
    assert out.data_ptr() == gp
    g2 = g.clone()
    p2, v2 = tops.cdmsgd_update_flat(x, w, g2, v, ALPHA, MU)
    assert (p2.data_ptr(), v2.data_ptr()) == (g2.data_ptr(), vp)
    assert cu.launch_counts() == before          # the CPU path launches nothing


def test_wrappers_reject_bad_operands():
    w, x, g, v = (torch.from_numpy(a) for a in _operands(2, 2, 4))
    with pytest.raises(TypeError, match="float32"):
        cu.cdsgd_update(w, x.double(), g, ALPHA)
    with pytest.raises(TypeError, match="float32"):
        cu.cdsgd_update(w, x, g.half(), ALPHA)
    with pytest.raises(ValueError, match="shape"):
        cu.cdsgd_update(w, x, g[:, :3], ALPHA)
    with pytest.raises(ValueError, match="contiguous"):
        cu.cdsgd_update(w.t(), x, g, ALPHA)
    with pytest.raises(ValueError, match="overlap"):
        cu.cdmsgd_update(w, x, g, g, ALPHA, MU)
    with pytest.raises(ValueError, match="overlap"):
        cu.cdsgd_update(w, x, x, ALPHA)
    with pytest.raises(ValueError, match=r"\(S, rows, 128\)"):
        cu.cdsgd_update(w, x[..., :64], g, ALPHA)


def test_mixing_error_and_wire_bytes_match():
    rng = np.random.default_rng(5)
    topo_j, topo_t = jtopo.make_topology("ring", 5), ttopo.make_topology("ring", 5)
    tree = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(5, 130)).astype(np.float32)}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    pi_j = jnp.asarray(topo_j.pi, jnp.float32)
    pi_t = torch.tensor(topo_t.pi, dtype=torch.float32)
    jm, tm = jcons.mix_pytree_stacked(pi_j, jtree), tcons.mix_pytree_stacked(pi_t, ttree)
    for a, b in zip(jax.tree.leaves(jm), tree_leaves(tm)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)
    assert abs(float(tcons.consensus_error_pytree(ttree))
               - float(jcons.consensus_error_pytree(jtree))) <= 1e-5
    js, ts = jfb.make_flat_spec(jtree, lead=1), tfb.make_flat_spec(ttree, lead=1)
    assert tcons.exchange_bytes_per_step(ts, topo_t) == \
        jcons.exchange_bytes_per_step(js, topo_j, "f32")
    assert tcons.exchange_bytes_per_step(ts, topo_t, "int8") == \
        jcons.exchange_bytes_per_step(js, topo_j, "int8")
    with pytest.raises(ValueError, match="unknown exchange"):
        tcons.stacked_flat_comm(pi_t, exchange="f16")


def test_stacked_flat_comm_gathers_legacy_operands():
    topo = ttopo.make_topology("fully_connected", 4)
    comm = stacked_comm_ops(topo, device="cpu")
    bufs = [torch.zeros(4, 3, 128)]
    nbrs, w, scales, selfs = comm.flat.gather(bufs, 0)
    assert nbrs[0] is bufs[0]
    assert scales == [None] and selfs == [None]
    assert w.device.type == "cpu" and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), topo.pi.astype(np.float32))
