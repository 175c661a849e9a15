"""Port parity: the self-separated (``_q``) update forms and the bf16
neighbour form against the Pallas kernels.

The JAX kernels ``cdsgd_update_2d`` / ``cdmsgd_update_2d`` with
``scales=`` / ``self_buf=`` run in Pallas interpret mode on the CPU (as the
JAX package's own tests run them); the port's wrappers run their plain
PyTorch versions on CPU tensors.  Both compute ``w0 * self + sum_s w_{s+1}
* (float(q_s) * scale_s)`` in float32 in stencil order, so the tolerance is
1e-6 abs (XLA may still contract a multiply-add).  Covered: every payload
dtype of the wire (int8, fp8 e4m3, bf16, f32), the one-agent ``(S+1,)``
stencil form, the stacked ``(A, A+1)`` form (one launch for all agents) and
the ring's self-separated weights (zeros off the two neighbours), and the
legacy bf16 wire's dense form (bf16 neighbours, f32 grad/momentum).  The
measured gaps print with ``pytest -s``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.kernels.consensus_update import ops as jops  # noqa: E402
from repro.kernels.consensus_update.consensus_update import (  # noqa: E402
    cdmsgd_update_2d,
    cdsgd_update_2d,
    sr_quantize_2d,
)
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ops as tops  # noqa: E402

ATOL = 1e-6
ALPHA, MU = 0.05, 0.9
PAYLOADS = ("int8", "fp8", "bf16", "f32")


def _to_torch(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _payload(kind, s, rows, rng):
    """A wire payload stack ``(S, rows, 128)`` and its scales (JAX arrays)."""
    x = jnp.asarray(rng.normal(size=(s, rows, 128)).astype(np.float32))
    if kind in ("int8", "fp8"):
        qs = [sr_quantize_2d(x[i], i, exchange=kind, interpret=True)
              for i in range(s)]
        return jnp.stack([q for q, _ in qs]), jnp.stack([sc for _, sc in qs])
    scales = jnp.asarray(rng.uniform(0.5, 2.0, (s, rows, 1)).astype(np.float32))
    return (x.astype(jnp.bfloat16) if kind == "bf16" else x), scales


def _gap(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


@pytest.mark.parametrize("kind", PAYLOADS)
@pytest.mark.parametrize("s,rows", [(1, 3), (3, 300)])
def test_stencil_q_form_matches_pallas(kind, s, rows):
    rng = np.random.default_rng(s * rows)
    q, sc = _payload(kind, s, rows, rng)
    w = rng.random(s + 1).astype(np.float32)
    w /= w.sum()
    slf, g, v = (rng.normal(size=(rows, 128)).astype(np.float32)
                 for _ in range(3))
    jo = cdsgd_update_2d(q, jnp.asarray(w), jnp.asarray(g), ALPHA, scales=sc,
                         self_buf=jnp.asarray(slf), alias=False, interpret=True)
    to = tops.cdsgd_update_flat(_to_torch(q), torch.from_numpy(w),
                                torch.from_numpy(g.copy()), ALPHA,
                                scales=_to_torch(sc),
                                self_buf=torch.from_numpy(slf))
    jp, jv = cdmsgd_update_2d(q, jnp.asarray(w), jnp.asarray(g),
                              jnp.asarray(v), ALPHA, MU, scales=sc,
                              self_buf=jnp.asarray(slf), alias=False,
                              interpret=True)
    tp, tv = tops.cdmsgd_update_flat(_to_torch(q), torch.from_numpy(w),
                                     torch.from_numpy(g.copy()),
                                     torch.from_numpy(v.copy()), ALPHA, MU,
                                     scales=_to_torch(sc),
                                     self_buf=torch.from_numpy(slf))
    gaps = [_gap(to, jo), _gap(tp, jp), _gap(tv, jv)]
    print(f"stencil _q {kind} S={s} rows={rows}: gaps {gaps}")
    assert max(gaps) <= ATOL


@pytest.mark.parametrize("kind", PAYLOADS)
@pytest.mark.parametrize("topo,rows", [("fully_connected", 261), ("ring", 7)])
def test_stacked_q_form_matches_pallas(kind, topo, rows):
    """``(A, A+1)`` self-separated weights of a real topology, the whole
    agent stack as the payload: one call for all agents."""
    a = 5
    rng = np.random.default_rng(rows)
    pi = jtopo.make_topology(topo, a).pi
    w = jcons._self_separated_weights(pi).astype(np.float32)
    q, sc = _payload(kind, a, rows, rng)
    slf, g, v = (rng.normal(size=(a, rows, 128)).astype(np.float32)
                 for _ in range(3))
    jo = jops.cdsgd_update_flat(q, jnp.asarray(w), jnp.asarray(g), ALPHA,
                                scales=sc, self_buf=jnp.asarray(slf),
                                interpret=True)
    jp, jv = jops.cdmsgd_update_flat(q, jnp.asarray(w), jnp.asarray(g),
                                     jnp.asarray(v), ALPHA, MU, scales=sc,
                                     self_buf=jnp.asarray(slf), interpret=True)
    before = cu.launch_counts()
    to = tops.cdsgd_update_flat(_to_torch(q), torch.from_numpy(w),
                                torch.from_numpy(g.copy()), ALPHA,
                                scales=_to_torch(sc),
                                self_buf=torch.from_numpy(slf))
    g2 = torch.from_numpy(g.copy())
    tp, tv = tops.cdmsgd_update_flat(_to_torch(q), torch.from_numpy(w), g2,
                                     torch.from_numpy(v.copy()), ALPHA, MU,
                                     scales=_to_torch(sc),
                                     self_buf=torch.from_numpy(slf))
    assert tp.data_ptr() == g2.data_ptr()               # in place
    assert cu.launch_counts() == before                 # CPU launches nothing
    gaps = [_gap(to, jo), _gap(tp, jp), _gap(tv, jv)]
    print(f"stacked _q {kind} {topo} rows={rows}: gaps {gaps}")
    assert max(gaps) <= ATOL
    # the port's self-separated weights are the JAX package's
    np.testing.assert_array_equal(
        tcons._self_separated_weights(pi).astype(np.float32), w)


@pytest.mark.parametrize("stacked", [True, False])
def test_bf16_neighbour_form_matches_pallas(stacked):
    """The legacy bf16 wire: the whole stack (self included) cast to bf16,
    dense weights, f32 grad and momentum."""
    a, rows = 4, 130
    rng = np.random.default_rng(9)
    w = rng.random((a, a)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    x = jnp.asarray(rng.normal(size=(a, rows, 128)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    g, v = (rng.normal(size=(a, rows, 128)).astype(np.float32)
            for _ in range(2))
    if not stacked:
        w, g, v = w[0], g[0], v[0]
    jo = jops.cdsgd_update_flat(x, jnp.asarray(w), jnp.asarray(g), ALPHA,
                                interpret=True)
    jp, jv = jops.cdmsgd_update_flat(x, jnp.asarray(w), jnp.asarray(g),
                                     jnp.asarray(v), ALPHA, MU, interpret=True)
    to = tops.cdsgd_update_flat(_to_torch(x), torch.from_numpy(w),
                                torch.from_numpy(g.copy()), ALPHA)
    tp, tv = tops.cdmsgd_update_flat(_to_torch(x), torch.from_numpy(w),
                                     torch.from_numpy(g.copy()),
                                     torch.from_numpy(v.copy()), ALPHA, MU)
    gaps = [_gap(to, jo), _gap(tp, jp), _gap(tv, jv)]
    print(f"bf16 neighbours stacked={stacked}: gaps {gaps}")
    assert max(gaps) <= ATOL


def test_q_wrappers_reject_bad_operands():
    a, rows = 2, 4
    w = torch.full((a, a + 1), 1.0 / (a + 1))
    slf, g, v = (torch.randn(a, rows, 128) for _ in range(3))
    q = torch.zeros(a, rows, 128, dtype=torch.int8)
    sc = torch.ones(a, rows, 1)
    with pytest.raises(TypeError, match="int8"):
        cu.cdsgd_update_q(w, slf, q.to(torch.int16), sc, g, ALPHA)
    with pytest.raises(ValueError, match="shape"):
        cu.cdsgd_update_q(w[:, :a], slf, q, sc, g, ALPHA)
    with pytest.raises(ValueError, match="shape"):
        cu.cdsgd_update_q(w, slf, q, sc[:, :2], g, ALPHA)
    with pytest.raises(TypeError, match="float32"):
        cu.cdsgd_update_q(w, slf, q, sc.double(), g, ALPHA)
    with pytest.raises(ValueError, match="contiguous"):
        cu.cdsgd_update_q(w, slf, q, sc, g.transpose(1, 2).contiguous()
                          .transpose(1, 2), ALPHA)
    with pytest.raises(ValueError, match="overlap"):
        cu.cdsgd_update_q(w, g, q, sc, g, ALPHA)          # self is the output
    with pytest.raises(ValueError, match="overlap"):
        cu.cdmsgd_update_q(w, slf, q, sc, g, g, ALPHA, MU)
    with pytest.raises(TypeError, match="bfloat16"):
        cu.cdsgd_update(w[:, :a].contiguous(), q, g, ALPHA)   # int8 needs _q
