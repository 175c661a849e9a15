"""Port parity: the Nesterov and CDAdam update forms and the mixed-momentum
(``_qm``) forms against the Pallas kernels.

The JAX kernels ``cdmsgd_update_2d`` (``mom_neighbors=``),
``cdmsgd_nesterov_update_2d`` and ``cdadam_update_2d`` run in Pallas
interpret mode on the CPU (as the JAX package's own tests run them); the
port's wrappers run their plain PyTorch versions on CPU tensors.  Both do
the float32 operations of the Pallas bodies in the same order, so the
tolerance is 1e-6 abs (XLA may still contract a multiply-add).  Covered:
the dense form (f32 and bf16 neighbours), the ``_q`` and ``_qm`` forms
with every payload dtype of the wire (int8, fp8 e4m3, bf16, f32), the
one-agent ``(S,)`` / ``(S+1,)`` stencil and the stacked ``(A, A)`` /
``(A, A+1)`` weights (one call for all agents), a ragged row count, and an
all-zero row in every operand (scale 1.0, Adam's ``0 / (0 + eps)``).  The
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
    sr_quantize_2d,
)
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ops as tops  # noqa: E402

ATOL = 1e-6
ALPHA, MU = 0.05, 0.9
B1, B2, EPS, T = 0.9, 0.999, 1e-8, 3
BC1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(T))
BC2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(T))
ADAM = (0.01, B1, B2, EPS, BC1, BC2)
PAYLOADS = ("int8", "fp8", "bf16", "f32")


def _to_torch(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _rows(rng, lead, rows, scale=1.0):
    """``lead + (rows, 128)`` float32 with row 0 all zero."""
    x = (scale * rng.normal(size=lead + (rows, 128))).astype(np.float32)
    x[..., 0, :] = 0.0
    return x


def _payload(kind, s, rows, rng, seed):
    """A wire payload stack ``(S, rows, 128)`` and its scales (JAX arrays)."""
    x = jnp.asarray(_rows(rng, (s,), rows))
    if kind in ("int8", "fp8"):
        qs = [sr_quantize_2d(x[i], seed + i, exchange=kind, interpret=True)
              for i in range(s)]
        return jnp.stack([q for q, _ in qs]), jnp.stack([sc for _, sc in qs])
    scales = jnp.asarray(rng.uniform(0.5, 2.0, (s, rows, 1)).astype(np.float32))
    return (x.astype(jnp.bfloat16) if kind == "bf16" else x), scales


def _weights(rng, stacked, a, n, topo=None):
    if topo is not None:
        pi = jtopo.make_topology(topo, a).pi
        w = jcons._self_separated_weights(pi) if n == a + 1 else pi
        return np.asarray(w, np.float32)
    w = rng.random((a, n) if stacked else (n,)).astype(np.float32)
    return w / w.sum(axis=-1, keepdims=True)


def _gap(ts, js):
    return max(float(np.max(np.abs(t.float().numpy()
                                   - np.asarray(j, np.float32))))
               for t, j in zip(ts, js))


def _operands(form, kind, stacked, s, rows, seed, topo=None):
    """JAX operands of one case: ``(nbrs, w, per_agent, kw)`` where ``kw``
    holds ``scales`` / ``self_buf`` / ``mom_neighbors`` / ``mom_scales``."""
    rng = np.random.default_rng(seed)
    a = s if stacked else None
    lead = (a,) if stacked else ()
    kw = {}
    if form == "dense":
        x = jnp.asarray(_rows(rng, (s,), rows))
        nbrs = x.astype(jnp.bfloat16) if kind == "bf16" else x
        w = _weights(rng, stacked, a, s, topo)
    else:
        nbrs, kw["scales"] = _payload(kind, s, rows, rng, seed)
        kw["self_buf"] = jnp.asarray(_rows(rng, lead, rows))
        w = _weights(rng, stacked, a, s + 1, topo)
        if form == "qm":
            kw["mom_neighbors"], kw["mom_scales"] = _payload(kind, s, rows, rng,
                                                             seed + 100)
    g = _rows(rng, lead, rows)
    mom = _rows(rng, lead, rows, 0.1)
    v2 = np.abs(_rows(rng, lead, rows, 0.01))
    return nbrs, jnp.asarray(w), g, mom, v2, kw


def _run_both(opt, form, kind, stacked, s, rows, seed, topo=None):
    nbrs, w, g, mom, v2, kw = _operands(form, kind, stacked, s, rows, seed, topo)
    tkw = {k: _to_torch(x) for k, x in kw.items()}
    tn, tw = _to_torch(nbrs), _to_torch(w)
    if opt == "cdmsgd":
        jo = jops.cdmsgd_update_flat(nbrs, w, jnp.asarray(g), jnp.asarray(mom),
                                     ALPHA, MU, interpret=True, **kw)
        to = tops.cdmsgd_update_flat(tn, tw, torch.from_numpy(g.copy()),
                                     torch.from_numpy(mom.copy()), ALPHA, MU,
                                     **tkw)
    elif opt == "nesterov":
        jo = jops.cdmsgd_nesterov_update_flat(
            nbrs, w, jnp.asarray(g), jnp.asarray(mom), ALPHA, MU,
            interpret=True, **kw)
        to = tops.cdmsgd_nesterov_update_flat(
            tn, tw, torch.from_numpy(g.copy()), torch.from_numpy(mom.copy()),
            ALPHA, MU, **tkw)
    else:
        jo = jops.cdadam_update_flat(
            nbrs, w, jnp.asarray(g), jnp.asarray(mom), jnp.asarray(v2), *ADAM,
            interpret=True, **kw)
        to = tops.cdadam_update_flat(
            tn, tw, torch.from_numpy(g.copy()), torch.from_numpy(mom.copy()),
            torch.from_numpy(v2.copy()), *ADAM, **tkw)
    return to, jo


CASES = ([("nesterov", "dense", k) for k in ("f32", "bf16")]
         + [("adam", "dense", k) for k in ("f32", "bf16")]
         + [(o, f, k) for o in ("nesterov", "adam") for f in ("q", "qm")
            for k in PAYLOADS]
         + [("cdmsgd", "qm", k) for k in PAYLOADS])


@pytest.mark.parametrize("opt,form,kind", CASES,
                         ids=[f"{o}-{f}-{k}" for o, f, k in CASES])
@pytest.mark.parametrize("stacked,s,rows", [(False, 3, 37), (True, 4, 9)],
                         ids=["stencil", "stacked"])
def test_update_form_matches_pallas(opt, form, kind, stacked, s, rows):
    before = cu.launch_counts()
    to, jo = _run_both(opt, form, kind, stacked, s, rows, seed=s * rows)
    assert cu.launch_counts() == before                 # CPU launches nothing
    assert len(to) == len(jo) and all(
        tuple(t.shape) == tuple(j.shape) for t, j in zip(to, jo))
    gap = _gap(to, jo)
    print(f"{opt} {form} {kind} {'stacked' if stacked else 'stencil'} "
          f"S={s} rows={rows}: max gap {gap:.2e}")
    assert gap <= ATOL


@pytest.mark.parametrize("opt", ["cdmsgd", "nesterov", "adam"])
@pytest.mark.parametrize("topo", ["ring", "fully_connected"])
def test_qm_form_on_topology_weights(opt, topo):
    """The trainer's operand form: ``[diag(Pi) | zero-diag Pi]`` of a real
    topology (the ring's zeros included), 5 agents, int8 payloads."""
    to, jo = _run_both(opt, "qm", "int8", True, 5, 21, seed=5, topo=topo)
    gap = _gap(to, jo)
    print(f"{opt} qm int8 {topo}: max gap {gap:.2e}")
    assert gap <= ATOL


def test_nesterov_lookahead_and_in_place_contract():
    """``look = x' + mu v'`` exactly; params and momentum written in place,
    the lookahead a new buffer; the all-zero row of Adam stays zero."""
    nbrs, w, g, mom, v2, kw = _operands("q", "int8", True, 3, 5, 11)
    tkw = {k: _to_torch(x) for k, x in kw.items()}
    tg, tv = torch.from_numpy(g.copy()), torch.from_numpy(mom.copy())
    x, v, look = tops.cdmsgd_nesterov_update_flat(
        _to_torch(nbrs), _to_torch(w), tg, tv, ALPHA, MU, **tkw)
    assert x.data_ptr() == tg.data_ptr() and v.data_ptr() == tv.data_ptr()
    assert look.data_ptr() not in (tg.data_ptr(), tv.data_ptr())
    mu32 = float(np.float32(MU))
    assert torch.equal(look, x + mu32 * v)
    tg, tm, tv2 = (torch.from_numpy(a.copy()) for a in (g, mom, v2))
    out, m1, v1 = tops.cdadam_update_flat(_to_torch(nbrs), _to_torch(w), tg,
                                          tm, tv2, *ADAM, **tkw)
    assert (out.data_ptr(), m1.data_ptr(), v1.data_ptr()) == \
        (tg.data_ptr(), tm.data_ptr(), tv2.data_ptr())
    assert float(m1[:, 0].abs().max()) == 0.0 and float(v1[:, 0].abs().max()) == 0.0


def test_b4_wrappers_reject_bad_operands():
    a, rows = 2, 4
    w = torch.full((a, a + 1), 1.0 / (a + 1))
    slf, g, v, m = (torch.randn(a, rows, 128) for _ in range(4))
    q = torch.zeros(a, rows, 128, dtype=torch.int8)
    sc = torch.ones(a, rows, 1)
    with pytest.raises(TypeError, match="int8"):       # payload kinds differ
        cu.cdmsgd_update_qm(w, slf, q, sc, q.float(), sc, g, v, ALPHA, MU)
    with pytest.raises(ValueError, match="shape"):
        cu.cdmsgd_update_qm(w, slf, q, sc, q, sc[:, :2], g, v, ALPHA, MU)
    with pytest.raises(ValueError, match="overlap"):    # v is the output
        cu.cdmsgd_nesterov_update_qm(w, slf, q, sc, q, sc, g, g, ALPHA, MU)
    vq = v.to(torch.int8)
    with pytest.raises(ValueError, match="overlap"):
        cu.cdadam_update_qm(w, slf, q, sc, vq, sc, g, m, m, *ADAM)
    with pytest.raises(TypeError, match="bfloat16"):    # int8 needs _q
        cu.cdadam_update(w[:, :a].contiguous(), q, g, m, v, *ADAM)
    # an f32 wire's momentum payload is the packed momentum itself: it must
    # not double as the momentum operand the kernel writes in place
    with pytest.raises(ValueError, match="overlap"):
        cu.cdmsgd_update_qm(w, slf, v, sc, v, sc, g, v, ALPHA, MU)


def test_plain_adam_square_root_is_correctly_rounded():
    """The plain versions' square root (``ref.sqrt_rn``) equals IEEE's
    correctly rounded float32 root (numpy's) on every input, as the
    kernel's ``__fsqrt_rn`` does; PyTorch's vectorized CPU ``torch.sqrt``
    need not (its share of one-ulp misses on this host prints with
    ``pytest -s``).  Adam's ``m / (sqrt(v) + eps)`` turns a one-ulp miss
    at a tiny ``v`` into a visible parameter difference."""
    from repro_torch.kernels.consensus_update import ref
    rng = np.random.default_rng(0)
    x = (rng.random(1_000_000) * 10.0 ** rng.integers(-40, 30, 1_000_000)
         ).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, 1e-45]
    want = np.sqrt(x)
    got = ref.sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    plain = torch.sqrt(torch.from_numpy(x)).numpy()
    print(f"torch.sqrt on the CPU: {np.mean(plain != want):.4%} of 1e6 "
          "float32 inputs one ulp or more from the correctly rounded root; "
          "ref.sqrt_rn: 0")
