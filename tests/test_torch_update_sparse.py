"""Port parity: the sparse operand form of the fused update (the top-k
wire) against the Pallas ``*_update_sparse_2d`` kernels.

The JAX kernels run in Pallas interpret mode on the CPU (as
``tests/test_sparse_update.py`` runs them), through the JAX package's
``*_update_flat`` entry points with a ``SparseNeighbors`` operand; the
port's ``*_update_flat`` run their plain PyTorch versions on CPU tensors
(``ref._mix_sparse``: ``w0 * self``, then one ``index_add_`` of ``w_{s+1}
* (float(value) * scale)`` per neighbour in stencil order).  Tolerance 1e-6
abs for every output (params, momentum, lookahead, both Adam moments).
Covered: CDSGD, CDMSGD, Nesterov and CDAdam; the one-agent ``(S+1,)``
stencil form and the stacked ``(A, A+1)`` form (JAX's vmap, the port's one
launch); a ring ``Pi`` with zero weights; indices on the Pallas and CUDA
block edges (Pallas with 4-row blocks; CUDA blocks of 8 rows = 1,024
elements); ``k_rows = rows``; index layouts that stress the CUDA
kernel's carried cursor (entries clustered in a few runs, entries on both
sides of the 1,024-element tile edges, sparse and at half density).  Each
sparse plain version is also held
against the port's own decompress-then-``_q`` plain version (the dense
oracle of the JAX package's tests), within 1e-6.  ``pytest -s`` prints the
gaps.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import topology as jtopo  # noqa: E402
from repro.kernels.consensus_update import consensus_update as jcu  # noqa: E402
from repro.kernels.consensus_update import ops as jops  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.kernels.consensus_update import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_update import topk as ttk  # noqa: E402

ATOL = 1e-6
FAMILIES = ("cdsgd", "cdmsgd", "cdmsgd_nesterov", "cdadam")
SCALARS = {"cdsgd": (0.05,), "cdmsgd": (0.05, 0.9),
           "cdmsgd_nesterov": (0.05, 0.9),
           "cdadam": (0.05, 0.9, 0.999, 1e-8, 0.1, 0.001)}
N_STATE = {"cdsgd": 0, "cdmsgd": 1, "cdmsgd_nesterov": 1, "cdadam": 2}
JFLAT = {"cdsgd": jops.cdsgd_update_flat, "cdmsgd": jops.cdmsgd_update_flat,
         "cdmsgd_nesterov": jops.cdmsgd_nesterov_update_flat,
         "cdadam": jops.cdadam_update_flat}
TFLAT = {"cdsgd": tops.cdsgd_update_flat, "cdmsgd": tops.cdmsgd_update_flat,
         "cdmsgd_nesterov": tops.cdmsgd_nesterov_update_flat,
         "cdadam": tops.cdadam_update_flat}


def _indices(rng, s, k_rows, rows):
    """Sorted unique flat positions per neighbour, with the block edges
    (0, 127 | 128, 511 | 512, 1023 | 1024, the last element) present."""
    n, kk = rows * 128, k_rows * 128
    edges = np.unique([e for e in (0, 127, 128, 511, 512, 1023, 1024, n - 1)
                       if e < n])
    out = []
    for _ in range(s):
        rest = np.setdiff1d(np.arange(n), edges)
        pick = rng.choice(rest, kk - len(edges), replace=False) \
            if kk > len(edges) else np.array([], np.int64)
        idx = np.sort(np.concatenate([edges[:kk], pick]))
        out.append(idx.astype(np.int32).reshape(k_rows, 128))
    return np.stack(out)


def _operands(s, a_out, rows, k_rows, seed, weights=None):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-127, 128, (s, k_rows, 128)).astype(np.int8)
    idx = _indices(rng, s, k_rows, rows)
    # a wire's row scales: amax / 127, amax over three decades
    scs = (rng.uniform(1e-3, 4.0, (s, k_rows, 1)) / 127).astype(np.float32)
    if weights is None:
        weights = rng.random((a_out, s + 1)).astype(np.float32)
        weights /= weights.sum(axis=1, keepdims=True)
    per_agent = [rng.normal(size=(a_out, rows, 128)).astype(np.float32)
                 for _ in range(5)]
    per_agent[4] = np.abs(per_agent[4]) * 0.01       # Adam's second moment
    return vals, idx, scs, weights.astype(np.float32), per_agent


def _state_args(family, per_agent):
    """grad, then the family's state operands (momentum; Adam m, v)."""
    if family == "cdadam":
        return [per_agent[1], per_agent[2], per_agent[4]]
    return [per_agent[1]] + [per_agent[2]] * N_STATE[family]


def _run_jax(family, vals, idx, scs, w, self_buf, args, stencil):
    sl = (lambda a: a[0]) if stencil else (lambda a: a)
    nb = jops.SparseNeighbors(jnp.asarray(vals), jnp.asarray(idx),
                              jnp.asarray(scs))
    out = JFLAT[family](nb, jnp.asarray(sl(w)),
                        *[jnp.asarray(sl(a)) for a in args],
                        *SCALARS[family],
                        self_buf=jnp.asarray(sl(self_buf)), interpret=True)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _run_port(family, nbrs, w, self_buf, args, stencil, scales=None):
    sl = (lambda a: a[0]) if stencil else (lambda a: a)
    t = lambda a: torch.from_numpy(np.array(sl(a), copy=True))
    out = TFLAT[family](nbrs, t(w), *[t(a) for a in args],
                        *SCALARS[family], scales=scales, self_buf=t(self_buf))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _gap(a, b) -> float:
    return max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))


def _check(family, vals, idx, scs, w, per_agent, stencil, what):
    args = _state_args(family, per_agent)
    want = _run_jax(family, vals, idx, scs, w, per_agent[0], args, stencil)
    nb = tops.SparseNeighbors(*(torch.from_numpy(a.copy())
                                for a in (vals, idx, scs)))
    got = _run_port(family, nb, w, per_agent[0], args, stencil)
    assert len(got) == len(want)
    gap = _gap(got, want)
    # the port's dense oracle: decompress, then the _q form, unit scales
    rows = per_agent[0].shape[1]
    dense = ttk.topk_decompress_2d(*(torch.from_numpy(a.copy())
                                     for a in (vals, idx, scs)), rows)
    unit = torch.ones(dense.shape[:-1] + (1,))
    oracle = _run_port(family, dense, w, per_agent[0], args, stencil,
                       scales=unit)
    own = _gap(got, oracle)
    print(f"{family} sparse {what}: max gap vs Pallas {gap:.2e}, vs the "
          f"port's decompress-then-_q {own:.2e}")
    assert gap <= ATOL and own <= ATOL


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("s,rows,k_rows", [(2, 12, 2), (3, 9, 9), (1, 1, 1)])
def test_stencil_sparse_form_matches_pallas(family, s, rows, k_rows):
    vals, idx, scs, w, pa = _operands(s, 1, rows, k_rows, seed=rows + s)
    _check(family, vals, idx, scs, w, pa, True,
           f"stencil S={s} rows={rows} k_rows={k_rows}")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("topo", ["ring", "fully_connected"])
def test_stacked_sparse_form_matches_pallas(family, topo):
    """The trainer's form: all agents' compact stacks shared by every
    agent, the self-separated ``[diag(Pi) | zero-diag Pi]`` weights (the
    ring's have zeros), one port call against JAX's vmap."""
    a = 5
    w = tcons._self_separated_weights(jtopo.make_topology(topo, a).pi)
    vals, idx, scs, w, pa = _operands(a, a, 10, 3, seed=17, weights=w)
    _check(family, vals, idx, scs, w, pa, False, f"stacked A=S={a} {topo}")


def test_block_edges_and_full_density_pallas_blocks():
    """The Pallas kernel with 4-row blocks (its row0 masking) on indices
    at block edges, and ``k_rows = rows``."""
    for rows, k_rows in ((12, 3), (8, 8)):
        vals, idx, scs, w, pa = _operands(2, 1, rows, k_rows, seed=3)
        got = _run_port("cdsgd", tops.SparseNeighbors(
            *(torch.from_numpy(x.copy()) for x in (vals, idx, scs))), w,
            pa[0], [pa[1]], True)[0]
        want = jcu.cdsgd_update_sparse_2d(
            jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(scs),
            jnp.asarray(w[0]), jnp.asarray(pa[1][0]), 0.05,
            self_buf=jnp.asarray(pa[0][0]), block_rows=4, alias=False,
            interpret=True)
        gap = float(np.max(np.abs(got - np.asarray(want))))
        print(f"cdsgd sparse rows={rows} k_rows={k_rows} 4-row Pallas "
              f"blocks: max gap {gap:.2e}")
        assert gap <= ATOL


def _layout_indices(rng, s, k_rows, rows, layout):
    """Sorted unique flat positions per neighbour laid out to stress a
    kernel that walks the bucket in 1,024-element tiles with one cursor per
    neighbour: ``"clustered"`` puts each neighbour's entries in three runs,
    one in each third of the bucket, so most tiles hold none and a run may
    fill whole tiles; ``"boundaries"`` draws them near the tile edges (within
    8 elements, where the CUDA kernel's persistent CTAs' ranges meet), a few
    elsewhere."""
    n, kk = rows * 128, k_rows * 128
    out = []
    for _ in range(s):
        if layout == "clustered":
            cuts = [n * i // 3 for i in range(4)]
            parts = []
            for i in range(3):
                length = kk * (i + 1) // 3 - kk * i // 3
                seg = cuts[i + 1] - cuts[i]
                assert length <= seg
                start = cuts[i] + rng.integers(0, seg - length + 1)
                parts.append(np.arange(start, start + length))
            idx = np.concatenate(parts)
        else:
            d = np.arange(n) % 1024
            w = np.where(np.minimum(d, 1024 - d) < 8, 1.0, 1e-3)
            idx = np.sort(rng.choice(n, kk, replace=False, p=w / w.sum()))
        out.append(idx.astype(np.int32).reshape(k_rows, 128))
    return np.stack(out)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("stencil", [False, True], ids=["stacked", "stencil"])
@pytest.mark.parametrize("layout,rows,k_rows", [
    ("clustered", 40, 2), ("boundaries", 40, 3), ("boundaries", 24, 12)],
    ids=["clustered", "boundaries", "dense-boundaries"])
def test_cursor_layouts_match_pallas(layout, rows, k_rows, stencil, family):
    """Index layouts that stress the CUDA kernel's carried cursor (its plain
    version here, the kernel on the card): entries clustered into a few
    runs with most 8-row tiles empty, and entries on both sides of the tile
    edges, sparse and at half density (more than 32 entries a tile)."""
    s, a_out = 3, 1 if stencil else 3
    vals, _, scs, w, pa = _operands(s, a_out, rows, k_rows, seed=rows + k_rows)
    idx = _layout_indices(np.random.default_rng(k_rows), s, k_rows, rows, layout)
    _check(family, vals, idx, scs, w, pa, stencil,
           f"{layout} S={s} A_out={a_out} rows={rows} k_rows={k_rows}")


def test_sparse_form_rejects_bad_operands():
    vals, idx, scs, w, pa = _operands(2, 1, 4, 1, seed=0)
    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    nb = tops.SparseNeighbors(t(vals), t(idx), t(scs))
    with pytest.raises(ValueError, match="self_buf"):
        tops.cdsgd_update_flat(nb, t(w[0]), t(pa[1][0]), 0.05)
    with pytest.raises(ValueError, match="scales"):
        tops.cdsgd_update_flat(nb, t(w[0]), t(pa[1][0]), 0.05,
                               scales=t(scs), self_buf=t(pa[0][0]))
    bad = tops.SparseNeighbors(t(vals), t(idx).long(), t(scs))
    with pytest.raises(TypeError, match="int32"):
        tops.cdsgd_update_flat(bad, t(w[0]), t(pa[1][0]), 0.05,
                               self_buf=t(pa[0][0]))
    big = tops.SparseNeighbors(*(t(np.concatenate([a] * 5, axis=1))
                                 for a in (vals, idx, scs)))
    with pytest.raises(ValueError, match="compact rows"):
        tops.cdsgd_update_flat(big, t(w[0]), t(pa[1][0]), 0.05,
                               self_buf=t(pa[0][0]))
