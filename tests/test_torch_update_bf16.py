"""Port parity: bfloat16 parameter buckets in the fused update and the wire
quantizer, against the Pallas kernels.

The model zoo's parameters are bfloat16, so their packed bucket, its
gradient, momentum, Adam moments, Nesterov lookahead and (self-separated
forms) native self tile are bfloat16.  The Pallas kernels widen them to
float32, compute the float32 expression and store into the bucket's dtype;
the port's plain versions (the CPU path of the wrappers, what the CUDA
kernels are held against on the card) do the same float32 operations in
the same order and round each output once to bfloat16.  So every form
matches **bit for bit**, for CDSGD, CDMSGD, Nesterov and CDAdam:

* the dense form (bf16 neighbours, and float32 neighbours), stacked on a
  ring's ``Pi`` at ``A = S = 4`` and as one agent's ``(S,)`` stencil;
* the ``_q`` form with int8, fp8 and bf16 payloads, stacked ``(A, A+1)``
  and as one agent's ``(S+1,)`` stencil;
* the mixed-momentum ``_qm`` form of CDMSGD, Nesterov and CDAdam (the
  momentum, or Adam's first moment, as a second payload of the same type),
  int8, fp8 and bf16, stacked and as a stencil;
* the sparse (top-k wire) form of all four, its compact values int8 with
  float32 row scales, stacked and as a stencil;

at the row counts of ``ROWS`` (ragged, and larger).

The Pallas kernels run in interpret mode in one subprocess for the module,
whose XLA compiles for the CPU without FMA instructions
(``--xla_cpu_max_isa=AVX``): XLA fuses the kernel body into one loop and
lets LLVM contract a multiply and an add into an FMA where it chooses,
which moves a float32 result by an ulp now and then (the float32 parity
tests allow 1e-6 for it) and so, at a bf16 rounding boundary, a bf16
output by one bf16 ulp.  The kernels themselves (and the CUDA kernels,
with ``_rn`` intrinsics) round every multiply and add.  Inputs are drawn
with numpy in the subprocess; it returns them with the outputs as raw
bytes.

``sr_quantize`` of a bfloat16 bucket is held through ``_quantize_math
(x.astype(f32), u, ...)`` with the same uniforms, bit for bit.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.kernels.consensus_update import ops as jops  # noqa: E402
from repro.kernels.consensus_update.consensus_update import _quantize_math  # noqa: E402
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402

A = 4
S_STENCIL = 3                    # one agent's neighbours in the stencil forms
ALPHA, MU = 0.05, 0.9
ADAM = (0.9, 0.999, 1e-8, 0.1, 0.001)      # b1 b2 eps bc1 bc2
ROWS = (37, 261)                 # ragged (not a multiple of 8) and larger
#: the JAX oracle's XLA flag: no FMA instructions, so no contraction
NO_FMA = "--xla_cpu_max_isa=AVX"
FAMILIES = ("cdsgd", "cdmsgd", "cdmsgd_nesterov", "cdadam")
#: per family: its per-agent operands after the neighbours (grad first) and
#: its scalars
STATE = {"cdsgd": ("g",), "cdmsgd": ("g", "v"), "cdmsgd_nesterov": ("g", "v"),
         "cdadam": ("g", "m", "v2")}
SCALARS = {"cdsgd": (ALPHA,), "cdmsgd": (ALPHA, MU),
           "cdmsgd_nesterov": (ALPHA, MU), "cdadam": (ALPHA, *ADAM)}
JFLAT = {"cdsgd": jops.cdsgd_update_flat, "cdmsgd": jops.cdmsgd_update_flat,
         "cdmsgd_nesterov": jops.cdmsgd_nesterov_update_flat,
         "cdadam": jops.cdadam_update_flat}
TFLAT = {"cdsgd": tops.cdsgd_update_flat, "cdmsgd": tops.cdmsgd_update_flat,
         "cdmsgd_nesterov": tops.cdmsgd_nesterov_update_flat,
         "cdadam": tops.cdadam_update_flat}
#: the families each form runs (the _qm form has no CDSGD)
FORM_FAMILIES = {"qm": FAMILIES[1:], "qm-stencil": FAMILIES[1:]}
#: (name, form, operand kind, rows): the oracle's cases.  Dense: the
#: neighbour type; _q / _qm: the payload type; sparse: int8 compact values.
CASES = ([(f"dense-{k}-{r}", "dense", k, r) for k in ("bf16", "f32") for r in ROWS]
         + [(f"q-{k}-{r}", "q", k, r) for k in ("int8", "fp8", "bf16")
            for r in ROWS]
         + [(f"stencil-{k}", "stencil", k, 37) for k in ("int8", "bf16")]
         + [("dense-stencil-bf16", "dense-stencil", "bf16", 37)]
         + [(f"qm-{k}-{r}", "qm", k, r) for k in ("int8", "fp8", "bf16")
            for r in ROWS]
         + [(f"qm-stencil-{k}", "qm-stencil", k, 261) for k in ("int8", "bf16")]
         + [(f"sparse-{r}", "sparse", "int8", r) for r in ROWS]
         + [("sparse-stencil", "sparse-stencil", "int8", 261)])
_RAW = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}


def _ids(cases):
    return [c[0] for c in cases]


def _to_torch(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(t) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _assert_bits(got, want, what):
    want = want if isinstance(want, torch.Tensor) else _to_torch(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if not np.array_equal(_bits(got), _bits(want)):
        gap = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"{what}: not bit for bit (max gap {gap:.3e})")


def _bf16(rng, shape):
    """A bf16 array whose rows span six decades (JAX array)."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, shape[:-1] + (1,))
    return jnp.asarray(x.astype(np.float32), jnp.bfloat16)


def _payload(kind, rng, shape):
    """A wire payload stack ``(S, rows, 128)`` and its scales: int8 / fp8
    codes of a bf16 stack by the quantizer's arithmetic (``_quantize_math``,
    int8 with numpy uniforms), or the stack itself."""
    x = _bf16(rng, shape)
    if kind == "int8":
        return _jit_quantize(kind)(x, jnp.asarray(rng.random(shape, np.float32)))
    if kind == "fp8":
        return _jit_quantize(kind)(x)
    if kind == "f32":
        return x.astype(jnp.float32), None
    return x, jnp.ones(shape[:-1] + (1,), jnp.float32)


def _sparse(rng, s, rows):
    """Top-k compact stacks of ``s`` neighbours over ``rows`` dense rows:
    int8 values, sorted unique int32 flat indices (the first and the last
    element present), float32 row scales ``amax / 127``."""
    k_rows = max(1, rows // 12)
    n, kk = rows * 128, k_rows * 128
    idx = np.stack([np.sort(np.concatenate([[0, n - 1], rng.choice(
        np.arange(1, n - 1), kk - 2, replace=False)])).reshape(k_rows, 128)
        for _ in range(s)]).astype(np.int32)
    vals = rng.integers(-127, 128, (s, k_rows, 128)).astype(np.int8)
    scs = (rng.uniform(1e-3, 4.0, (s, k_rows, 1)) / 127).astype(np.float32)
    return jops.SparseNeighbors(jnp.asarray(vals), jnp.asarray(idx),
                                jnp.asarray(scs))


def _stencil_weights(rng, n):
    w = rng.random(n).astype(np.float32)
    return w / w.sum()


def _inputs(form, kind, rows, rng) -> dict:
    """One case's operands (JAX arrays; ``nb`` the neighbours or payload,
    or a ``SparseNeighbors``)."""
    stencil = form.endswith("stencil")
    s = S_STENCIL if stencil else A
    lead = () if stencil else (A,)
    pi = jtopo.make_topology("ring", A).pi
    if form.startswith("dense"):
        w = (_stencil_weights(rng, s) if stencil else np.asarray(pi, np.float32))
    else:
        w = (_stencil_weights(rng, s + 1) if stencil else
             np.asarray(jcons._self_separated_weights(pi), np.float32))
    c = {"w": w}
    if form.startswith("sparse"):
        c["nb"] = _sparse(rng, s, rows)
    else:
        c["nb"], c["sc"] = _payload(kind, rng, (s, rows, 128))
    for k in ("slf", "g", "v", "m"):
        c[k] = _bf16(rng, lead + (rows, 128))
    # Adam's second moment: positive, over the decades of g * g
    c["v2"] = jnp.abs(_bf16(rng, lead + (rows, 128)))
    if form.startswith("qm"):
        c["mq"], c["msc"] = _payload(kind, rng, (s, rows, 128))
    return c


def _kwargs(form, c) -> dict:
    """The flat entry point's keyword operands of a form (JAX arrays or
    tensors, from the case's ``c``)."""
    if form.startswith("dense"):
        return {}
    kw = {"self_buf": c["slf"]}
    if form.startswith("sparse"):
        return kw
    kw["scales"] = c["sc"]
    if form.startswith("qm"):
        kw.update(mom_neighbors=c["mq"], mom_scales=c["msc"])
    return kw


def _oracle_case(form, kind, rows) -> dict:
    """Inputs and Pallas-interpret outputs of one case (JAX arrays): the
    operands, and ``<family>.<i>`` for output ``i`` of each family."""
    rng = np.random.default_rng(rows + len(kind) + len(form))
    c = _inputs(form, kind, rows, rng)
    kw = _kwargs(form, c)
    out = {k: v for k, v in c.items() if v is not None and k != "nb"}
    if form.startswith("sparse"):
        out.update(vals=c["nb"].values, idx=c["nb"].indices, ssc=c["nb"].scales)
    else:
        out["nb"] = c["nb"]
    for fam in FORM_FAMILIES.get(form, FAMILIES):
        res = JFLAT[fam](c["nb"], jnp.asarray(c["w"]), *[c[k] for k in STATE[fam]],
                         *SCALARS[fam], interpret=True, **kw)
        for i, r in enumerate(res if isinstance(res, tuple) else (res,)):
            out[f"{fam}.{i}"] = r
    return out


def write_oracle(path: str) -> None:
    """Every case's arrays into one npz: ``<case>/<name>`` as raw bytes and
    ``<case>/<name>.dtype`` as the dtype's name."""
    arrays = {}
    for name, form, kind, rows in CASES:
        for k, a in _oracle_case(form, kind, rows).items():
            a = np.asarray(a)
            arrays[f"{name}/{k}"] = a.view(_RAW.get(a.dtype.name, a.dtype))
            arrays[f"{name}/{k}.dtype"] = np.asarray(a.dtype.name)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX side, computed once in a subprocess without FMA."""
    path = str(tmp_path_factory.mktemp("oracle") / "bf16_updates.npz")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA).strip())
    subprocess.run([sys.executable, __file__, path], env=env, cwd=str(root),
                   check=True, timeout=600)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _case(oracle, name) -> dict:
    """One case's arrays as tensors (bf16 / fp8 bit for bit)."""
    out = {}
    for key, a in oracle.items():
        case, _, k = key.partition("/")
        if case != name or k.endswith(".dtype"):
            continue
        dt = str(oracle[f"{key}.dtype"])
        t = torch.from_numpy(np.array(a, copy=True))
        out[k] = t.view(getattr(torch, dt)) if dt in _RAW else t
    return out


def _check_family(c, form, fam, name) -> None:
    """The port's flat entry point on the case's operands (the plain
    version, in place) against the Pallas outputs, every output bit for
    bit."""
    if form.startswith("sparse"):
        nb = tops.SparseNeighbors(c["vals"], c["idx"], c["ssc"])
    else:
        nb = c["nb"]
    kw = _kwargs(form, c)
    state = [c[k].clone() for k in STATE[fam]]
    got = TFLAT[fam](nb, c["w"], *state, *SCALARS[fam], **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert got[0].data_ptr() == state[0].data_ptr()       # in place
    n_out = sum(k.startswith(f"{fam}.") for k in c)
    assert len(got) == n_out
    for i, t in enumerate(got):
        assert t.dtype == torch.bfloat16
        _assert_bits(t, c[f"{fam}.{i}"], f"{fam} output {i} {name}")


BASE = [c for c in CASES if c[1] in ("dense", "q", "stencil")]
OTHER = [c for c in CASES if c[1] in ("dense", "q", "stencil", "dense-stencil")]
QM = [c for c in CASES if c[1].startswith("qm")]
SPARSE = [c for c in CASES if c[1].startswith("sparse")]


@pytest.mark.parametrize("name,form,kind,rows", BASE, ids=_ids(BASE))
def test_bf16_bucket_matches_pallas_bitwise(oracle, name, form, kind, rows):
    """Dense: ``weights (A, A)`` = the ring's ``Pi``, the whole bf16 stack
    (or its float32 widening) as the neighbours.  ``_q``: ``[diag(Pi) |
    zero-diag Pi]``, every agent's int8 / fp8 / bf16 payload.  Stencil: one
    agent's ``(S+1,)`` row.  bf16 self, grad and momentum throughout:
    CDSGD, and CDMSGD's params and momentum."""
    c = _case(oracle, name)
    for fam in ("cdsgd", "cdmsgd"):
        _check_family(c, form, fam, name)
    print(f"bf16 bucket {name}: cdsgd / cdmsgd (params, momentum) bit for bit")


@pytest.mark.parametrize("name,form,kind,rows", OTHER, ids=_ids(OTHER))
def test_bf16_bucket_nesterov_adam_match_pallas_bitwise(oracle, name, form,
                                                        kind, rows):
    """Nesterov (params, momentum, the lookahead ``x' + mu v'`` from the
    unrounded float32 ``x'`` and ``v'``) and CDAdam (params, both moments;
    the step from the unrounded ``m'``, ``v'``) on the dense, ``_q`` and
    stencil cases, and on one agent's dense ``(S,)`` stencil."""
    c = _case(oracle, name)
    for fam in ("cdmsgd_nesterov", "cdadam"):
        _check_family(c, form, fam, name)
    if form == "dense-stencil":
        for fam in ("cdsgd", "cdmsgd"):
            _check_family(c, form, fam, name)
    print(f"bf16 bucket {name}: nesterov / cdadam, every output bit for bit")


@pytest.mark.parametrize("name,form,kind,rows", QM, ids=_ids(QM))
def test_bf16_bucket_qm_forms_match_pallas_bitwise(oracle, name, form, kind,
                                                   rows):
    """The mixed-momentum forms: the bf16 momentum (CDAdam: first moment)
    is the self tile of its own int8 / fp8 / bf16 payload, mixed with the
    parameters' weights; CDMSGD, Nesterov and CDAdam, stacked and as one
    agent's stencil."""
    c = _case(oracle, name)
    for fam in FORM_FAMILIES[form]:
        _check_family(c, form, fam, name)
    print(f"bf16 bucket {name}: _qm cdmsgd / nesterov / cdadam bit for bit")


@pytest.mark.parametrize("name,form,kind,rows", SPARSE, ids=_ids(SPARSE))
def test_bf16_bucket_sparse_forms_match_pallas_bitwise(oracle, name, form,
                                                       kind, rows):
    """The sparse (top-k wire) forms of all four families: bf16 self, grad
    and state, int8 compact neighbours with float32 row scales scattered in
    stencil order; stacked ``(A, A+1)`` and as one agent's stencil."""
    c = _case(oracle, name)
    for fam in FAMILIES:
        _check_family(c, form, fam, name)
    print(f"bf16 bucket {name}: the four sparse forms bit for bit")


@functools.lru_cache(maxsize=None)
def _jit_quantize(exchange):
    qmax = {"int8": 127.0, "fp8": 448.0}[exchange]
    qdtype = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[exchange]
    if exchange == "int8":
        return jax.jit(lambda x, u: _quantize_math(x.astype(jnp.float32), u,
                                                   qmax, qdtype))
    return jax.jit(lambda x: _quantize_math(x.astype(jnp.float32), None,
                                            qmax, qdtype))


@pytest.mark.parametrize("exchange", ["int8", "fp8"])
@pytest.mark.parametrize("rows", ROWS)
def test_sr_quantize_bf16_bucket_matches_quantize_math(exchange, rows):
    """The wrapper on a bf16 ``(A, rows, 128)`` bucket (the CPU path: the
    plain version, Philox uniforms) against JAX's ``_quantize_math`` of the
    bucket widened to float32, with the same uniforms: codes and scales
    bit for bit; and equal to the wrapper on the float32 widening."""
    rng = np.random.default_rng(rows)
    x = _bf16(rng, (A, rows, 128))
    x = x.at[:, 0].set(0)                        # an all-zero row: scale 1.0
    xt = _to_torch(x)
    seed, stride = 12345, 104729
    q, sc = cu.sr_quantize(xt, seed, exchange, agent_stride=stride)
    assert q.dtype == ref.QDTYPE[exchange] and sc.dtype == torch.float32
    for a in range(A):
        if exchange == "int8":
            u = ref.uniforms(ref.as_int32(seed + stride * a), (rows, 128))
            jq, jsc = _jit_quantize(exchange)(x[a], jnp.asarray(u.numpy()))
        else:
            jq, jsc = _jit_quantize(exchange)(x[a])
        _assert_bits(q[a], jq, f"sr_quantize {exchange} agent {a} codes")
        _assert_bits(sc[a], jsc, f"sr_quantize {exchange} agent {a} scales")
    qf, scf = cu.sr_quantize(xt.float(), seed, exchange, agent_stride=stride)
    assert np.array_equal(_bits(q), _bits(qf))
    assert np.array_equal(_bits(sc), _bits(scf))


def _ring_weights(q_form: bool) -> np.ndarray:
    pi = jtopo.make_topology("ring", A).pi
    w = jcons._self_separated_weights(pi) if q_form else pi
    return np.asarray(w, np.float32)


def test_bf16_bucket_operands_must_agree():
    """One bucket type: a bf16 grad with a float32 momentum, second moment
    or self buffer is refused, as is a float16 grad."""
    rows = 8
    w = torch.full((A, A), 1.0 / A)
    x = torch.randn(A, rows, 128)
    g = torch.randn(A, rows, 128).bfloat16()
    with pytest.raises(TypeError, match="momentum must be torch.bfloat16"):
        cu.cdmsgd_update(w, x, g, torch.zeros(A, rows, 128), ALPHA, MU)
    wq = torch.from_numpy(_ring_weights(True))
    q = torch.zeros(A, rows, 128, dtype=torch.int8)
    with pytest.raises(TypeError, match="self_buf must be torch.bfloat16"):
        cu.cdsgd_update_q(wq, torch.zeros(A, rows, 128), q,
                          torch.ones(A, rows, 1), g, ALPHA)
    with pytest.raises(TypeError, match="v must be torch.bfloat16"):
        cu.cdadam_update(w, x, g, torch.zeros_like(g), torch.zeros(A, rows, 128),
                         ALPHA, *ADAM)
    vals = torch.zeros(A, 1, 128, dtype=torch.int8)
    idx = torch.arange(128, dtype=torch.int32).expand(A, 1, 128).contiguous()
    with pytest.raises(TypeError, match="self_buf must be torch.bfloat16"):
        cu.cdsgd_update_sparse(wq, torch.zeros(A, rows, 128), vals, idx,
                               torch.ones(A, 1, 1), g, ALPHA)
    with pytest.raises(TypeError, match="float32"):
        cu.cdsgd_update(w, x, g.half(), ALPHA)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        cu.sr_quantize(x.half(), 0, "int8")


if __name__ == "__main__":
    write_oracle(sys.argv[1])
