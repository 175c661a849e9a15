"""Port parity: bfloat16 parameter buckets in the fused update and the wire
quantizer, against the Pallas kernels.

The model zoo's parameters are bfloat16, so their packed bucket, its
gradient, momentum and (``_q`` form) native self tile are bfloat16.  The
Pallas kernels ``cdsgd_update_2d`` / ``cdmsgd_update_2d`` widen them to
float32, compute the float32 expression and store into the bucket's dtype;
the port's plain versions (the CPU path of the wrappers, what the CUDA
kernels are held against on the card) do the same float32 operations in
the same order and round each output once to bfloat16.  So the forms match
**bit for bit**: the dense form (bf16 neighbours, and float32 neighbours),
and the ``_q`` form with int8, fp8 and bf16 payloads, at ``A = S = 4`` on
a ring's ``Pi`` and a ragged row count, in the stacked ``(A, A+1)`` and
the one-agent stencil forms.

The Pallas kernels run in interpret mode in a subprocess whose XLA
compiles for the CPU without FMA instructions (``--xla_cpu_max_isa=AVX``):
XLA fuses the kernel body into one loop and lets LLVM contract a multiply
and an add into an FMA where it chooses, which moves a float32 result by an
ulp now and then (the float32 parity tests allow 1e-6 for it) and so, at a
bf16 rounding boundary, a bf16 output by one bf16 ulp.  The kernels
themselves (and the CUDA kernels, with ``_rn`` intrinsics) round every
multiply and add.  Inputs are drawn with numpy in the subprocess; it
returns them with the outputs as raw bytes.

``sr_quantize`` of a bfloat16 bucket is held through ``_quantize_math
(x.astype(f32), u, ...)`` with the same uniforms, bit for bit.  The
Nesterov, CDAdam, ``_qm`` and sparse forms refuse a bfloat16 bucket with a
``TypeError`` naming their ROADMAP item, before any work.
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
from repro.kernels.consensus_update.consensus_update import (  # noqa: E402
    _quantize_math,
    cdmsgd_update_2d,
    cdsgd_update_2d,
    sr_quantize_2d,
)
from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402

A = 4
ALPHA, MU = 0.05, 0.9
ROWS = (37, 261)                 # ragged (not a multiple of 8) and larger
#: the JAX oracle's XLA flag: no FMA instructions, so no contraction
NO_FMA = "--xla_cpu_max_isa=AVX"
#: (name, form, operand kind, rows): the oracle's cases
CASES = ([(f"dense-{k}-{r}", "dense", k, r) for k in ("bf16", "f32") for r in ROWS]
         + [(f"q-{k}-{r}", "q", k, r) for k in ("int8", "fp8", "bf16")
            for r in ROWS]
         + [(f"stencil-{k}", "stencil", k, 37) for k in ("int8", "bf16")])
_RAW = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}


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
    """A wire payload stack ``(S, rows, 128)`` and its scales."""
    x = _bf16(rng, shape)
    if kind in ("int8", "fp8"):
        qs = [sr_quantize_2d(x[i].astype(jnp.float32), i, exchange=kind,
                             interpret=True) for i in range(shape[0])]
        return jnp.stack([q for q, _ in qs]), jnp.stack([sc for _, sc in qs])
    if kind == "f32":
        return x.astype(jnp.float32), None
    return x, jnp.ones(shape[:-1] + (1,), jnp.float32)


def _ring_weights(q_form: bool) -> np.ndarray:
    pi = jtopo.make_topology("ring", A).pi
    w = jcons._self_separated_weights(pi) if q_form else pi
    return np.asarray(w, np.float32)


def _oracle_case(form, kind, rows) -> dict:
    """Inputs and Pallas-interpret outputs of one case (JAX arrays)."""
    rng = np.random.default_rng(rows + len(kind) + len(form))
    if form == "stencil":
        s = 3
        w = rng.random(s + 1).astype(np.float32)
        w /= w.sum()
        q, sc = _payload(kind, rng, (s, rows, 128))
        slf, g, v = (_bf16(rng, (rows, 128)) for _ in range(3))
        kw = dict(scales=sc, self_buf=slf, alias=False, interpret=True)
        out = cdsgd_update_2d(q, jnp.asarray(w), g, ALPHA, **kw)
        p, nv = cdmsgd_update_2d(q, jnp.asarray(w), g, v, ALPHA, MU, **kw)
        return dict(w=w, q=q, sc=sc, slf=slf, g=g, v=v, out=out, p=p, nv=nv)
    pi = jtopo.make_topology("ring", A).pi
    if form == "dense":
        w = np.asarray(pi, np.float32)
        x, _ = _payload(kind, rng, (A, rows, 128))
        g, v = _bf16(rng, (A, rows, 128)), _bf16(rng, (A, rows, 128))
        out = jops.cdsgd_update_flat(x, jnp.asarray(w), g, ALPHA, interpret=True)
        p, nv = jops.cdmsgd_update_flat(x, jnp.asarray(w), g, v, ALPHA, MU,
                                        interpret=True)
        return dict(w=w, q=x, g=g, v=v, out=out, p=p, nv=nv)
    w = np.asarray(jcons._self_separated_weights(pi), np.float32)
    q, sc = _payload(kind, rng, (A, rows, 128))
    slf, g, v = (_bf16(rng, (A, rows, 128)) for _ in range(3))
    kw = dict(scales=sc, self_buf=slf, interpret=True)
    out = jops.cdsgd_update_flat(q, jnp.asarray(w), g, ALPHA, **kw)
    p, nv = jops.cdmsgd_update_flat(q, jnp.asarray(w), g, v, ALPHA, MU, **kw)
    return dict(w=w, q=q, sc=sc, slf=slf, g=g, v=v, out=out, p=p, nv=nv)


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


@pytest.mark.parametrize("name,form,kind,rows", CASES,
                         ids=[c[0] for c in CASES])
def test_bf16_bucket_matches_pallas_bitwise(oracle, name, form, kind, rows):
    """Dense: ``weights (A, A)`` = the ring's ``Pi``, the whole bf16 stack
    (or its float32 widening) as the neighbours.  ``_q``: ``[diag(Pi) |
    zero-diag Pi]``, every agent's int8 / fp8 / bf16 payload.  Stencil: one
    agent's ``(S+1,)`` row.  bf16 self, grad and momentum throughout."""
    c = _case(oracle, name)
    w = c["w"]
    kw = {} if form == "dense" else dict(scales=c["sc"], self_buf=c["slf"])
    g = c["g"].clone()
    to = tops.cdsgd_update_flat(c["q"], w, g, ALPHA, **kw)
    assert to.data_ptr() == g.data_ptr()                 # in place
    tp, tv = tops.cdmsgd_update_flat(c["q"], w, c["g"].clone(), c["v"].clone(),
                                     ALPHA, MU, **kw)
    _assert_bits(to, c["out"], f"cdsgd {name}")
    _assert_bits(tp, c["p"], f"cdmsgd params {name}")
    _assert_bits(tv, c["nv"], f"cdmsgd momentum {name}")
    print(f"bf16 bucket {name}: cdsgd / cdmsgd (params, momentum) bit for bit")


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


def _refusal_cases(w, wq, x, slf, q, sc, g, m, v, vals, idx, ssc):
    return {
        "cdmsgd_nesterov_update": lambda: cu.cdmsgd_nesterov_update(
            w, x, g, m, ALPHA, MU),
        "cdmsgd_nesterov_update_q": lambda: cu.cdmsgd_nesterov_update_q(
            wq, slf, q, sc, g, m, ALPHA, MU),
        "cdadam_update": lambda: cu.cdadam_update(
            w, x, g, m, v, ALPHA, 0.9, 0.999, 1e-8, 0.1, 0.001),
        "cdadam_update_q": lambda: cu.cdadam_update_q(
            wq, slf, q, sc, g, m, v, ALPHA, 0.9, 0.999, 1e-8, 0.1, 0.001),
        "cdmsgd_update_qm": lambda: cu.cdmsgd_update_qm(
            wq, slf, q, sc, q, sc, g, m, ALPHA, MU),
        "cdmsgd_update_sparse": lambda: cu.cdmsgd_update_sparse(
            wq, slf, vals, idx, ssc, g, m, ALPHA, MU),
        "cdsgd_update_sparse": lambda: cu.cdsgd_update_sparse(
            wq, slf, vals, idx, ssc, g, ALPHA),
    }


REFUSING = ["cdmsgd_nesterov_update", "cdmsgd_nesterov_update_q",
            "cdadam_update", "cdadam_update_q", "cdmsgd_update_qm",
            "cdmsgd_update_sparse", "cdsgd_update_sparse"]


@pytest.mark.parametrize("name", REFUSING)
def test_other_forms_refuse_a_bf16_bucket(name):
    """A bf16 bucket given to Nesterov, CDAdam, ``_qm`` or the sparse forms
    raises a TypeError naming ROADMAP A21, and nothing was written."""
    rows = 8
    bf = torch.bfloat16
    w = torch.full((A, A), 1.0 / A)
    wq = torch.from_numpy(_ring_weights(True))
    x = torch.randn(A, rows, 128).to(bf)
    slf, g, m, v = (torch.randn(A, rows, 128).to(bf) for _ in range(4))
    q = torch.randint(-127, 128, (A, rows, 128), dtype=torch.int8)
    sc = torch.ones(A, rows, 1)
    vals = torch.randint(-127, 128, (A, 1, 128), dtype=torch.int8)
    idx = torch.arange(128, dtype=torch.int32).expand(A, 1, 128).contiguous()
    ssc = torch.ones(A, 1, 1)
    before = [t.clone() for t in (g, m, v)]
    call = _refusal_cases(w, wq, x, slf, q, sc, g, m, v, vals, idx, ssc)[name]
    with pytest.raises(TypeError, match="ROADMAP A21"):
        call()
    for t, b in zip((g, m, v), before):
        assert torch.equal(t, b)


def test_bf16_bucket_operands_must_agree():
    """One bucket type: a bf16 grad with a float32 momentum or self buffer
    is refused, as is a float16 grad."""
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
    with pytest.raises(TypeError, match="float32"):
        cu.cdsgd_update(w, x, g.half(), ALPHA)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        cu.sr_quantize(x.half(), 0, "int8")


if __name__ == "__main__":
    write_oracle(sys.argv[1])
