"""Port parity: the whole slice, one trainer step at a time, against JAX.

The ``benchmarks/common.py`` MLP setup (6x50 ReLU MLP on 64-dim synthetic
data, 5 agents, fully connected, lr 0.05, batch 64), trained by fused CDSGD
and CDMSGD in both packages on the quantized wires: {bf16, fp8} x {sync,
overlap}, and int8 x {sync, overlap} x {EF off, on}, with the JAX
package's uniforms patched into the port for int8 (``ref.uniforms``).

Free-running trajectories of lossy wires part after the first rounding
flip: a ~6e-7 backward-order gap moves a value across an fp8 / bf16
rounding boundary now and then, and each flip moves a parameter by up to
one quantization step times a weight.  So the test is "teacher-forced":
at every step the JAX trainer's state (params, momentum, wire, residual)
is loaded into the port, both take one step on the same batch, and

* the wire codes and scales are equal bit for bit (the wire the sync step
  quantizes from the loaded params, and the new carried wire of overlap);
* the new error-feedback residual is within 1e-6;
* the params are within 1e-5.

Every configuration runs 5 steps; int8 overlap with EF and fp8 sync run
20 (the runtime budget of one test file).  ``pytest -s`` prints the gaps.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_topology as jmake_topology  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.data import AgentPartitioner as JPartitioner  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch.core import make_optimizer, make_topology  # noqa: E402
from repro_torch.core.optim import OptState  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import AgentPartitioner, make_classification  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

PARAM_ATOL = 1e-5
RESIDUAL_ATOL = 1e-6
LONG = {("int8", "overlap", True), ("fp8", "sync", False)}
CONFIGS = [("bf16", "sync", False), ("bf16", "overlap", False),
           ("fp8", "sync", False), ("fp8", "overlap", False),
           ("int8", "sync", False), ("int8", "sync", True),
           ("int8", "overlap", False), ("int8", "overlap", True)]


def _to_torch(a):
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bytes(t) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _wire_to_torch(wire):
    return tuple((_to_torch(p), _to_torch(s)) for p, s in wire)


def _assert_wire_equal(tw, jw):
    assert len(tw) == len(jw)
    for (tp, ts), (jp, js) in zip(tw, _wire_to_torch(jw)):
        assert tp.dtype == jp.dtype and tp.shape == jp.shape
        np.testing.assert_array_equal(_bytes(tp), _bytes(jp))
        np.testing.assert_array_equal(_bytes(ts), _bytes(js))


def _max_gap(ts, js) -> float:
    return max([float((t.float() - _to_torch(j).float()).abs().max())
                for t, j in zip(ts, js)], default=0.0)


@functools.lru_cache(maxsize=None)
def _jax_uniform_fn(shape):
    return jax.jit(lambda s: jax.random.uniform(jax.random.PRNGKey(s), shape,
                                                jnp.float32))


def jax_uniforms(seed, shape, device=None):
    """The uniforms the JAX package draws on the CPU for one agent's bucket."""
    return _to_torch(_jax_uniform_fn(tuple(shape))(jnp.int32(seed)))


@pytest.fixture(scope="module")
def setup():
    train, _ = make_classification(4096, n_classes=10, dim=64, seed=0)
    jp = jinit(jpm.mlp_classifier_template(64, 10, width=50, depth=6),
               jax.random.PRNGKey(0))
    return train, jp


def _load_jax_state(tt, jt):
    """The JAX trainer's state, copied into the port's trainer."""
    js, o = jt.state, jt.state.opt_state
    tt.state = TrainState(
        params=params_from_numpy(jax.tree.map(np.asarray, js.params), "cpu"),
        opt_state=OptState(
            step=int(o.step),
            inner=params_from_numpy(jax.tree.map(np.asarray, o.inner), "cpu"),
            wire=_wire_to_torch(o.wire),
            residual=tuple(_to_torch(r) for r in o.residual)),
        step=js.step)


@pytest.mark.parametrize("exchange,schedule,ef", CONFIGS,
                         ids=[f"{e}-{s}{'-ef' if f else ''}"
                              for e, s, f in CONFIGS])
@pytest.mark.parametrize("name,kw", [("cdsgd", {}), ("cdmsgd", {"mu": 0.9})])
def test_teacher_forced_steps_match_jax(setup, monkeypatch, name, kw,
                                        exchange, schedule, ef):
    train, jp = setup
    if exchange == "int8":
        monkeypatch.setattr(ref, "uniforms", jax_uniforms)
    knobs = dict(exchange=exchange, schedule=schedule, error_feedback=ef)
    jt = JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                  jp, jmake_topology("fully_connected", 5),
                  jmake_optimizer(name, 0.05, fused=True, **kw), **knobs)
    tt = CollaborativeTrainer(
        functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        make_topology("fully_connected", 5),
        make_optimizer(name, 0.05, fused=True, **kw), device="cpu", **knobs)
    jfl, tfl = jt.comm.flat, tt.comm.flat
    if schedule == "overlap":
        # the overlap wire at init: x_0 quantized at seed -1.  The JAX
        # trainer builds it eagerly, where the scale is a true division
        # amax / qmax; compiled (every step after), XLA multiplies by
        # f32(1 / qmax), which the port follows.  So the port's init wire is
        # held against the compiled form of the same stage.
        j0 = jt.state.params
        _assert_wire_equal(tt.state.opt_state.wire, jax.jit(
            jfl.strategy.initial_wire)(jfl.pack(j0, jfl.spec(j0))))
    jb = JPartitioner(train, 5, seed=0).batches(64)
    tb = AgentPartitioner(train, 5, seed=0).batches(64)
    steps = 20 if (exchange, schedule, ef) in LONG else 5
    gaps = {"param": 0.0, "residual": 0.0}
    # compiled, as inside the JAX trainer's step
    j_quantize = jax.jit(jfl.strategy.quantize_stage)
    j_quantize_ef = jax.jit(jfl.strategy.quantize_ef)
    for i in range(steps):
        _load_jax_state(tt, jt)
        if schedule == "sync":
            # the wire this step quantizes from the (shared) current params
            jbufs = jfl.pack(jt.state.params, jfl.spec(jt.state.params))
            tbufs = tfl.pack(tt.state.params, tfl.spec(tt.state.params))
            if ef:
                jw, jr = j_quantize_ef(jbufs, jnp.int32(i),
                                       jt.state.opt_state.residual)
                tw, tr = tfl.strategy.quantize_ef(
                    tbufs, i, tt.state.opt_state.residual)
                gaps["residual"] = max(gaps["residual"], _max_gap(tr, jr))
            else:
                jw = j_quantize(jbufs, jnp.int32(i))
                tw = tfl.strategy.quantize_stage(tbufs, i)
            _assert_wire_equal(tw, jw)
        batch = next(jb)
        next(tb)
        mj, mt = jt.step(batch), tt.step(batch)
        assert abs(mj["loss"] - mt["loss"]) <= 1e-4, (i, mj, mt)
        gaps["param"] = max(gaps["param"], max(
            float(np.max(np.abs(np.asarray(a) - b.numpy())))
            for a, b in zip(jax.tree.leaves(jt.state.params),
                            tree_leaves(tt.state.params))))
        _assert_wire_equal(tt.state.opt_state.wire, jt.state.opt_state.wire)
        gaps["residual"] = max(gaps["residual"], _max_gap(
            tt.state.opt_state.residual, jt.state.opt_state.residual))
    print(f"{name} {exchange} {schedule}{' EF' if ef else ''}: {steps} "
          f"teacher-forced steps, wire bitwise, max param gap "
          f"{gaps['param']:.2e}, max residual gap {gaps['residual']:.2e}")
    assert gaps["param"] <= PARAM_ATOL
    assert gaps["residual"] <= RESIDUAL_ATOL
    assert tt.wire_bytes_per_step == jt.wire_bytes_per_step
