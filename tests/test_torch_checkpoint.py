"""Port parity: checkpoints cross between the packages, in both directions.

The port's ``repro_torch.checkpoint`` writes the JAX package's npz format
key for key (``params::...``, ``opt_state::.step``, ``opt_state::.inner::
...``, ``opt_state::.wire::0::0``, bf16 / fp8 leaves as raw ``uint8``,
``step`` a 0-d int32), so

* the port restores a train state written by the JAX trainer and takes the
  same next step (params within the trainer parity bound, 1e-5), and the
  JAX trainer restores a state the port wrote and takes the same next step
  as the port, for the f32 sync, int8 overlap, fp8 sync, int8 overlap with
  error feedback, ``rank:4`` (error feedback) and staleness-ring (depth 2
  under faults) programs of fused CDMSGD (mirroring
  ``tests/test_data_checkpoint.py``): the restored wire, residual, warm
  start and ring state are the writer's bit for bit;
* the two packages write the same key set, dtypes and shapes for the same
  configuration;
* a params-only checkpoint against a stateful template raises ``KeyError``
  (in both directions), a shape mismatch ``ValueError``.

Mirrors ``tests/test_data_checkpoint.py:75-176``.  ``pytest -s`` prints
the gaps.
"""

import functools
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.checkpoint.checkpoint import _path_str as j_path_str  # noqa: E402
from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core.consensus import WireRing as JWireRing  # noqa: E402
from repro.core import make_topology as jmake_topology  # noqa: E402
from repro.core.optim import OptState as JOptState  # noqa: E402
from repro.core.trainer import CollaborativeTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainState as JTrainState  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn.param import init_params as jinit  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core import make_optimizer, make_topology  # noqa: E402
from repro_torch.core.consensus import WireRing  # noqa: E402
from repro_torch.core.optim import OptState  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

A = 4
LR, MU = 5e-3, 0.9
PARAM_TOL = 1e-5
PROGRAMS = {
    "f32-sync": dict(),
    "int8-overlap": dict(exchange="int8", schedule="overlap"),
    "fp8-sync": dict(exchange="fp8"),
    "int8-overlap-ef": dict(exchange="int8", schedule="overlap",
                            error_feedback=True),
    "rank4-ef": dict(compressor="rank:4", error_feedback=True),
    "ring-depth2": dict(exchange="int8", schedule="overlap", staleness=2,
                        fault_schedule="straggler:1:1"),
}


@pytest.fixture(scope="module")
def setup():
    jp = jinit(jpm.mlp_classifier_template(8, 4, width=16, depth=2),
               jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((A, 8, 8)).astype(np.float32),
             "y": rng.integers(0, 4, (A, 8)).astype(np.int32)}
    return jp, batch


def _jax_trainer(jp, knobs):
    return JTrainer(functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply),
                    jp, jmake_topology("ring", A),
                    jmake_optimizer("cdmsgd", LR, mu=MU, fused=True),
                    donate=False, **knobs)


def _port_trainer(jp, knobs):
    return CollaborativeTrainer(
        functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        make_topology("ring", A), make_optimizer("cdmsgd", LR, mu=MU, fused=True),
        device="cpu", **knobs)


def _np(x):
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float8_e4m3fn)
                else t).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype.name in ("bfloat16", "float8_e4m3fn") else x


def _param_gap(tp, jp) -> float:
    return max(float(np.max(np.abs(_np(t) - _np(j))))
               for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)))


def _assert_state_equal(t_state, j_state):
    """Every opt-state leaf (step, momentum, wire, residual, qwarm, ring)
    equal, value for value."""
    tl, jl = tree_leaves(t_state), jax.tree.leaves(j_state)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_checkpoints_cross_both_ways(setup, tmp_path, program):
    jp, batch = setup
    knobs = PROGRAMS[program]
    jb = jax.tree.map(jnp.asarray, batch)
    # the JAX package writes, the port restores and steps
    jtr = _jax_trainer(jp, knobs)
    for _ in range(3):
        jtr.step(jb)
    jdir = str(tmp_path / "jax")
    jckpt.save_train_state(jdir, 3, jtr.state.params, jtr.state.opt_state)
    ttr = _port_trainer(jp, knobs)
    p0, o0 = tckpt.restore_train_state(jdir, ttr.state.params, ttr.state.opt_state)
    assert isinstance(o0.step, int) and o0.step == 3
    _assert_state_equal(o0, jtr.state.opt_state)
    ttr.state = TrainState(params=p0, opt_state=o0, step=o0.step)
    ttr.step(batch)
    jtr.step(jb)
    gap_in = _param_gap(ttr.state.params, jtr.state.params)
    # the port writes, the JAX package restores and steps
    ttr2 = _port_trainer(jp, knobs)
    for _ in range(3):
        ttr2.step(batch)
    tdir = str(tmp_path / "port")
    tckpt.save_train_state(tdir, 3, ttr2.state.params, ttr2.state.opt_state)
    jp0, jo0 = jckpt.restore_train_state(tdir, jtr.state.params, jtr.state.opt_state)
    assert int(jo0.step) == 3
    _assert_state_equal(ttr2.state.opt_state, jo0)
    jtr.state = JTrainState(params=jp0, opt_state=jo0, step=3)
    jtr.step(jb)
    ttr2.step(batch)
    gap_out = _param_gap(ttr2.state.params, jtr.state.params)
    # one format: the same keys, dtypes and shapes
    with np.load(f"{jdir}/ckpt_00000003.npz") as a, \
            np.load(f"{tdir}/ckpt_00000003.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a["opt_state::.step"].shape == () and \
            a["opt_state::.step"].dtype == np.int32
        keys = sorted(a.files)
    print(f"checkpoint {program}: next-step param gaps JAX->port {gap_in:.2e}, "
          f"port->JAX {gap_out:.2e}; {len(keys)} keys, e.g. {keys[-3:]}")
    assert gap_in <= PARAM_TOL and gap_out <= PARAM_TOL


class _Pair(NamedTuple):
    first: object
    second: object


def test_path_keys_are_the_jax_packages():
    """Dict keys (sorted), list / tuple indices, ``.field`` of a named
    tuple, ``None`` and ``()`` empty: the keys of JAX's path walk."""
    tree = {"params": {"w": np.zeros(2), "b": [np.zeros(1), (np.zeros(1),)]},
            "opt_state": JOptState(step=np.int32(0), inner=(),
                                   wire=((np.zeros(1), np.zeros(1)),),
                                   residual=None, qwarm=_Pair(np.zeros(1), ()))}
    jkeys = [j_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    ttree = dict(tree, opt_state=OptState(*tree["opt_state"]))
    tkeys = ["::".join(map(str, p)) for p, _ in tree_flatten_with_path(ttree)]
    assert tkeys == jkeys
    assert "opt_state::.wire::0::0" in tkeys and "opt_state::.qwarm::.first" in tkeys


def test_roundtrip_dtypes_and_errors(tmp_path):
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": torch.ones(3, dtype=torch.bfloat16),
                       "q": torch.tensor([[0.5, -2.0]]).to(torch.float8_e4m3fn)},
            "opt_state": OptState(step=7, inner=(torch.zeros(2),),
                                  wire=WireRing(slots=((torch.ones(1, 2, 128,
                                                                   dtype=torch.int8),
                                                        torch.ones(1, 2, 1)),),
                                                send_age=torch.zeros(1, dtype=torch.int32),
                                                ages=torch.zeros(1, 1, dtype=torch.int32)))}
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, 7, tree)
    tckpt.save_checkpoint(d, 12, tree)
    assert tckpt.latest_step(d) == 12
    with np.load(f"{d}/ckpt_00000012.npz") as data:
        assert data["params::b"].dtype == np.uint8 and data["params::b"].shape == (6,)
        assert data["params::q"].dtype == np.uint8
        assert data["opt_state::.step"].dtype == np.int32
        assert "opt_state::.wire::.slots::0::0" in data.files
    back = tckpt.restore_checkpoint(d, tree)
    assert back["opt_state"].step == 7 and isinstance(back["opt_state"].step, int)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                                      b.view(torch.uint8))
    # the JAX package reads the port's file (bf16 through its raw bytes)
    jtree = jckpt.restore_checkpoint(d, {"params": {
        "w": jnp.zeros((2, 3)), "b": jnp.zeros(3, jnp.bfloat16),
        "q": jnp.zeros((1, 2), jnp.float8_e4m3fn)}, "opt_state": JOptState(
            step=jnp.int32(0), inner=(jnp.zeros(2),),
            wire=JWireRing(slots=((jnp.zeros((1, 2, 128), jnp.int8),
                                   jnp.zeros((1, 2, 1))),),
                           send_age=jnp.zeros(1, jnp.int32),
                           ages=jnp.zeros((1, 1), jnp.int32)))})
    assert int(jtree["opt_state"].step) == 7
    np.testing.assert_array_equal(np.asarray(jtree["params"]["b"], np.float32),
                                  np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(d, {**tree, "params": {**tree["params"],
                                                        "w": torch.zeros(3, 3)}})
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), tree)


def test_params_only_checkpoint_rejected_by_stateful_template(tmp_path):
    """A params-only checkpoint cannot silently restore into a stateful
    trainer: the wire keys are missing and restore fails loudly, whichever
    package wrote it."""
    stateful = OptState(step=0, inner=(),
                        wire=((torch.zeros(4, 1, 128, dtype=torch.int8),
                               torch.ones(4, 1, 1)),))
    params = {"w": torch.zeros(4, 2)}
    d = str(tmp_path / "port")
    tckpt.save_checkpoint(d, 0, {"params": params, "opt_state": OptState(0, ())})
    with pytest.raises(KeyError, match="opt_state::.wire::0::0"):
        tckpt.restore_train_state(d, params, stateful)
    jd = str(tmp_path / "jax")
    jparams = {"w": jnp.zeros((4, 2))}
    jckpt.save_checkpoint(jd, 0, {"params": jparams,
                                  "opt_state": JOptState(jnp.int32(0), ())})
    with pytest.raises(KeyError):
        tckpt.restore_train_state(jd, params, stateful)
    with pytest.raises(KeyError):
        jckpt.restore_train_state(d, jparams, JOptState(
            jnp.int32(0), (), wire=((jnp.zeros((4, 1, 128), jnp.int8),
                                     jnp.ones((4, 1, 1))),)))
