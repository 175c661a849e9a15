"""Port parity: collaborative LM training (the model zoo's training path,
``repro_torch.launch.train``) against the JAX package.

* The training attention and WKV, in float32, values and gradients
  (``jax.grad`` against ``torch.autograd`` of ``sum(out * cotangent)``):
  ``blockwise_attention`` (global, and a window over a ragged length, whose
  KV chunks are padded), ``banded_attention`` (static window) and the
  ``gqa_attention(differentiable=True)`` dispatch between them, at GQA
  groups 1 and 4; ``wkv6_chunked`` (and the ``rwkv6_time_mix`` dispatch to
  it at ``s >= 64``).  Values within 1e-6 of max |out|, gradients within
  1e-5 of max |grad|.  The WKV decays lie in the model's range (0.15 ..
  0.9): for decays below about 1e-9 the chunked form's gradient in ``w``
  is ill-conditioned in float32 in both packages alike (each about 1e3
  relative from a float64 step-by-step scan).
* The small pieces: ``make_grad_phase(microbatches=2)`` within 1e-6;
  ``lm_agent_batches`` identical arrays; the schedules; ``CSVLogger``'s
  file; the tree arithmetic; ``perturb_per_agent`` (its arithmetic on the
  JAX package's noise; its own stream statistically).
* The slice: the JAX and port ``CollaborativeTrainer`` on the LM loss
  (reduced gemma3-1b and rwkv6-1.6b at ``param_dtype="float32"``, carried
  weights, the same ``lm_agent_batches``, fused CDMSGD on a ring), three
  steps within 1e-5.  At bfloat16, the update phase teacher-forced on the
  JAX trainer's gradients and state: new params and momentum bit for bit
  (the JAX side in a subprocess whose XLA emits no FMA, as in
  ``test_torch_update_bf16.py``).
* ``repro_torch.launch.train.main`` on the CPU: both archs train with
  finite losses; four uninterrupted steps equal two, ``--checkpoint-dir``,
  ``--resume`` and two more, bit for bit (every key of the final train
  state), with ``--exchange int8 --schedule overlap --error-feedback`` and
  with ``--microbatch 2``.

``pytest -s`` prints the gaps.
"""

import dataclasses
import functools
import gc
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_topology as jmake_topology  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.data import lm_agent_batches as j_lm_agent_batches  # noqa: E402
from repro.data import make_lm_tokens as j_make_lm_tokens  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro.utils import metrics as jmetrics  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import make_optimizer, make_topology, schedules  # noqa: E402
from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import lm_agent_batches, make_lm_tokens  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402
from repro_torch.utils import metrics as tmetrics  # noqa: E402
from repro_torch.utils import tree as ttree  # noqa: E402

VALUE_TOL = 1e-6        # of max |out|
GRAD_TOL = 1e-5         # of max |grad|
STEP_TOL = 1e-5         # abs, params after three trainer steps
LR, MU, AGENTS, BATCH = 0.01, 0.9, 4, 2
SEQ = {"gemma3-1b": 32, "rwkv6-1.6b": 64}    # banded + blockwise; chunked WKV
NO_FMA = "--xla_cpu_max_isa=AVX"             # see test_torch_update_bf16.py


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _value_and_grads(jfn, tfn, arrays, seed=0):
    """``jfn`` / ``tfn`` of the same float32 ``arrays``: the output and the
    gradients of ``sum(out * ct)`` for a random cotangent ``ct``, as
    ``(value gap, [grad gaps])`` relative to the JAX side's max."""
    jout = jfn(*(jnp.asarray(a) for a in arrays))
    ct = np.random.default_rng(seed).normal(size=jout.shape).astype(np.float32)
    jg = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * ct),
                  argnums=tuple(range(len(arrays))))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    (tout * torch.from_numpy(ct)).sum().backward()
    return (_rel(tout.detach().numpy(), jout),
            [_rel(t.grad.numpy(), g) for t, g in zip(ts, jg)])


def _qkv(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, n, hd)).astype(np.float32)
                 for n in (h, kv, kv))


@pytest.mark.parametrize("kv", [4, 1], ids=["group1", "group4"])
@pytest.mark.parametrize("kind,s,window", [
    ("blockwise", 64, None), ("blockwise", 40, 8), ("banded", 64, 8),
    ("banded", 64, 24)])
def test_training_attention_matches_jax(kind, s, window, kv):
    q, k, v = _qkv(2, s, 4, kv, 16, seed=s + kv)
    if kind == "blockwise":
        def jfn(*a): return jattn.blockwise_attention(*a, window=window, chunk=16)
        def tfn(*a): return tattn.blockwise_attention(*a, window=window, chunk=16)
    else:
        def jfn(*a): return jattn.banded_attention(*a, window=window, q_chunk=16)
        def tfn(*a): return tattn.banded_attention(*a, window=window, q_chunk=16)
    gap, ggaps = _value_and_grads(jfn, tfn, (q, k, v))
    print(f"{kind} s={s} window={window} kv={kv}: value {gap:.2e}, "
          f"grads {[f'{g:.2e}' for g in ggaps]}")
    assert gap <= VALUE_TOL and max(ggaps) <= GRAD_TOL


@pytest.mark.parametrize("s,window", [(64, None), (64, 8), (40, 8)])
def test_gqa_attention_dispatch_matches_jax(s, window):
    """The layer: projections, rope, then banded (static window below s,
    s a multiple of the chunk), else blockwise, as the reference picks."""
    rng = np.random.default_rng(s)
    d, h, kv, hd = 32, 4, 1, 16
    params = {n: (rng.normal(size=shp) / math.sqrt(shp[0])).astype(np.float32)
              for n, shp in (("wq", (d, h, hd)), ("wk", (d, kv, hd)),
                             ("wv", (d, kv, hd)), ("wo", (h, hd, d)))}
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    names = sorted(params)

    def jfn(x, *ws):
        return jattn.gqa_attention(dict(zip(names, ws)), x, jnp.arange(s),
                                   window=window, chunk=16)

    def tfn(x, *ws):
        return tattn.gqa_attention(dict(zip(names, ws)), x, torch.arange(s),
                                   window=window, chunk=16, differentiable=True)

    gap, ggaps = _value_and_grads(jfn, tfn, (x, *(params[n] for n in names)))
    print(f"gqa_attention s={s} window={window}: value {gap:.2e}, grads "
          f"{[f'{g:.2e}' for g in ggaps]}")
    assert gap <= VALUE_TOL and max(ggaps) <= GRAD_TOL


@pytest.mark.parametrize("chunk,s", [(32, 64), (16, 128)])
def test_wkv6_chunked_matches_jax(chunk, s):
    rng = np.random.default_rng(chunk)
    b, nh, hs = 2, 2, 16
    r, k, v = (rng.normal(size=(b, s, nh, hs)).astype(np.float32) for _ in range(3))
    # decays as the live weights' w0 ~ N(-0.5, 0.3) give them (0.15 .. 0.9):
    # below about 1e-9 the chunked form's gradient in w is ill-conditioned
    # in float32 in both packages (each 1e3 relative off a float64 scan)
    w = np.exp(-np.exp(rng.normal(-0.5, 0.3, (b, s, nh, hs)))).astype(np.float32)
    u = rng.normal(size=(nh, hs)).astype(np.float32)

    def jfn(*a):
        return jssm.wkv6_chunked(*a, chunk=chunk)[0]

    def tfn(*a):
        return tssm.wkv6_chunked(*a, chunk=chunk)[0]

    gap, ggaps = _value_and_grads(jfn, tfn, (r, k, v, w, u))
    _, js = jssm.wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk)
    _, ts = tssm.wkv6_chunked(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                              chunk=chunk)
    sgap = _rel(ts.numpy(), js)
    print(f"wkv6_chunked chunk={chunk} s={s}: y {gap:.2e}, state {sgap:.2e}, "
          f"grads {[f'{g:.2e}' for g in ggaps]}")
    assert gap <= VALUE_TOL and sgap <= VALUE_TOL and max(ggaps) <= GRAD_TOL


# --------------------------------------------------------------------------
# the small pieces
# --------------------------------------------------------------------------


def test_microbatch_grad_phase_matches_jax():
    rng = np.random.default_rng(0)
    jp = jparam.init_params(jpm.mlp_classifier_template(8, 4, width=16, depth=2),
                            jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda x: jnp.stack([x] * 3) * (1 + 0.1 * jnp.arange(3).reshape(
        (3,) + (1,) * x.ndim)), jp)
    batch = {"x": rng.normal(size=(3, 8, 8)).astype(np.float32),
             "y": rng.integers(0, 4, (3, 8)).astype(np.int32)}
    jloss = functools.partial(jpm.classifier_loss, jpm.mlp_classifier_apply)
    tloss = functools.partial(tpm.classifier_loss, tpm.mlp_classifier_apply)
    (jl, jm), jg = jengine.make_grad_phase(jloss, 2)(
        jp, jax.tree.map(jnp.asarray, batch))
    (tl, tm), tg = tengine.make_grad_phase(tloss, 2)(
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(tl.shape) == tuple(jl.shape) == (2, 3)
    gaps = [float(np.max(np.abs(tl.numpy() - np.asarray(jl))))]
    gaps += [float(np.max(np.abs(t.numpy() - np.asarray(j))))
             for t, j in zip(ttree.tree_leaves(tg), jax.tree.leaves(jg))]
    assert set(tm) == set(jm) and all(tuple(tm[k].shape) == (2, 3) for k in tm)
    assert all(t.dtype == torch.float32 for t in ttree.tree_leaves(tg))
    print(f"microbatches=2: loss and grad gaps {max(gaps):.2e}")
    assert max(gaps) <= 1e-6


def test_lm_agent_batches_identical():
    a = make_lm_tokens(8192, vocab=300, seed=3)
    b = j_make_lm_tokens(8192, vocab=300, seed=3)
    np.testing.assert_array_equal(a, b)
    for got, want, _ in zip(lm_agent_batches(a, 3, 2, 17, seed=5),
                            j_lm_agent_batches(b, 3, 2, 17, seed=5), range(4)):
        for key in ("inputs", "targets"):
            assert got[key].shape == (3, 2, 17)
            np.testing.assert_array_equal(got[key], want[key])


def test_schedules_match_jax():
    steps = range(0, 40)
    pairs = [(schedules.exponential_decay(0.1, 0.9, 3),
              jsched.exponential_decay(0.1, 0.9, 3)),
             (schedules.warmup_cosine(0.05, 5, 30, 0.001),
              jsched.warmup_cosine(0.05, 5, 30, 0.001)),
             (schedules.warmup_cosine(0.3, 0, 10), jsched.warmup_cosine(0.3, 0, 10))]
    for t, j in pairs:
        got = np.array([t(k) for k in steps], np.float32)
        want = np.array([float(j(k)) for k in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for args in ((0.9, 1.2, 3.0, 0.7), (0.1, 2.0, 1.0, 0.2)):
        assert schedules.paper_step_size_bound(*args) == \
            jsched.paper_step_size_bound(*args)


def test_csv_logger_writes_the_same_file(tmp_path):
    rows = [dict(step=1, loss=0.5, consensus_error=1e-3),
            dict(step=2, loss=0.25, consensus_error=2.5e-4, extra=7)]
    for mod, name in ((tmetrics, "port"), (jmetrics, "jax")):
        log = mod.CSVLogger(str(tmp_path / name / "m.csv"))
        for r in rows:
            log.log(**r)
    assert (tmp_path / "port" / "m.csv").read_text() == \
        (tmp_path / "jax" / "m.csv").read_text()


def test_tree_arithmetic_matches_jax():
    rng = np.random.default_rng(1)
    trees = [{"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]} for _ in range(3)]
    jx = [jax.tree.map(jnp.asarray, t) for t in trees]
    tx = [params_from_numpy(t) for t in trees]

    def same(t, j):
        for a, b in zip(ttree.tree_leaves(t), jax.tree.leaves(j)):
            assert str(a.dtype)[6:] == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))

    same(ttree.tree_add(tx[0], tx[1]), jtree.tree_add(jx[0], jx[1]))
    same(ttree.tree_sub(tx[0], tx[1]), jtree.tree_sub(jx[0], jx[1]))
    same(ttree.tree_scale(0.3, tx[0]), jtree.tree_scale(0.3, jx[0]))
    same(ttree.tree_axpy(0.7, tx[0], tx[1]), jtree.tree_axpy(0.7, jx[0], jx[1]))
    w = [0.2, 0.5, 0.3]
    same(ttree.tree_weighted_sum(w, tx), jtree.tree_weighted_sum(w, jx))
    same(ttree.tree_cast(tx[0], torch.bfloat16), jtree.tree_cast(jx[0], jnp.bfloat16))
    np.testing.assert_allclose(float(ttree.tree_dot(tx[0], tx[1])),
                               float(jtree.tree_dot(jx[0], jx[1])), rtol=1e-6)
    np.testing.assert_allclose(float(ttree.tree_l2_norm(tx[2])),
                               float(jtree.tree_l2_norm(jx[2])), rtol=1e-6)
    assert ttree.tree_size(tx[0]) == jtree.tree_size(jx[0]) == 17
    assert ttree.tree_bytes(tx[0]) == jtree.tree_bytes(jx[0]) == 68
    with pytest.raises(ValueError):
        ttree.tree_weighted_sum([1.0], tx)


def test_perturb_per_agent(monkeypatch):
    """On the JAX package's noise (patched in leaf by leaf) the port's
    ``x + scale * n`` equals JAX's; its own draws are standard normal
    scaled (statistically) and repeat under the same generator seed."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(4, 64, 64)).astype(np.float32),
              "b": rng.normal(size=(4, 64)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    want = jtrainer.perturb_per_agent(jax.tree.map(jnp.asarray, params), key, 0.05)
    leaves, _ = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    noise = iter([np.asarray(jax.random.normal(k, x.shape, x.dtype))
                  for x, k in zip(leaves, keys)])
    monkeypatch.setattr(ttrainer, "_normal_like",
                        lambda x, gen: torch.from_numpy(next(noise).copy()))
    got = ttrainer.perturb_per_agent(params_from_numpy(params), torch.Generator(), 0.05)
    for a, b in zip(ttree.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    monkeypatch.undo()
    tp = params_from_numpy(params)
    outs = [ttrainer.perturb_per_agent(tp, torch.Generator().manual_seed(3), 0.05)
            for _ in range(2)]
    for a, b in zip(*(ttree.tree_leaves(o) for o in outs)):
        assert torch.equal(a, b)
    n = (outs[0]["w"] - tp["w"]) / 0.05
    assert abs(float(n.mean())) < 0.02 and abs(float(n.std()) - 1.0) < 0.02
    assert not torch.equal(n[0], n[1])               # agents differ


# --------------------------------------------------------------------------
# the slice: the LM trainer
# --------------------------------------------------------------------------


def _live_leaf(rng, path, pd):
    """Every leaf drawn, zero-initialised ones included; matrices at
    variance 1 / (contraction size) (the attention projections contract
    over d, or heads x hd for wo): ``test_torch_lm_models.py``'s weights."""
    name = str(getattr(path[-1], "key", path[-1]))
    if pd.init == "ones":
        return 1.0 + 0.1 * rng.normal(size=pd.shape)
    if pd.init == "zeros":
        if name.startswith("mu_"):
            return rng.uniform(0.0, 1.0, size=pd.shape)
        if name == "w0":
            return rng.normal(-0.5, 0.3, size=pd.shape)
        return 0.3 * rng.normal(size=pd.shape)
    if pd.init in ("normal", "embed"):
        return (0.02 if pd.init == "normal" else 0.05) * rng.normal(size=pd.shape)
    fan_in = pd.shape[-2]
    if str(getattr(path[-2], "key", "")) == "attn":
        fan_in = pd.shape[-3] * (pd.shape[-2] if name == "wo" else 1)
    return pd.scale / math.sqrt(fan_in) * rng.normal(size=pd.shape)


def _setup(arch, param_dtype):
    """Configs, carried weights (JAX arrays, port tensors) and the batch
    stream's first steps (numpy)."""
    jc = dataclasses.replace(j_get_config(arch + "-reduced"), param_dtype=param_dtype)
    tc = dataclasses.replace(get_config(arch + "-reduced"), param_dtype=param_dtype)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        jt.model_template(jc), is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    rng = np.random.default_rng(0)
    jp = jax.tree.unflatten(treedef, [
        jnp.asarray(_live_leaf(rng, p, pd).astype(np.float32), pd.dtype)
        for p, pd in flat])
    tokens = make_lm_tokens(1 << 13, vocab=jc.vocab_size, seed=0)
    it = lm_agent_batches(tokens, AGENTS, BATCH, SEQ[arch], seed=0)
    batches = [next(it) for _ in range(3)]
    return jc, tc, jp, batches


def _jax_trainer(jc, jp, optimizer="cdmsgd"):
    kw = {"mu": MU} if optimizer == "cdmsgd" else {}
    return jtrainer.CollaborativeTrainer(
        lambda p, b: jt.loss_fn(jc, p, b), jp, jmake_topology("ring", AGENTS),
        jmake_optimizer(optimizer, LR, fused=True, **kw), donate=False)


def _port_trainer(tc, tp):
    return CollaborativeTrainer(
        lambda p, b: tt.loss_fn(tc, p, b), tp, make_topology("ring", AGENTS),
        make_optimizer("cdmsgd", LR, mu=MU, fused=True), device="cpu")


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-1.6b"])
def test_lm_trainer_matches_jax_float32(arch):
    jc, tc, jp, batches = _setup(arch, "float32")
    jtr = _jax_trainer(jc, jp)
    ttr = _port_trainer(tc, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    gaps = []
    for b in batches:
        jm, tm = jtr.step(b), ttr.step(b)
        gaps.append(max(float(np.max(np.abs(t.numpy() - np.asarray(j))))
                        for t, j in zip(ttree.tree_leaves(ttr.state.params),
                                        jax.tree.leaves(jtr.state.params))))
        assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
    print(f"{arch} f32 LM trainer, fused CDMSGD on a ring: param gaps {gaps}")
    assert max(gaps) <= STEP_TOL


#: the JAX trainer's bf16 trajectories: (arch, optimizer), fused on a ring
ORACLE_RUNS = (("gemma3-1b", "cdmsgd"), ("rwkv6-1.6b", "cdmsgd"),
               ("gemma3-1b", "cdadam"))


def write_oracle(path: str) -> None:
    """The JAX trainer's bf16 trajectories, three steps each: per step the
    state before, the gradients and the state after, as JAX checkpoints
    under ``path/<arch>-<optimizer>`` (step = the step index)."""
    for arch, optimizer in ORACLE_RUNS:
        jc, _, jp, batches = _setup(arch, "bfloat16")
        tr = _jax_trainer(jc, jp, optimizer)
        prog = tr._program
        grad_fn, update_fn = jax.jit(prog.grad_phase), jax.jit(prog.update_phase)
        for i, b in enumerate(batches):
            st = tr.state
            gp = tr.optimizer.grad_params(st.params, st.opt_state)
            _, grads = grad_fn(gp, jax.tree.map(jnp.asarray, b))
            new_p, new_o = update_fn(st.params, grads, st.opt_state)
            jckpt.save_checkpoint(os.path.join(path, f"{arch}-{optimizer}"), i, {
                "before": {"params": st.params, "opt_state": st.opt_state},
                "grads": grads,
                "after": {"params": new_p, "opt_state": new_o}})
            tr.state = jtrainer.TrainState(params=new_p, opt_state=new_o,
                                           step=st.step + 1)


@pytest.fixture(scope="module")
def bf16_oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_bf16"))
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA).strip())
    subprocess.run([sys.executable, __file__, path], env=env, cwd=str(root),
                   check=True, timeout=900)
    return path


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-1.6b"])
def test_lm_trainer_bf16_update_phase_bitwise(bf16_oracle, arch):
    """bf16 parameters, one bf16 bucket: at each of three steps the JAX
    trainer's state and gradients go into the port's update phase (fused
    CDMSGD on a ring, the dense kernel's plain version on the bf16 bucket),
    and the new params and momentum equal JAX's bit for bit."""
    _, tc, jp, _ = _setup(arch, "bfloat16")
    tr = _port_trainer(tc, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    _teacher_forced_bitwise(tr, os.path.join(bf16_oracle, f"{arch}-cdmsgd"), arch)
    print(f"{arch} bf16 update phase, 3 teacher-forced steps: bit for bit")


def _teacher_forced_bitwise(tr, oracle_dir, what) -> None:
    """The JAX trainer's three steps (state before, gradients) through the
    port trainer's update phase: new params and optimizer state (momentum;
    Adam's two moments) equal to JAX's bit for bit, all bf16."""
    params0 = tr.state.params
    assert {t.dtype for t in ttree.tree_leaves(params0)} == {torch.bfloat16}
    like = {"before": {"params": params0, "opt_state": tr.state.opt_state},
            "grads": params0,
            "after": {"params": params0, "opt_state": tr.state.opt_state}}
    for i in range(3):
        c = tckpt.restore_checkpoint(oracle_dir, like, step=i)
        with torch.no_grad():
            new_p, new_o = tr._program.update_phase(
                c["before"]["params"], c["grads"], c["before"]["opt_state"])
        assert new_o.step == c["after"]["opt_state"].step == i + 1
        for got, want in ((new_p, c["after"]["params"]),
                          (new_o.inner, c["after"]["opt_state"].inner)):
            leaves = list(zip(ttree.tree_leaves(got), ttree.tree_leaves(want)))
            assert leaves
            for a, b in leaves:
                assert a.dtype == b.dtype == torch.bfloat16
                assert torch.equal(a.view(torch.int16), b.view(torch.int16)), \
                    f"{what} step {i}: not bit for bit"


# --------------------------------------------------------------------------
# the CLI: repro_torch.launch.train
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-1.6b"])
def test_train_cli_runs_on_cpu(arch, capsys):
    tr = tlaunch.main(["--arch", arch, "--preset", "tiny", "--device", "cpu",
                       "--optimizer", "cdmsgd", "--fused", "--steps", "4",
                       "--log-every", "2"])
    losses = tr.history.series("loss")
    out = capsys.readouterr().out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert "bytes/agent/step on the wire" in out and "[train] done:" in out
    assert {t.dtype for t in ttree.tree_leaves(tr.state.params)} == {torch.bfloat16}


@pytest.mark.parametrize("flags", [
    ["--optimizer", "cdmsgd_nesterov", "--fused"],
    ["--optimizer", "cdadam", "--fused", "--exchange", "int8", "--schedule",
     "overlap"],
    ["--optimizer", "cdmsgd", "--exchange", "int8", "--momentum-mixing",
     "mixed"],
], ids=["nesterov", "cdadam-int8-overlap", "cdmsgd-int8-mixed"])
def test_train_steps_leave_no_tensor_in_a_reference_cycle(flags, monkeypatch):
    """Every buffer a step lets go of is freed at once, by reference
    counting: no tensor of a finished step waits in a reference cycle for
    Python's cyclic collector.  (On the card a cycle held a whole parameter
    bucket's views for several steps, so the allocator grew its segments
    and flushed its cache in the steps' time.)"""
    cyclic = []
    step = CollaborativeTrainer.step

    def checked(self, batch):
        out = step(self, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            gc.collect()
            cyclic.extend(tuple(o.shape) for o in gc.garbage
                          if isinstance(o, torch.Tensor))
        finally:
            gc.set_debug(0)
            gc.garbage.clear()
        return out

    gc.collect()
    monkeypatch.setattr(CollaborativeTrainer, "step", checked)
    tr = tlaunch.main(["--arch", "gemma3-1b", "--preset", "tiny", "--device",
                       "cpu", "--agents", "3", "--topology", "ring",
                       "--steps", "2", "--log-every", "0", *flags])
    assert tr.state.step == 2 and not cyclic, cyclic


def test_train_cli_cdadam_bf16_update_phases_bitwise(bf16_oracle, monkeypatch):
    """``launch/train.py --optimizer cdadam --fused`` on reduced gemma3-1b
    (one bf16 bucket; the carried weights in place of its seeded draw),
    three steps on the CPU with finite losses; then its trainer's update
    phase (the dense CDAdam kernel's plain version on the bf16 bucket)
    teacher-forced on the JAX trainer's three fused CDAdam steps: params
    and both moments bit for bit."""
    _, _, jp, _ = _setup("gemma3-1b", "bfloat16")
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(tlaunch, "init_params",
                        lambda template, seed, device=None: carried)
    tr = tlaunch.main(["--arch", "gemma3-1b", "--preset", "tiny", "--device", "cpu",
                       "--agents", str(AGENTS), "--topology", "ring",
                       "--optimizer", "cdadam", "--fused", "--lr", str(LR),
                       "--batch", str(BATCH), "--seq", str(SEQ["gemma3-1b"]),
                       "--steps", "3", "--log-every", "0"])
    losses = tr.history.series("loss")
    assert tr.state.step == 3 and len(losses) == 3 and all(np.isfinite(losses))
    assert type(tr.optimizer).__name__ == "CDAdam" and tr.optimizer.fused
    _teacher_forced_bitwise(tr, os.path.join(bf16_oracle, "gemma3-1b-cdadam"),
                            "the CLI's CDAdam")
    print("launch/train.py cdadam --fused, bf16 update phase, 3 teacher-forced "
          "steps: bit for bit")


def _cli(ckpt, steps, extra, resume=False):
    argv = ["--arch", "gemma3-1b", "--preset", "tiny", "--device", "cpu",
            "--agents", "3", "--topology", "ring", "--optimizer", "cdmsgd",
            "--batch", "2", "--seq", "32", "--log-every", "0",
            "--steps", str(steps), "--checkpoint-dir", ckpt, *extra]
    return tlaunch.main(argv + (["--resume"] if resume else []))


@pytest.mark.parametrize("extra", [
    ["--exchange", "int8", "--schedule", "overlap", "--error-feedback"],
    ["--fused", "--microbatch", "2"]], ids=["int8-overlap-ef", "microbatch2"])
def test_resumed_run_equals_uninterrupted_bitwise(tmp_path, extra):
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    _cli(whole, 4, extra)
    _cli(split, 2, extra)
    tr = _cli(split, 2, extra, resume=True)
    assert tr.state.step == 4 and len(tr.history.series("loss")) == 2
    with np.load(os.path.join(whole, "ckpt_00000004.npz")) as a, \
            np.load(os.path.join(split, "ckpt_00000004.npz")) as b:
        assert set(a.files) == set(b.files)
        assert any(".wire" in k for k in a.files) or "--microbatch" in extra
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


if __name__ == "__main__":
    write_oracle(sys.argv[1])
