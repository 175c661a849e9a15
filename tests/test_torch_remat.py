"""The loss's rematerialization (``loss_fn(..., remat=True)``, the port's
``jax.checkpoint`` of each scanned block) and the sharded step's default.

* The stacked trainer's grad phase (``engine.make_grad_phase``: ``vmap`` of
  ``grad_and_value`` over the agent axis) with ``remat=True`` gives the
  same bits as with ``remat=False``: losses, metrics and every gradient
  (``torch.equal``), for gemma3-1b's super-blocks, kimi-k2's dense and MoE
  blocks (the router's aux term flows through the recompute),
  deepseek-v2's MLA, internvl2-2b's frontend and rwkv6-1.6b, reduced, on
  numpy-drawn weights, in float32 and in the configs' bfloat16; also with
  2 microbatches.
* Outside ``torch.func``, under plain autograd, a rematerialized loss
  keeps each unit's inputs only: the activations saved for the backward
  pass (counted through ``saved_tensors_hooks``, the parameters' own
  storage left out) are under half of those without remat, and the
  gradients the same bits.
* The sharded ``build_train_step`` at its default ``remat=True`` (the
  reference's): 2 gloo ranks, reduced gemma3-1b in float32, fused CDMSGD
  on the int8 wire; each rank's grad phase bit for bit with a
  ``remat=False`` build's, and two whole steps within 1e-5 of the stacked
  trainer's (``test_torch_sharded.py``'s bound: the grad phase without
  ``vmap`` rounds differently).
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks  # noqa: E402
from torch_zoo_carry import carried, one_torch_thread  # noqa: E402, F401

from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import engine, make_topology  # noqa: E402
from repro_torch.core.trainer import CollaborativeTrainer, TrainState  # noqa: E402
from repro_torch.data import lm_agent_batches, make_lm_tokens  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

AGENTS, B, S = 2, 2, 16
STEP_TOL = 1e-5


def _stacked(tp, seed=0):
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: torch.stack([t, (t.float() * (1 + 0.01 * torch.from_numpy(
        rng.normal(size=t.shape).astype(np.float32)))).to(t.dtype)]), tp)


def _agent_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab_size, (AGENTS, B, S))
                                 .astype(np.int32)) for k in ("inputs", "targets")}
    if cfg.modality == "vlm":
        batch["frontend"] = torch.from_numpy(rng.normal(
            size=(AGENTS, B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32))
    return batch


CASES = [("gemma3-1b", "float32", 1), ("gemma3-1b", "bfloat16", 1),
         ("kimi-k2-1t-a32b", "float32", 1), ("kimi-k2-1t-a32b", "bfloat16", 1),
         ("kimi-k2-1t-a32b", "float32", 2), ("deepseek-v2-236b", "float32", 1),
         ("internvl2-2b", "float32", 1), ("rwkv6-1.6b", "float32", 1)]


@pytest.mark.parametrize("name,dtype,micro", CASES,
                         ids=[f"{n}-{d}-mb{m}" for n, d, m in CASES])
def test_grad_phase_with_remat_is_bitwise(name, dtype, micro):
    _, tc, _, tp = carried(name, dtype)
    gp, batch = _stacked(tp), _agent_batch(tc)
    out = {}
    for remat in (False, True):
        phase = engine.make_grad_phase(
            lambda p, b, r=remat: tt.loss_fn(tc, p, b, remat=r), micro)
        out[remat] = phase(gp, batch)
    (l0, m0), g0 = out[False]
    (l1, m1), g1 = out[True]
    leaves0, leaves1 = tree_leaves(g0), tree_leaves(g1)
    assert len(leaves0) == len(leaves1) == len(tree_leaves(tp))
    assert torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(leaves0, leaves1))
    if tc.is_moe:
        assert float(m1["moe_aux"].min()) > 0
        router = g1["groups"]["moe"]["moe"]["router"]
        assert router.dtype == torch.float32 and float(router.abs().max()) > 0
    print(f"remat {name} {dtype} microbatches {micro}: {len(leaves1)} gradients bit "
          f"for bit, losses {l1.reshape(-1).tolist()}")


def _saved_bytes(fn, params) -> int:
    """Bytes of the activations saved for ``fn()``'s backward (tensors
    that share no storage with a parameter)."""
    weights = {p.untyped_storage().data_ptr() for p in tree_leaves(params)}
    total = [0]

    def pack(t):
        if t.untyped_storage().data_ptr() not in weights:
            total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = fn()
    loss.backward()
    return total[0]


@pytest.mark.parametrize("name", ["gemma3-1b", "kimi-k2-1t-a32b"])
def test_remat_saves_only_the_units_inputs(name):
    _, tc, _, tp = carried(name, "float32")
    batch = {k: v[0] for k, v in _agent_batch(tc).items()}
    grads, saved = {}, {}
    for remat in (False, True):
        params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
        saved[remat] = _saved_bytes(
            lambda: tt.loss_fn(tc, params, batch, remat=remat)[0], params)
        grads[remat] = [p.grad for p in tree_leaves(params)]
    print(f"remat {name}: {saved[True]:,} B saved for backward, {saved[False]:,} B "
          f"without ({saved[True] / saved[False]:.3f})")
    assert saved[True] < 0.5 * saved[False]
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))


@pytest.fixture(scope="module")
def remat_runs(tmp_path_factory):
    cfg = ranks.lm_config()
    rng = np.random.default_rng(1)
    base = ranks.live_params(tt.model_template(cfg), seed=0)
    p0 = tree_map(lambda x: torch.from_numpy(np.stack([
        x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
        for _ in range(AGENTS)])), base)
    stream = lm_agent_batches(make_lm_tokens(1 << 13, vocab=cfg.vocab_size, seed=0),
                              AGENTS, B, S, seed=0)
    batches = [next(stream) for _ in range(2)]
    path = str(tmp_path_factory.mktemp("remat") / "inputs.pt")
    torch.save({"P0": p0, "batches": batches, "seq": S, "batch": B}, path)
    got = mesh_lib.spawn_agents(ranks.run_remat_default, AGENTS, args=(path,),
                                backend="gloo", device="cpu", timeout=60,
                                join_timeout=300)
    tr = CollaborativeTrainer(lambda p, b: tt.loss_fn(cfg, p, b),
                              tree_map(lambda x: x[0], p0),
                              make_topology("ring", AGENTS),
                              ranks.make_opt("cdmsgd", True), device="cpu",
                              exchange="int8")
    tr.state = TrainState(params=tree_map(torch.clone, p0),
                          opt_state=tr._program.init_state(tree_map(torch.clone, p0)))
    for b in batches:
        tr.step(b)
    return tr.state.params, got


def test_sharded_default_remat_matches_the_stacked_trainer(remat_runs):
    want, got = remat_runs
    shape = InputShape("t", S, B * AGENTS, "train")
    bundle = steps_lib.build_train_step(
        ranks.lm_config(), shape,
        mesh_lib.AgentMesh(rank=0, size=AGENTS, backend="gloo", group=None,
                           device=torch.device("cpu")),
        ranks.make_opt("cdmsgd", True), mixing="ppermute_fused")
    assert bundle.grad_phase is not None
    gaps = []
    for r, res in enumerate(got):
        assert res["grads_bitwise"] and res["n_grads"] == len(tree_leaves(want))
        gaps.append(max(float((x - y[r]).abs().max()) for x, y in
                        zip(tree_leaves(res["params"]), tree_leaves(want))))
    print(f"sharded remat=True (default), {AGENTS} ranks, CDMSGD int8, 2 steps: grad "
          f"phases bit for bit with remat=False; params vs the stacked trainer "
          f"{max(gaps):.3e} (tol {STEP_TOL:g})")
    assert max(gaps) <= STEP_TOL
