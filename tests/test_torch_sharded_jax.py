"""The sharded mode against the JAX package's sharded step, on the CPU.

One subprocess runs the reference's ``build_train_step(...,
mixing="ppermute_fused")`` on ``make_debug_mesh(4, 1)`` (four host devices,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, the idiom of
``tests/test_sharded.py``, with XLA's intra-op threads off) over reduced
gemma3-1b in float32, fused CDMSGD on a ring, from carried weights
(``torch_sharded_ranks.live_params`` plus a per-agent perturbation) on the
same ``lm_agent_batches``; the port's four ``gloo`` ranks run the same
configuration through ``repro_torch.launch.steps.build_train_step``.  Three steps, sync and
overlap on the f32 wire, the f32 staleness ring (``staleness=2``) under
``straggler:1:1,drop:0:1``, CDMSGD on ``rank:4`` with error feedback (the
JAX warm-start basis carried into the port's ``OptState.qwarm``: the
port draws its own) and FedAvg (E = 2) with partial participation
(``straggler:1:1``, ``mixing="dense"``): params within 1e-5, losses
within 1e-5 relative.  None of these draws a random stream the two
packages would draw differently.  The reference's stencil sums in shift
order and the port's in sender order, so this check is not bit for bit
(the port's sharded update phase is held bit for bit against its stacked
one in ``test_torch_sharded.py``, the top-k wire among them).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks  # noqa: E402

from repro_torch.data import lm_agent_batches, make_lm_tokens  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENTS, BATCH, SEQ, STEPS = 4, 2, 16, 3
STEP_TOL = 1e-5           # abs, params after three steps
LOSS_TOL = 1e-5           # relative
RANK = 4
CONFIGS = {
    "cdmsgd-f32-sync": {"optimizer": "cdmsgd", "topology": "ring",
                        "knobs": {"schedule": "sync"}},
    "cdmsgd-f32-overlap": {"optimizer": "cdmsgd", "topology": "ring",
                           "knobs": {"schedule": "overlap"}},
    "cdmsgd-f32-overlap-ring2-faults": {
        "optimizer": "cdmsgd", "topology": "ring",
        "knobs": {"schedule": "overlap", "staleness": 2,
                  "fault_schedule": "straggler:1:1,drop:0:1"}},
    "cdmsgd-rank4-ef-sync": {"optimizer": "cdmsgd", "topology": "ring",
                             "knobs": {"compressor": f"rank:{RANK}",
                                       "error_feedback": True}},
    "fedavg-faults": {"optimizer": "fedavg", "topology": "ring",
                      "mixing": "dense", "opt_faults": "straggler:1:1",
                      "knobs": {}},
}

JAX_STEP = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.core.faults import make_fault_schedule
    from repro.core.optim import make_optimizer
    from repro.launch.mesh import make_debug_mesh
    from repro.launch import steps as steps_lib

    src, out = sys.argv[1], sys.argv[2]
    data = np.load(src)
    spec = json.loads(str(data["spec"]))
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                              param_dtype="float32")
    shape = InputShape("tiny_train", spec["seq"], spec["batch"] * 4, "train")
    mesh = make_debug_mesh(4, 1)
    results = {}
    for name, c in spec["configs"].items():
        mixing = c.get("mixing", "ppermute_fused")
        kw = {"mu": spec["mu"]}
        if c["optimizer"] == "fedavg":
            kw.update(local_steps=2, faults=make_fault_schedule(
                c["opt_faults"], 4))
        else:
            kw["fused"] = True
        opt = make_optimizer(c["optimizer"], spec["lr"], **kw)
        b = steps_lib.build_train_step(
            cfg, shape, mesh, opt, mode="train", topology_name=c["topology"],
            mixing=mixing, remat=False, **c["knobs"])
        leaves, treedef = jax.tree.flatten(b.param_template,
            is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "init"))
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(data["p0/" + k]) for k in spec["keys"]])
        batches = [{"inputs": jnp.asarray(data[f"b{i}/inputs"]),
                    "targets": jnp.asarray(data[f"b{i}/targets"])}
                   for i in range(spec["steps"])]
        with mesh:
            state = b.init_state(params)
            step = jax.jit(b.step_fn)
            losses = []
            for batch in batches:
                params, state, metrics = step(params, state, batch)
                losses.append(float(metrics["loss"]))
        for k, x in zip(spec["keys"], jax.tree.leaves(params)):
            results[f"{name}/{k}"] = np.asarray(x)
        results[f"{name}/losses"] = np.asarray(losses)
    np.savez(out, **results)
""")


def _keys(tree):
    """Leaf paths in the trees' shared (sorted-key) order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out.append("/".join(path))

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_jax")
    cfg = ranks.lm_config()
    rng = np.random.default_rng(1)
    base = ranks.live_params(tt.model_template(cfg), seed=0)
    p0 = tree_map(lambda x: np.stack([
        x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
        for _ in range(AGENTS)]), base)
    stream = lm_agent_batches(make_lm_tokens(1 << 13, vocab=cfg.vocab_size,
                                             seed=0), AGENTS, BATCH, SEQ, seed=0)
    batches = [next(stream) for _ in range(STEPS)]
    keys = _keys(p0)
    leaves, _ = tree_flatten(p0)
    arrays = {f"p0/{k}": x for k, x in zip(keys, leaves)}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    spec = {"configs": CONFIGS, "keys": keys, "seq": SEQ, "batch": BATCH,
            "steps": STEPS, "lr": ranks.LR, "mu": ranks.MU}
    # the reference's rank-r warm start, carried into the port's state
    from repro.kernels.consensus_update.topk import rank_init_q
    qwarm = torch.tensor(np.asarray(rank_init_q(RANK)))
    src, out = str(d / "inputs.npz"), str(d / "jax.npz")
    np.savez(src, spec=json.dumps(spec), **arrays)
    # XLA's intra-op thread pool spins for work: beside the other test
    # processes it stalls the four host devices' collectives
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.Popen([sys.executable, "-c", JAX_STEP, src, out],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        path = str(d / "port.pt")
        torch.save({"configs": CONFIGS, "batches": batches, "seq": SEQ,
                    "batch": BATCH, "qwarm": qwarm,
                    "P0": tree_map(torch.from_numpy, p0)}, path)
        port = mesh_lib.spawn_agents(ranks.run_jax_configs, AGENTS,
                                     args=(path,), backend="gloo",
                                     device="cpu", timeout=60,
                                     join_timeout=300)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"JAX sharded step failed:\n{err[-4000:]}"
    return keys, dict(np.load(out)), port


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_ranks_match_jax_sharded_step(both, name):
    keys, jax_out, port = both
    gaps = []
    for r in range(AGENTS):
        leaves, _ = tree_flatten(port[r][name]["params"])
        for k, t in zip(keys, leaves):
            gaps.append(float(np.max(np.abs(t.numpy() - jax_out[f"{name}/{k}"][r]))))
        want = jax_out[f"{name}/losses"]
        got = np.asarray(port[r][name]["losses"])
        # the step's loss is this agent's; the reference's the agents' mean
        if r == 0:
            mean = np.mean([port[q][name]["losses"] for q in range(AGENTS)], axis=0)
            assert np.all(np.abs(mean - want) <= LOSS_TOL * np.abs(want)), \
                (mean, want)
        assert np.all(np.isfinite(got))
    print(f"{name}: port ranks vs JAX sharded step after {STEPS} steps, "
          f"max gap {max(gaps):.3e}")
    assert max(gaps) <= STEP_TOL
