"""The sharded serve mode (``build_prefill_step`` / ``build_serve_step`` on
a ``data x model`` process mesh) against the JAX package, on the CPU.

* **The spec functions.**  ``safe_partition_specs`` under the three modes'
  rules, and ``cache_partition_specs`` / ``decode_input_specs`` (shapes,
  dtypes, specs) at ``prefill_32k``, ``decode_32k`` and ``long_500k``,
  equal the reference's for every config of ``repro.configs`` at the
  production mesh sizes 16 x 16 and 2 x 16 x 16.  The reference functions
  read only ``mesh.shape`` and ``mesh.axis_names``, so an abstract mesh
  stands in for the devices.  Also ``tests/test_extensions.py``'s
  even / odd divisibility case.
* **The steps.**  One JAX subprocess (8 host devices,
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, XLA's intra-op
  threads off) runs the reference's ``build_prefill_step`` and
  ``build_serve_step`` on ``make_debug_mesh(2, 2)``, the params, batch and
  cache placed by the bundles' own specs (so GSPMD partitions the steps),
  and reports the debug meshes' device order.  One ``spawn_agents`` run of
  4 gloo ranks on ``{"data": 2, "model": 2}`` runs the port's steps on the
  same float32 weights (``torch_sharded_ranks.live_params``): reduced
  gemma3-1b (1 KV head: the sequence-sharded cache), reduced granite-3-8b
  (4 KV heads: the head-sharded cache) and granite with a vocabulary of
  511 (the replicated branch).  Prefill last logits within
  :data:`LOGIT_TOL` of max |logit|; greedy decode steps from an empty
  cache (4, and 12 for gemma, whose sliding window of 8 then drops
  positions held on other ranks) with the tokens equal and the caches,
  reassembled with ``global_from_shards``, within :data:`CACHE_TOL`; a
  batch-1 decode (the sequence over every axis) in the same spawn.
  ``pytest -s`` prints the gaps.
* **The mesh.**  The rank layout and each axis's lines against the
  reference's device order; an agent-only mesh keeps its coordinates,
  peers and shift keys; what the serve mode does not run raises at build
  time, naming its ROADMAP item.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks  # noqa: E402
# one torch thread: under the suite's -n 6, torch's thread per core stalls
from torch_zoo_carry import one_torch_thread  # noqa: E402, F401

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402
from repro_torch.nn.param import (ParamDef, global_from_shards,  # noqa: E402
                                  partition_specs)
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"data": 2, "model": 2}
SEQ, BATCH = 16, 4
LOGIT_TOL = 1e-5          # of max |logit|: prefill last logits, port vs JAX
CACHE_TOL = 1e-5          # abs: the reassembled caches after the decode steps
# decode steps a config: reduced gemma3-1b's local layers see a window of 8,
# so from step 8 on they drop positions that another rank of the sequence
# split holds (8 positions a rank at batch 4, 4 at batch 1, whose first
# block drops whole at step 11)
CONFIGS = {
    "gemma3-1b": {"arch": "gemma3-1b", "vocab": 0, "decode_batches": [BATCH, 1],
                  "steps": 12},
    "granite-3-8b": {"arch": "granite-3-8b", "vocab": 0,
                     "decode_batches": [BATCH, 1], "steps": 4},
    "granite-3-8b-v511": {"arch": "granite-3-8b", "vocab": 511,
                          "decode_batches": [BATCH], "steps": 4},
}
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def _duck(axes: dict):
    """A mesh for the reference's spec functions, which read its shape and
    names (and ``decode_input_specs`` puts it in a ``NamedSharding``): an
    abstract mesh, no devices."""
    return jax.sharding.AbstractMesh(tuple(axes.values()), tuple(axes))


def _port_mesh(axes: dict, rank: int = 0):
    return mesh_lib.AgentMesh(rank=rank, size=int(np.prod(list(axes.values()))),
                              backend="gloo", group=None,
                              device=torch.device("cpu"), axes=axes)


def _norm(entry):
    """A spec entry with one-axis tuples as the axis name (JAX's form)."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def _jspecs(tree):
    """``[(path, entries)]`` of a JAX spec (or struct) tree, path-sorted."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = []
    for path, x in leaves:
        spec = x.sharding.spec if hasattr(x, "sharding") else x
        out.append((tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path),
                    tuple(_norm(e) for e in spec)))
    return out


def _tspecs(tree):
    return [(tuple(path), tuple(_norm(e) for e in sp.axes))
            for path, sp in tree_flatten_with_path(tree)]


# --------------------------------------------------------------------------
# the spec functions against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "train_hier", "serve"])
def test_safe_partition_specs_equal_the_reference(mesh_name, mode):
    axes = MESHES[mesh_name]
    jm, tm = _duck(axes), _port_mesh(axes)
    for arch in list_archs():
        want = _jspecs(jsh.safe_partition_specs(
            jt.model_template(jget(arch)), jsh.rules_for_mode(mode, jm), jm))
        got = _tspecs(sh.safe_partition_specs(
            tt.model_template(get_config(arch)), sh.rules_for_mode(mode, tm), tm))
        assert got == want, arch
    assert sh.rules_for_mode(mode, tm) == jsh.rules_for_mode(mode, jm)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_cache_and_decode_input_specs_equal_the_reference(mesh_name, shape):
    axes = MESHES[mesh_name]
    jm, tm = _duck(axes), _port_mesh(axes)
    for arch in list_archs():
        jc, tc = jget(arch), get_config(arch)
        js, ts = J_SHAPES[shape], INPUT_SHAPES[shape]
        assert _tspecs(sh.cache_partition_specs(tc, ts, tm)) == \
            _jspecs(jsh.cache_partition_specs(jc, js, jm)), arch
        jcache, jtok, jcur = jsh.decode_input_specs(jc, js, jm)
        tcache, ttok, tcur = sh.decode_input_specs(tc, ts, tm)
        jl = jax.tree_util.tree_flatten_with_path(jcache)[0]
        tl = tree_flatten_with_path(tcache)
        assert [tuple(getattr(p, "key", p) for p in path) for path, _ in jl] == \
            [tuple(path) for path, _ in tl], arch
        for (_, j), (_, t) in zip(jl, tl):
            assert tuple(j.shape) == t.shape, arch
            assert str(j.dtype) == str(t.dtype).replace("torch.", ""), arch
            assert tuple(_norm(e) for e in j.sharding.spec) == \
                tuple(_norm(e) for e in t.spec.axes), arch
        assert tuple(jtok.shape) == ttok.shape
        assert tuple(_norm(e) for e in jtok.sharding.spec) == \
            tuple(_norm(e) for e in ttok.spec.axes)
        assert tuple(jcur.shape) == tcur.shape == ()
        assert sh.serve_batch_count(ts, tm) == jsh.serve_batch_count(js, jm)
        for mode in ("train", "train_hier", "serve"):
            assert sh.batch_axes(tm, mode) == jsh.batch_axes(jm, mode)


def test_safe_partition_specs_divisibility_fallback():
    """``tests/test_extensions.py``'s case on a 4 x 2 mesh: 6 heads shard
    over ``model``, 5 replicate (the trailing replicated dim dropped)."""
    tm = _port_mesh({"data": 4, "model": 2})
    t = {"even": ParamDef((8, 6), ("fsdp", "tp")),
         "odd": ParamDef((8, 5), ("fsdp", "tp"))}
    specs = sh.safe_partition_specs(t, sh.rules_for_mode("serve", tm), tm)
    assert specs["even"].axes == ("data", "model")
    assert specs["odd"].axes == ("data",)
    # partition_specs itself resolves every logical axis, as the reference's
    want = jparam.partition_specs(
        {"w": jparam.ParamDef((8, 6), ("fsdp", "tp"))},
        {"fsdp": "data", "tp": "model"})["w"]
    got = partition_specs(t, {"fsdp": "data", "tp": "model"})["even"]
    assert got.axes == tuple(want)


def test_local_cache_allocates_the_block():
    tm = _port_mesh(AXES, rank=3)
    cfg = ranks.serve_config("gemma3-1b")
    shape = InputShape("d", SEQ, BATCH, "decode")
    cache = sh.local_cache(cfg, shape, tm, device="cpu")
    # gemma's 1 KV head: batch over data, the sequence over model
    assert cache["lg_super"]["k"].shape == (1, 2, BATCH // 2, SEQ // 2, 1, 64)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [AXES, {"pod": 2, "data": 2, "model": 2}],
                         ids=["data2xmodel2", "pod2xdata2xmodel2"])
def test_rank_layout_and_lines_follow_the_reference_device_order(both, axes):
    order = np.asarray(both["jax"]["devices"]["x".join(axes)])
    tm = _port_mesh(axes)
    for rank in range(tm.size):
        assert order[tm.coords(rank)] == rank
    for k, a in enumerate(axes):
        want = np.moveaxis(order, k, -1).reshape(-1, axes[a]).tolist()
        assert mesh_lib.axis_lines(axes, a) == want
    if axes == AXES:
        for r, res in enumerate(both["port"]):
            for a in axes:
                line = next(ln for ln in mesh_lib.axis_lines(axes, a) if r in ln)
                assert res["groups"][a] == line, (r, a)


@pytest.mark.parametrize("axes", [None, {"pod": 2, "data": 2}],
                         ids=["data4", "pod2xdata2"])
def test_agent_only_meshes_keep_their_layout(axes):
    """An agent-only mesh keeps its coordinates, peers and shift keys (the
    values the sharded training tests were written against) and has no
    line groups."""
    for rank in range(4):
        m = mesh_lib.AgentMesh(rank=rank, size=4, backend="gloo", group=None,
                               device=torch.device("cpu"), axes=axes)
        assert m.groups == {} and m.agent_axes == m.axis_names
        if axes is None:
            assert m.coords(rank) == (rank,)
            assert m.peers(1) == ((rank - 1) % 4, (rank + 1) % 4)
            assert [m.shift_key(s) for s in range(4)] == [0, 1, 2, 3]
        else:
            p, d = divmod(rank, 2)
            assert m.coords(rank) == (p, d)
            assert m.peers(1, "data") == (p * 2 + 1 - d,) * 2
            assert m.peers((1, 1)) == (3 - rank,) * 2
            assert m.shift_key((1, 0)) == 2 and m.shift_key(1, "data") == 1


def _serve_shape(b=BATCH):
    return InputShape("d", SEQ, b, "decode")


@pytest.mark.parametrize("what,err,item", [
    ("train-model-axis", NotImplementedError, "A16.2.3"),
    ("train_hier", NotImplementedError, "A16.2.2"),
    ("serve-rwkv6", NotImplementedError, "A16.2.3"),
    ("serve-moe", NotImplementedError, "A16.2.3"),
    ("serve-vlm", NotImplementedError, "A16.2.3"),
    ("serve-mla", NotImplementedError, "A16.2.3"),
    ("serve-hybrid", NotImplementedError, "A16.2.3"),
    ("serve-encdec", NotImplementedError, "A16.2.3"),
    ("context-parallel", NotImplementedError, "A16.2.4"),
    ("serve-agent-only-mesh", ValueError, "model"),
])
def test_what_the_serve_mode_does_not_run_raises_at_build(what, err, item):
    tm = _port_mesh(AXES)
    cfg = ranks.lm_config()
    if what == "train-model-axis":
        # the dense family trains over the model axis; MoE's expert split
        # does not yet
        b = steps_lib.build_train_step(cfg, InputShape("t", SEQ, 8, "train"), tm,
                                       ranks.make_opt("cdmsgd", True),
                                       mixing="ppermute_fused")
        assert b.tp is not None and b.n_agents == AXES["data"]
        cfg = get_config("kimi-k2-1t-a32b").reduced()
    with pytest.raises(err, match=item):
        if what == "train-model-axis":
            steps_lib.build_train_step(cfg, InputShape("t", SEQ, 8, "train"), tm,
                                       ranks.make_opt("cdmsgd", True),
                                       mixing="ppermute_fused")
        elif what == "train_hier":
            steps_lib.build_train_step(cfg, InputShape("t", SEQ, 8, "train"),
                                       _port_mesh({"data": 4}),
                                       ranks.make_opt("cdmsgd", True),
                                       mode="train_hier", mixing="ppermute_fused")
        elif what.startswith("serve-") and what != "serve-agent-only-mesh":
            arch = {"serve-rwkv6": "rwkv6-1.6b", "serve-moe": "kimi-k2-1t-a32b",
                    "serve-vlm": "internvl2-2b", "serve-mla": "deepseek-v2-236b",
                    "serve-hybrid": "hymba-1.5b",
                    "serve-encdec": "seamless-m4t-medium"}[what]
            steps_lib.build_serve_step(get_config(arch).reduced(), _serve_shape(), tm)
        elif what == "context-parallel":
            steps_lib.build_prefill_step(cfg, InputShape("p", SEQ, BATCH, "prefill"),
                                         tm, context_parallel=True)
        else:
            steps_lib.build_serve_step(cfg, _serve_shape(), _port_mesh({"data": 4}))


# --------------------------------------------------------------------------
# the steps against the reference's sharded steps
# --------------------------------------------------------------------------

JAX_SERVE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch import sharding as shlib
    from repro.launch import steps as steps_lib
    from repro.launch.mesh import make_debug_mesh
    from repro.nn.transformer import init_cache

    src, out = sys.argv[1], sys.argv[2]
    data = np.load(src)
    spec = json.loads(str(data["spec"]))
    ids = np.vectorize(lambda d: d.id)
    res = {"devices/dataxmodel": ids(make_debug_mesh(2, 2).devices),
           "devices/podxdataxmodel": ids(make_debug_mesh(2, 2, multi_pod=True).devices)}
    mesh = make_debug_mesh(2, 2)
    leaf = lambda x: isinstance(x, P)
    for name, c in spec["configs"].items():
        cfg = dataclasses.replace(get_config(c["arch"]).reduced(),
                                  param_dtype="float32")
        if c["vocab"]:
            cfg = dataclasses.replace(cfg, vocab_size=c["vocab"])
        toks = jnp.asarray(data[f"{name}/tokens"])
        b = steps_lib.build_prefill_step(
            cfg, InputShape("p", spec["seq"], toks.shape[0], "prefill"), mesh)
        treedef = jax.tree.structure(b.param_specs, is_leaf=leaf)
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(data[f"{name}/p/{k}"]) for k in spec["keys"][name]])
        params = jax.device_put(params, shlib.named_tree(mesh, b.param_specs))
        (bs,) = b.input_structs
        batch = {k: jax.device_put(toks, bs[k].sharding)
                 for k in ("inputs", "targets")}
        with mesh:
            res[f"{name}/prefill"] = np.asarray(jax.jit(b.step_fn)(params, batch))
        for bsz in c["decode_batches"]:
            sb = steps_lib.build_serve_step(
                cfg, InputShape("d", spec["seq"], bsz, "decode"), mesh)
            cstructs, tstruct, _ = sb.input_structs
            cache = jax.device_put(init_cache(cfg, bsz, spec["seq"]),
                                   jax.tree.map(lambda s: s.sharding, cstructs))
            tok = jax.device_put(toks[:bsz, :1], tstruct.sharding)
            got = []
            with mesh:
                step = jax.jit(sb.step_fn)
                for i in range(c["steps"]):
                    tok, cache = step(params, cache, tok, jnp.int32(i))
                    got.append(np.asarray(tok))
            res[f"{name}/decode{bsz}/tokens"] = np.concatenate(got, axis=1)
            for path, x in jax.tree_util.tree_flatten_with_path(cache)[0]:
                key = "/".join(str(p.key) for p in path)
                res[f"{name}/decode{bsz}/cache/{key}"] = np.asarray(x)
    np.savez(out, **res)
""")


def _keys(tree):
    """Leaf paths in the trees' shared (sorted-key) order."""
    return ["/".join(path) for path, _ in tree_flatten_with_path(tree)]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_serve")
    rng = np.random.default_rng(5)
    spec = {"configs": CONFIGS, "seq": SEQ, "keys": {}}
    arrays, params, tokens = {}, {}, {}
    for name, c in CONFIGS.items():
        cfg = ranks.serve_config(c["arch"], c["vocab"])
        p = ranks.live_params(tt.model_template(cfg), seed=0)
        params[name] = p
        spec["keys"][name] = _keys(p)
        for k, (_, x) in zip(spec["keys"][name], tree_flatten_with_path(p)):
            arrays[f"{name}/p/{k}"] = x
        tokens[name] = rng.integers(1, cfg.vocab_size, size=(BATCH, SEQ))
        arrays[f"{name}/tokens"] = tokens[name].astype(np.int32)
    src, out = str(d / "inputs.npz"), str(d / "jax.npz")
    np.savez(src, spec=json.dumps(spec), **arrays)
    # XLA's intra-op thread pool spins for work: beside the other test
    # processes it stalls the host devices' collectives
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SERVE, src, out],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        path = str(d / "port.pt")
        torch.save({"configs": CONFIGS, "params": params, "tokens": tokens,
                    "seq": SEQ}, path)
        port = mesh_lib.spawn_agents(ranks.run_serve, 4, args=(path,),
                                     backend="gloo", device="cpu", timeout=60,
                                     join_timeout=300, axes=AXES)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"JAX serve steps failed:\n{err[-4000:]}"
    got = dict(np.load(out))
    jax_out = {"devices": {"dataxmodel": got.pop("devices/dataxmodel"),
                           "podxdataxmodel": got.pop("devices/podxdataxmodel")}}
    jax_out.update(got)
    return {"jax": jax_out, "port": port}


def _rows(rank: int, b: int) -> slice:
    """This rank's rows of a batch of ``b`` on the 2 x 2 mesh (over data)."""
    if b % AXES["data"]:
        return slice(0, b)
    d, n = divmod(rank, AXES["model"])[0], b // AXES["data"]
    return slice(d * n, (d + 1) * n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_last_logits_match_the_jax_sharded_step(both, name):
    want = both["jax"][f"{name}/prefill"]
    top = float(np.max(np.abs(want)))
    gaps = []
    for r, res in enumerate(both["port"]):
        got = res[name]["prefill"].numpy()
        assert got.shape == want[_rows(r, BATCH)].shape
        gaps.append(float(np.max(np.abs(got - want[_rows(r, BATCH)]))))
    print(f"{name}: prefill last logits, 4 ranks vs the JAX sharded step, max gap "
          f"{max(gaps):.3e} of max |logit| {top:.3e}")
    assert max(gaps) <= LOGIT_TOL * top


@pytest.mark.parametrize("name,b", [(n, b) for n, c in CONFIGS.items()
                                    for b in c["decode_batches"]])
def test_decode_tokens_and_caches_match_the_jax_sharded_step(both, name, b):
    cfg = ranks.serve_config(CONFIGS[name]["arch"], CONFIGS[name]["vocab"])
    tokens = both["jax"][f"{name}/decode{b}/tokens"]
    for r, res in enumerate(both["port"]):
        got = res[name][f"decode{b}"]["tokens"].numpy()
        np.testing.assert_array_equal(got, tokens[_rows(r, b)])
    specs = sh.cache_partition_specs(cfg, _serve_shape(b), _port_mesh(AXES))
    cache = global_from_shards([res[name][f"decode{b}"]["cache"]
                                for res in both["port"]], specs, _port_mesh(AXES))
    gaps = []
    for path, x in tree_flatten_with_path(cache):
        want = both["jax"][f"{name}/decode{b}/cache/" + "/".join(path)]
        assert x.shape == want.shape
        gaps.append(float(np.max(np.abs(x.numpy() - want))))
    split = [sp.axes for _, sp in tree_flatten_with_path(specs)][0]
    print(f"{name}: {CONFIGS[name]['steps']} greedy decode steps at batch {b} "
          f"(cache spec {split}), "
          f"tokens equal, reassembled caches max gap {max(gaps):.3e}")
    assert max(gaps) <= CACHE_TOL


def test_axis_collectives_gather_and_sum_over_each_line(both):
    """``all_gather`` over ``data`` (stacked), over ``model`` (concatenated),
    over every axis, and ``all_reduce_sum`` over ``model``, float32 and
    bfloat16, against the ranks' own values."""
    ranks.check_axis_collectives([res["collectives"] for res in both["port"]], AXES)


def test_the_census_counts_the_collectives_by_axis(both):
    for res in both["port"]:
        by = res["census"]["by_axis"]
        # fsdp gathers over data; partial sums, logits and partials over
        # model; the batch-1 decode's partials over every axis
        assert set(by) == {"data", "model", "data+model"}
        assert all(c["calls"] > 0 and c["bytes"] > 0 for c in by.values())
        assert res["census"]["collectives"] == sum(c["calls"] for c in by.values())
