"""The dry-run (``repro_torch.launch.dryrun``): one rank's gemma3-1b
``train_4k`` step at full width and depth traced on ``meta`` (16 agents,
16 sequences of 4,096 a rank, CDMSGD on a top-k wire with error feedback
under overlap), nothing allocated:

* a schema-2 record that ``load_dryrun_record`` reads, with the roofline
  on the H100 and the verify block's value rules skipped;
* ``exchange_bytes_per_step`` and ``update_cost`` equal the reference's
  functions on the same spec and program;
* ``dot_flops`` equals, within 1%, a closed form from the config's shapes:
  the block and head matmuls and the attention products (banded over
  1,024 keys on the 22 local layers, all 4,096 on the 4 global ones) of
  the forward, twice that for the backward, and the blocks' forward again
  for remat's recompute;
* prefill and decode shapes write the ROADMAP A16.2 skip.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# one torch thread: under the suite's -n 6, torch's thread per core stalls
from torch_zoo_carry import one_torch_thread  # noqa: E402, F401

from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import flatbuf as jflat  # noqa: E402
from repro.core.topology import make_topology as jtopo  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.analysis.records import load_dryrun_record  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

AGENTS, B, S = 16, 16, 4096
TOPK = "topk:0.01"


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k",
                        "--exchange", "int8", "--schedule", "overlap",
                        "--compressor", TOPK, "--error-feedback",
                        "--out", str(out)]) == 0
    (path,) = out.glob("*.json")
    return load_dryrun_record(str(path)), out


def test_a_v2_record_at_full_size(record):
    rec, _ = record
    assert rec["version"] == 2 and rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "data16" and rec["chips"] == AGENTS
    rl = rec["roofline"]
    assert rl["mesh"] == "data16" and rl["dominant"] in ("compute", "memory",
                                                         "collective")
    assert rec["peak_bytes_per_device"] > rec["argument_bytes_per_device"] > 0
    assert rec["fits_h100_80gb"] == (rec["peak_bytes_per_device"] < 80e9)
    assert rec["collective_count"]["collective-permute"] > 0
    assert rec["mixing_program"]["compressor"] == TOPK
    v = {r["rule"]: r for r in rec["verify"]["rules"]}
    assert rec["verify"]["ok"], [r for r in v.values() if not r["ok"]]
    for rule in ("census.ppermute_count", "bytes.wire_vs_program",
                 "bytes.hlo_collective_permute", "seeds.strides_distinct",
                 "sparse.shape_contract", "sparse.k_rows_clamp"):
        assert v[rule]["ok"] and not v[rule]["skipped"], rule
    for rule in ("census.critical_path", "alias.fused_coverage",
                 "sparse.index_bounds"):
        assert v[rule]["skipped"] and "launch.check" in v[rule]["detail"]


def test_bytes_and_update_cost_equal_the_reference(record):
    rec, _ = record
    jc = jget("gemma3-1b")
    jspec = jflat.make_flat_spec(jax.tree.map(
        lambda pd: jax.ShapeDtypeStruct(pd.shape, pd.dtype), jt.model_template(jc),
        is_leaf=lambda x: isinstance(x, jparam.ParamDef)))
    topo = jtopo("ring", AGENTS)
    prog = jcons.make_mixing_program(topo, compressor=TOPK, error_feedback=True,
                                     exchange="int8")
    want = jcons.exchange_bytes_per_step(jspec, topo, prog.exchange, prog.rounds,
                                         prog.n_payloads, program=prog)
    assert rec["exchange_bytes_per_step"] == want
    cost = jroof.consensus_update_cost(jspec, prog, 2)
    assert rec["update_cost"] == {"sparse_update": prog.sparse_update, **cost}
    assert rec["collective_bytes"]["collective-permute"] \
        == want["per_step_bytes"]


def test_dot_flops_equal_the_closed_form(record):
    rec, _ = record
    c = get_config("gemma3-1b")
    d, h, kv, hd, ff, v = (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim_,
                           c.d_ff, c.vocab_size)
    tokens, layers = B * S, c.n_layers
    proj = 2 * tokens * (2 * d * h * hd + 2 * d * kv * hd)      # q, o; k, v
    mlp = 2 * tokens * 3 * d * ff                               # gated
    span = min(c.attn_chunk + -(-c.window // c.attn_chunk) * c.attn_chunk, S)
    n_global = sum(c.layer_is_global(i) for i in range(layers))
    attn = 4 * B * S * h * hd * ((layers - n_global) * span + n_global * S)
    blocks = layers * (proj + mlp) + attn
    head = 2 * tokens * d * v
    want = 3 * (blocks + head) + blocks          # forward, backward, remat
    got = rec["roofline"]["hlo_flops_per_device"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert rec["roofline"]["useful_flops_ratio"] > 0.5


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_serving_shapes_record_the_skip(record, shape):
    _, out = record
    rec = dryrun.run_pair("gemma3-1b", shape, out_dir=str(out), verbose=False)
    assert rec["status"].startswith("skip") and "A16.2" in rec["status"]
    got = load_dryrun_record(str(out / f"gemma3-1b__{shape}__data16__"
                                       "train_ppermute_fused.json"))
    assert got["verify"] is None and got["version"] == 2
