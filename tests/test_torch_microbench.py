"""The kernel microbenchmark (``repro_torch.benchmarks.kernel_microbench``)
on the CPU, at smoke counts, against the reference's
(``benchmarks/kernel_microbench.py``):

* every row name of the reference's smoke run, in order, and its records;
* the figures that depend on no device equal the reference functions'
  values: wire bytes per precision, the sweep ratios 5/7 and 7/10, ring
  bytes independent of S, error feedback adding 0 bytes, k rounds at k x
  the sync bytes, the mixed momentum at 2x, and the sparse / dense byte
  ratio of the top-k update;
* every row is marked as the plain versions' CPU time, no card's.
"""

import json
import os
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# one torch thread: under the suite's -n 6, torch's thread per core stalls
from torch_zoo_carry import one_torch_thread  # noqa: E402, F401
import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as jroof  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import flatbuf as jflat  # noqa: E402
from repro.core.topology import make_topology as jtopo  # noqa: E402
from repro_torch.benchmarks import kernel_microbench as kmb  # noqa: E402

REF = Path(__file__).resolve().parents[1] / "benchmarks" / "kernel_microbench.py"


def _reference_smoke_names():
    src = REF.read_text()
    names = re.findall(r'"(kernel/[a-z0-9_]+)"', src)
    tail = src[src.index("    if smoke:"):]
    late = set(re.findall(r'"(kernel/[a-z0-9_]+)"', tail))
    return [n for n in names if n not in late]


@pytest.fixture(scope="module")
def bench():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = kmb.run(smoke=True, device="cpu")
    line = [x for x in buf.getvalue().splitlines() if x.startswith("JSON,")][-1]
    records = {r["bench"]: r for r in json.loads(line[len("JSON,"):])}
    return rows, records


def test_every_row_and_record_of_the_reference(bench):
    rows, records = bench
    names = [r[0] for r in rows]
    assert len(names) == len(set(names))
    assert set(names) == set(_reference_smoke_names())
    want = set(re.findall(r'"bench": "(consensus/[a-z_]+)"', REF.read_text()))
    assert set(records) == want
    for name, us, derived in rows:
        assert "device=cpu" in derived, name
        if name in ("kernel/consensus_update", "kernel/sparse_update"):
            assert "bound_ms=" in derived and "bound_share=" in derived


def test_wire_bytes_per_precision(bench):
    _, records = bench
    spec = jflat.make_flat_spec(
        {"w": jax.ShapeDtypeStruct((1024, 1024), jnp.float32)})
    want = {e: jcons.exchange_bytes_per_step(spec, jtopo("ring", 8), e)
            ["per_step_bytes"] for e in jflat.EXCHANGE_DTYPES}
    assert records["consensus/exchange_wire"]["per_step_bytes"] == want
    assert records["consensus/hbm_ratio"] == {
        "bench": "consensus/hbm_ratio",
        "cdsgd": {"fused_sweeps": 5, "unfused_sweeps": 7},
        "cdmsgd": {"fused_sweeps": 7, "unfused_sweeps": 10}}
    bucket = records["consensus/bucketed_model_update"]
    assert bucket["kernel_launches"] == {"per_leaf": 8, "fused": 2}
    alias = records["consensus/alias_accounting"]
    assert alias["aliased"]["extra_output_bytes"] == 0
    assert alias["unaliased"]["extra_output_bytes"] == 2 * alias["bucket_bytes"]


def test_schedule_rounds_momentum_and_ring_bytes(bench):
    _, records = bench
    spec = jflat.make_flat_spec({"w": jax.ShapeDtypeStruct((4, 256, 128), jnp.float32),
                                 "b": jax.ShapeDtypeStruct((4, 300), jnp.float32)},
                                lead=1)
    int8 = spec.exchange_bytes("int8")
    ov = records["consensus/schedule_overlap"]["wire_bytes_per_neighbor"]
    assert ov == {"sync": int8, "overlap": int8}
    mr = records["consensus/multi_round"]
    assert mr["wire_bytes_per_step"]["k3"] == 3 * mr["wire_bytes_per_step"]["k1"]
    assert mr["wire_bytes_per_step"]["k1_ef"] == mr["wire_bytes_per_step"]["k1"]
    assert mr["ef_wire_bytes_per_neighbor"] == {"plain": int8, "ef": int8}
    mm = records["consensus/momentum_mix"]
    assert mm["wire_bytes_per_neighbor_from_buffers"]["mixed"] == 2 * int8
    ring = records["consensus/stale_ring"]
    assert set(ring["wire_bytes_per_neighbor"].values()) == {int8}
    assert ring["sync_wire_bytes_per_neighbor"] == int8
    fr = records["consensus/compressor_frontier"]
    assert fr["wire_bytes_per_neighbor"]["int8"] == int8
    assert fr["bytes_ratio_f32_over_topk001"] >= 25


def test_sparse_over_dense_bytes(bench):
    _, records = bench
    spec = jflat.make_flat_spec(
        {"w": jax.ShapeDtypeStruct((kmb.ROWS_N * 128,), jnp.float32)})
    for p, got in records["consensus/sparse_update"]["per_density"].items():
        prog = jcons.make_mixing_program(jtopo("ring", 4), compressor=f"topk:{p}",
                                         error_feedback=True)
        cost = jroof.consensus_update_cost(spec, prog, 2)
        assert got["hbm_bytes"] == {"dense": cost["dense_bytes"],
                                    "sparse": cost["sparse_bytes"]}
        assert got["hbm_bytes_ratio"] == round(cost["bytes_ratio"], 2)
        assert got["max_abs_diff_dense_vs_sparse"] < 1e-5
