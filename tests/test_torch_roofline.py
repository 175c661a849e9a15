"""The port's roofline arithmetic and dry-run records against the
reference's (``repro.analysis.roofline`` / ``records``), bit for bit.

* ``roofline_from_stats`` / ``RooflineTerms.as_dict`` equal the
  reference's for the same stats and the same hardware fields (the test
  builds the port's ``Hardware`` from the reference's TPU figures; the port
  itself stores only the H100's);
* ``model_flops`` for every config and input shape;
* ``consensus_update_cost`` for a ``topk:`` program on the CNN's spec;
* ``kernel_bound`` at phase 3's path shapes reproduces ``PERF.md`` §6's
  bounds (H100 SXM5: 3.35e12 B/s, 67e12 float32 FLOP/s);
* the records of schema 1 and 2, written to ``tmp_path``.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import records as jrecords  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.analysis.hlo import HloStats  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import flatbuf as jflat  # noqa: E402
from repro.core.topology import make_topology as jtopo  # noqa: E402
from repro.nn.paper_models import cnn_classifier_template as jcnn  # noqa: E402
from repro_torch.analysis import opcount, records, roofline  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.core import consensus, flatbuf, make_topology  # noqa: E402
from repro_torch.nn.paper_models import cnn_classifier_template  # noqa: E402

PATH_ROWS = 16941            # chip_smoke phase 3: one f32 bucket of the CNN


def _stats(cls):
    return cls(collective_bytes={"all-reduce": 40e9, "collective-permute": 3e9},
               dot_flops=2e14, traffic_bytes=5e11,
               collective_count={"all-reduce": 1, "collective-permute": 4},
               trip_counts={})


@pytest.mark.parametrize("peak_memory", [None, 12e9])
def test_roofline_terms_equal_the_reference(peak_memory):
    hw = roofline.Hardware(**dataclasses.asdict(jroof.HW_V5E))
    kw = dict(arch="x", shape="y", mesh="m", chips=256,
              model_flops_total=1e16, xla_cost_flops=None,
              peak_memory_bytes=peak_memory)
    want = jroof.roofline_from_stats(stats=_stats(HloStats), **kw)
    got = roofline.roofline_from_stats(
        stats=_stats(opcount.StepStats), hw=hw, **kw)
    assert got.as_dict() == want.as_dict()
    assert got.mfu_bound == want.mfu_bound
    assert got.dominant == want.dominant


def test_the_card_and_the_mfu():
    hw = roofline.HW_H100
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.hbm_bytes, hw.f32_flops) \
        == (989e12, 3.35e12, 450e9, 80e9, 67e12)
    t = roofline.roofline_from_stats(
        arch="x", shape="y", mesh="m", chips=2, stats=_stats(opcount.StepStats),
        model_flops_total=989e12)
    assert t.compute_s == 2e14 / 989e12
    assert t.mfu_bound == 989e12 / (2 * 989e12 * t.step_time_lower_bound)


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_model_flops_equal_the_reference(shape):
    for arch in list_archs():
        assert roofline.model_flops(get_config(arch), INPUT_SHAPES[shape]) \
            == jroof.model_flops(jget(arch), J_SHAPES[shape]), (arch, shape)


@pytest.mark.parametrize("compressor", ["topk:0.01", "topk:0.1",
                                        "topk:auto:65536"])
def test_consensus_update_cost_equals_the_reference(compressor):
    tmpl = cnn_classifier_template(32, 3, 10)
    spec = flatbuf.make_flat_spec(
        {k: {n: torch.empty(pd.shape, dtype=pd.dtype, device="meta")
             for n, pd in v.items()} for k, v in tmpl.items()})
    jspec = jflat.make_flat_spec(jax.tree.map(
        lambda pd: jax.ShapeDtypeStruct(pd.shape, jnp.float32), jcnn(32, 3, 10),
        is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init")))
    prog = consensus.make_mixing_program(make_topology("ring", 5),
                                         compressor=compressor,
                                         error_feedback=True)
    jprog = jcons.make_mixing_program(jtopo("ring", 5), compressor=compressor,
                                      error_feedback=True)
    assert roofline.consensus_update_cost(spec, prog, 2) \
        == jroof.consensus_update_cost(jspec, jprog, 2)
    with pytest.raises(ValueError, match="top-k"):
        roofline.consensus_update_cost(
            spec, consensus.make_mixing_program(make_topology("ring", 5)), 2)


@pytest.mark.parametrize("name,args,want", [
    ("cdsgd_update", (5, 5, PATH_ROWS), 0.03884),
    ("cdsgd_update_q", (5, 5, PATH_ROWS, torch.int8), 0.04218),
    ("cdmsgd_update", (5, 5, PATH_ROWS), 0.06473),
    ("cdmsgd_update_q", (5, 5, PATH_ROWS, torch.int8), 0.06807),
    ("cdmsgd_update_qm", (5, 5, PATH_ROWS, torch.int8), 0.07141),
    ("cdmsgd_update_qm", (5, 5, PATH_ROWS, torch.float32), 0.09082),
    ("sr_quantize", (5, 0, PATH_ROWS, torch.int8), 0.01628),
])
def test_kernel_bound_reproduces_the_table(name, args, want):
    ms, by = roofline.kernel_bound(name, *args)
    assert by == "bytes"
    assert round(ms, 5) == want


def _v1_record():
    return {"arch": "gemma3-1b", "shape": "train_4k", "mesh": "data16",
            "status": "ok"}


def test_records_of_both_versions(tmp_path):
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps(_v1_record()))
    v2 = tmp_path / "v2.json"
    rec2 = dict(_v1_record(), version=2, verify={
        "rules": [{"rule": "census.ppermute_count", "ok": True},
                  {"rule": "alias.fused_coverage", "ok": True, "skipped": True},
                  {"rule": "bytes.wire_vs_program", "ok": False}]})
    v2.write_text(json.dumps(rec2))
    assert records.DRYRUN_SCHEMA_VERSION == jrecords.DRYRUN_SCHEMA_VERSION == 2
    for path in (v1, v2):
        got = records.load_dryrun_record(str(path))
        assert got == jrecords.load_dryrun_record(str(path))
        assert records.verify_summary(got) == jrecords.verify_summary(got)
    assert records.verify_summary(records.load_dryrun_record(str(v1))) == "not run"
    assert records.verify_summary(records.load_dryrun_record(str(v2))) \
        == "FAIL: bytes.wire_vs_program"
    assert records.verify_summary({"verify": "FAIL: boom"}) == "FAIL: boom"
    ok = dict(rec2, verify={"rules": [{"rule": "a", "ok": True}]})
    assert records.verify_summary(ok) == jrecords.verify_summary(ok) == "ok (1 rules)"
    assert np.isfinite(roofline.HW_H100.peak_flops)
