"""Roofline aggregation: the dry-run records -> the roofline table.

The port of ``benchmarks/roofline.py``: reads every record that
:mod:`repro_torch.launch.dryrun` wrote under ``results/dryrun_torch/``
and prints one ``roofline/<arch>__<shape>__<mesh><tag>`` CSV row per traced
record (``tag``: the dry-run's ``--tag``): the three terms in seconds on an H100
(:data:`repro_torch.analysis.roofline.HW_H100`), the dominant term, the
MODEL_FLOPS / counted-FLOPs ratio and whether the op counter's peak of
live bytes fits the card's 80 GB.  A record with an ``update_cost`` block
(a top-k compressor) adds a ``roofline/update_cost/...`` row pricing the
fused update's dense and sparse operand forms.  The markdown table goes
to ``results/roofline_torch.md``.  Skipped records (prefill and decode
shapes, ROADMAP A16.2) are listed in the table as skipped.
"""

from __future__ import annotations

import glob
import os
import time

from repro_torch.analysis.records import load_dryrun_record, verify_summary

RESULTS = os.path.join("results", "dryrun_torch")
TABLE = os.path.join("results", "roofline_torch.md")


def load_records(results: str = RESULTS, pattern: str = "*.json"):
    return [load_dryrun_record(p)
            for p in sorted(glob.glob(os.path.join(results, pattern)))]


def run(mesh_filter: str = "", device=None, results: str = RESULTS,
        table: str = TABLE):
    """Print the rows; ``device`` is accepted for the runner's signature
    (the table reads records and runs nothing)."""
    del device
    recs = load_records(results)
    rows = []
    md = ["| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
          "| dominant | useful-FLOP ratio | fits H100 80GB | verify |",
          "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if mesh_filter and r.get("mesh") != mesh_filter:
            continue
        if r.get("status") != "ok":
            if "skip" in str(r.get("status", "")):
                md.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                          f"| — | skipped ({r['status'][6:]}) | — | — | — |")
            continue
        rl = r["roofline"]
        key = f"{r['arch']}__{r['shape']}__{r['mesh']}{r.get('tag', '')}"
        name = f"roofline/{key}"
        ratio = rl["useful_flops_ratio"]
        ratio_s = f"{ratio:.3f}" if ratio == ratio else "n/a"
        fits = r["fits_h100_80gb"]
        derived = (f"compute={rl['compute_s']:.3e};memory={rl['memory_s']:.3e};"
                   f"collective={rl['collective_s']:.3e};"
                   f"dominant={rl['dominant']};useful_ratio={ratio_s};"
                   f"fits={fits};peak_gib="
                   f"{r['peak_bytes_per_device'] / 2**30:.2f}")
        rows.append((name, derived))
        md.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                  f"| {rl['compute_s']:.3e} | {rl['memory_s']:.3e} "
                  f"| {rl['collective_s']:.3e} | **{rl['dominant']}** "
                  f"| {ratio_s} | {fits} | {verify_summary(r)} |")
        uc = r.get("update_cost")
        if uc:
            rows.append((
                f"roofline/update_cost/{key}",
                f"sparse_update={uc['sparse_update']};"
                f"dense_bytes={uc['dense_bytes']};"
                f"sparse_bytes={uc['sparse_bytes']};"
                f"bytes_ratio={uc['bytes_ratio']:.2f};"
                f"flops_ratio={uc['flops_ratio']:.2f};"
                f"n_buckets={len(uc['per_bucket'])}"))
    t0 = time.time()
    for name, derived in rows:
        print(f"{name},{1e6 * (time.time() - t0):.1f},{derived}")
    os.makedirs(os.path.dirname(table) or ".", exist_ok=True)
    with open(table, "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"roofline/markdown_table,0.0,written={table};rows={len(rows)}")
    return rows


if __name__ == "__main__":
    run()
