"""Loaders for the JSON records that :mod:`repro_torch.launch.dryrun`
writes, with schema versioning (the port of :mod:`repro.analysis.records`).

A record carries

* ``version`` — the integer schema version (:data:`DRYRUN_SCHEMA_VERSION`);
* ``verify``  — the wire-contract checker's report
  (:meth:`repro_torch.analysis.staticcheck.CheckReport.as_dict`), or
  ``None`` when the checker did not run (non-train shapes, records of
  schema 1), or a ``"FAIL: ..."`` string when it crashed.

:func:`load_dryrun_record` normalizes records of any version, so the
readers (``benchmarks/roofline.py``) see one shape: a missing ``version``
means 1, a missing ``verify`` means None.
"""

import json

# bump when the record's shape changes; the loaders keep reading every
# older version
DRYRUN_SCHEMA_VERSION = 2


def load_dryrun_record(path):
    """Read one dry-run record, normalized to the current schema:
    ``version`` defaults to 1 and ``verify`` to None."""
    with open(path) as f:
        rec = json.load(f)
    rec.setdefault("version", 1)
    rec.setdefault("verify", None)
    return rec


def verify_summary(rec):
    """One-line summary of a record's verify block: ``"not run"``, the
    failure string, or ``"ok (N rules)"`` / ``"FAIL: rule, rule"``."""
    v = rec.get("verify")
    if v is None:
        return "not run"
    if isinstance(v, str):
        return v
    rules = v.get("rules", [])
    bad = [r["rule"] for r in rules if not r.get("ok", False)
           and not r.get("skipped", False)]
    if bad:
        return "FAIL: " + ", ".join(bad)
    return f"ok ({len(rules)} rules)"
