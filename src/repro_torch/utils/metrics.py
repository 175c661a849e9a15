"""Lightweight metric logging: CSV and in-memory history (copy of
:mod:`repro.utils.metrics`)."""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional


class MetricHistory:
    """In-memory step -> metrics store with simple reductions."""

    def __init__(self) -> None:
        self._rows: List[Dict[str, float]] = []

    def log(self, step: int, **metrics: float) -> None:
        row = {"step": float(step)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._rows.append(row)

    @property
    def rows(self) -> List[Dict[str, float]]:
        return list(self._rows)

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self._rows if key in r]

    def last(self, key: str) -> Optional[float]:
        s = self.series(key)
        return s[-1] if s else None

    def moving_average(self, key: str, window: int = 10) -> List[float]:
        s = self.series(key)
        out = []
        for i in range(len(s)):
            lo = max(0, i - window + 1)
            out.append(sum(s[lo : i + 1]) / (i - lo + 1))
        return out


class CSVLogger:
    """Append-only CSV metric logger (creates header lazily)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fields: Optional[List[str]] = None
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def log(self, **metrics) -> None:
        first = self._fields is None
        if first:
            self._fields = list(metrics.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if first:
                w.writeheader()
            w.writerow(metrics)
