"""Structured metric logging (the port's copy of
``mgat_graphsage_tpu/utils/logging.py``; the reference logs via bare
``print`` and persists results only as ad-hoc CSVs).

``MetricLogger`` writes one JSONL row per call and can mirror to a CSV
with a stable column set; both formats are what the eval/report tooling
reads back.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

__all__ = ["MetricLogger", "read_jsonl"]


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 csv_path: Optional[str] = None,
                 echo: bool = False):
        self.jsonl_path = jsonl_path
        self.csv_path = csv_path
        self.echo = echo
        self._csv_cols: Optional[List[str]] = None
        for p in (jsonl_path, csv_path):
            if p:
                os.makedirs(os.path.dirname(p) or ".", exist_ok=True)

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        row = {"time": time.time()}
        if step is not None:
            row["step"] = step
        row.update({k: v for k, v in metrics.items()
                    if isinstance(v, (int, float, str, bool))})
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self.csv_path:
            if self._csv_cols is None:
                self._csv_cols = list(row)
                if not os.path.exists(self.csv_path) or \
                        os.path.getsize(self.csv_path) == 0:
                    with open(self.csv_path, "a") as f:
                        f.write(",".join(self._csv_cols) + "\n")
            with open(self.csv_path, "a") as f:
                f.write(",".join(str(row.get(c, "")) for c in
                                 self._csv_cols) + "\n")
        if self.echo:
            print(" | ".join(f"{k}={v}" for k, v in row.items()
                             if k != "time"))


def read_jsonl(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
