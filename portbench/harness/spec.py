"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's file
is ``BENCHMARK.json``'s ``file``, the mix is ``portbench/traffic/<mix>.json``,
the cell's correctness limits are ``portbench/limits/<cell>.json``, and a
per-layer metric's reader is ``portbench/metrics/<metric>.py``.  A new
cell, configuration, mix or metric is new files and entries: nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Spec:
    def __init__(self, root: str = ROOT, bench_dir: Optional[str] = None,
                 traffic_overrides: Optional[Dict] = None):
        self.root = root
        self.bench_dir = bench_dir or os.path.join(root, "portbench")
        # parameters set over every mix's own (the calibration and sweep
        # tools), never by a benchmark run
        self.traffic_overrides = traffic_overrides or {}
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return {**self._json("traffic", name), **self.traffic_overrides}

    def limits(self, cell: str) -> Dict:
        return self._json("limits", cell)

    def _json(self, kind: str, name: str) -> Dict:
        with open(os.path.join(self.bench_dir, kind, name + ".json")) as f:
            return json.load(f)

    def _applies(self, metric: Dict, cell: str, reported: List[str]) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves") in reported if "moves" in metric \
            else True

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"]
                if self._applies(m, cell, [])]

    def per_layer(self, cell: str) -> List[Dict]:
        reported = [m["name"] for m in self.end_to_end(cell)]
        return [m for m in self.data["per_layer"]
                if self._applies(m, cell, reported)]

    def reader(self, metric: str):
        """The ``read`` function of ``portbench/metrics/<metric>.py``."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
