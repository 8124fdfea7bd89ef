"""BENCHMARK.json against the contract's character rules, the files each
entry names, the import rules of the harness and the reference, and
discovery by name: a copy with one more configuration, mix, limits and
metric file runs with no edit of the harness."""

import ast
import json
import os
import re
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench.harness.spec import Spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mgat_graphsage_tpu"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    every = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(every) == len(set(every))


def test_every_entry_has_its_files():
    spec = Spec(ROOT)
    for w in spec.data["workloads"]:
        spec.config(w["config"])
        tr = spec.traffic(w["traffic"])
        assert os.path.exists(os.path.join(
            BENCH, "harness", "drivers", tr["driver"] + ".py"))
        assert spec.limits(w["name"])
        reported = spec.per_layer(w["name"])
        assert reported, w["name"]
        for m in reported:
            assert callable(spec.reader(m["name"]))


def _imports(path):
    tree = ast.parse(open(path).read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return [m.split(".", 1)[0] for m in out if m]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_and_the_reference_takes_nothing_of_the_program():
    for path in _sources(BENCH):
        assert not FORBIDDEN & set(_imports(path)), path
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "mgat_graphsage_torch" not in _imports(path), path


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = bench()
    b["configs"].append({**b["configs"][0], "name": "flagship_copy",
                         "file": "portbench/configs/flagship_copy.json"})
    b["workloads"].append({"name": "flagship_copy.score_small",
                           "config": "flagship_copy",
                           "traffic": "score_small", "chips": 1,
                           "why": "a test's cell"})
    b["per_layer"].append({"name": "calls.score_small", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "model forward",
                           "moves": "score_mol_per_s",
                           "workloads": ["flagship_copy.score_small"]})
    b["end_to_end"][0]["workloads"].append("flagship_copy.score_small")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    pb = root / "portbench"
    shutil.copy(pb / "configs/flagship.json",
                pb / "configs/flagship_copy.json")
    tr = json.loads((pb / "traffic/score.json").read_text())
    tr.update(pool=256, chunk=128, warmup_calls=1, check_molecules=64,
              trace_seconds=0.1)
    (pb / "traffic/score_small.json").write_text(json.dumps(tr))
    shutil.copy(pb / "limits/flagship.score.json",
                pb / "limits/flagship_copy.score_small.json")
    (pb / "metrics/calls.score_small.py").write_text(
        "def read(r):\n    return r.counters['molecules'] / 128\n")
    from portbench.harness import runner

    spec = Spec(str(root))
    assert [m["name"] for m in spec.per_layer("flagship_copy.score_small")
            ] == ["calls.score_small"]
    res = runner.run(spec, "flagship_copy.score_small", 5, 0.5, True, 0.0,
                     device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["calls.score_small"]["value"] >= 1


def test_no_card_no_result():
    """The command refuses to measure without a CUDA device."""
    import subprocess

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "flagship.score", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
