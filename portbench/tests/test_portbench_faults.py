"""Whole runs of each cell on the CPU at a test's size (the harness's look
for a card skipped), sound and with the timed path broken underneath:
a sound run is ``correct``, and each fault the cell can have makes it
not ``correct``.  Faults: an answer altered where it is produced, an
unparseable SMILES answered; a train step that returns its state
unchanged, half of each batch left out (the mean over the rest).  One
card, so no exchange between chips to leave out.  The HTTP serving cell,
which ``BENCHMARK.json`` does not hold yet (PERF.md), runs from its
files with its entries added here."""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.harness import runner  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402

SMALL = {
    "flagship.score": ({"pool": 256, "chunk": 128, "warmup_calls": 1,
                        "check_molecules": 256}, 0.5),
    "flagship.serve_http": ({"pool": 256, "rate": 6, "check_molecules": 999,
                             "invalid_share": 0.1, "oversize_share": 0.1,
                             "sizes": [[0.6, 1, 1], [0.4, 2, 8]],
                             "warmup_requests": [1, 8],
                             "drain_seconds": 30}, 2.0),
    "flagship.train": ({"rows": [384, 64]}, 0.5),
}


SERVE_CELL = {"name": "flagship.serve_http", "config": "flagship",
              "traffic": "serve_http", "chips": 1, "why": "a test's cell"}
SERVE_METRIC = {"name": "request_p95_ms", "unit": "ms", "better": "lower",
                "bound": 0.25, "source": "host_clock",
                "workloads": ["flagship.serve_http"]}


def run(cell):
    over, seconds = SMALL[cell]
    spec = Spec(ROOT, traffic_overrides=over)
    if cell == SERVE_CELL["name"]:
        spec.data["workloads"].append(SERVE_CELL)
        spec.data["end_to_end"].append(SERVE_METRIC)
    runner.prepare_env(ROOT)
    return runner.run(spec, cell, 4_294_967_311, seconds, False, 0.0,
                      device="cpu")


def _altered(how):
    from mgat_graphsage_torch.eval import predict

    orig = predict.Predictor.__call__

    def call(self, smiles, batch_size=64):
        out = orig(self, smiles, batch_size)
        if how == "answer":
            out = out + np.float32(0.01)      # NaN stays NaN
        else:
            out = np.nan_to_num(out, nan=6.5)
        return out

    return call


@pytest.mark.parametrize("cell", ["flagship.score", "flagship.serve_http"])
@pytest.mark.parametrize("fault", [None, "answer", "nan"])
def test_serving_cells(cell, fault, monkeypatch):
    if fault:
        from mgat_graphsage_torch.eval import predict

        monkeypatch.setattr(predict.Predictor, "__call__", _altered(fault))
    res = run(cell)
    assert res["correct"] is (fault is None), res["checks"]


def _unchanged(orig):
    def train_step(self, state, batch, *a, **kw):
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        out = orig(self, state, batch, *a, **kw)
        with torch.no_grad():
            state.model.load_state_dict(before)
        return out
    return train_step


def _half(orig):
    def batches(self, ds, batch_size, rng=None, shard=False):
        for b in orig(self, ds, batch_size, rng, shard):
            b["sample_mask"] = b["sample_mask"].clone()
            b["sample_mask"][batch_size // 2:] = 0.0
            yield b
    return batches


@pytest.mark.parametrize("fault", [None, "unchanged", "half"])
def test_train_cell(fault, monkeypatch):
    from mgat_graphsage_torch.train import trainer

    if fault == "unchanged":
        monkeypatch.setattr(trainer.Trainer, "train_step",
                            _unchanged(trainer.Trainer.train_step))
    elif fault == "half":
        monkeypatch.setattr(trainer.Trainer, "_batches",
                            _half(trainer.Trainer._batches))
    res = run("flagship.train")
    assert res["correct"] is (fault is None), res["checks"]
