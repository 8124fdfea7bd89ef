"""The plain reference against the program on the CPU, at small sizes: the
featuriser copy bit for bit against the program's Python featuriser, the
weights' names and shapes against the program's model, the forward pass
against the program's, and the controls and a fault, which must part
from the reference by more than the limits.  (A train step against the
program's: ``test_portbench_faults.py``.)"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.harness import check, traffic, weights  # noqa: E402
from portbench.reference import featurize as ref_feat  # noqa: E402

SEED = 2_718_281_828


def conf(name="flagship"):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def limits(cell):
    with open(os.path.join(ROOT, "portbench", "limits", cell + ".json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def smiles(n=96):
    tr = {"pool": n, "invalid_share": 0.05, "oversize_share": 0.05}
    return traffic.library_pool(tr, SEED, 80)


def test_featuriser_copy_is_the_programs_bit_for_bit():
    from mgat_graphsage_torch.data import MolecularDataset

    sm = smiles()
    kept, nodes, edges, nmask, emask, fp = ref_feat.featurize(sm, 80, 176)
    ds = MolecularDataset(sm, np.zeros(len(sm), np.float32), max_nodes=80,
                          max_edges=176, verbose=False, use_native=False)
    assert np.array_equal(np.flatnonzero(kept), ds.kept_indices)
    assert 0 < kept.sum() < len(sm)
    for a, b in ((nodes, ds.nodes), (edges, ds.edges), (nmask, ds.node_mask),
                 (emask, ds.edge_mask), (fp, ds.fp)):
        assert np.array_equal(a, b)


def test_weights_fit_the_programs_model():
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import get_config

    model = build_model(get_config("flagship"))
    w = weights.make_weights(conf()["model"], SEED, "cpu")
    assert list(w) == list(model.state_dict())
    model.load_state_dict(w)
    again = weights.make_weights(conf()["model"], SEED, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def _ctx(name="flagship"):
    return types.SimpleNamespace(config=conf(name), seed=SEED,
                                 device=torch.device("cpu"))


def test_forward_matches_the_program():
    from mgat_graphsage_torch.eval.predict import predict_dataset
    from mgat_graphsage_torch.data import MolecularDataset, StandardScaler
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import get_config

    cfg = get_config("flagship")
    model = build_model(cfg)
    model.load_state_dict(weights.make_weights(
        conf()["model"], traffic.seed_for(SEED, "weights"), "cpu"))
    model.eval()
    sm = smiles()
    scaler = (6.9, 1.2)
    ds = MolecularDataset(sm, np.zeros(len(sm), np.float32), max_nodes=80,
                          max_edges=176, verbose=False)
    got = np.full(len(sm), np.nan, np.float32)
    got[ds.kept_indices] = predict_dataset(
        model, cfg, StandardScaler(*scaler), ds, 64)
    want = check.reference_predictions(_ctx(), sm, scaler)
    nums = check.prediction_numbers(got, want)
    assert nums["nan_mismatch"] == 0 and nums["pred_gap"] < 1e-5


def test_tf32_control_fails_the_score_limit():
    sm = smiles()
    ctx, scaler = _ctx(), (6.9, 1.2)
    want = check.reference_predictions(ctx, sm, scaler)
    got = check.reference_predictions(ctx, sm, scaler, mode="tf32")
    nums = check.prediction_numbers(got, want)
    assert nums["pred_gap"] > limits("flagship.score")["pred_gap"]


@pytest.mark.parametrize("name,mode,fault", [
    ("flagship", "tf32", None),
    ("flagship", None, "half"),
    ("flagship_bf16_bs1024_wc", "fp8", None),
])
def test_controls_and_faults_fail_a_training_limit(name, mode, fault):
    """At a test's size (the first 2 batches of 32 rows)."""
    ctx = _ctx(name)
    ctx.config["train"]["batch_size"] = 32
    sm, y = check.load_csv("train_data.csv")
    sm, y = sm[:96], y[:96]
    want = check.reference_train(ctx, sm, y, 2)
    got = check.reference_train(ctx, sm, y, 2, mode=mode, fault=fault)
    nums = check.train_numbers(got, want)
    lim = limits(name + ".train")
    assert any(nums[k] > lim[k] for k in lim), nums
