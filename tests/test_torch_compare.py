"""The port's classical-ML and statistics harnesses
(``mgat_graphsage_torch/compare/{classical,stats}.py``) against the
reference package's on the same data: features bit for bit, the same
model registry, the same leaderboard (model order, RMSEs within 1e-9) on
a fixed split of 60 training molecules (``fast``, 2 folds), and the same
descriptor table on 60 rows."""

import csv

import numpy as np
import pytest

from mgat_graphsage_tpu.compare import classical as jclassical
from mgat_graphsage_tpu.compare import stats as jstats

from mgat_graphsage_torch.compare import classical, stats
from mgat_graphsage_torch.data import TRAIN_CSV, load_csv

# fitting the sklearn registry on a few dozen rows warns, as in
# tests/test_classical.py
pytestmark = [
    pytest.mark.filterwarnings(
        "ignore:Class PassiveAggressiveRegressor is deprecated"
        ":FutureWarning"),
    pytest.mark.filterwarnings(
        "ignore::sklearn.exceptions.ConvergenceWarning"),
    pytest.mark.filterwarnings("ignore::RuntimeWarning"),
    pytest.mark.filterwarnings("ignore::UserWarning"),
]

N_MOL, N_TRAIN = 60, 45


@pytest.fixture(scope="module")
def molecules():
    sm, y = load_csv(TRAIN_CSV)
    return list(sm[:N_MOL]), np.asarray(y[:N_MOL], np.float64)


def test_combined_features_and_names_equal_the_reference(molecules):
    sm, y = molecules
    for s in sm[:8] + ["CC(=O)Oc1ccccc1C(=O)O"]:
        got = classical.get_combined_features(s)
        want = jclassical.get_combined_features(s)
        assert got.dtype == want.dtype and np.array_equal(got, want), s
    assert classical.feature_names() == jclassical.feature_names()
    x, yy = classical.featurize_dataframe(sm, y)
    jx, jy = jclassical.featurize_dataframe(sm, y)
    assert x.shape == (N_MOL, 1199)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(yy, jy)


def test_build_models_has_the_reference_registry():
    got = classical.build_models(fast=True)
    want = jclassical.build_models(fast=True)
    assert list(got) == list(want)
    for name in want:
        assert type(got[name]) is type(want[name]), name
        assert repr(got[name].get_params()) == \
            repr(want[name].get_params()), name
    assert classical.SCALING_MODELS == jclassical.SCALING_MODELS
    assert classical.unavailable_boosters() == \
        jclassical.unavailable_boosters()


def test_leaderboard_equals_the_reference(molecules, tmp_path):
    sm, y = molecules
    x, yy = classical.featurize_dataframe(sm, y)
    split = (x[:N_TRAIN], yy[:N_TRAIN], x[N_TRAIN:], yy[N_TRAIN:])
    got = classical.comprehensive_modeling(
        *split, output_dir=str(tmp_path / "port"), cv_folds=2, fast=True,
        verbose=False)
    want = jclassical.comprehensive_modeling(
        *split, output_dir=str(tmp_path / "ref"), cv_folds=2, fast=True,
        verbose=False)
    assert [r["model"] for r in got] == [r["model"] for r in want]
    scored = 0
    for g, w in zip(got, want):
        assert g.get("status", "ok").split(" ")[0] == \
            w.get("status", "ok").split(" ")[0], g["model"]
        for key in ("rmse", "mae", "cv_rmse", "pearson_r", "r2"):
            if key in w:
                assert g[key] == pytest.approx(w[key], abs=1e-9,
                                               nan_ok=True), \
                    (g["model"], key)
        scored += "rmse" in w
    assert scored >= 20
    lb = (tmp_path / "port" / "leaderboard.csv").read_text().splitlines()
    assert lb[0].split(",")[:2] == ["model", "status"]
    assert len(lb) == 1 + len(got) + len(classical.unavailable_boosters())


def test_statistical_analysis_equals_the_reference(tmp_path):
    sm, y = load_csv(TRAIN_CSV)
    path = tmp_path / "rows.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Smiles", "pchembl"])
        for s, v in zip(sm[:N_MOL], y[:N_MOL]):
            w.writerow([s, f"{float(v):.4f}"])
    got = stats.run_statistical_analysis(str(path), str(tmp_path / "port"),
                                         verbose=False)
    want = jstats.run_statistical_analysis(str(path), str(tmp_path / "ref"),
                                           verbose=False)
    assert [r["descriptor"] for r in got["stats"]] == \
        [r["descriptor"] for r in want["stats"]]
    for g, w in zip(got["stats"], want["stats"]):
        for key, v in w.items():
            if isinstance(v, float):
                assert g[key] == pytest.approx(v, rel=1e-12, abs=1e-12,
                                               nan_ok=True), (w, key)
            else:
                assert g[key] == v, (w, key)
    assert got["rf"] == want["rf"]
    assert (tmp_path / "port" / "descriptor_stats.csv").read_text() == \
        (tmp_path / "ref" / "descriptor_stats.csv").read_text()
