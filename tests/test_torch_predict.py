"""The serving slice end to end on the CPU: a light JAX checkpoint of the
flagship (CNN fc1 cut to 16 wide) is carried into a port checkpoint, and
the port's ``Predictor`` must give the reference ``Predictor``'s pChEMBL
values, with NaN in the same slots.

Tolerance: 1e-4 pChEMBL, for f32 sums in another order (the CNN fc1 sums
131072 terms).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mgat_graphsage_tpu.eval.predict import Predictor as JaxPredictor
from mgat_graphsage_tpu.ops import dense_adjacency as jdense
from mgat_graphsage_tpu.train.checkpoint import save_checkpoint as jsave
from mgat_graphsage_tpu.train.config import get_config as jget_config
from mgat_graphsage_tpu.train.trainer import build_model as jbuild

from mgat_graphsage_torch.data import TEST_CSV, load_csv
from mgat_graphsage_torch.eval import predict as tpredict
from mgat_graphsage_torch.models import params_from_jax
from mgat_graphsage_torch.train import TrainConfig, get_config, load_checkpoint
from mgat_graphsage_torch.train import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = (80, 176)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(reference checkpoint, port checkpoint) holding the same weights."""
    d = tmp_path_factory.mktemp("torch_predict")
    cfg = jget_config("flagship", cnn_fc_hidden=16)
    model = jbuild(cfg)
    n, e = BUDGET
    adj = jdense(jnp.zeros((1, 2, e), jnp.int32), jnp.zeros((1, e)), n)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, n, 35)), adj, jnp.ones((1, n)),
        jnp.zeros((1, 1024)))["params"])
    meta = {"config": dataclasses.asdict(cfg),
            "scaler": {"mean": 6.25, "scale": 1.375},
            "max_nodes": n, "max_edges": e}
    jpath = str(d / "ref.msgpack")
    jsave(jpath, {"step": np.zeros((), np.int32), "params": params,
                  "batch_stats": {}}, meta, light=True)
    tpath = str(d / "port.pt")
    with open(jpath + ".json") as f:
        side = json.load(f)
    save_checkpoint(tpath, params_from_jax(params), side)
    return jpath, tpath


@pytest.fixture(scope="module")
def smiles24():
    smiles, _ = load_csv(TEST_CSV)
    s = smiles[:23]
    return s[:9] + ["C1CC("] + s[9:]


def test_port_checkpoint_sidecar_keeps_reference_schema(ckpts):
    jpath, tpath = ckpts
    sd, step, meta = load_checkpoint(tpath)
    ref = json.load(open(jpath + ".json"))
    assert meta == ref and meta["light"] is True and step == 0
    # the reference's fields, each at the preset's value; the port's own
    # fields (the graph transformer's widths) are absent and take their
    # defaults when the sidecar loads
    port = dataclasses.asdict(get_config("flagship", cnn_fc_hidden=16))
    assert meta["config"] == {k: port[k] for k in meta["config"]}
    assert TrainConfig(**meta["config"]) == get_config("flagship",
                                                       cnn_fc_hidden=16)
    assert sd["cnn.fc1.weight"].shape == (16, 1024 * 128)


def test_predictor_matches_reference(ckpts, smiles24):
    jpath, tpath = ckpts
    ref = JaxPredictor(jpath)(smiles24)
    port = tpredict.Predictor(tpath, device="cpu")
    ours = port(smiles24)
    assert ours.shape == ref.shape == (24,)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[9]) and np.isfinite(np.delete(ours, 9)).all()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    assert set(port.last_timings) == {"featurize_s", "dispatch_s",
                                      "native_s", "upload_s", "readback_s"}
    # a single string, a request with no valid molecule, batch 7
    np.testing.assert_allclose(port(smiles24[0]), ref[:1], atol=1e-4)
    assert np.isnan(port(["C1CC(", "not a smiles"])).all()
    np.testing.assert_allclose(port(smiles24, batch_size=7), ours,
                               atol=1e-5, rtol=0)


def test_predict_cli_writes_reference_columns(ckpts, smiles24, tmp_path):
    _, tpath = ckpts
    csv = tmp_path / "in.csv"
    csv.write_text("Smiles,pchembl\n" + "".join(
        f"{s},{5 + 0.1 * i:.4f}\n" for i, s in enumerate(smiles24)))
    out = tmp_path / "pred.csv"
    r = subprocess.run(
        [sys.executable, "-m", "mgat_graphsage_torch.eval.predict", tpath,
         str(csv), "--out", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = out.read_text().splitlines()
    assert lines[0] == "SMILES,True_Value,Predicted_Value,Absolute_Error"
    assert len(lines) == 1 + 23                  # "C1CC(" skipped
    _, t, p, ae = lines[1].rsplit(",", 3)
    assert float(ae) == pytest.approx(abs(float(t) - float(p)), abs=2e-6)
    assert "Pearson correlation" in r.stdout


@pytest.mark.parametrize("entry", ["Predictor", "predict_csv",
                                   "load_model_from_checkpoint"])
def test_entry_points_refuse_to_fall_back_to_cpu(ckpts, entry, monkeypatch):
    """Without ``device``, an entry point runs on CUDA or raises."""
    _, tpath = ckpts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (tpath, TEST_CSV) if entry == "predict_csv" else (tpath,)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tpredict, entry)(*args)


def test_bf16_inference_serves_close_to_f32(ckpts, smiles24):
    """``infer_dtype="bfloat16"`` casts the weights once and serves within
    0.05 pChEMBL of f32 here (scale 1.375; ``tests/
    test_torch_mixed_precision.py`` holds it against the reference), with
    NaN in the same slot; an unknown dtype raises, and so does
    ``predict_dataset`` given an f32 model for bf16 serving (the model is
    cast once, by its caller)."""
    bf16 = tpredict.Predictor(ckpts[1], infer_dtype="bfloat16", device="cpu")
    assert {p.dtype for p in bf16.model.parameters()} == {torch.bfloat16}
    got = bf16(smiles24)
    want = tpredict.Predictor(ckpts[1], device="cpu")(smiles24)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[9]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
    with pytest.raises(ValueError, match="infer_dtype"):
        tpredict.Predictor(ckpts[1], infer_dtype="float16", device="cpu")
    f32 = tpredict.Predictor(ckpts[1], device="cpu")
    with pytest.raises(ValueError, match="cast to bf16"):     # before ds
        tpredict.predict_dataset(f32.model, f32.cfg, f32.scaler, None,
                                 infer_dtype="bfloat16")
