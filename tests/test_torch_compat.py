"""Checkpoint interchange in the port (``compat.py``, ``compare/``, and the
msgpack reading of ``train/checkpoint.py``) against the reference package,
on the CPU, mirroring ``tests/test_compat.py``.

- a reference composite ``best_model.pth`` (the port's ``TorchHybrid``
  oracle, seeded, with a pickled sklearn scaler) imported by both
  packages serves the same pChEMBL predictions within 1e-4, and the
  port's import serves the oracle's own predictions within 1e-4;
- import -> export gives the reference composite back bit for bit;
- the baselines' bare ``state_dict``s (the six oracles and the ablation
  graphs of models 1-2) import with their predictions or values intact;
- the fingerprint caveat names its class, MACCS and BCI apart;
- a checkpoint that the reference package's ``save_checkpoint`` wrote
  (``.msgpack``) serves through the port's ``Predictor`` and its HTTP
  server within 1e-4 of the reference ``Predictor``; a full one (bf16 Adam moments) restores
  its Adam state through ``Trainer.load`` equal to rtol 1e-6 to
  ``adam_state_from_jax`` of the state in memory.

PyTorch runs on one thread here (several test processes share the cores).
"""

import json
import os
import threading
import urllib.request
import warnings

import numpy as np
import pytest
import torch
import jax
import sklearn.preprocessing

from mgat_graphsage_tpu.compat import (
    import_reference_checkpoint as jax_import_reference_checkpoint)
from mgat_graphsage_tpu.data import MolecularDataset as JDataset
from mgat_graphsage_tpu.eval.predict import Predictor as JPredictor
from mgat_graphsage_tpu.train import Trainer as JTrainer
from mgat_graphsage_tpu.train import get_config as jget_config
from mgat_graphsage_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)

from mgat_graphsage_torch.compare.torch_ref import (
    TorchGraphBranch,
    TorchHybrid,
    TorchModifiedGATLayer,
    TorchSAGEConv,
    flat_batch,
)
from mgat_graphsage_torch.compare.torch_ref_gnn import (
    BASELINE_ORACLES,
    TorchGATConv,
)
from mgat_graphsage_torch.compat import (
    export_reference_checkpoint,
    fingerprint_layout_warning,
    import_baseline_checkpoint,
    import_reference_checkpoint,
    main,
)
from mgat_graphsage_torch.data import (
    TEST_CSV,
    TRAIN_CSV,
    MolecularDataset,
    load_csv,
)
from mgat_graphsage_torch.eval.predict import (
    Predictor,
    load_model_from_checkpoint,
    predict_dataset,
)
from mgat_graphsage_torch.models import adam_state_from_jax
from mgat_graphsage_torch.serve import make_server
from mgat_graphsage_torch.train import Trainer, get_config

MAX_NODES, MAX_EDGES = 80, 176
N_MOL = 12


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def molecules():
    sm, y = load_csv(TEST_CSV)
    return list(sm[:N_MOL]), np.asarray(y[:N_MOL], np.float32)


def _graphs(ds):
    """Per-molecule (features, edge_index) of a padded dataset, unpadded,
    and its fingerprints as [1, nbits] rows."""
    graphs = []
    for i in range(len(ds)):
        n, e = int(ds.node_mask[i].sum()), int(ds.edge_mask[i].sum())
        graphs.append((ds.nodes[i, :n], ds.edges[i, :, :e]))
    fps = [ds.fp[i:i + 1] for i in range(len(ds))] if ds.fp is not None \
        else [np.zeros((1, 1), np.float32)] * len(ds)
    return graphs, fps


def _oracle_hybrid(tmodel, ds, scaler):
    """The oracle's de-normalised predictions, one molecule per batch as
    the reference infers (``test.py:175-208``)."""
    graphs, fps = _graphs(ds)
    out = []
    with torch.no_grad():
        for g, f in zip(graphs, fps):
            x, ei, batch, ng, fp = flat_batch([g], [f])
            out.append(float(tmodel(x, ei, batch, ng, fp)[0][0, 0]))
    return np.asarray(out) * float(scaler.scale_[0]) + float(scaler.mean_[0])


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    torch.manual_seed(7)
    tmodel = TorchHybrid().eval()
    scaler = sklearn.preprocessing.StandardScaler()
    scaler.fit(np.random.default_rng(3).normal(6.5, 1.2, size=(64, 1)))
    path = str(tmp_path_factory.mktemp("ref_ckpt") / "best_model.pth")
    torch.save({
        "gat_graphsage_model_state_dict": tmodel.graph.state_dict(),
        "cnn_model_state_dict": tmodel.cnn.state_dict(),
        "combined_model_state_dict": tmodel.combined.state_dict(),
        "optimizer_state_dict": {},
        "normalized_mse": 0.123,
        "original_mse": 0.456,
        "scaler": scaler,
    }, path)
    return path, tmodel, scaler


def test_reference_pth_serves_alike_in_both_packages(reference_pth,
                                                     molecules, tmp_path):
    pth, tmodel, scaler = reference_pth
    smiles, _ = molecules
    ours = str(tmp_path / "imported.pt")
    with pytest.warns(UserWarning, match="bit POSITIONS"):
        _, meta = import_reference_checkpoint(
            pth, ours, preset="flagship", max_nodes=MAX_NODES,
            max_edges=MAX_EDGES, device="cpu")
    assert meta["reference_normalized_mse"] == pytest.approx(0.123)
    assert meta["scaler"]["mean"] == pytest.approx(float(scaler.mean_[0]))
    theirs = str(tmp_path / "imported.msgpack")
    with pytest.warns(UserWarning, match="bit POSITIONS"):
        jax_import_reference_checkpoint(pth, theirs, preset="flagship",
                                        max_nodes=MAX_NODES,
                                        max_edges=MAX_EDGES)
    got = Predictor(ours, device="cpu")(smiles)
    want = JPredictor(theirs)(smiles)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # and the oracle itself, on the port's own featurisation
    ds = MolecularDataset(smiles, np.zeros(len(smiles), np.float32),
                          max_nodes=MAX_NODES, max_edges=MAX_EDGES,
                          verbose=False)
    np.testing.assert_allclose(got, _oracle_hybrid(tmodel, ds, scaler),
                               atol=1e-4, rtol=0)


def test_export_round_trip_is_bit_for_bit(reference_pth, tmp_path, capsys):
    pth, _, scaler = reference_pth
    native = str(tmp_path / "native.pt")
    with pytest.warns(UserWarning, match="bit POSITIONS"):
        main(["import", pth, native, "--preset", "flagship", "--max-nodes",
              str(MAX_NODES), "--max-edges", str(MAX_EDGES), "--device",
              "cpu"])
    assert os.path.exists(native) and os.path.exists(native + ".json")
    back = str(tmp_path / "back.pth")
    main(["export", native, back, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "imported" in out and "exported" in out
    orig = torch.load(pth, map_location="cpu", weights_only=False)
    rt = torch.load(back, map_location="cpu", weights_only=False)
    for part in ("gat_graphsage_model_state_dict", "cnn_model_state_dict",
                 "combined_model_state_dict"):
        assert list(orig[part]) == list(rt[part]), part
        for k in orig[part]:
            assert torch.equal(orig[part][k], rt[part][k]), f"{part}.{k}"
    x = np.array([[0.7]])
    np.testing.assert_array_equal(rt["scaler"].inverse_transform(x),
                                  scaler.inverse_transform(x))
    assert rt["optimizer_state_dict"] == {}


def test_import_errors_are_clear(reference_pth, tmp_path):
    pth, _, _ = reference_pth
    with pytest.raises(ValueError, match="preset"), \
            pytest.warns(UserWarning, match="bit POSITIONS"):
        import_reference_checkpoint(pth, str(tmp_path / "x.pt"),
                                    preset="morgan2048", device="cpu")
    bogus = str(tmp_path / "not_a_ckpt.pth")
    torch.save({"weights": torch.zeros(3)}, bogus)
    with pytest.raises(KeyError, match="gat_graphsage_model_state_dict"):
        import_reference_checkpoint(bogus, str(tmp_path / "y.pt"),
                                    device="cpu")
    with pytest.raises(ValueError, match="rdkit"):
        import_reference_checkpoint(pth, str(tmp_path / "z.pt"),
                                    fingerprint_layout="bogus",
                                    device="cpu")
    with pytest.raises(ValueError, match="composite|hybrid"):
        import_baseline_checkpoint(pth, str(tmp_path / "b.pt"),
                                   preset="graphsage", device="cpu")


def test_import_rdkit_layout_pins_the_fingerprint(reference_pth, tmp_path):
    pth, _, _ = reference_pth
    out = str(tmp_path / "rdkit.pt")
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no UserWarning on this path
        _, meta = import_reference_checkpoint(
            pth, out, max_nodes=MAX_NODES, max_edges=MAX_EDGES,
            fingerprint_layout="rdkit", device="cpu")
    assert meta["config"]["fingerprint"] == "ecfp1024_rdkit"
    p = Predictor(out, device="cpu")
    assert p.cfg.fingerprint == "ecfp1024_rdkit"
    assert np.isfinite(p(["CCO", "c1ccccc1O"])).all()


def test_fingerprint_layout_warning_splits_maccs_and_bci():
    for fp in ("ecfp1024", "ecfp2048", "fcfp1024", "morgan1024",
               "morgan2048"):
        msg = fingerprint_layout_warning("x", fp)
        assert "--fingerprint-layout rdkit" in msg, fp
        assert "No RDKit-layout escape hatch" not in msg, fp
    maccs = fingerprint_layout_warning("x", "maccs")
    bci = fingerprint_layout_warning("x", "bci")
    for msg in (maccs, bci):
        assert "No RDKit-layout escape hatch" in msg
        assert "--fingerprint-layout rdkit" not in msg
    assert "MACCS key SMARTS are proprietary" in maccs
    assert "MACCS" not in bci and "BCI fragment dictionary" in bci
    msg = fingerprint_layout_warning("x", "smifp")
    assert "SALTED hash()" in msg and "SMIFP.py:60-88" in msg
    for fp in ("ecfp1024", "maccs", "bci", "smifp"):
        assert "bit POSITIONS" in fingerprint_layout_warning("x", fp)


# (preset, TrainConfig.model, featurizer, atol): the reference package's
# cases and tolerances (tests/test_compat.py)
BASELINE_CASES = [
    ("graphsage", "sage", "35", 2e-5),
    ("gat", "gat", "35", 2e-5),
    ("gcn", "gcn", "5", 2e-5),
    ("gat_gcn", "gat_gcn", "35", 5e-5),
    ("gin", "gin", "35", 5e-5),
    ("chebnet", "cheb", "35", 5e-4),
]


@pytest.mark.parametrize("preset,model_key,featurizer,tol", BASELINE_CASES)
def test_baseline_import_prediction_parity(preset, model_key, featurizer,
                                           tol, molecules, tmp_path):
    """oracle (random init) -> ``torch.save(state_dict())`` ->
    import-baseline -> the port's forward reproduces the oracle."""
    smiles, _ = molecules
    torch.manual_seed(11)
    tmodel = BASELINE_ORACLES[model_key](
        features=5 if featurizer == "5" else 35).eval()
    pth = str(tmp_path / f"{preset}.pth")
    torch.save(tmodel.state_dict(), pth)      # gnn/gat.py:135 format
    out = str(tmp_path / f"{preset}.pt")
    import_baseline_checkpoint(pth, out, preset=preset, max_nodes=MAX_NODES,
                               max_edges=MAX_EDGES, device="cpu")
    model, cfg, scaler, _ = load_model_from_checkpoint(out, device="cpu")
    assert (scaler.mean_, scaler.scale_) == (0.0, 1.0)   # raw targets
    ds = MolecularDataset(smiles, np.zeros(len(smiles), np.float32),
                          fingerprint=None, featurizer=featurizer,
                          max_nodes=MAX_NODES, max_edges=MAX_EDGES,
                          verbose=False)
    got = predict_dataset(model, cfg, scaler, ds, batch_size=8)
    graphs, fps = _graphs(ds)
    x, ei, batch, ng, _ = flat_batch(graphs, fps)
    with torch.no_grad():
        want = tmodel(x, ei, batch, ng).numpy().reshape(-1)
    np.testing.assert_allclose(got, want, atol=tol, rtol=1e-4)


@pytest.mark.parametrize("preset", ["model1", "model2"])
def test_ablation_graph_state_dict_import(preset, tmp_path):
    """Ablation models 1-3 save the bare graph-branch state_dict: the
    import keeps every value (model1: plain GATConv, model2: the
    ModifiedGAT dual-pool path)."""
    torch.manual_seed(13)
    nn_t = torch.nn

    class M1(nn_t.Module):      # ablation/model1.py:53-77 names/shapes
        def __init__(self):
            super().__init__()
            self.conv1 = TorchGATConv(35, 35, heads=10)
            self.conv2 = TorchSAGEConv(350, 350)
            self.fc_g1 = nn_t.Linear(700, 1500)
            self.fc_g2 = nn_t.Linear(1500, 128)
            self.out = nn_t.Linear(128, 1)

    class M2(nn_t.Module):      # ablation/model 2.py names/shapes
        def __init__(self):
            super().__init__()
            self.conv1 = TorchModifiedGATLayer(35)
            self.conv2 = TorchSAGEConv(35, 35)
            self.fc_g1 = nn_t.Linear(70, 1500)
            self.fc_g2 = nn_t.Linear(1500, 128)
            self.out = nn_t.Linear(128, 1)

    tmodel = {"model1": M1, "model2": M2}[preset]()
    pth = str(tmp_path / f"{preset}.pth")
    torch.save(tmodel.state_dict(), pth)
    out = str(tmp_path / f"{preset}.pt")
    import_baseline_checkpoint(pth, out, preset=preset, max_nodes=MAX_NODES,
                               max_edges=MAX_EDGES, device="cpu")
    model, _, _, _ = load_model_from_checkpoint(out, device="cpu")
    ours, sd = model.state_dict(), tmodel.state_dict()
    assert torch.equal(ours["fc_g1.weight"], sd["fc_g1.weight"])
    key = "conv1.conv3.weight" if preset == "model2" else "conv1.att_src"
    assert torch.equal(ours[key], sd[key])


def test_export_rejects_a_baseline(tmp_path):
    torch.manual_seed(0)
    pth = str(tmp_path / "gin.pth")
    torch.save(BASELINE_ORACLES["gin"]().state_dict(), pth)
    out = str(tmp_path / "gin.pt")
    import_baseline_checkpoint(pth, out, preset="gin", device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        export_reference_checkpoint(out, str(tmp_path / "x.pth"),
                                    device="cpu")


def test_oracle_runs_on_its_input_device():
    """The port's oracles make every tensor on their input's device (the
    reference package's make them on the CPU): a graph branch on a
    ``meta`` input stays on ``meta``."""
    g = TorchGraphBranch().to("meta")
    x = torch.zeros(5, 35, device="meta")
    ei = torch.zeros(2, 4, dtype=torch.long, device="meta")
    out = g(x, ei, torch.zeros(5, dtype=torch.long, device="meta"), 1)
    assert out.device.type == "meta"


# ---------------------------------------------------------------------------
# the reference package's msgpack checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_sets():
    sm, y = load_csv(TRAIN_CSV)
    return (JDataset(sm[:32], y[:32], fit_scaler=True,
                     fingerprint="ecfp1024", verbose=False),
            MolecularDataset(sm[:32], y[:32], fit_scaler=True,
                             verbose=False))


def _jax_meta(cfg, jds):
    import dataclasses

    return {"config": dataclasses.asdict(cfg),
            "scaler": {"mean": float(jds.scaler.mean_),
                       "scale": float(jds.scaler.scale_)},
            "max_nodes": int(jds.max_nodes),
            "max_edges": int(jds.max_edges)}


def test_jax_light_checkpoint_serves_in_the_port(train_sets, molecules,
                                                 tmp_path):
    jds, _ = train_sets
    smiles, _ = molecules
    cfg = jget_config("flagship", batch_size=16, epochs=1)
    state = JTrainer(cfg, jds).init_state()
    path = str(tmp_path / "best_model.msgpack")
    jax_save_checkpoint(path, state, _jax_meta(cfg, jds), light=True)
    got = Predictor(path, device="cpu")(smiles)
    want = JPredictor(path)(smiles)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # and serve.py, over HTTP, from the same .msgpack
    srv = make_server(path, port=0, batch_size=8, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict",
            data=json.dumps({"smiles": smiles[:3]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            served = json.loads(r.read())["predictions"]
    finally:
        srv.shutdown()
        srv.server_close()
    np.testing.assert_allclose(served, want[:3], atol=1e-4, rtol=0)


def test_jax_full_checkpoint_resumes_in_the_port(train_sets, tmp_path):
    """A full checkpoint of the bf16 production preset (bf16 Adam
    moments, which decode as bf16 tensors) with a non-trivial Adam state:
    ``Trainer.load`` restores the weights bit for bit, the step, and the
    Adam state equal (rtol 1e-6) to ``adam_state_from_jax`` of the state
    in memory."""
    jds, ds = train_sets
    cfg = jget_config("flagship_bf16_bs1024_wc", batch_size=16, epochs=1)
    state = JTrainer(cfg, jds).init_state()
    rng = np.random.default_rng(0)
    opt = state.opt_state
    noisy = lambda t: jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(a.dtype) * 1e-3,
        jax.device_get(t))
    opt = opt._replace(count=np.int32(3), mu=noisy(opt.mu), nu=noisy(opt.nu))
    state = state.replace(step=np.int32(3), opt_state=opt)
    path = str(tmp_path / "ckpt_3.msgpack")
    jax_save_checkpoint(path, state, _jax_meta(cfg, jds), light=False)

    pt = Trainer(get_config("flagship_bf16_bs1024_wc", batch_size=16,
                            epochs=1), ds, device="cpu")
    restored, meta = pt.load(path)
    assert restored.step == 3 and meta["config"]["name"] == cfg.name
    from mgat_graphsage_torch.models import params_from_jax

    host = jax.device_get(state)
    for k, v in params_from_jax(host.params).items():
        assert torch.equal(restored.model.state_dict()[k], v.float()), k
    fresh = pt.init_state()
    want = adam_state_from_jax(host.opt_state, fresh.model, fresh.optimizer)
    fresh.optimizer.load_state_dict(want)
    got_state = restored.optimizer.state_dict()["state"]
    want_state = fresh.optimizer.state_dict()["state"]
    assert set(got_state) == set(want_state)
    for i in want_state:
        for key, w in want_state[i].items():
            g = got_state[i][key]
            if key != "step":
                assert g.dtype == w.dtype == torch.bfloat16, key
            np.testing.assert_allclose(torch.as_tensor(g).float().numpy(),
                                       torch.as_tensor(w).float().numpy(),
                                       rtol=1e-6, atol=0, err_msg=f"{i} {key}")
