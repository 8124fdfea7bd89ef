"""The fingerprint-suite presets ``maccs``, ``smifp`` and ``bci`` in the
port against the reference package, on the CPU: their datasets bit for
bit, the full-width hybrid forward at each fingerprint's width, two train
steps of the ``Trainer``, the training CLI and compact storage.

Setup of the trainer parity as in ``tests/test_torch_train.py``: the
first 64 train and 32 validation molecules of the bundled CSVs, batch 32
(2 steps), the same initial weights, dropout the identity on both sides
(inside the test only); losses and MSEs to rtol 1e-4.  One JAX
``Trainer`` and its initial state are made per preset and serve both the
forward and the trainer parity.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_model import TOL
from test_torch_train import no_dropout  # noqa: F401  (fixture)

from mgat_graphsage_tpu.data import MolecularDataset as JDataset
from mgat_graphsage_tpu.ops.graph import dense_adjacency as jdense
from mgat_graphsage_tpu.train import Trainer as JTrainer
from mgat_graphsage_tpu.train import get_config as jget_config

from mgat_graphsage_torch.data import (
    TRAIN_CSV,
    VAL_CSV,
    MolecularDataset,
    load_csv,
)
from mgat_graphsage_torch.data.packed import pack_dataset
from mgat_graphsage_torch.eval import Predictor
from mgat_graphsage_torch.models import build_model, params_from_jax
from mgat_graphsage_torch.train import Trainer, get_config
from mgat_graphsage_torch.train.run import main as run_main

PRESETS = ["maccs", "smifp", "bci"]
WIDTHS = {"maccs": 167, "smifp": 1024, "bci": 1024}
RTOL = 1e-4
CFG_KW = dict(epochs=1, batch_size=32)
_DATA = {}
_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one thread in this file: its eager train steps slow down
    several times over when several test processes each spin a full
    thread pool on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _datasets(preset):
    """(port train, port val, JAX train, JAX val) of a preset, 64 + 32
    molecules, made once."""
    if preset not in _DATA:
        sm, y = load_csv(TRAIN_CSV)
        vs, vy = load_csv(VAL_CSV)
        kw = dict(fingerprint=get_config(preset).fingerprint, verbose=False)
        out = []
        for cls in (MolecularDataset, JDataset):
            tr = cls(sm[:64], y[:64], fit_scaler=True, **kw)
            va = cls(vs[:32], vy[:32], scaler=tr.scaler,
                     max_nodes=tr.max_nodes, max_edges=tr.max_edges, **kw)
            out += [tr, va]
        _DATA[preset] = tuple(out)
    return _DATA[preset]


def _jax_trainer(preset):
    """(JAX Trainer, its initial state, the initial params on the host) of
    a preset, made once.  The train step donates the state, so the forward
    parity reads the host copy."""
    if preset not in _JAX:
        jtr, jva = _datasets(preset)[2:]
        jt = JTrainer(jget_config(preset, **CFG_KW), jtr, jva)
        jstate = jt.init_state()
        _JAX[preset] = (jt, jstate, jax.device_get(jstate.params))
    return _JAX[preset]


@pytest.mark.parametrize("preset", PRESETS)
def test_dataset_equals_reference_bit_for_bit(preset):
    tr, va, jtr, jva = _datasets(preset)
    assert tr.fp_dim == WIDTHS[preset]
    for ours, ref in ((tr, jtr), (va, jva)):
        assert ours.smiles == ref.smiles
        for key in ("nodes", "edges", "node_mask", "edge_mask", "fp", "y",
                    "y_orig"):
            a, b = getattr(ours, key), np.asarray(getattr(ref, key))
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), (preset, key)


@pytest.mark.parametrize("preset", PRESETS)
def test_hybrid_forward_matches_flax(preset):
    """The full-width hybrid at the preset's fingerprint width, prediction
    and latent, on the first 16 molecules."""
    tr = _datasets(preset)[0]
    jt, _, params = _jax_trainer(preset)
    model = build_model(get_config(preset))
    model.load_state_dict(params_from_jax(params), strict=True)
    model.eval()
    assert model.cnn.fc1.weight.shape == (256, 128 * WIDTHS[preset])
    sel = slice(0, 16)
    n = tr.nodes.shape[1]
    adj = jdense(jnp.asarray(tr.edges[sel]), jnp.asarray(tr.edge_mask[sel]),
                 n)
    jpred, jlat = jt.model.apply({"params": params}, tr.nodes[sel], adj,
                                 tr.node_mask[sel], tr.fp[sel])
    with torch.no_grad():
        pred, lat = model(torch.from_numpy(tr.nodes[sel]),
                          torch.from_numpy(np.array(adj)),
                          torch.from_numpy(tr.node_mask[sel]),
                          torch.from_numpy(tr.fp[sel]))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), **TOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), **TOL)


@pytest.mark.parametrize("preset", PRESETS)
def test_trainer_two_steps_match_jax(preset, no_dropout):  # noqa: F811
    """One epoch of 2 steps from the same initial weights: train loss,
    val MSE, original-scale MSE and the best metric."""
    tr, va = _datasets(preset)[:2]
    jt, jstate, params = _jax_trainer(preset)
    pt = Trainer(get_config(preset, **CFG_KW), tr, va, device="cpu")
    state = pt.init_state()
    state.model.load_state_dict(params_from_jax(params), strict=True)
    _, _, jhist = jt.fit(state=jstate, verbose=False, save_best=False)
    final, _, hist = pt.fit(state=state, verbose=False, save_best=False)
    assert final.step == 2
    for key in ("train_loss", "val_mse", "original_mse"):
        np.testing.assert_allclose(hist[0][key], jhist[0][key], rtol=RTOL,
                                   err_msg=f"{preset} {key}")
    assert pt.best_metric == pytest.approx(jt.best_metric, rel=RTOL)


def test_cli_trains_maccs_and_the_checkpoint_serves(tmp_path, capsys):
    run_main(["--preset", "maccs", "--device", "cpu", "--epochs", "1",
              "--limit", "64", "--batch-size", "32", "--ckpt-dir",
              str(tmp_path)])
    assert "Training completed" in capsys.readouterr().out
    ckpt = tmp_path / "maccs" / "best_model.pt"
    p = Predictor(str(ckpt), device="cpu")
    assert p.cfg.fingerprint == "maccs"
    out = p(["CC(=O)Oc1ccccc1C(=O)O", "C1CC(", "Cn1cnc2c1c(=O)n(C)c(=O)n2C"])
    assert np.isfinite(out[[0, 2]]).all() and np.isnan(out[1])


def test_cli_offers_every_preset(capsys):
    with pytest.raises(SystemExit) as e:
        run_main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for preset in PRESETS:
        assert preset in text


@pytest.mark.parametrize("preset,packs", [("maccs", True), ("bci", False)])
def test_compact_storage_packs_binary_fingerprints_only(preset, packs):
    """MACCS's 167 bits pack; BCI's descriptor half is not binary, so its
    fingerprint stays float32 (the other streams still pack)."""
    tr = _datasets(preset)[0]
    packed = pack_dataset(tr)
    assert ("fp" not in packed) == packs
    assert "nodes_i8" in packed
    if not packs:
        assert packed["fp"].dtype == np.float32
        np.testing.assert_array_equal(packed["fp"], tr.fp)
