"""The graph transformer of the port (``models/zoo.py::GraphormerNet``,
preset ``graphormer_base``) on the CPU, at a tiny size (2 layers, width
32, 4 heads, FFN 32, paths of 5 bonds), against its plain reference
(``compare/torch_ref_graphormer.py``) on the same seeded weights: the
structure, the forward pass, the loss, every leaf's gradient and one Adam
step, with the dropouts on (masks replayed from the trainer's generator)
and off; the explicit attention against the SDPA path; and a saved
checkpoint served by ``Predictor``.

The molecules hold the cases the structure has to get right: a salt (two
components, so unreachable pairs), a chain of more than 5 bonds (paths
cut at 5), a one-atom molecule, and batches padded with masked rows.

Tolerances, all in f32 with TF32 off, relative to the reference's norm:
the forward and the loss 1e-5 (the two sum the same products in other
orders: the edge encoding through a per-hop table, the scale after the
product; a few ulps of 1e-7 each); each gradient leaf 1e-4 of its own
norm, or of the median leaf's for the key projection's bias, whose
gradient is zero but for round-off (a softmax does not see a constant
added to a row's logits) (the backward
of the explicit attention sums ``ds`` in its own order over ~100 rows,
and the tables' gradients sum over every pair of the batch); Adam's
change 1e-5 (one step of ``lr * m / sqrt(v)`` from gradients that agree
to 1e-4 moves by ``lr`` up to the ``eps`` term, whatever their size),
leaving out the key bias, which Adam moves by its round-off alone, as the
benchmark's ``change_gap`` leaves out leaves under a thousandth of the
median leaf's gradient).
The structure, native against Python, is compared bit for bit.
"""

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.chem import native
from mgat_graphsage_torch.chem.featurize import smiles_to_structure
from mgat_graphsage_torch.compare import torch_ref_graphormer as ref
from mgat_graphsage_torch.data import (
    TRAIN_CSV,
    MolecularDataset,
    load_csv,
)
from mgat_graphsage_torch.data.packed import gather_batch, pack_dataset
from mgat_graphsage_torch.data.packed import to_device
from mgat_graphsage_torch.eval import predict as tpredict
from mgat_graphsage_torch.ops.biased_attention import biased_attention
from mgat_graphsage_torch.train import Trainer, get_config

SPECIAL = ["CC(=O)[O-].[Na+]", "CCCCCCCCCCO", "C", "c1ccccc1CC(=O)NCCO",
           "C#CC=CC1CC1"]
TINY = dict(n_layers=2, hidden_dim=32, n_heads=4, ffn_dim=32,
            compute_dtype="float32", lr_schedule="constant", lr=1e-3,
            batch_size=8, eval_batch_size=8, epochs=1)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(2)
    smiles, y = load_csv(TRAIN_CSV)
    smiles = SPECIAL + smiles[:9]
    y = np.concatenate([y[:len(SPECIAL)], y[:9]]).astype(np.float32)
    cfg = get_config("graphormer_base", **TINY)
    ds = MolecularDataset(smiles, y, fit_scaler=True, fingerprint=None,
                          structure=True, verbose=False)
    return cfg, smiles, ds


def _reference_inputs(ds, smiles, rows, smask):
    """The reference's own featurisation of the batch's rows."""
    kept, nodes, nmask, deg, spd, path = ref.featurize(smiles, ds.max_nodes)
    assert kept == list(range(len(smiles)))
    sel = np.asarray(rows)
    sm = torch.from_numpy(np.asarray(smask, np.float32))
    return {"nodes": torch.from_numpy(nodes[sel]),
            "node_mask": torch.from_numpy(nmask[sel]) * sm[:, None],
            "degree": torch.from_numpy(deg[sel]),
            "spd": torch.from_numpy(spd[sel]),
            "path_types": torch.from_numpy(path[sel])}, sm


@pytest.mark.parametrize("workers", [1, 2, 8])
def test_native_structure_is_the_python_structure(workers, monkeypatch):
    """The native batch call's degrees, distances and path types equal the
    Python path's and the reference's own search, bit for bit, on 1, 2
    and 8 workers, padding included."""
    monkeypatch.setattr(native, "worker_count", lambda n: workers)
    smiles = (SPECIAL + load_csv(TRAIN_CSV)[0][:155] + ["C1CC("])
    out = native.featurize_structure_native(smiles, 35, 80, 176)
    status, degree, spd, path = out[5], out[7], out[8], out[9]
    assert status[-1] == -1
    for i, smi in enumerate(smiles[:-1]):
        n = int(status[i])
        _, _, deg, d, p = smiles_to_structure(smi)
        rdeg, rd, rp = ref.structure(native_free_parse(smi))
        for got, py, own in ((degree[i, :n], deg, rdeg),
                             (spd[i, :n, :n], d, rd),
                             (path[i, :n, :n], p, rp)):
            np.testing.assert_array_equal(got, py)
            np.testing.assert_array_equal(got, own)
        assert (spd[i, n:] == -1).all() and (spd[i, :, n:] == -1).all()
        assert (path[i, n:] == 0).all() and (degree[i, n:] == 0).all()
    # a salt's two components, a path cut at 5 bonds
    salt = smiles.index("CC(=O)[O-].[Na+]")
    assert (spd[salt, 4, :4] == -1).all() and spd[salt, 0, 2] == 2
    chain = smiles.index("CCCCCCCCCCO")
    assert spd[chain, 0, 10] == 10 and (path[chain, 0, 10] == 1).all()


def native_free_parse(smi):
    from mgat_graphsage_torch.chem.smiles import parse_smiles
    return parse_smiles(smi)


def test_dataset_structure_native_and_python_agree(tiny):
    """``MolecularDataset(structure=True)`` holds the same structure on the
    native and the Python path, and the compact storage carries it as
    it is."""
    cfg, smiles, ds = tiny
    py = MolecularDataset(smiles, np.zeros(len(smiles), np.float32),
                          fingerprint=None, structure=True, verbose=False,
                          use_native=False)
    for k in ("degree", "spd", "path_types", "nodes"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(py, k))
    idx = torch.tensor([3, 0, 2])
    plain = gather_batch(to_device({k: getattr(ds, k) for k in (
        "degree", "spd", "path_types")}, "cpu"), idx, 0)
    packed = gather_batch(to_device(pack_dataset(ds), "cpu"), idx, 0)
    for k in plain:
        assert torch.equal(plain[k], packed[k]), k


@pytest.mark.parametrize("dropout", [True, False])
def test_train_step_matches_reference(tiny, dropout):
    """One train step of ``Trainer`` on a batch of 8 with 2 padded rows
    (the salt, the long chain and the one-atom molecule among the rest),
    against the reference on its own featurisation: the loss, every leaf's
    gradient and the parameters after Adam's step."""
    cfg, smiles, ds = tiny
    if not dropout:
        cfg = cfg.replace(graph_dropout=0.0, attention_dropout=0.0)
    sub = MolecularDataset(smiles[:6], ds.y_orig[:6], scaler=ds.scaler,
                           fingerprint=None, structure=True, verbose=False,
                           max_nodes=ds.max_nodes, max_edges=ds.max_edges)
    trainer = Trainer(cfg, sub, device="cpu")
    state = trainer.init_state(seed=3)
    w0 = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    batch = next(trainer._batches(sub, 8))
    seed = 11
    out = trainer.train_step(state, batch,
                             torch.Generator().manual_seed(seed))
    got_grads = {n: p.grad for n, p in state.model.named_parameters()}

    rows = [0, 1, 2, 3, 4, 5, 0, 0]
    inputs, sm = _reference_inputs(sub, smiles[:6], rows,
                                   batch["sample_mask"].numpy())
    for k in ("nodes", "degree", "spd", "path_types"):
        assert torch.equal(inputs[k].to(batch[k].dtype), batch[k]), k
    n = ds.max_nodes
    masks = ref.draw_masks(torch.Generator().manual_seed(seed), 8, n, 4, 32,
                           2, cfg.attention_dropout, cfg.graph_dropout,
                           "cpu") if dropout else None
    with ref.ieee_flags():
        loss, grads = ref.train_step(w0, inputs, batch["y"], sm, 4, masks,
                                     cfg.attention_dropout, cfg.graph_dropout)
    assert abs(float(out["loss"]) - float(loss)) <= 1e-5 * float(loss)
    assert set(grads) == set(got_grads)
    med = float(np.median([float(g.norm()) for g in grads.values()]))
    for k in grads:
        gap = float((got_grads[k] - grads[k]).norm())
        scale = med if k.endswith("k_proj.bias") else float(grads[k].norm())
        assert gap <= 1e-4 * scale, k
    new = ref.adam_step(w0, grads, cfg.lr)
    after = dict(state.model.named_parameters())
    moved = [k for k in new if float(grads[k].norm()) >= 1e-3 * med]
    assert {f"layers.{i}.k_proj.bias" for i in range(2)} \
        <= set(new) - set(moved)
    for k in moved:
        want = (new[k] - w0[k]).norm()
        assert abs(float((after[k].detach() - w0[k]).norm() - want)) \
            <= 1e-5 * float(want), k


def test_forward_matches_reference_in_evaluation(tiny):
    """``Trainer.evaluate``'s predictions against the reference's forward
    with no dropout, padded final batch included."""
    cfg, smiles, ds = tiny
    trainer = Trainer(cfg, ds, ds, device="cpu")
    state = trainer.init_state(seed=5)
    w = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    got = torch.from_numpy(trainer.evaluate(state)["pred"])
    inputs, _ = _reference_inputs(ds, smiles, list(range(len(smiles))),
                                  np.ones(len(smiles)))
    with ref.ieee_flags(), torch.no_grad():
        want = ref.forward(w, inputs["nodes"], inputs["node_mask"],
                           inputs["degree"], inputs["spd"],
                           inputs["path_types"], 4)
    assert got.shape == want.shape == (len(smiles),)
    assert _rel(got, want) <= 1e-5


def test_explicit_attention_matches_sdpa():
    """The explicit path and ``scaled_dot_product_attention`` (the CPU
    backend) give the same output with no dropout, masked keys included;
    the explicit backward's bias gradient is the softmax's."""
    g = torch.Generator().manual_seed(0)
    b, h, n, d = 3, 4, 9, 8
    q, k, v = (torch.randn(b, h, n, d, generator=g) for _ in range(3))
    bias = torch.randn(b, h, n, n, generator=g)
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[0, 5:] = False
    mask[2, 1:] = False
    with torch.no_grad():
        exp = biased_attention(q, k, v, bias, mask, sdpa=False)
        fast = biased_attention(q, k, v, bias, mask, sdpa=True)
    assert _rel(exp, fast) <= 1e-5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    out = biased_attention(*leaves, mask, sdpa=False)
    out.square().sum().backward()
    plain = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    s = torch.matmul(plain[0], plain[1].transpose(-1, -2)) * d ** -0.5 \
        + plain[3] + torch.where(mask, 0.0, float("-inf"))[:, None, None]
    torch.matmul(torch.softmax(s, -1), plain[2]).square().sum().backward()
    for a, c in zip(leaves, plain):
        assert _rel(a.grad, c.grad) <= 1e-5


def test_predictor_scores_a_saved_checkpoint(tiny, tmp_path):
    """A ``graphormer_base`` checkpoint (tiny widths) written by
    ``Trainer.fit`` is served by ``Predictor``: NaN for what does not
    parse, else the reference's forward on its own featurisation,
    de-normalised."""
    cfg, smiles, ds = tiny
    trainer = Trainer(cfg, ds, ds, ckpt_dir=str(tmp_path), device="cpu")
    trainer.fit(epochs=1, verbose=False)
    ckpt = str(tmp_path / "best_model.pt")
    pred = tpredict.Predictor(ckpt, device="cpu")
    query = smiles[:7] + ["C1CC("]
    got = pred(query, batch_size=4)
    assert np.isnan(got[-1]) and np.isfinite(got[:-1]).all()
    w = {k: v.float() for k, v in pred.model.state_dict().items()}
    inputs, _ = _reference_inputs(ds, smiles[:7], list(range(7)),
                                  np.ones(7))
    with ref.ieee_flags(), torch.no_grad():
        want = ref.forward(w, inputs["nodes"], inputs["node_mask"],
                           inputs["degree"], inputs["spd"],
                           inputs["path_types"], 4)
    want = want.numpy() * ds.scaler.scale_ + ds.scaler.mean_
    np.testing.assert_allclose(got[:-1], want, rtol=1e-5, atol=0)


def test_train_run_writes_a_checkpoint_that_serves(tiny, tmp_path,
                                                   monkeypatch):
    """``train/run.py`` (``mgat-torch-train``) trains the preset (its widths
    cut to the tiny ones) and writes ``<ckpt-dir>/graphormer_base/
    best_model.pt``; ``serve.py``'s backend answers from it as
    ``Predictor`` does, and reports the attention calls in ``/health``."""
    import json

    from mgat_graphsage_torch.serve import PredictionServer
    from mgat_graphsage_torch.train import config as tconfig
    from mgat_graphsage_torch.train import run as trun

    cfg, smiles, _ = tiny
    monkeypatch.setitem(tconfig.PRESETS, "graphormer_base", cfg)
    trun.main(["--preset", "graphormer_base", "--epochs", "1", "--limit",
               "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    ckpt = str(tmp_path / "graphormer_base" / "best_model.pt")
    server = PredictionServer(ckpt, device="cpu")
    try:
        got = server.predict_payload({"smiles": smiles[:5] + ["C1CC("]})
        want = tpredict.Predictor(ckpt, device="cpu")(smiles[:5] + ["C1CC("])
        assert got["model"] == "graphormer_base" and got["count"] == 6
        assert got["predictions"][-1] is None
        np.testing.assert_array_equal(np.array(got["predictions"][:5],
                                               np.float32), want[:5])
        health = server.health()
        assert health["telemetry"]["attention"]["explicit"] > 0
        json.dumps(health)
    finally:
        server.close()
