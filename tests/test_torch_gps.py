"""GraphGPS of the port (``models/zoo.py::GPSNet``, preset
``graphgps_medium``) on the CPU, at a tiny size (2 layers, width 32, 2
heads, FFN 32), against its plain reference (``compare/torch_ref_gps.py``)
on the same seeded weights: the random-walk encoding, the bond types, the
train step over 2 steps (loss, every leaf's gradient, the parameters'
change) with the dropouts on (masks replayed from the trainer's generator)
and off, the evaluation forward, the padding budget, the gated message
passing's backward, and a saved checkpoint served by ``Predictor`` and
trained by ``train/run.py``.

The molecules hold the cases the layers have to get right: a salt (two
components), a one-atom molecule (no edge), a ring, and batches padded
with masked rows, whose atoms and edges must stay out of every norm, sum
and pool.

Tolerances, all in f32 with TF32 off: the loss 1e-5 relative (the two sum
the same products in other orders: the port over padded slots, the
reference over the real atoms and edges alone); each gradient leaf 1e-4 of
its own norm, or of the median leaf's for a leaf whose reference gradient
is under a thousandth of the median's (a bias that a batch norm or the
softmax cancels, whose gradient is round-off, and the last layer's edge
norm, which reaches no output: the benchmark's ``change_gap`` leaves such
leaves out alike); the parameters' change over each step 1e-4 of its norm
for the other leaves (Adam moves an element by ``lr g / (|g| + 1e-8)``, so
an element whose gradient lies within the two sides' gap of 1e-8 moves by
another share of ``lr``: up to 2.5e-5 measured, on ``C.bias``, whose
elements are small before the edge norm); the evaluation forward 1e-5.
The featurisation, native against Python, is compared bit for bit.
"""

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.chem import native
from mgat_graphsage_torch.chem.featurize import random_walk_se
from mgat_graphsage_torch.chem.smiles import parse_smiles
from mgat_graphsage_torch.compare import torch_ref_gps as ref
from mgat_graphsage_torch.data import TRAIN_CSV, MolecularDataset, load_csv
from mgat_graphsage_torch.data.packed import (
    gather_batch,
    pack_dataset,
    to_device,
)
from mgat_graphsage_torch.eval import predict as tpredict
from mgat_graphsage_torch.ops import gated_message as gm
from mgat_graphsage_torch.train import Trainer, get_config

SPECIAL = ["CC(=O)[O-].[Na+]", "C", "c1ccccc1CC(=O)NCCO", "C#CC=CC1CC1",
           "CCCCCCCCCCO"]
TINY = dict(n_layers=2, hidden_dim=32, n_heads=2, ffn_dim=32,
            compute_dtype="float32", lr_schedule="constant", lr=1e-3,
            batch_size=8, eval_batch_size=8, epochs=1)
HEADS, WIDTH, FFN, LAYERS = 2, 32, 32, 2


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(2)
    smiles, y = load_csv(TRAIN_CSV)
    smiles = SPECIAL + smiles[:3]
    y = np.concatenate([y[:len(SPECIAL)], y[:3]]).astype(np.float32)
    cfg = get_config("graphgps_medium", **TINY)
    ds = MolecularDataset(smiles, y, fit_scaler=True, fingerprint=None,
                          structure="edges", verbose=False)
    return cfg, smiles, ds


def _graph(ds, smiles, rows):
    kept, mols = ref.parse_kept(smiles, ds.max_nodes)
    assert kept == list(range(len(smiles)))
    return ref.collate([mols[r] for r in rows], list(range(len(rows))),
                       ds.max_nodes, ds.max_edges, "cpu")


def _grads(model):
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def test_rwse_on_known_graphs():
    """A 6-ring returns to its start with probability 0 at odd steps, 1/2
    at two and 3/8 at four; an isolated atom reads 0; a salt's ions, each
    alone, read 0, its acetate as a star; the port's float64 product and
    the reference's ``matrix_power`` agree within f32 rounding."""
    ring = parse_smiles("C1CCCCC1")
    pairs = sorted({(b.a1, b.a2) for b in ring.GetBonds()}
                   | {(b.a2, b.a1) for b in ring.GetBonds()})
    got = random_walk_se(6, np.array(pairs).T)
    assert got.shape == (6, 16) and got.dtype == np.float32
    assert (got[:, 0::2] == 0).all()
    np.testing.assert_allclose(got[:, 1], 0.5)
    np.testing.assert_allclose(got[:, 3], 0.375)
    assert (random_walk_se(1, np.zeros((2, 0), np.int64)) == 0).all()
    for smi in SPECIAL:
        feats, pairs, _, want = ref.graph(parse_smiles(smi))
        idx = np.array(pairs, np.int64).T.reshape(2, -1)
        np.testing.assert_allclose(random_walk_se(feats.shape[0], idx), want,
                                   rtol=1e-6, atol=1e-7)
    salt = random_walk_se(5, np.array([[0, 1, 1, 1, 2, 3],
                                       [1, 0, 2, 3, 1, 1]]))
    assert (salt[4] == 0).all() and salt[0, 1] == pytest.approx(1 / 3)


def test_edge_structure_native_and_python_agree(tiny):
    """``MolecularDataset(structure="edges")`` holds the same bond types
    and random-walk encoding on the native and the Python path (and on 1
    and 8 native workers), the reference's own where a molecule has them;
    the compact storage carries both as they are."""
    cfg, smiles, ds = tiny
    py = MolecularDataset(smiles, np.zeros(len(smiles), np.float32),
                          fingerprint=None, structure="edges", verbose=False,
                          use_native=False)
    for k in ("edge_types", "rwse", "nodes", "edges", "edge_mask"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(py, k))
    many = smiles + load_csv(TRAIN_CSV)[0][3:200]
    a, b = (native.featurize_structure_native(many, 35, 80, 176, hops=1)
            for _ in range(2))
    np.testing.assert_array_equal(a[6], b[6])
    for i, smi in enumerate(smiles):
        _, pairs, types, _ = ref.graph(parse_smiles(smi))
        e = len(pairs)
        np.testing.assert_array_equal(ds.edge_types[i, :e], types)
        assert (ds.edge_types[i, e:] == 0).all()
        assert (ds.rwse[i, int(ds.node_mask[i].sum()):] == 0).all()
    idx = torch.tensor([3, 0, 2])
    plain = gather_batch(to_device({k: getattr(ds, k) for k in (
        "edge_types", "rwse")}, "cpu"), idx, 0)
    packed = gather_batch(to_device(pack_dataset(ds), "cpu"), idx, 0)
    for k in plain:
        assert torch.equal(plain[k], packed[k]), k


@pytest.mark.parametrize("dropout", [True, False])
def test_train_steps_match_reference(tiny, dropout):
    """Two train steps of ``Trainer`` on a batch of 8 with 2 padded rows
    (the salt, the one-atom molecule and the ring among the rest), against
    the reference on its own featurisation: each step's loss, every leaf's
    gradient, and the parameters after each of Adam's steps."""
    cfg, smiles, ds = tiny
    if not dropout:
        cfg = cfg.replace(graph_dropout=0.0, attention_dropout=0.0)
    sub = MolecularDataset(smiles[:6], ds.y_orig[:6], scaler=ds.scaler,
                           fingerprint=None, structure="edges",
                           verbose=False, max_nodes=ds.max_nodes,
                           max_edges=ds.max_edges)
    trainer = Trainer(cfg, sub, device="cpu")
    state = trainer.init_state(seed=3)
    w = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    params = {k: v for k, v in w.items() if not ref.is_buffer(k)}
    adam = ref.Adam(params, cfg.weight_decay)
    batch = next(trainer._batches(sub, 8))
    assert batch["sample_mask"].tolist() == [1.0] * 6 + [0.0] * 2
    gen, rgen = (torch.Generator().manual_seed(11) for _ in range(2))
    g = _graph(sub, smiles[:6], range(6))
    for step in range(2):
        before = {k: v.clone() for k, v in params.items()}
        out = trainer.train_step(state, batch, gen)
        got = _grads(state.model)
        masks = ref.draw_masks(rgen, 8, ds.max_nodes, ds.max_edges, WIDTH,
                               HEADS, FFN, LAYERS, cfg.graph_dropout,
                               cfg.attention_dropout, "cpu") \
            if dropout else None
        with ref.ieee_flags():
            loss, grads = ref.train_step(w, g, batch["y"][:6], HEADS, masks,
                                         cfg.graph_dropout,
                                         cfg.attention_dropout)
        assert abs(float(out["loss"]) - float(loss)) <= 1e-5 * float(loss)
        assert set(grads) == set(got)
        med = float(np.median([float(t.norm()) for t in grads.values()]))
        small = {k for k in grads if float(grads[k].norm()) < 1e-3 * med}
        assert "layers.1.local_model.bn_edge_e.scale" in small
        for k in grads:
            scale = med if k in small else float(grads[k].norm())
            assert float((got[k] - grads[k]).norm()) <= 1e-4 * scale, k
        adam.step(grads, cfg.lr)
        after = dict(state.model.named_parameters())
        for k in set(params) - small:
            want = (params[k] - before[k]).norm()
            moved = (after[k].detach() - before[k]).norm()
            assert abs(float(moved - want)) <= 1e-4 * float(want), k
        # the next step starts from the program's own parameters
        params.update({k: v.detach().clone() for k, v in after.items()})
        w.update(params)


def test_forward_matches_reference_in_evaluation(tiny):
    """``Trainer.evaluate``'s predictions against the reference's forward
    with the batch norms' running statistics and no dropout, the padded
    final batch included."""
    cfg, smiles, ds = tiny
    trainer = Trainer(cfg, ds, ds, device="cpu")
    state = trainer.init_state(seed=5)
    state, _ = trainer.train_epoch(state, 0)
    w = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    assert float(w["layers.0.norm2.mean"].abs().max()) > 0
    got = torch.from_numpy(trainer.evaluate(state)["pred"])
    with ref.ieee_flags(), torch.no_grad():
        want = ref.forward(w, _graph(ds, smiles, range(len(smiles))), HEADS,
                           train=False)
    assert got.shape == want.shape == (len(smiles),)
    assert _rel(got, want) <= 1e-5


def test_wider_padding_changes_no_output(tiny):
    """The same molecules at a wider budget, 16 more atom slots and 64
    more edge slots: the same evaluation predictions and the same loss and
    gradients of a train step without dropout, within f32 rounding (the
    sums over the padded slots add zeros in another order)."""
    cfg, smiles, ds = tiny
    cfg = cfg.replace(graph_dropout=0.0, attention_dropout=0.0)
    wide = MolecularDataset(smiles, ds.y_orig, scaler=ds.scaler,
                            fingerprint=None, structure="edges",
                            verbose=False, max_nodes=ds.max_nodes + 16,
                            max_edges=ds.max_edges + 64)
    runs = []
    for d in (ds, wide):
        trainer = Trainer(cfg, d, d, device="cpu")
        state = trainer.init_state(seed=7)
        pred = torch.from_numpy(trainer.evaluate(state)["pred"])
        loss = trainer.train_step(state, next(trainer._batches(d, 8)))
        runs.append((pred, loss["loss"], _grads(state.model)))
    (p0, l0, g0), (p1, l1, g1) = runs
    assert _rel(p1, p0) <= 1e-6 and _rel(l1, l0) <= 1e-6
    med = float(np.median([float(t.norm()) for t in g0.values()]))
    for k in g0:
        assert float((g1[k] - g0[k]).norm()) \
            <= 1e-5 * max(float(g0[k].norm()), med), k


def test_gated_message_backward_matches_autograd():
    """``GatedMessage``'s explicit backward against autograd through the
    reference's ops (gathers and ``index_add`` sums over the real edges
    alone) in f64, with an unused ``e`` output and with both used; masked
    slots, whatever their indices and values, change no output."""
    g = torch.Generator().manual_seed(0)
    b, n, e, d = 3, 7, 12, 5
    x = [torch.randn(b, n, d, generator=g, dtype=torch.float64)
         for _ in range(3)]
    ce = torch.randn(b, e, d, generator=g, dtype=torch.float64)
    edges = torch.randint(0, n, (b, 2, e), generator=g)
    mask = (torch.rand(b, e, generator=g) > 0.3).double()
    cot = torch.randn(b, n, d, generator=g, dtype=torch.float64)
    ecot = torch.randn(b, e, d, generator=g, dtype=torch.float64)

    def plain(dh, eh, ce, bh):
        src, dst = gm._flat(edges, n)
        keep = mask.reshape(-1) > 0
        src, dst = src[keep], dst[keep]
        flat = [t.reshape(b * n, d) for t in (dh, eh, bh)]
        ev = ce.reshape(-1, d)
        e_all = flat[0][gm._flat(edges, n)[1]] + flat[1][gm._flat(
            edges, n)[0]] + ev
        gate = torch.sigmoid(e_all[keep])
        num = torch.zeros(b * n, d, dtype=torch.float64).index_add(
            0, dst, gate * flat[2][src])
        den = torch.zeros(b * n, d, dtype=torch.float64).index_add(
            0, dst, gate)
        return (num / (den + gm.EPS)).view(b, n, d), e_all.view(b, e, d)

    for use_e in (False, True):
        outs = []
        for fn in (lambda *a: gm.gated_message(*a, edges, mask), plain):
            leaves = [t.clone().requires_grad_(True)
                      for t in (x[0], x[1], ce, x[2])]
            agg, e_new = fn(*leaves)
            loss = (agg * cot).sum() + ((e_new * ecot).sum() if use_e else 0)
            loss.backward()
            outs.append([agg.detach(), e_new.detach()]
                        + [t.grad for t in leaves])
        for got, want in zip(*outs):
            assert _rel(got, want) <= 1e-12
    # masked slots: other indices and values, the same outputs
    off = (mask == 0)[:, None, :].expand(b, 2, e)
    edges2 = torch.where(off, torch.randint(0, n, edges.shape, generator=g),
                         edges)
    ce2 = torch.where(mask[..., None] > 0, ce, ce * 7.0 + 3.0)
    a = gm.gated_message(x[0], x[1], ce, x[2], edges, mask)[0]
    c = gm.gated_message(x[0], x[1], ce2, x[2], edges2, mask)[0]
    assert torch.equal(a, c)


def test_predictor_scores_a_saved_checkpoint(tiny, tmp_path):
    """A ``graphgps_medium`` checkpoint (tiny widths) written by
    ``Trainer.fit`` is served by ``Predictor``: NaN for what does not
    parse, else the reference's evaluation forward on its own
    featurisation with the checkpoint's running statistics,
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
    with ref.ieee_flags(), torch.no_grad():
        want = ref.forward(w, _graph(ds, smiles[:7], range(7)), HEADS,
                           train=False)
    want = want.numpy() * ds.scaler.scale_ + ds.scaler.mean_
    np.testing.assert_allclose(got[:-1], want, rtol=1e-5, atol=0)


def test_train_run_writes_a_checkpoint_that_serves(tiny, tmp_path,
                                                   monkeypatch):
    """``train/run.py`` trains the preset (its widths cut to the tiny
    ones) and writes ``<ckpt-dir>/graphgps_medium/best_model.pt``;
    ``serve.py``'s backend answers from it and reports the attention calls
    without a bias and the gated message passing's edges in ``/health``."""
    import json

    from mgat_graphsage_torch.serve import PredictionServer
    from mgat_graphsage_torch.train import config as tconfig
    from mgat_graphsage_torch.train import run as trun

    cfg, smiles, _ = tiny
    monkeypatch.setitem(tconfig.PRESETS, "graphgps_medium", cfg)
    trun.main(["--preset", "graphgps_medium", "--epochs", "1", "--limit",
               "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    ckpt = str(tmp_path / "graphgps_medium" / "best_model.pt")
    server = PredictionServer(ckpt, device="cpu")
    try:
        got = server.predict_payload({"smiles": smiles[:3] + ["C1CC("]})
        assert got["model"] == "graphgps_medium" and got["count"] == 4
        assert got["predictions"][-1] is None
        tele = server.health()["telemetry"]
        assert tele["attention"]["unbiased"] > 0
        msg = tele["gated_message"]
        assert msg["explicit"] > 0 and 0 < msg["edges"] < msg["edge_slots"]
        json.dumps(tele)
    finally:
        server.close()
