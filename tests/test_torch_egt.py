"""EGT of the port (``models/zoo.py::EGTNet``, preset ``egt_110m``) on the
CPU, at a tiny size (2 layers, width 16, 4 heads, pair width 8, 8 atoms
and 4 virtual nodes), against its plain reference
(``compare/torch_ref_egt.py``) on the same seeded weights: the SVD
encodings, the gated attention's explicit path against autograd, the
train step over 2 steps (loss, every leaf's gradient, the parameters'
change) with the sign flips and dropouts replayed from the trainer's
generator, the evaluation forward, the last layer without a pair update,
the pair stream's device spans forward and backward, the model's fields
and inputs, and a saved checkpoint served by ``Predictor`` and trained by
``train/run.py``.

The molecules hold the cases the layers have to get right: a salt (two
components, so unreachable pairs), a one-atom molecule (no bond), a ring
(repeated singular values), and a batch padded with masked rows, whose
atoms must stay out of every softmax, gate and scaler.

Tolerances, all in f32 with TF32 off: the loss 1e-5 relative (the two
sum the same products in other orders); each gradient leaf 1e-4 of its
own norm, or of the median leaf's for a leaf whose reference gradient is
under a thousandth of the median's (the key projection's bias, which the
softmax cancels but for the clip, reads round-off); the parameters'
change over each step 1e-4 of its norm for the other leaves; the
evaluation forward 1e-5.  The gated attention against autograd in f64:
1e-12.  The featurisation, native against Python, is compared bit for
bit.

On the card (marked ``card``; they skip without CUDA; this file imports
no JAX, so ``python3 -m pytest --noconftest -q -m card
tests/test_torch_egt.py``): the gated attention in bf16 at the cell's
shape against f64 (through the kernels), bf16 train steps through the
kernels that leave no tensor behind, and a bf16 train step whose
``egt.attention`` and ``egt.pair`` device spans land on the open unit.
"""

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.chem import native
from mgat_graphsage_torch.chem.featurize import svd_encoding
from mgat_graphsage_torch.chem.smiles import parse_smiles
from mgat_graphsage_torch.compare import torch_ref_egt as ref
from mgat_graphsage_torch.data import TRAIN_CSV, MolecularDataset, load_csv
from mgat_graphsage_torch.data.packed import (
    gather_batch,
    pack_dataset,
    to_device,
)
from mgat_graphsage_torch.eval import predict as tpredict
from mgat_graphsage_torch.models import build_model
from mgat_graphsage_torch.models.zoo import model_fields, model_inputs
from mgat_graphsage_torch.ops import biased_attention as ba
from mgat_graphsage_torch.train import Trainer, get_config
from mgat_graphsage_torch.utils import telemetry

SPECIAL = ["CC(=O)[O-].[Na+]", "C", "c1ccccc1", "C#CC=CC1CC1", "OCC(N)C=O",
           "CCO", "c1ccncc1"]
TINY = dict(n_layers=2, hidden_dim=16, n_heads=4, ffn_dim=16, pair_dim=8,
            compute_dtype="float32", lr_schedule="constant", lr=1e-3,
            batch_size=8, eval_batch_size=8, epochs=1)
HEADS, WIDTH, PAIR, LAYERS, V, N = 4, 16, 8, 2, 4, 8


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(2)
    cfg = get_config("egt_110m", **TINY)
    y = load_csv(TRAIN_CSV)[1][:len(SPECIAL)]
    ds = MolecularDataset(SPECIAL, y, fit_scaler=True, fingerprint=None,
                          structure="paths_svd", verbose=False, max_nodes=N)
    assert len(ds) == len(SPECIAL)
    return cfg, ds


def _inputs(smiles):
    kept, mols = ref.parse_kept(smiles, N)
    assert kept == list(range(len(smiles)))
    return {k: torch.from_numpy(a) for k, a in ref.arrays(mols, N).items()}


def _grads(model):
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def test_svd_encodings_on_known_graphs():
    """The encoding's two halves rebuild the adjacency where the rank
    covers every atom (``U S V^T = A``); a 6-ring's singular values are 2,
    2 and four 1s; one atom reads 0; past the molecule's atoms a column is
    0; the reference, calling the same routine on the adjacency it builds
    itself, reads the same bits."""
    for smi in SPECIAL:
        mol = parse_smiles(smi)
        feats, spd, bond, want = ref.pairs(mol)
        n = feats.shape[0]
        idx = np.array(np.nonzero(bond), np.int64).reshape(2, -1)
        got = svd_encoding(n, idx)
        assert got.shape == (n, 16) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        a = got[:, :8].astype(np.float64) @ got[:, 8:].T.astype(np.float64)
        np.testing.assert_allclose(a, (bond > 0).astype(np.float64),
                                   atol=1e-6)
        assert (got[:, n:8] == 0).all() and (got[:, 8 + n:] == 0).all()
    ring = svd_encoding(6, np.array([[i for i in range(6) for _ in (0, 1)],
                                     [(i + s) % 6 for i in range(6)
                                      for s in (1, 5)]]))
    np.testing.assert_allclose((ring[:, :8] ** 2).sum(0)[:6],
                               [2, 2, 1, 1, 1, 1], atol=1e-6)
    assert (svd_encoding(1, np.zeros((2, 0), np.int64)) == 0).all()


def test_paths_svd_native_and_python_agree(tiny, monkeypatch):
    """``MolecularDataset(structure="paths_svd")`` holds the same paths and
    SVD encodings on the native and the Python path, and on 1 and 8
    native workers; the compact storage carries them as they are; the
    reference's distances and bonds are the dataset's."""
    cfg, ds = tiny
    py = MolecularDataset(SPECIAL, np.zeros(len(SPECIAL), np.float32),
                          fingerprint=None, structure="paths_svd",
                          verbose=False, use_native=False, max_nodes=N)
    for k in ("svd", "spd", "path_types", "degree", "nodes", "edges"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(py, k))
    many = SPECIAL + load_csv(TRAIN_CSV)[0][:200]
    runs = []
    for workers in (1, 8):
        monkeypatch.setattr(native, "worker_count", lambda n: workers)
        runs.append(native.featurize_structure_native(many, 35, 80, 176))
    for x, y in zip(*runs):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    want = _inputs(SPECIAL)
    assert torch.equal(torch.from_numpy(ds.svd), want["svd"])
    assert torch.equal(torch.from_numpy(ds.spd).long(), want["spd"])
    bonded = torch.from_numpy(ds.spd) == 1
    types = torch.where(bonded, torch.from_numpy(ds.path_types[..., 0]), 0)
    assert torch.equal(types.long(), want["bond"])
    idx = torch.tensor([3, 0, 2])
    plain = gather_batch(to_device({k: getattr(ds, k) for k in (
        "svd", "spd", "path_types")}, "cpu"), idx, 0)
    packed = gather_batch(to_device(pack_dataset(ds), "cpu"), idx, 0)
    for k in plain:
        assert torch.equal(plain[k], packed[k]), k
    bucket = ds.bucket_view(8, ds.max_edges, np.array([2, 1]))
    assert np.array_equal(bucket.svd, ds.svd[[2, 1]])


def test_model_fields_and_inputs(tiny):
    """``egt`` reads the atoms, their mask, the paths and the SVD
    encodings: the atoms and the mask (padded rows zeroed) in the compute
    dtype, the paths as integers, the SVD encodings in f32; the trainer
    refuses a dataset without them."""
    cfg, ds = tiny
    assert cfg.structure == "paths_svd"
    assert model_fields(cfg) == ("nodes", "node_mask", "spd", "path_types",
                                 "svd")
    trainer = Trainer(cfg, ds, device="cpu")
    batch = next(trainer._batches(ds, 8))
    args = model_inputs(cfg, batch, torch.bfloat16)
    assert [a.dtype for a in args] == [torch.bfloat16, torch.bfloat16,
                                       torch.int8, torch.int8, torch.float32]
    assert float(args[1][-1].sum()) == 0.0 and float(args[1][0].sum()) == 5
    flat = MolecularDataset(SPECIAL, ds.y_orig, fingerprint=None,
                            structure="paths", verbose=False)
    with pytest.raises(ValueError, match="paths_svd"):
        Trainer(cfg, flat, device="cpu")


def _attention_case(dtype=torch.float64, device="cpu"):
    """Inputs of the gated attention with every edge case: logits past the
    clip on both sides and one exactly at it, padded keys, a batch row
    with no valid key, two virtual rows, a keep-mask."""
    g = torch.Generator().manual_seed(0)
    b, h, n, d = 3, 2, 7, 4
    q, k, v = (torch.randn(b, h, n, d, generator=g, dtype=torch.float64) * 2
               for _ in range(3))
    q[0, 0, 3], k[0, 0, 5] = 0.0, 0.0
    q[0, 0, 3, 0], k[0, 0, 5, 0] = 5.0, 2.0       # scale 1/2: exactly 5
    bias = torch.randn(b, h, n, n, generator=g, dtype=torch.float64)
    gate = torch.randn(b, h, n, n, generator=g, dtype=torch.float64)
    key_mask = torch.tensor([[1, 1, 1, 1, 1, 0, 0], [1] * 7, [0] * 7]) > 0
    keep = torch.rand(b, h, n, n, generator=g) > 0.3
    return [t.to(device, dtype) for t in (q, k, v, bias, gate)] + [
        key_mask.to(device), keep.to(device)]


def _plain_attention(q, k, v, bias, gate, key_mask, keep, p, fixed):
    """The equations by autograd through torch's own ops, the first
    ``fixed`` rows' scaler 1."""
    s = torch.matmul(q, k.transpose(-1, -2)) / 2.0
    hh = torch.clamp(s, -5.0, 5.0) + bias
    km = key_mask[:, None, None, :]
    a = torch.softmax(hh.masked_fill(~km, float("-inf")), -1)
    a = torch.where(key_mask.any(-1)[:, None, None, None], a, 0.0)
    g = torch.sigmoid(gate) * km
    out = torch.matmul(a * g * keep / (1.0 - p), v)
    sc = torch.where(torch.arange(q.shape[2]) < fixed, 1.0,
                     torch.log1p(g.sum(-1)))
    return out * sc.unsqueeze(-1), hh


@pytest.mark.parametrize("fixed", [2, 0], ids=["virtual-rows", "no-virtual"])
@pytest.mark.parametrize("use_hh", [True, False], ids=["hh", "no-hh"])
def test_gated_attention_matches_autograd(fixed, use_hh):
    """``GatedAttention``'s explicit forward and backward against autograd
    through torch's own ops, in f64: the clip passes no gradient outside
    ``[-5, 5]`` and does at its edge, padded keys take no probability and
    no gate, a row with no valid key reads 0, the virtual rows' scaler is
    1, and ``H^``'s gradient (or none, as in the last layer) comes back
    in; every call is counted with its real pairs."""
    case = _attention_case()
    cot = torch.randn(case[2].shape, generator=torch.Generator()
                      .manual_seed(1), dtype=torch.float64)
    hcot = torch.randn(case[3].shape, generator=torch.Generator()
                       .manual_seed(2), dtype=torch.float64)
    s = torch.matmul(case[0], case[1].transpose(-1, -2)) / 2.0
    assert (s > 5).any() and (s < -5).any() and (s == 5.0).any()
    outs = []
    before = ba.gated_counts()
    for fn in (lambda *a: ba.gated_attention(*a, p=0.3, scale=0.5, clip=5.0,
                                             fixed=fixed),
               lambda *a: _plain_attention(*a, 0.3, fixed)):
        leaves = [t.clone().requires_grad_(True) for t in case[:5]]
        out, hh = fn(*leaves, case[5], case[6])
        loss = (out * cot).sum() + ((hh * hcot).sum() if use_hh else 0.0)
        loss.backward()
        outs.append([out.detach(), hh.detach()] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        assert _rel(got, want) <= 1e-12
    assert torch.equal(outs[0][0][2], torch.zeros_like(outs[0][0][2]))
    after = ba.gated_counts()
    assert after["explicit"] - before["explicit"] == 1
    assert after["pairs"] - before["pairs"] == 25 + 49
    assert after["pair_slots"] - before["pair_slots"] == 3 * 49


def _step_masks(gen, cfg, rows):
    masks = ref.draw_masks(gen, cfg.batch_size, N, V, WIDTH, PAIR, HEADS,
                           LAYERS, cfg.attention_dropout, cfg.graph_dropout,
                           "cpu")
    return ref.rows_of(masks, list(rows))


@pytest.mark.parametrize("dropout", ["attention", "all", "none"])
def test_train_steps_match_reference(tiny, dropout):
    """Two train steps of ``Trainer`` on a batch of 8 with 2 padded rows,
    against the reference on its own featurisation with the sign flips and
    keep-masks replayed from the same generator: each step's loss, every
    leaf's gradient, and the parameters after each of Adam's steps; with
    the attention's dropout alone (the preset), with every dropout at 0.2,
    and with none (the sign flips alone)."""
    cfg, ds = tiny
    cfg = cfg.replace(**{"attention": {}, "all": dict(graph_dropout=0.2),
                         "none": dict(attention_dropout=0.0)}[dropout])
    sub = MolecularDataset(SPECIAL[:6], ds.y_orig[:6], scaler=ds.scaler,
                           fingerprint=None, structure="paths_svd",
                           verbose=False, max_nodes=N)
    trainer = Trainer(cfg, sub, device="cpu")
    state = trainer.init_state(seed=3)
    w = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    params = dict(w)
    adam = ref.Adam(params, cfg.weight_decay)
    batch = next(trainer._batches(sub, 8))
    assert batch["sample_mask"].tolist() == [1.0] * 6 + [0.0] * 2
    gen, rgen = (torch.Generator().manual_seed(11) for _ in range(2))
    inputs = _inputs(SPECIAL[:6])
    ones = torch.ones(6)
    for step in range(2):
        before = {k: v.clone() for k, v in params.items()}
        out = trainer.train_step(state, batch, gen)
        got = _grads(state.model)
        masks = _step_masks(rgen, cfg, range(6))
        with ref.ieee_flags():
            loss, grads = ref.train_step(w, inputs, batch["y"][:6], ones,
                                         HEADS, masks, cfg.attention_dropout,
                                         cfg.graph_dropout)
        assert abs(float(out["loss"]) - float(loss)) <= 1e-5 * float(loss)
        assert set(grads) == set(got)
        med = float(np.median([float(t.norm()) for t in grads.values()]))
        small = {k for k in grads if float(grads[k].norm()) < 1e-3 * med}
        for k in grads:
            scale = med if k in small else float(grads[k].norm())
            assert float((got[k] - grads[k]).norm()) <= 1e-4 * scale, k
        adam.step(grads, cfg.lr)
        after = dict(state.model.named_parameters())
        for k in set(params) - small:
            want = (params[k] - before[k]).norm()
            moved = (after[k].detach() - before[k]).norm()
            assert abs(float(moved - want)) <= 1e-4 * float(want), k
        params.update({k: v.detach().clone() for k, v in after.items()})
        w.update(params)


def test_sign_flips_come_from_the_generator(tiny):
    """In training the SVD encodings' signs are the generator's first
    draw, one per molecule and triplet, the same for ``U`` and ``V``: the
    program's training forward without dropout equals the reference's
    with the signs drawn from the same seed, and not with all signs kept;
    evaluation flips nothing."""
    cfg, ds = tiny
    cfg = cfg.replace(attention_dropout=0.0)
    model = build_model(cfg).train()
    trainer = Trainer(cfg, ds, device="cpu")
    batch = next(trainer._batches(ds, 8))
    w = {k: v.detach() for k, v in model.state_dict().items()}
    with torch.no_grad(), ref.ieee_flags():
        got = model(*model_inputs(cfg, batch),
                    torch.Generator().manual_seed(4)).reshape(-1)[:7]
        masks = _step_masks(torch.Generator().manual_seed(4), cfg, range(7))
        want = ref.forward(w, _inputs(SPECIAL), HEADS, masks, 0.0, 0.0)
        kept = ref.forward(w, _inputs(SPECIAL), HEADS,
                           {**masks, "signs": masks["signs"] | True}, 0.0,
                           0.0)
        plain = model.eval()(*model_inputs(cfg, batch)).reshape(-1)[:7]
    assert not masks["signs"].all() and masks["signs"].any()
    assert _rel(got, want) <= 1e-5 and _rel(got, kept) > 1e-3
    assert _rel(plain, kept) <= 1e-5


def test_forward_matches_reference_in_evaluation(tiny):
    """``Trainer.evaluate``'s predictions after an epoch against the
    reference's forward with no dropout and no sign flip, the padded final
    batch included."""
    cfg, ds = tiny
    trainer = Trainer(cfg, ds, ds, device="cpu")
    state = trainer.init_state(seed=5)
    state, _ = trainer.train_epoch(state, 0)
    w = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    got = torch.from_numpy(trainer.evaluate(state)["pred"])
    with ref.ieee_flags(), torch.no_grad():
        want = ref.forward(w, _inputs(SPECIAL), HEADS)
    assert got.shape == want.shape == (len(SPECIAL),)
    assert _rel(got, want) <= 1e-5


def test_last_layer_has_no_pair_update(tiny):
    """The last layer holds no pair update and returns the pair states it
    was given, the same tensor; every other layer updates them; the
    preset's 30 layers hold 109,831,233 parameters."""
    cfg, ds = tiny
    model = build_model(cfg)
    names = {k for k, _ in model.named_parameters()}
    assert "layers.0.pair_out.weight" in names
    assert not any(k.startswith("layers.1.pair") and "pair_norm" not in k
                   for k in names)
    h = torch.randn(2, 6, WIDTH)
    e = torch.randn(2, 6, 6, PAIR)
    mask = torch.ones(2, 6, dtype=torch.bool)
    model.eval()
    assert model.layers[1](h, e, mask)[1] is e
    assert not torch.equal(model.layers[0](h, e, mask)[1], e)
    with torch.device("meta"):
        full = build_model(get_config("egt_110m"))
    assert sum(p.numel() for p in full.parameters()) == 109831233


def _tensors_alive_after_steps(model, args, steps=3):
    """Live tensors after each of ``steps`` training steps of ``model``."""
    import gc

    alive = []
    for step in range(steps):
        gen = torch.Generator(args[0].device).manual_seed(step)
        model(*args, gen).float().sum().backward()
        gc.collect()
        alive.append(sum(1 for o in gc.get_objects()
                         if type(o) in (torch.Tensor, torch.nn.Parameter)))
    return alive


def test_a_step_leaves_no_tensor_behind():
    """Training steps of a small ``EGTNet`` leave as many tensors alive
    after each as after the first: the backward spans' hooks hold no
    tensor, so no step's graph outlives its backward."""
    from mgat_graphsage_torch.models.zoo import EGTNet

    torch.manual_seed(0)
    model = EGTNet(dim=16, pair_dim=8, layers=3, heads=4,
                   ffn_dim=16).train()
    b, n = 3, 6
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(b, n, 35, generator=g), torch.ones(b, n),
            torch.randint(-1, 5, (b, n, n), generator=g).to(torch.int8),
            torch.randint(0, 5, (b, n, n, 5), generator=g).to(torch.int8),
            torch.randn(b, n, 16, generator=g))
    alive = _tensors_alive_after_steps(model, args)
    assert alive[0] == alive[1] == alive[2]


class _Recorder:
    """``telemetry.device_span``'s stand-in: logs each span's opening and
    closing by name."""

    def __init__(self):
        self.log = []

    def __call__(self, name, device):
        rec = self

        class Span:
            def __enter__(self):
                rec.log.append(("open", name))
                return self

            def __exit__(self, *exc):
                rec.log.append(("close", name))

        return Span()


def test_pair_spans_bracket_the_pair_streams_work(tiny, monkeypatch):
    """Forward, each layer opens ``egt.pair`` for its norm and two
    projections, then ``egt.attention``, then (but in the last layer)
    ``egt.pair`` for its update; backward, the tensor hooks open and close
    ``egt.pair`` around the update's backward before the attention's and
    around the norm and projections' after it, and no two spans overlap."""

    cfg, ds = tiny
    rec = _Recorder()
    monkeypatch.setattr(telemetry, "device_span", rec)
    model = build_model(cfg).train()
    batch = next(Trainer(cfg, ds, device="cpu")._batches(ds, 8))
    out = model(*model_inputs(cfg, batch), torch.Generator().manual_seed(0))
    fwd = [n for kind, n in rec.log if kind == "open"]
    assert fwd == ["egt.pair", "egt.attention", "egt.pair",
                   "egt.pair", "egt.attention"]
    rec.log.clear()
    out.sum().backward()
    assert [n for kind, n in rec.log if kind == "open"] == [
        "egt.attention", "egt.pair", "egt.pair", "egt.attention",
        "egt.pair"]
    depth = 0
    for kind, _ in rec.log:
        depth += 1 if kind == "open" else -1
        assert depth in (0, 1)
    assert depth == 0


def test_train_run_writes_a_checkpoint_that_serves(tiny, tmp_path,
                                                   monkeypatch):
    """``train/run.py`` trains the preset (its widths cut to the tiny
    ones) and writes ``<ckpt-dir>/egt_110m/best_model.pt``; ``Predictor``
    serves it (NaN for what does not parse, else the reference's
    evaluation forward, de-normalised); ``/health`` reports the gated
    attention's calls and its real pairs under its slots."""
    import json

    from mgat_graphsage_torch.serve import PredictionServer
    from mgat_graphsage_torch.train import config as tconfig
    from mgat_graphsage_torch.train import run as trun

    cfg, ds = tiny
    monkeypatch.setitem(tconfig.PRESETS, "egt_110m", cfg)
    trun.main(["--preset", "egt_110m", "--epochs", "1", "--limit", "16",
               "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    ckpt = str(tmp_path / "egt_110m" / "best_model.pt")
    pred = tpredict.Predictor(ckpt, device="cpu")
    got = pred(SPECIAL[:4] + ["C1CC("], batch_size=4)
    assert np.isnan(got[-1]) and np.isfinite(got[:-1]).all()
    w = {k: v.float() for k, v in pred.model.state_dict().items()}
    with ref.ieee_flags(), torch.no_grad():
        want = ref.forward(w, _inputs(SPECIAL[:4]), HEADS)
    scaler = pred.scaler
    np.testing.assert_allclose(
        got[:-1], want.numpy() * scaler.scale_ + scaler.mean_, rtol=1e-5)
    server = PredictionServer(ckpt, device="cpu")
    try:
        got = server.predict_payload({"smiles": SPECIAL[:3]})
        assert got["model"] == "egt_110m" and got["count"] == 3
        tele = server.health()["telemetry"]
        att = tele["gated_attention"]
        assert att["explicit"] > 0 and 0 < att["pairs"] < att["pair_slots"]
        json.dumps(tele)
    finally:
        server.close()


# ---- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_gated_attention_in_bf16_on_the_card(cuda):
    """The explicit path at the cell's shape (32 heads of 24, 84 keys) in
    bf16 on the card against the f64 path on the CPU, on the same
    bf16-rounded inputs: the output and the gradients of ``q``, ``k``,
    ``v``, ``E`` and ``G`` within 2^-6 of their norms (bf16 keeps 8
    significant bits; the products' outputs and the rounding of ``A``,
    ``dS`` and the gradients add to that), ``H^`` within 2^-8 (the
    logits' one rounding to bf16, 2^-9 of each, before the clip)."""
    g = torch.Generator().manual_seed(5)
    b, h, n, d = 4, 32, 84, 24
    q, k, v = (torch.randn(b, h, n, d, generator=g).bfloat16().double()
               for _ in range(3))
    bias, gate = (torch.randn(b, h, n, n, generator=g).bfloat16().double()
                  for _ in range(2))
    key_mask = torch.arange(n)[None] < torch.tensor([[84], [40], [5], [30]])
    keep = torch.rand(b, h, n, n, generator=g) > 0.3
    cot = torch.randn(b, h, n, d, generator=g, dtype=torch.float64)
    hcot = torch.randn(b, h, n, n, generator=g, dtype=torch.float64)
    outs = []
    for dev, dt in ((cuda, torch.bfloat16), ("cpu", torch.float64)):
        leaves = [t.to(dev, dt).requires_grad_(True)
                  for t in (q, k, v, bias, gate)]
        out, hh = ba.gated_attention(*leaves, key_mask.to(dev),
                                     keep.to(dev), 0.3, clip=5.0, fixed=4)
        ((out.double() * cot.to(dev)).sum()
         + (hh.double() * hcot.to(dev)).sum()).backward()
        outs.append([out.detach(), hh.detach()] + [t.grad for t in leaves])
    for i, (got, want) in enumerate(zip(*outs)):
        gap = _rel(got.cpu(), want)
        assert gap <= (2.0 ** -8 if i == 1 else 2.0 ** -6), (i, gap)


@pytest.mark.card
def test_a_card_step_leaves_no_tensor_behind(cuda):
    """``test_a_step_leaves_no_tensor_behind`` on the card in bf16 with 8
    heads, so that the attention runs the gated kernels: their
    ``autograd.Function`` saves nothing that outlives a step."""
    from mgat_graphsage_torch.models.zoo import EGTNet
    from mgat_graphsage_torch.ops import biased_attention as ba

    torch.manual_seed(0)
    model = EGTNet(dim=64, pair_dim=16, layers=3, heads=8,
                   ffn_dim=64).to(cuda, torch.bfloat16).train()
    b, n = 3, 12
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(b, n, 35, generator=g).to(cuda, torch.bfloat16),
            torch.ones(b, n).to(cuda, torch.bfloat16),
            torch.randint(-1, 5, (b, n, n), generator=g).to(cuda,
                                                             torch.int8),
            torch.randint(0, 5, (b, n, n, 5), generator=g).to(cuda,
                                                               torch.int8),
            torch.randn(b, n, 16, generator=g).to(cuda))
    before = ba.gated_counts()["kernel"]
    alive = _tensors_alive_after_steps(model, args)
    assert ba.gated_counts()["kernel"] - before == 9
    assert alive[0] == alive[1] == alive[2]


@pytest.mark.card
def test_train_step_spans_on_the_card(cuda):
    """A bf16 train step of a small ``EGTNet`` on the card inside a unit:
    the unit's device seconds hold ``egt.attention`` and ``egt.pair``, 2
    attention spans and 3 pair spans a direction for 2 layers, all
    resolved."""
    from mgat_graphsage_torch.models.zoo import EGTNet

    model = EGTNet(dim=64, pair_dim=16, layers=2, heads=4,
                   ffn_dim=64).to(cuda, torch.bfloat16).train()
    b, n = 6, 20
    gen = torch.Generator().manual_seed(3)
    sizes = torch.tensor([20, 12, 5, 1, 9, 17])
    node_mask = (torch.arange(n)[None] < sizes[:, None]).to(cuda)
    nodes = torch.randn(b, n, 35, generator=gen).to(cuda, torch.bfloat16)
    spd = torch.randint(-1, 20, (b, n, n), generator=gen).to(cuda,
                                                              torch.int8)
    paths = torch.randint(0, 5, (b, n, n, 5), generator=gen).to(cuda,
                                                                 torch.int8)
    svd = torch.randn(b, n, 16, generator=gen).to(cuda)
    reg = telemetry.Registry()
    before = dict(reg.snapshot()["device_spans"])
    orig = telemetry.device_span
    telemetry.device_span = reg.device_span
    try:
        with reg.unit("train_epoch") as rec:
            out = model(nodes, node_mask.to(torch.bfloat16), spd, paths, svd,
                        torch.Generator(cuda).manual_seed(0))
            out.float().square().mean().backward()
            torch.cuda.synchronize()
    finally:
        telemetry.device_span = orig
    spans = reg.snapshot()["device_spans"]
    assert before == {} and rec.device_unresolved == 0
    assert spans["egt.attention"]["count"] == 4
    assert spans["egt.pair"]["count"] == 6
    assert rec.device["egt.attention"] > 0 and rec.device["egt.pair"] > 0
