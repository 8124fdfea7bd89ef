"""The port's interpretability package (``mgat_graphsage_torch/explain``)
against the reference package's, on the CPU.

- Stage 1 (input gradients): the full-width graph branch (the flagship's
  ``gat_graphsage``, weights carried from a flax init) on the first 64
  bundled test molecules at the serving budget (80, 176).  Tolerance:
  each molecule's importances to 1e-5 of its largest one (f32 sums in
  another order through the same math), predictions to 1e-5; where the
  reference's f32 breaks a tie of the max pool that exact arithmetic
  keeps, the port is held to the exact (float64) importances instead.
- Stage 3 (GNNExplainer): the same initial masks (the reference's own
  ``jax.random`` draw, rebuilt here) through the reference's
  ``_optimize_masks`` and the port's ``optimize_masks``, at 5 and 100
  Adam steps; tolerance and its measured gap at each test.
- The numpy parts (normalisation, sampling, SMARTS, substructures,
  figures) equal the reference exactly, and the whole pipeline runs end
  to end on a port checkpoint, with and without figures.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from mgat_graphsage_tpu.chem import parse_smiles as jparse
from mgat_graphsage_tpu.explain import gnnexplainer as jgnn
from mgat_graphsage_tpu.explain import (
    find_important_substructures as jfind_important,
    make_gradient_explainer as jmake_gradient_explainer,
    process_node_importance as jprocess,
    process_node_importance_batch as jprocess_batch,
    select_representative_molecules as jselect,
    stratified_sample_by_column as jstratified,
)
from mgat_graphsage_tpu.explain.pipeline import _batch_perm as jbatch_perm
from mgat_graphsage_tpu.explain.smarts import find_matches as jfind_matches
from mgat_graphsage_tpu.explain.substructures import (
    analyze_full_dataset_substructures as janalyze,
)
from mgat_graphsage_tpu.models import zoo as jzoo

from mgat_graphsage_torch.chem import parse_smiles
from mgat_graphsage_torch.data import TEST_CSV, MolecularDataset, load_csv
from mgat_graphsage_torch.explain import (
    COMMON_SUBSTRUCTURES,
    analyze_full_dataset_substructures,
    find_important_substructures,
    find_matches,
    hybrid_analysis_strategy,
    make_gnn_explainer,
    make_gradient_explainer,
    process_node_importance,
    process_node_importance_batch,
    quick_importance_analysis_all,
    select_representative_molecules,
    stratified_sample_by_column,
)
from mgat_graphsage_torch.explain.gnnexplainer import optimize_masks
from mgat_graphsage_torch.explain.pipeline import (
    _batch_perm,
    detailed_importance,
)
from mgat_graphsage_torch.models import GATGraphSAGE, build_model
from mgat_graphsage_torch.models import params_from_jax
from mgat_graphsage_torch.ops import dense_adjacency
from mgat_graphsage_torch.train import get_config
from mgat_graphsage_torch.train.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = (80, 176)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one thread in this file: its loops of small operations
    (100 mask steps, Stage 3 of the pipeline) slow down by an order of
    magnitude when several test processes each spin a full thread pool
    on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def molecules():
    """The first 64 bundled test molecules at the serving budget."""
    sm, y = load_csv(TEST_CSV)
    return MolecularDataset(sm[:64], y[:64], fingerprint=None,
                            max_nodes=BUDGET[0], max_edges=BUDGET[1],
                            verbose=False)


@pytest.fixture(scope="module")
def branch(molecules):
    """(flax graph-branch apply, port graph branch in eval mode), the full
    published widths, the same weights."""
    jm = jzoo.GATGraphSAGE()
    ds = molecules
    adj = np.zeros((1,) + BUDGET[:1] * 2, np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), ds.nodes[:1],
                                    adj, ds.node_mask[:1])["params"])
    model = GATGraphSAGE()
    model.load_state_dict(params_from_jax(params), strict=True)

    def japply(nodes, adj, node_mask):
        return jm.apply({"params": params}, nodes, adj, node_mask)

    return japply, model.eval()


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _inputs(ds, sel=slice(None)):
    return ds.nodes[sel], ds.edges[sel], ds.edge_mask[sel], ds.node_mask[sel]


# ---------------------------------------------------------------- numpy ----

def test_process_node_importance_equals_reference():
    rng = np.random.default_rng(3)
    cases = [(rng.uniform(0, 3, 9), 9), (rng.uniform(0, 3, (7, 35)), 7),
             (np.ones(4), 4), (rng.uniform(size=3), 6),
             (rng.uniform(size=8), 5), (np.zeros(2), 0)]
    for raw, n in cases:
        got, want = process_node_importance(raw, n), jprocess(raw, n)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    raw = rng.uniform(0, 3, size=(6, 10))
    raw[4] = 1.0
    num_atoms = np.array([10, 3, 7, 1, 5, 0])
    for g, w in zip(process_node_importance_batch(raw, num_atoms),
                    jprocess_batch(raw, num_atoms)):
        assert g.tobytes() == w.tobytes()
    assert (_batch_perm(961, 512) == jbatch_perm(961, 512)).all()


def test_sampling_equals_reference():
    rng = np.random.default_rng(1)
    n = 500
    info = {"index": np.arange(n), "prediction": rng.normal(6, 1, n),
            "avg_importance": rng.uniform(0, 1, n),
            "num_atoms": rng.integers(11, 94, n)}
    for target in (200, 12, 600):
        assert select_representative_molecules(info, target, verbose=False) \
            == jselect(info, target, verbose=False)
    vals = rng.normal(size=200)
    assert stratified_sample_by_column(np.arange(200), vals, 50) == \
        jstratified(np.arange(200), vals, 50)


def _smarts_cases():
    """Every (molecule, pattern) pair of the reference's SMARTS tests,
    read from that file, and the pattern vocabulary over a few drugs."""
    import re

    src = open(os.path.join(REPO, "tests", "test_smarts.py")).read()
    mols = re.findall(r'parse_smiles\("([^"]+)"\)', src)
    pats = re.findall(r'(?:find_matches|has_match)\(\w+, "([^"]+)"\)', src)
    assert len(mols) >= 10 and len(pats) >= 20
    drugs = ["CC(=O)Oc1ccccc1C(=O)O", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
             "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "c1ccc2[nH]ccc2c1",
             "O=C1CCCN1C1CCNCC1", "OCC1OC(O)C(O)C1O"]
    pats = list(dict.fromkeys(pats + list(COMMON_SUBSTRUCTURES.values())))
    return list(dict.fromkeys(mols + drugs)), pats


def test_smarts_matches_equal_reference():
    mols, pats = _smarts_cases()
    for smi in mols:
        m, jm = parse_smiles(smi), jparse(smi)
        for pat in pats:
            assert find_matches(m, pat) == jfind_matches(jm, pat), (smi, pat)


def test_substructures_equal_reference(molecules):
    rng = np.random.default_rng(5)
    smiles = molecules.smiles[:24] + ["CC(=O)Oc1ccccc1C(=O)O"]
    imps = [rng.uniform(size=parse_smiles(s).GetNumAtoms()) for s in smiles]
    for smi, imp in zip(smiles, imps):
        assert find_important_substructures(smi, imp, 0.5) == \
            jfind_important(smi, imp, 0.5)
    assert analyze_full_dataset_substructures(smiles, imps, 0.3) == \
        janalyze(smiles, imps, 0.3)


def test_figures_render(tmp_path):
    from mgat_graphsage_torch.explain import figures as F

    p = F.molecule_importance_figure(
        "CC(=O)Oc1ccccc1C(=O)O", np.linspace(0, 1, 13),
        str(tmp_path / "mol.png"), prediction=6.5, true_value=7.0)
    assert os.path.getsize(p) > 10_000
    p = F.atom_importance_figures(
        {"C": [0.2, 0.5, 0.9], "O": [0.7, 0.8], "N": [0.1]},
        str(tmp_path / "atoms.png"))
    assert os.path.getsize(p) > 10_000


# ---------------------------------------------------- Stage 1: gradients ---

def _exact_importance(model, ds):
    """The per-atom importances of the port's graph branch in float64:
    the exact ones to well below f32's precision, with the max pool's
    ties (symmetric atoms) split evenly as exact arithmetic splits
    them."""
    m64 = copy.deepcopy(model).double()
    nodes, edges, emask, nmask = _t(*_inputs(ds))
    adj = dense_adjacency(edges, emask, nodes.shape[1]).double()
    x = nodes.double().requires_grad_(True)
    (g,) = torch.autograd.grad(m64(x, adj, nmask.double()).sum(), x)
    return (torch.linalg.vector_norm(g, dim=-1) * nmask.double()).numpy()


def test_gradient_importance_matches_reference(molecules, branch):
    """Predictions to 1e-5; importances to 1e-5 of each molecule's largest
    one, against the exact (float64) importances on every molecule, and
    against the reference on every molecule where the reference is
    itself that close to the exact ones.

    Symmetric atoms (the two O of a sulfonyl, the ring atoms of a
    para-substituted benzene) tie in the graph branch's max pool.  Both
    packages split the gradient evenly among exact ties, but the
    reference's f32 rounds symmetric rows apart on some molecules and
    sends the whole gradient to one of them: 6 of these 64 molecules,
    0.03-0.20 of the largest importance off the exact one.  The port
    keeps the ties (4.6e-7 off the exact ones on all 64, measured on the
    CPU)."""
    japply, model = branch
    raw_ref, preds_ref = jmake_gradient_explainer(japply)(
        *(jnp.asarray(a) for a in _inputs(molecules)))
    raw_ref, preds_ref = np.asarray(raw_ref), np.asarray(preds_ref)
    raw, preds = make_gradient_explainer(model)(*_t(*_inputs(molecules)))
    raw, preds = raw.numpy(), preds.numpy()
    assert all(p.grad is None for p in model.parameters())
    np.testing.assert_allclose(preds, preds_ref, rtol=1e-5, atol=1e-5)
    exact = _exact_importance(model, molecules)
    scale = exact.max(axis=1, keepdims=True)
    assert (scale > 0).all()
    gap_port = (np.abs(raw - exact) / scale).max(axis=1)
    gap_ref = (np.abs(raw_ref - exact) / scale).max(axis=1)
    gap = (np.abs(raw - raw_ref) / scale).max(axis=1)
    print(f"importance gap to the exact ones: port {gap_port.max():.2e}, "
          f"reference {gap_ref.max():.2e} "
          f"({int((gap_ref > 1e-5).sum())} molecules over 1e-5)")
    assert (gap_port <= 1e-5).all()
    ref_exact = gap_ref <= 1e-5
    assert ref_exact.sum() >= 56
    assert (gap[ref_exact] <= 1e-5).all()
    # padded atoms get exactly zero importance
    pad = molecules.node_mask == 0
    assert (raw[pad] == 0).all() and (raw_ref[pad] == 0).all()


def test_stage1_is_batch_size_invariant(molecules, branch):
    _, model = branch

    class Scaler:
        def inverse_transform(self, y):
            return np.asarray(y)

    device_data = _t(*_inputs(molecules))
    outs = [quick_importance_analysis_all(molecules, model, Scaler(), b,
                                          verbose=False,
                                          device_data=device_data)
            for b in (7, 64)]
    np.testing.assert_allclose(outs[0]["prediction"], outs[1]["prediction"],
                               rtol=2e-6, atol=2e-6)
    for a, b in zip(outs[0]["importances"], outs[1]["importances"]):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6)
    assert len(outs[0]["importances"]) == len(molecules)


# ---------------------------------------------- Stage 3: GNNExplainer ---

def _reference_draw(rng, b, n, f, e):
    """The reference's initial masks (``gnnexplainer.py:56-62``)."""
    k1, k2 = jax.random.split(rng)
    return (np.array(0.1 * jax.random.normal(k1, (b, n, f))),
            np.array(0.1 * jax.random.normal(k2, (b, e))))


@pytest.mark.parametrize("epochs,tol", [(5, 1e-5), (100, 1e-4)])
def test_gnnexplainer_matches_reference_from_the_same_masks(
        molecules, branch, epochs, tol):
    """Feature and edge masks after ``epochs`` steps, from the same initial
    masks, to ``tol`` absolute (the masks lie in [0, 1]).  Measured on
    this panel: ~1e-7 after 5 steps, ~1e-6 after 100; the tolerance
    leaves room for Adam's normalised step, which turns a rounding gap
    in a near-cancelling gradient into up to lr = 0.01 per step."""
    japply, model = branch
    ins = _inputs(molecules, slice(0, 8))
    b, n, f = ins[0].shape
    init = _reference_draw(jax.random.PRNGKey(11), b, n, f, ins[1].shape[-1])
    fm_ref, em_ref = jax.jit(
        lambda *a: jgnn._optimize_masks(japply, optax.adam(0.01), epochs,
                                        *a))(
        *(jnp.asarray(a) for a in ins), jax.random.PRNGKey(11))
    fm, em = optimize_masks(model, *_t(*ins), epochs=epochs,
                            init=_t(*init))
    gap_f = float(np.abs(fm.numpy() - np.asarray(fm_ref)).max())
    gap_e = float(np.abs(em.numpy() - np.asarray(em_ref)).max())
    print(f"GNNExplainer gap after {epochs} steps: feature {gap_f:.3e}, "
          f"edge {gap_e:.3e}")
    assert gap_f <= tol and gap_e <= tol
    assert all(p.grad is None for p in model.parameters())


def test_gnnexplainer_keeps_padding_at_zero(molecules, branch):
    _, model = branch
    nodes, edges, emask, nmask = _t(*_inputs(molecules, slice(0, 4)))
    gen = torch.Generator().manual_seed(0)
    fm, em = make_gnn_explainer(model, epochs=3)(nodes, edges, emask, nmask,
                                                 generator=gen)
    assert fm.shape == nodes.shape and em.shape == emask.shape
    assert (fm[nmask == 0] == 0).all() and (em[emask == 0] == 0).all()
    valid = fm[nmask > 0]
    assert ((valid > 0) & (valid < 1)).all()
    # the generator-drawn default is reproducible from its seed
    fm2, _ = make_gnn_explainer(model, epochs=3)(
        nodes, edges, emask, nmask,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(fm, fm2)


def test_detailed_importance_wraps_the_last_batch(molecules, branch):
    """Stage 3 over a selection that is not a whole number of batches,
    with the dataset uploaded to the model's device: one row per selected
    molecule, each its own atom count, in [0, 1], the min-max scaling of
    the returned mask norms."""
    _, model = branch
    sel = [3, 0, 17, 9, 40]
    norms, imps = detailed_importance(molecules, model, sel, batch_size=2)
    atoms = molecules.node_mask[sel].sum(axis=1).astype(np.int64)
    assert norms.shape == (len(sel), molecules.nodes.shape[1])
    assert [len(i) for i in imps] == atoms.tolist()
    assert all(((i >= 0) & (i <= 1)).all() for i in imps)
    assert all(np.array_equal(a, b) for a, b in
               zip(imps, process_node_importance_batch(norms, atoms)))


# ------------------------------------------------------------ pipeline ---

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, molecules):
    """A port checkpoint of the flagship (random weights, seed 0; the CNN
    branch's hidden width cut to 16) at the serving budget."""
    cfg = get_config("flagship", cnn_fc_hidden=16)
    torch.manual_seed(0)
    model = build_model(cfg)
    path = str(tmp_path_factory.mktemp("ckpt") / "best_model.pt")
    import dataclasses

    save_checkpoint(path, model.state_dict(), {
        "config": dataclasses.asdict(cfg),
        "scaler": molecules.scaler.to_dict(),
        "max_nodes": BUDGET[0], "max_edges": BUDGET[1]})
    return path


def test_pipeline_end_to_end_on_the_cpu(checkpoint, tmp_path, capsys):
    from mgat_graphsage_torch.explain.pipeline import main

    out = tmp_path / "explain"
    out.mkdir()
    (out / "molecule_999.png").write_bytes(b"stale")
    main([checkpoint, TEST_CSV, "--count", "12", "--limit", "48", "--out",
          str(out), "--device", "cpu"])
    assert "Stage 3: detailed analysis of 12 molecules" in \
        capsys.readouterr().out
    assert not (out / "molecule_999.png").exists()
    report = (out / "analysis_report.txt").read_text()
    assert "Global statistics" in report and "+/-" in report
    assert "functional groups" in report
    res = json.load(open(out / "analysis_results.json"))
    assert res["n_molecules"] == 48 and res["n_detailed"] == 12
    assert len(res["selected_indices"]) == 12
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert {"atom_importance.png", "substructures.png",
            "highlighted_molecules.png",
            "substructure_heatmap.png"} <= set(pngs)
    assert sum(f.startswith("molecule_") for f in pngs) == 6


def test_pipeline_without_figures_needs_no_matplotlib(checkpoint, tmp_path,
                                                      monkeypatch):
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib.") or \
                name == "mgat_graphsage_torch.explain.figures":
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = hybrid_analysis_strategy(
        TEST_CSV, checkpoint, 12, output_dir=str(tmp_path), batch_size=16,
        limit=48, make_figures=False, verbose=False, device="cpu")
    assert res["figures"] == [] and res["detailed_method"] == "gnnexplainer"
    assert sorted(res["detailed_importances"]) == res["selected_indices"]
    assert res["detailed_norms"].shape == (12, BUDGET[0])
    assert sorted(os.listdir(tmp_path)) == ["analysis_report.txt",
                                            "analysis_results.json"]
    assert set(res["timings"]) >= {"stage1_s", "stage3_gnnexplainer_s",
                                   "total_s"}
    # importing the package loads no matplotlib either
    code = ("import sys, mgat_graphsage_torch.explain.pipeline; "
            "assert 'matplotlib' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
