"""The interpretability orchestrator (port of
``mgat_graphsage_tpu/explain/pipeline.py``; reference ``gnnexplainer.py``
``hybrid_analysis_strategy``, ``:1609-1641``):

Stage 1 - gradient importance for ALL molecules (``:1402-1442``): batched
          input gradients, ``stage1_batch`` molecules a batch;
Stage 2 - hierarchical stratified selection of 200 representatives
          (``:1445-1512``);
Stage 3 - detailed analysis of the selected set: GNNExplainer mask
          optimisation + substructure mapping (``:1515-1573``) and the
          full-dataset substructure sweep (``:1078-1178``);
Stage 4 - aggregation, figure suite, comprehensive text report
          (``:1576-1606, 1644-1794``).

As in the reference's ``load_best_model`` (``:1352-1366``), only the
GRAPH BRANCH of the hybrid checkpoint drives importance: the CNN branch
consumes fingerprints, which have no per-atom attribution.

Differences from the reference package, by design: a GNNExplainer
failure raises (the reference falls back to the gradient importances,
which on the card would hide a kernel failure); Stage 3's initial masks
come from a ``torch.Generator`` seeded with :data:`SEED`, not from
``jax.random``; the default output directory is ``explain_output_torch``.
The figure suite (matplotlib) is imported only when figures are made.
Runs on CUDA unless given ``device="cpu"``:

    python -m mgat_graphsage_torch.explain.pipeline CKPT CSV [--count 200]
           [--threshold 0.3] [--out explain_output_torch] [--limit ROWS]
           [--no-gnnexplainer] [--device cuda|cpu]
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..chem.smiles import parse_smiles
from ..data import MolecularDataset, load_csv
from ..eval.predict import load_model_from_checkpoint
from ..models import matmul_precision
from .gradients import (
    make_scan_gradient_explainer,
    process_node_importance_batch,
)
from .gnnexplainer import make_scan_gnn_explainer
from .sampling import select_representative_molecules
from .substructures import (
    SubstructureIdentifier,
    analyze_full_dataset_substructures,
)

__all__ = ["hybrid_analysis_strategy", "quick_importance_analysis_all",
           "detailed_importance", "SEED"]

# seed of Stage 3's mask initialisation (the reference's PRNGKey(42))
SEED = 42


def _graph_branch_apply(cfg, model):
    """The eval-mode module whose importances are taken: the hybrid's
    ``gat_graphsage`` graph branch, or a standalone graph model (a model
    of ``build_model(cfg)``)."""
    return model.gat_graphsage if cfg.is_hybrid else model


def _batch_perm(n_mols: int, batch_size: int) -> np.ndarray:
    """``[nb, B]`` index array covering ``n_mols`` in order; the final
    batch wraps around to index 0 (rows past ``n_mols`` are dropped after
    flattening, so the duplicates are never read)."""
    nb = (n_mols + batch_size - 1) // batch_size
    return (np.arange(nb * batch_size) % n_mols).astype(
        np.int64).reshape(nb, batch_size)


def _device_dataset(ds: MolecularDataset, device):
    """The padded dataset arrays on ``device``, uploaded once."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (ds.nodes, ds.edges, ds.edge_mask, ds.node_mask))


def quick_importance_analysis_all(ds: MolecularDataset, graph_apply,
                                  scaler, batch_size: int = 64,
                                  verbose: bool = True,
                                  device_data=None) -> Dict:
    """Stage 1: gradient importance + prediction for every molecule
    (reference ``quick_importance_analysis_all``,
    ``gnnexplainer.py:1402-1442``), batch after batch over the dataset on
    the device, then one vectorised host post-process.  ``device_data``
    is :func:`_device_dataset`'s tuple (else uploaded to the model's
    device)."""
    explain_all = make_scan_gradient_explainer(graph_apply)
    nodes_d, edges_d, emask_d, nmask_d = (
        device_data if device_data is not None
        else _device_dataset(ds, next(graph_apply.parameters()).device))
    perm = torch.from_numpy(_batch_perm(len(ds), batch_size)).to(
        nodes_d.device)
    t0 = time.perf_counter()
    raw, preds = explain_all(nodes_d, edges_d, emask_d, nmask_d, perm)
    raw = raw.cpu().numpy()[:len(ds)]
    preds = preds.cpu().numpy()[:len(ds)]
    num_atoms = ds.node_mask.sum(axis=1).astype(np.int64)
    all_imp = process_node_importance_batch(raw, num_atoms)
    preds_denorm = scaler.inverse_transform(preds)
    if verbose:
        dt = time.perf_counter() - t0
        print(f"Stage 1: gradient importance for {len(ds)} molecules in "
              f"{dt:.1f}s ({len(ds) / max(dt, 1e-9):,.0f} mol/s)")
    return {
        "index": np.arange(len(ds)),
        "smiles": ds.smiles,
        "prediction": preds_denorm,
        "avg_importance": np.array([imp.mean() for imp in all_imp]),
        "num_atoms": np.array([len(imp) for imp in all_imp]),
        "importances": all_imp,
    }


def detailed_importance(ds: MolecularDataset, graph_apply, selected,
                        batch_size: int = 64, device_data=None
                        ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Stage 3's GNNExplainer importances of the molecules ``selected``
    (indices into ``ds``), batch after batch over the dataset on the
    device; the final batch wraps cyclically and its duplicate rows are
    dropped.  The initial masks come from a generator seeded
    :data:`SEED`.  Returns the per-atom mask norms ``[len(selected), N]``
    before the min-max scaling, and the scaled importances of each
    molecule's real atoms.  ``device_data`` is as in
    :func:`quick_importance_analysis_all`."""
    nodes_d, edges_d, emask_d, nmask_d = (
        device_data if device_data is not None
        else _device_dataset(ds, next(graph_apply.parameters()).device))
    gexp = make_scan_gnn_explainer(graph_apply)
    sel_arr = np.asarray(selected, dtype=np.int64)
    nb = (len(sel_arr) + batch_size - 1) // batch_size
    perm = torch.from_numpy(np.resize(sel_arr, nb * batch_size).reshape(
        nb, batch_size)).to(nodes_d.device)
    generator = torch.Generator().manual_seed(SEED)
    norms = gexp(nodes_d, edges_d, emask_d, nmask_d, perm, generator)
    norms = norms.cpu().numpy()[:len(sel_arr)]
    num_atoms_sel = ds.node_mask[sel_arr].sum(axis=1).astype(np.int64)
    return norms, process_node_importance_batch(norms, num_atoms_sel)


def hybrid_analysis_strategy(
    test_csv: str,
    checkpoint_path: str,
    target_detailed_count: int = 200,
    importance_threshold: float = 0.3,
    output_dir: str = "explain_output_torch",
    use_gnnexplainer: bool = True,
    batch_size: int = 64,
    stage1_batch: int = 512,
    limit: Optional[int] = None,
    make_figures: bool = True,
    verbose: bool = True,
    device=None,
) -> Dict:
    """Full 4-stage interpretability pipeline.  Writes the text report,
    ``analysis_results.json`` and (``make_figures``) the figures to
    ``output_dir``, and returns the analysis dict; besides what the JSON
    holds, it carries ``stage1`` (Stage 1's per-molecule dict),
    ``detailed_importances`` (index -> Stage 3 importances),
    ``detailed_norms`` (Stage 3's mask norms before scaling, rows in the
    order of ``selected_indices``; None without GNNExplainer),
    ``detailed_method`` and ``timings`` (seconds by stage, host clock)."""
    os.makedirs(output_dir, exist_ok=True)
    t_start = time.perf_counter()
    model, cfg, scaler, (mn, me) = load_model_from_checkpoint(
        checkpoint_path, device)
    graph_apply = _graph_branch_apply(cfg, model)
    dev = next(model.parameters()).device

    smiles, targets = load_csv(test_csv)
    if limit:
        smiles, targets = smiles[:limit], targets[:limit]
    ds = MolecularDataset(smiles, targets, scaler=scaler,
                          fingerprint=None, featurizer=cfg.featurizer,
                          max_nodes=mn, max_edges=me, verbose=verbose)
    timings = {"load_s": time.perf_counter() - t_start}

    # ---- Stage 1: quick gradient pass over everything ----
    # stage1_batch is decoupled from the stage-3 batch: Stage 1 draws no
    # random numbers and each molecule's result does not depend on its
    # batch, so a bigger batch only saves launches.  Stage 3 keeps
    # ``batch_size``: its batches draw their initial masks in turn.
    t0 = time.perf_counter()
    with matmul_precision(cfg.matmul_precision):
        device_data = _device_dataset(ds, dev)
        info = quick_importance_analysis_all(
            ds, graph_apply, scaler, min(stage1_batch, len(ds)), verbose,
            device_data=device_data)
    timings["stage1_s"] = time.perf_counter() - t0

    # ---- Stage 2: representative selection ----
    t0 = time.perf_counter()
    if verbose:
        print("\nStage 2: selecting representative molecules")
    selected = select_representative_molecules(
        info, target_detailed_count, verbose=verbose)
    selected = sorted(selected)
    timings["stage2_s"] = time.perf_counter() - t0

    # ---- Stage 3: detailed analysis on the selected set ----
    if verbose:
        print(f"\nStage 3: detailed analysis of {len(selected)} molecules")
    t0 = time.perf_counter()
    detailed_importances: Dict[int, np.ndarray] = {}
    norms = None
    if use_gnnexplainer:
        with matmul_precision(cfg.matmul_precision):
            norms, processed = detailed_importance(
                ds, graph_apply, selected, batch_size,
                device_data=device_data)
        for k, idx in enumerate(selected):
            detailed_importances[int(idx)] = processed[k]
    for idx in selected:
        detailed_importances.setdefault(int(idx),
                                        info["importances"][int(idx)])
    timings["stage3_gnnexplainer_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    identifier = SubstructureIdentifier()
    detailed = analyze_full_dataset_substructures(
        [ds.smiles[i] for i in selected],
        [detailed_importances[int(i)] for i in selected],
        importance_threshold=max(importance_threshold, 0.5),
        identifier=identifier, verbose=verbose)

    # full-dataset sweep with the quick importances (reference
    # analyze_full_dataset_substructures over all molecules)
    full = analyze_full_dataset_substructures(
        ds.smiles, info["importances"],
        importance_threshold=importance_threshold,
        identifier=identifier, verbose=verbose)
    timings["stage3_substructures_s"] = time.perf_counter() - t0

    # ---- Stage 4: aggregate + figures + report ----
    t0 = time.perf_counter()
    results = {
        "n_molecules": len(ds),
        "n_detailed": len(selected),
        "selected_indices": [int(i) for i in selected],
        "coverage": {
            "prediction": [float(info["prediction"][selected].min()),
                           float(info["prediction"][selected].max())],
            "avg_importance": [
                float(info["avg_importance"][selected].min()),
                float(info["avg_importance"][selected].max())],
            "num_atoms": [int(info["num_atoms"][selected].min()),
                          int(info["num_atoms"][selected].max())],
        },
        "substructure_frequency": full["substructure_frequency"],
        "substructure_mean_importance":
            full["substructure_mean_importance"],
        "detailed_substructure_frequency":
            detailed["substructure_frequency"],
    }
    # radius-2 fragment environments around important atoms (reference
    # extract_important_substructures, gnnexplainer.py:171-197; carried
    # into per-molecule records as num_local_fragments, :1053)
    frag_counts: Dict[str, int] = {}
    n_local_fragments = 0
    for rec in detailed["per_molecule"]:
        envs = rec.get("atom_environments", {})
        n_local_fragments += len(envs)
        for frag in envs.values():
            frag_counts[frag] = frag_counts.get(frag, 0) + 1
    results["fragment_environment_frequency"] = dict(
        sorted(frag_counts.items(), key=lambda kv: -kv[1])[:40])
    results["n_local_fragments"] = n_local_fragments
    # functional-group totals over the full dataset (reference report's
    # "Most common functional groups", gnnexplainer.py:1714-1717)
    fg_counts: Dict[str, int] = {}
    for rec in full["per_molecule"]:
        for k, v in rec["functional_groups"].items():
            fg_counts[k] = fg_counts.get(k, 0) + v
    results["functional_group_counts"] = dict(
        sorted(fg_counts.items(), key=lambda kv: -kv[1]))

    figure_paths = []
    if make_figures:
        from . import figures as F

        if verbose:
            print("\nStage 4: rendering figures + report")
        # element-level importance pools
        elem_imp: Dict[str, List[float]] = {}
        for i in selected[:500]:
            mol = parse_smiles(ds.smiles[i])
            for a in mol.GetAtoms():
                elem_imp.setdefault(a.GetSymbol(), []).append(
                    float(detailed_importances[int(i)][a.idx]))
        if elem_imp:
            figure_paths.append(F.atom_importance_figures(
                elem_imp, os.path.join(output_dir, "atom_importance.png")))
        figure_paths.append(F.substructure_figures(
            full["substructure_frequency"],
            full["substructure_mean_importance"],
            results["functional_group_counts"],
            os.path.join(output_dir, "substructures.png")))
        # highlighted grid: y > 6 & max importance > 0.5
        entries = []
        for i in selected:
            imp = detailed_importances[int(i)]
            if ds.y_orig[i] > 6 and imp.max() > 0.5:
                entries.append(dict(smiles=ds.smiles[i], importance=imp,
                                    prediction=float(info["prediction"][i]),
                                    true_value=float(ds.y_orig[i])))
        figure_paths.append(F.highlighted_grid(
            entries, os.path.join(output_dir, "highlighted_molecules.png")))
        figure_paths.append(F.substructure_heatmap(
            detailed["per_molecule"],
            os.path.join(output_dir, "substructure_heatmap.png")))
        # six selected per-molecule panels; drop panels from any previous
        # run first — selection indices change with the model/dataset, and
        # stale molecule_<i>.png files would mix two generations of output
        for old in glob.glob(os.path.join(output_dir, "molecule_*.png")):
            os.remove(old)
        for k, i in enumerate(selected[:6]):
            figure_paths.append(F.molecule_importance_figure(
                ds.smiles[i], detailed_importances[int(i)],
                os.path.join(output_dir, f"molecule_{i}.png"),
                prediction=float(info["prediction"][i]),
                true_value=float(ds.y_orig[i])))

    report_path = os.path.join(output_dir, "analysis_report.txt")
    _write_report(report_path, results, info, selected)
    results["report"] = report_path
    with open(os.path.join(output_dir, "analysis_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    if verbose:
        print(f"Report: {report_path}")
    timings["stage4_s"] = time.perf_counter() - t0
    timings["total_s"] = time.perf_counter() - t_start
    results["figures"] = figure_paths
    results.update(
        stage1=info, detailed_importances=detailed_importances,
        detailed_norms=norms,
        detailed_method="gnnexplainer" if use_gnnexplainer else "gradient",
        timings=timings)
    return results


def _write_report(path: str, results: Dict, info: Dict,
                  selected: List[int]) -> None:
    """Comprehensive text report (reference
    ``generate_comprehensive_report``, ``gnnexplainer.py:1644-1794``)."""
    cov = results["coverage"]
    lines = [
        "=" * 70,
        "M-GAT-GraphSAGE interpretability analysis report",
        "=" * 70,
        "",
        f"Molecules analyzed (quick gradient pass): "
        f"{results['n_molecules']}",
        f"Molecules analyzed in detail:             "
        f"{results['n_detailed']}",
        "",
        # reference Global Statistics block (gnnexplainer.py:1652-1664):
        # full-dataset prediction / importance / size distributions
        "Global statistics (all molecules, quick gradient pass):",
        f"  prediction:     {float(np.min(info['prediction'])):.3f} - "
        f"{float(np.max(info['prediction'])):.3f}   mean "
        f"{float(np.mean(info['prediction'])):.3f} +/- "
        f"{float(np.std(info['prediction'])):.3f}",
        f"  avg importance: {float(np.min(info['avg_importance'])):.3f} - "
        f"{float(np.max(info['avg_importance'])):.3f}   mean "
        f"{float(np.mean(info['avg_importance'])):.3f}",
        f"  molecule size:  {int(np.min(info['num_atoms']))} - "
        f"{int(np.max(info['num_atoms']))} atoms   mean "
        f"{float(np.mean(info['num_atoms'])):.1f}",
        "",
        "Sampling coverage of the detailed set:",
        f"  prediction range:      {cov['prediction'][0]:.3f} - "
        f"{cov['prediction'][1]:.3f}",
        f"  avg importance range:  {cov['avg_importance'][0]:.3f} - "
        f"{cov['avg_importance'][1]:.3f}",
        f"  molecule size range:   {cov['num_atoms'][0]} - "
        f"{cov['num_atoms'][1]} atoms",
        "",
        "Most frequent important substructures (full dataset):",
    ]
    for name, cnt in list(results["substructure_frequency"].items())[:15]:
        imp = results["substructure_mean_importance"].get(name, float("nan"))
        lines.append(f"  {name:<20} {cnt:>6} molecules   "
                     f"mean importance {imp:.3f}")
    lines += ["", "Detailed-set substructure frequency:"]
    for name, cnt in list(
            results["detailed_substructure_frequency"].items())[:15]:
        lines.append(f"  {name:<20} {cnt:>6}")
    # reference Analysis Completeness block (gnnexplainer.py:1718-1725)
    n_mol = max(int(results["n_molecules"]), 1)
    lines += [
        "",
        "Analysis completeness:",
        f"  detailed coverage:                "
        f"{100.0 * results['n_detailed'] / n_mol:.1f}% "
        f"({results['n_detailed']}/{n_mol} molecules)",
        f"  identified important substructures: "
        f"{len(results.get('substructure_frequency', {}))}",
    ]
    lines += ["", "Most common functional groups (full dataset, Top 10):"]
    for name, cnt in list(
            results.get("functional_group_counts", {}).items())[:10]:
        lines.append(f"  {name:<20} {cnt:>6}")
    lines += [
        "",
        f"Radius-2 fragment environments around important atoms "
        f"({results.get('n_local_fragments', 0)} total):",
    ]
    for frag, cnt in list(
            results.get("fragment_environment_frequency", {}).items())[:15]:
        lines.append(f"  {frag:<30} {cnt:>6}")
    lines += ["", "=" * 70]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="The 4-stage interpretability pipeline on a checkpoint "
                    "of the PyTorch port.")
    ap.add_argument("checkpoint")
    ap.add_argument("csv")
    ap.add_argument("--count", type=int, default=200)
    ap.add_argument("--threshold", type=float, default=0.3)
    ap.add_argument("--out", default="explain_output_torch")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no-gnnexplainer", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    hybrid_analysis_strategy(
        args.csv, args.checkpoint, args.count, args.threshold,
        output_dir=args.out, limit=args.limit,
        use_gnnexplainer=not args.no_gnnexplainer, device=args.device)


if __name__ == "__main__":
    main()
