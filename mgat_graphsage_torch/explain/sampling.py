"""Hierarchical stratified sampling of representative molecules.

Reference ``gnnexplainer.py:1445-1512`` (and README "Experimental
Procedures" Steps 1-5): pick ``target_count`` molecules as
- 40% stratified over prediction value,
- 30% stratified over average node importance,
- 20% stratified over molecule size,
- remainder random,
with disjoint pools, quintile (qcut q=5, duplicate-edges dropped) bins,
``target_count // 5`` per bin, seed 42, random fallback when binning
fails.

A copy of ``mgat_graphsage_tpu/explain/sampling.py``
(the port imports nothing of that package); keep the two in step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["qcut_bins", "stratified_sample_by_column",
           "select_representative_molecules"]


def qcut_bins(values: np.ndarray, q: int = 5) -> np.ndarray:
    """Quantile binning with duplicate edges dropped (pandas
    ``qcut(..., duplicates='drop')`` semantics). Returns bin ids, -1 for
    NaN."""
    values = np.asarray(values, dtype=np.float64)
    qs = np.quantile(values[~np.isnan(values)],
                     np.linspace(0, 1, q + 1))
    edges = np.unique(qs)
    if len(edges) < 2:
        return np.zeros(len(values), dtype=np.int64)
    # interior edges only; rightmost bin inclusive
    ids = np.searchsorted(edges[1:-1], values, side="left")
    ids = np.where(np.isnan(values), -1, ids)
    return ids.astype(np.int64)


def stratified_sample_by_column(indices: Sequence[int],
                                values: np.ndarray,
                                target_count: int,
                                seed: int = 42) -> List[int]:
    """Sample ``target_count // 5`` rows from each quintile bin of
    ``values`` (reference ``stratified_sample_by_column``); falls back to
    plain random sampling if binning degenerates."""
    indices = np.asarray(indices)
    rng = np.random.default_rng(seed)
    try:
        bins = qcut_bins(values, 5)
        per_bin = target_count // 5
        chosen: List[int] = []
        for b in np.unique(bins):
            if b < 0:
                continue
            pool = indices[bins == b]
            take = min(per_bin, len(pool))
            if take > 0:
                chosen.extend(rng.choice(pool, size=take,
                                         replace=False).tolist())
        return chosen
    except Exception as e:  # pragma: no cover — mirrors reference fallback
        print(f"Stratified sampling failed, using random sampling: {e}")
        take = min(target_count, len(indices))
        return rng.choice(indices, size=take, replace=False).tolist()


def select_representative_molecules(info: Dict[str, np.ndarray],
                                    target_count: int = 200,
                                    seed: int = 42,
                                    verbose: bool = True) -> List[int]:
    """``info`` needs arrays ``index``, ``prediction``, ``avg_importance``,
    ``num_atoms`` (one row per molecule).  Returns selected ``index``
    values (reference ``select_representative_molecules``)."""
    idx = np.asarray(info["index"])
    n = len(idx)
    if n < target_count:
        if verbose:
            print(f"Available molecules ({n}) < target count "
                  f"({target_count}), will analyze all available")
        return idx.tolist()

    selected: List[int] = []

    def remaining_mask():
        sel = set(selected)
        return np.array([i not in sel for i in idx])

    if verbose:
        print("  - Stratified sampling by prediction values...")
    selected.extend(stratified_sample_by_column(
        idx, np.asarray(info["prediction"], dtype=float),
        int(target_count * 0.4), seed))

    if verbose:
        print("  - Stratified sampling by average importance...")
    m = remaining_mask()
    if m.any():
        selected.extend(stratified_sample_by_column(
            idx[m], np.asarray(info["avg_importance"], dtype=float)[m],
            int(target_count * 0.3), seed))

    if verbose:
        print("  - Stratified sampling by molecule size...")
    m = remaining_mask()
    if m.any():
        selected.extend(stratified_sample_by_column(
            idx[m], np.asarray(info["num_atoms"], dtype=float)[m],
            int(target_count * 0.2), seed))

    if verbose:
        print("  - Random sampling for remaining molecules...")
    m = remaining_mask()
    need = target_count - len(selected)
    if need > 0 and m.any():
        pool = idx[m]
        rng = np.random.default_rng(seed)
        take = min(need, len(pool))
        selected.extend(rng.choice(pool, size=take, replace=False).tolist())

    if verbose:
        sel_set = set(selected)
        mask = np.array([i in sel_set for i in idx])
        pred = np.asarray(info["prediction"], dtype=float)[mask]
        imp = np.asarray(info["avg_importance"], dtype=float)[mask]
        na = np.asarray(info["num_atoms"])[mask]
        print(f"Selected {len(selected)} representative molecules")
        print(f"  Prediction range: {pred.min():.3f} - {pred.max():.3f}")
        print(f"  Importance range: {imp.min():.3f} - {imp.max():.3f}")
        print(f"  Molecule size range: {na.min()} - {na.max()} atoms")
    return selected
