"""Descriptor statistics study of the port (copy of
``mgat_graphsage_tpu/compare/stats.py``, the ``mgat-stats`` CLI; reference
``statistical analysis.py``).

    python -m mgat_graphsage_torch.compare.stats [--csv CSV] [--limit N] \\
        [--out stats_output_torch]

Host-side numpy, scipy, scikit-learn and matplotlib, on the port's own
``chem`` and ``data``; the default output directory,
``stats_output_torch``, is not the reference's ``stats_output/``.

Reproduces the reference pipeline on a ``Smiles,pchembl`` CSV:
- median split into High/Low affinity groups
  (``statistical analysis.py:51-52``);
- 11 molecular descriptors (``:54-66``) computed by the bundled
  descriptor suite (NumAromaticRings, NumAliphaticRings, NumHAcceptors,
  NumHDonors, NumRotatableBonds, RingCount, TPSA, MolLogP, MolWt,
  HeavyAtomCount, BertzCT);
- Student's t-test (the reference's scipy default; Welch available) + median-dichotomized odds ratio with 95% CI and the
  Haldane 0.5 correction (``:77-109``);
- two-panel forest plot (``:135-232``);
- PCA scatter colored by affinity group (``:244-261``);
- RandomForest descriptor importance + classification report (``:263-278``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chem.descriptors import DESCRIPTORS
from ..chem.smiles import MolFromSmiles
from ..data import load_csv

__all__ = ["compute_descriptor_table", "odds_ratio_ci", "welch_ttest",
           "student_ttest", "descriptor_statistics",
           "run_statistical_analysis"]


def compute_descriptor_table(smiles_list) -> Tuple[np.ndarray, List[int]]:
    """[n, 11] descriptor matrix + kept row indices (bad SMILES skipped,
    mirroring ``safe_mol_from_smiles``)."""
    names = list(DESCRIPTORS)
    rows, kept = [], []
    for i, smi in enumerate(smiles_list):
        mol = MolFromSmiles(str(smi))
        if mol is None:
            continue
        rows.append([float(DESCRIPTORS[n](mol)) for n in names])
        kept.append(i)
    return np.asarray(rows, np.float64), kept


def odds_ratio_ci(high: np.ndarray, low: np.ndarray,
                  alpha: float = 0.05) -> Tuple[float, float, float]:
    """Median-dichotomized odds ratio with 95% CI (reference
    ``calculate_odds_ratio_and_ci``, ``statistical analysis.py:77-109``):
    above/below the pooled median, Haldane +0.5 when a cell is zero."""
    overall_median = np.median(np.concatenate([high, low]))
    ha = float(np.sum(high > overall_median))
    hb = len(high) - ha
    la = float(np.sum(low > overall_median))
    lb = len(low) - la
    if hb == 0 or la == 0:
        ha += 0.5
        hb += 0.5
        la += 0.5
        lb += 0.5
    or_ = (ha * lb) / (hb * la) if hb * la > 0 else float("nan")
    se = math.sqrt(1 / max(ha, .5) + 1 / max(hb, .5)
                   + 1 / max(la, .5) + 1 / max(lb, .5))
    try:
        from scipy.stats import norm
        z = float(norm.ppf(1 - alpha / 2))
    except Exception:
        z = 1.959963985
    log_or = math.log(or_) if or_ > 0 else float("nan")
    return or_, math.exp(log_or - z * se), math.exp(log_or + z * se)


def welch_ttest(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """Welch's unequal-variance t-test (two-sided)."""
    try:
        from scipy import stats
        t, p = stats.ttest_ind(a, b, equal_var=False)
        return float(t), float(p)
    except Exception:
        va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
        t = (a.mean() - b.mean()) / math.sqrt(va + vb)
        # two-sided NORMAL approximation of the t tail (no scipy;
        # slightly anti-conservative for small samples)
        p = math.erfc(abs(t) / math.sqrt(2))
        return float(t), float(p)


def student_ttest(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """Pooled-variance Student's t-test (two-sided) — scipy
    ``ttest_ind``'s DEFAULT (``equal_var=True``), which is what the
    reference calls (``statistical analysis.py:117``)."""
    try:
        from scipy import stats
        t, p = stats.ttest_ind(a, b, equal_var=True)
        return float(t), float(p)
    except Exception:
        na, nb = len(a), len(b)
        sp2 = ((na - 1) * a.var(ddof=1) + (nb - 1) * b.var(ddof=1)) \
            / (na + nb - 2)
        t = (a.mean() - b.mean()) / math.sqrt(sp2 * (1 / na + 1 / nb))
        # two-sided NORMAL approximation of the t tail (no scipy;
        # slightly anti-conservative for small samples)
        p = math.erfc(abs(t) / math.sqrt(2))
        return float(t), float(p)


def descriptor_statistics(desc: np.ndarray, y: np.ndarray) -> List[Dict]:
    """Per-descriptor Student's t-test (the reference's scipy
    ``ttest_ind`` default, ``statistical analysis.py:117``) + odds ratio
    between High/Low affinity groups (median split on the target)."""
    names = list(DESCRIPTORS)
    threshold = np.median(y)
    hi_mask = y >= threshold
    out = []
    for j, name in enumerate(names):
        hi, lo = desc[hi_mask, j], desc[~hi_mask, j]
        t, p = student_ttest(hi, lo)
        or_, ci_lo, ci_hi = odds_ratio_ci(hi, lo)
        out.append({
            "descriptor": name,
            "high_mean": float(hi.mean()), "low_mean": float(lo.mean()),
            "t": t, "p": p,
            "odds_ratio": or_, "ci_low": ci_lo, "ci_high": ci_hi,
        })
    return out


def _forest_plot(stats_rows: List[Dict], out_path: str) -> str:
    """Two-panel forest plot (odds ratios + p-values), reference
    ``statistical analysis.py:135-232``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = stats_rows[::-1]
    names = [r["descriptor"] for r in rows]
    ors = np.array([r["odds_ratio"] for r in rows])
    lo = np.array([r["ci_low"] for r in rows])
    hi = np.array([r["ci_high"] for r in rows])
    ps = np.array([r["p"] for r in rows])
    ypos = np.arange(len(rows))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 6), sharey=True)
    ax1.errorbar(ors, ypos, xerr=[ors - lo, hi - ors], fmt="o",
                 color="#3F72AF", ecolor="#8aa8cf", capsize=3)
    ax1.axvline(1.0, color="red", ls="--", lw=1)
    ax1.set_xscale("log")
    ax1.set_yticks(ypos)
    ax1.set_yticklabels(names)
    ax1.set_xlabel("Odds ratio (95% CI, log scale)")
    ax1.set_title("High vs Low affinity")

    colors = ["#B83B5E" if p < 0.05 else "#999999" for p in ps]
    ax2.barh(ypos, -np.log10(np.maximum(ps, 1e-300)), color=colors)
    ax2.axvline(-math.log10(0.05), color="red", ls="--", lw=1)
    ax2.set_xlabel("-log10(p)  (Student's t-test)")
    ax2.set_title("Significance")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _pca_plot(desc: np.ndarray, y: np.ndarray, out_path: str) -> str:
    """PCA scatter colored by affinity group
    (reference ``statistical analysis.py:244-261``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.decomposition import PCA
    from sklearn.preprocessing import StandardScaler

    X = StandardScaler().fit_transform(desc)
    pcs = PCA(n_components=2).fit(X)
    xy = pcs.transform(X)
    hi = y >= np.median(y)
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.scatter(xy[hi, 0], xy[hi, 1], s=12, alpha=0.6, label="High",
               color="#B83B5E")
    ax.scatter(xy[~hi, 0], xy[~hi, 1], s=12, alpha=0.6, label="Low",
               color="#3F72AF")
    ax.set_xlabel(f"PC1 ({pcs.explained_variance_ratio_[0]:.1%})")
    ax.set_ylabel(f"PC2 ({pcs.explained_variance_ratio_[1]:.1%})")
    ax.legend()
    ax.set_title("Descriptor PCA by affinity group")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _rf_importance(desc: np.ndarray, y: np.ndarray,
                   out_path: str) -> Dict:
    """RandomForest descriptor importance + classification report
    (reference ``statistical analysis.py:263-278``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.metrics import classification_report
    from sklearn.model_selection import train_test_split

    names = list(DESCRIPTORS)
    labels = (y >= np.median(y)).astype(int)
    # reference split: test_size=0.2, random_state=42
    # (statistical analysis.py:266)
    xtr, xte, ytr, yte = train_test_split(desc, labels, test_size=0.2,
                                          random_state=42)
    rf = RandomForestClassifier(n_estimators=100, random_state=42)
    rf.fit(xtr, ytr)
    report = classification_report(yte, rf.predict(xte),
                                   target_names=["Low", "High"],
                                   output_dict=True)
    order = np.argsort(rf.feature_importances_)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.barh([names[i] for i in order], rf.feature_importances_[order],
            color="#3F72AF")
    ax.set_title("RandomForest descriptor importance")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return {"importances": dict(zip(names,
                                    rf.feature_importances_.tolist())),
            "classification_report": report}


def run_statistical_analysis(csv_path: str,
                             output_dir: str = "stats_output_torch",
                             limit: Optional[int] = None,
                             verbose: bool = True) -> Dict:
    """Full pipeline: descriptors -> stats -> forest plot, PCA, RF."""
    os.makedirs(output_dir, exist_ok=True)
    smiles, y = load_csv(csv_path)
    if limit:
        smiles, y = smiles[:limit], y[:limit]
    desc, kept = compute_descriptor_table(smiles)
    y = np.asarray(y)[kept]
    rows = descriptor_statistics(desc, y)
    if verbose:
        print(f"{'descriptor':<18}{'OR':>8}{'CI':>18}{'p':>12}")
        for r in rows:
            print(f"{r['descriptor']:<18}{r['odds_ratio']:>8.3f}"
                  f"   [{r['ci_low']:.3f}, {r['ci_high']:.3f}]"
                  f"{r['p']:>12.2e}")
    figures = [
        _forest_plot(rows, os.path.join(output_dir, "forest_plot.png")),
        _pca_plot(desc, y, os.path.join(output_dir, "pca.png")),
    ]
    rf = _rf_importance(desc, y, os.path.join(output_dir,
                                              "rf_importance.png"))
    # persist the tables the reference only prints (statistical
    # analysis.py:237-242 forest stats, :272-277 importances + report)
    # so the analysis is an inspectable artifact, not just stdout
    cols = ["descriptor", "high_mean", "low_mean", "t", "p",
            "odds_ratio", "ci_low", "ci_high"]
    with open(os.path.join(output_dir, "descriptor_stats.csv"), "w") as f:
        f.write(",".join(cols + ["significant"]) + "\n")
        for r in rows:
            # reference rule: Significant == p < 0.05 alone
            # (statistical analysis.py:129); the forest plot colors by
            # the same rule
            sig = r["p"] < 0.05
            f.write(",".join(f"{r[c]:.6g}" if isinstance(r[c], float)
                             else str(r[c]) for c in cols)
                    + f",{sig}\n")
    with open(os.path.join(output_dir, "rf_report.json"), "w") as f:
        json.dump(rf, f, indent=2)
    if verbose:
        acc = rf["classification_report"]["accuracy"]
        print(f"RandomForest High/Low classification accuracy: {acc:.3f}")
    return {"stats": rows, "rf": rf, "figures": figures}


def main():
    import argparse

    # default = the full bundled dataset: the reference's
    # `statistical analysis.py:25` runs on the FULL ki_data.csv, not a
    # split
    from ..data import FULL_CSV

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", default=FULL_CSV)
    ap.add_argument("--out", default="stats_output_torch")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args()
    run_statistical_analysis(args.csv, args.out, args.limit)


if __name__ == "__main__":
    main()
