"""The interpretability figure suite (matplotlib-only).

Reimplements the reference's ~15-figure visualization surface
(``gnnexplainer.py:235-604, 723-930, 1180-1349``) without RDKit Draw,
networkx, or seaborn (none available here):

- molecule drawing uses a built-in force-directed (Fruchterman-Reingold
  style) 2D layout over the bond graph — the stand-in for both RDKit
  coordgen and networkx ``spring_layout``;
- per-molecule two-panel figures (structure + node-importance map);
- atom-importance 4-plot set (bar / cumulative / element pie / element box);
- substructure 4-plot set (frequency / mean importance / functional-group
  pie / frequency-vs-importance scatter);
- highlighted-molecule grid (high-activity, high-importance picks);
- molecule x substructure presence heatmap (top 40).

All functions save PNG files and return the path.

A copy of ``mgat_graphsage_tpu/explain/figures.py``
(the port imports nothing of that package); keep the two in step.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ..chem.smiles import Mol, parse_smiles  # noqa: E402

__all__ = [
    "spring_layout",
    "draw_molecule",
    "molecule_importance_figure",
    "atom_importance_figures",
    "substructure_figures",
    "highlighted_grid",
    "substructure_heatmap",
]

_ELEMENT_COLORS = {"C": "#444444", "N": "#3050F8", "O": "#FF0D0D",
                   "S": "#FFC832", "F": "#90E050", "Cl": "#1FF01F",
                   "Br": "#A62929", "I": "#940094", "P": "#FF8000"}


def spring_layout(mol: Mol, iterations: int = 120,
                  seed: int = 42) -> np.ndarray:
    """Force-directed 2D coordinates [N, 2] for a molecule's bond graph."""
    n = mol.GetNumAtoms()
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=1.0, size=(n, 2))
    if n == 1:
        return pos
    adj = np.zeros((n, n), bool)
    for b in mol.GetBonds():
        adj[b.a1, b.a2] = adj[b.a2, b.a1] = True
    k = 1.0 / np.sqrt(n)
    t = 0.15
    for it in range(iterations):
        delta = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(delta, axis=-1) + 1e-9
        rep = (k * k / dist ** 2)[..., None] * delta
        # Fruchterman-Reingold attraction: |f| = d^2/k along -delta/d
        att = np.where(adj[..., None], -(dist / k)[..., None] * delta, 0.0)
        disp = rep.sum(1) + att.sum(1)
        length = np.linalg.norm(disp, axis=-1, keepdims=True) + 1e-9
        pos = pos + disp / length * np.minimum(length, t)
        t *= 0.97
    pos -= pos.mean(0)
    scale = np.abs(pos).max() or 1.0
    return pos / scale


def draw_molecule(ax, mol: Mol, pos: Optional[np.ndarray] = None,
                  node_color=None, node_size: float = 220.0,
                  highlight: Optional[Sequence[int]] = None) -> None:
    """Draw a molecule as a 2D graph on a matplotlib axis."""
    if pos is None:
        pos = spring_layout(mol)
    for b in mol.GetBonds():
        x = [pos[b.a1, 0], pos[b.a2, 0]]
        y = [pos[b.a1, 1], pos[b.a2, 1]]
        lw = 2.6 if b.order >= 2 else 1.4
        style = "-"
        color = "#909090" if not b.aromatic else "#707070"
        ax.plot(x, y, style, lw=lw, color=color, zorder=1)
    colors = node_color
    if colors is None:
        colors = [_ELEMENT_COLORS.get(a.GetSymbol(), "#777777")
                  for a in mol.GetAtoms()]
    ax.scatter(pos[:, 0], pos[:, 1], s=node_size, c=colors, zorder=2,
               edgecolors="white", linewidths=0.8)
    if highlight:
        hp = pos[list(highlight)]
        ax.scatter(hp[:, 0], hp[:, 1], s=node_size * 2.2, facecolors="none",
                   edgecolors="#E91E63", linewidths=2.0, zorder=3)
    for a in mol.GetAtoms():
        if a.GetSymbol() != "C":
            ax.annotate(a.GetSymbol(), pos[a.idx], ha="center", va="center",
                        fontsize=7, color="white", zorder=4)
    ax.set_axis_off()
    ax.set_aspect("equal")


def molecule_importance_figure(smiles: str, importance: np.ndarray,
                               out_path: str, prediction: float = None,
                               true_value: float = None) -> str:
    """Two-panel per-molecule figure (reference ``gnnexplainer.py:723-930``):
    structure colored by element + importance-colored node map."""
    mol = parse_smiles(smiles)
    imp = np.asarray(importance, float)[:mol.GetNumAtoms()]
    pos = spring_layout(mol)
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    draw_molecule(axes[0], mol, pos)
    axes[0].set_title("Molecular structure")
    cmap = plt.get_cmap("YlOrRd")
    draw_molecule(axes[1], mol, pos, node_color=cmap(imp),
                  highlight=np.nonzero(imp >= 0.5)[0].tolist())
    sm = plt.cm.ScalarMappable(cmap=cmap,
                               norm=plt.Normalize(vmin=0, vmax=1))
    fig.colorbar(sm, ax=axes[1], fraction=0.046, label="atom importance")
    title = "Node importance"
    if prediction is not None:
        title += f"  (pred {prediction:.2f}"
        if true_value is not None:
            title += f", true {true_value:.2f}"
        title += ")"
    axes[1].set_title(title)
    fig.suptitle(smiles[:80], fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def atom_importance_figures(element_importances: Dict[str, List[float]],
                            out_path: str) -> str:
    """4-plot atom-importance set (reference ``gnnexplainer.py:1180-1322``):
    mean importance per element (bar), cumulative distribution, share of
    important atoms per element (pie), per-element distribution (box)."""
    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    elems = sorted(element_importances,
                   key=lambda e: -np.mean(element_importances[e]))
    means = [float(np.mean(element_importances[e])) for e in elems]
    counts = [len(element_importances[e]) for e in elems]

    axes[0, 0].bar(elems, means,
                   color=[_ELEMENT_COLORS.get(e, "#777") for e in elems])
    axes[0, 0].set_title("Mean atom importance by element")
    axes[0, 0].set_ylabel("mean importance")

    all_imp = np.sort(np.concatenate(
        [np.asarray(v) for v in element_importances.values()]))
    axes[0, 1].plot(all_imp, np.linspace(0, 1, len(all_imp)))
    axes[0, 1].set_title("Cumulative importance distribution")
    axes[0, 1].set_xlabel("importance")

    axes[1, 0].pie(counts, labels=elems, autopct="%1.0f%%",
                   colors=[_ELEMENT_COLORS.get(e, "#777") for e in elems])
    axes[1, 0].set_title("Atom count share by element")

    axes[1, 1].boxplot([element_importances[e] for e in elems],
                       tick_labels=elems, showfliers=False)
    axes[1, 1].set_title("Importance distribution by element")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def substructure_figures(freq: Dict[str, int],
                         mean_importance: Dict[str, float],
                         functional_groups: Dict[str, int],
                         out_path: str, top: int = 15) -> str:
    """4-plot substructure set (reference ``gnnexplainer.py:240-404``)."""
    fig, axes = plt.subplots(2, 2, figsize=(13, 10))
    names = list(freq)[:top]
    axes[0, 0].barh(names[::-1], [freq[n] for n in names][::-1],
                    color="#3F72AF")
    axes[0, 0].set_title("Important substructure frequency")

    by_imp = sorted(mean_importance, key=lambda n: -mean_importance[n])[:top]
    axes[0, 1].barh(by_imp[::-1], [mean_importance[n] for n in by_imp][::-1],
                    color="#B83B5E")
    axes[0, 1].set_title("Mean importance by substructure")

    if functional_groups:
        fg = sorted(functional_groups.items(), key=lambda kv: -kv[1])[:8]
        axes[1, 0].pie([v for _, v in fg], labels=[k for k, _ in fg],
                       autopct="%1.0f%%")
    axes[1, 0].set_title("Functional group occurrence")

    common = [n for n in names if n in mean_importance]
    axes[1, 1].scatter([freq[n] for n in common],
                       [mean_importance[n] for n in common])
    for n in common:
        axes[1, 1].annotate(n, (freq[n], mean_importance[n]), fontsize=7)
    axes[1, 1].set_xlabel("frequency")
    axes[1, 1].set_ylabel("mean importance")
    axes[1, 1].set_title("Frequency vs importance")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def highlighted_grid(entries: List[Dict], out_path: str,
                     max_molecules: int = 12) -> str:
    """Grid of molecules with important atoms highlighted (reference
    ``gnnexplainer.py:406-523``: molecules with y > 6 and importance >
    0.5).  Each entry: {smiles, importance, prediction, true_value}."""
    entries = entries[:max_molecules]
    if not entries:
        entries = []
    cols = 4
    rows = max((len(entries) + cols - 1) // cols, 1)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3.6 * rows))
    axes = np.atleast_2d(axes)
    cmap = plt.get_cmap("YlOrRd")
    for k in range(rows * cols):
        ax = axes[k // cols, k % cols]
        if k >= len(entries):
            ax.set_axis_off()
            continue
        e = entries[k]
        mol = parse_smiles(e["smiles"])
        imp = np.asarray(e["importance"], float)[:mol.GetNumAtoms()]
        draw_molecule(ax, mol, node_color=cmap(imp), node_size=90,
                      highlight=np.nonzero(imp > 0.5)[0].tolist())
        ax.set_title(f"pred {e.get('prediction', float('nan')):.2f} / "
                     f"true {e.get('true_value', float('nan')):.2f}",
                     fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def substructure_heatmap(per_molecule: List[Dict], out_path: str,
                         max_molecules: int = 40) -> str:
    """Molecule x substructure presence heatmap, top-40 molecules by
    number of important substructures (reference
    ``gnnexplainer.py:525-604``)."""
    ranked = sorted(per_molecule,
                    key=lambda r: -len(r["important_substructures"]))
    ranked = ranked[:max_molecules]
    names = sorted({n for r in ranked for n in r["important_substructures"]})
    if not ranked or not names:
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.text(0.5, 0.5, "no substructure hits", ha="center")
        ax.set_axis_off()
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
    mat = np.zeros((len(ranked), len(names)))
    for i, r in enumerate(ranked):
        for j, n in enumerate(names):
            d = r["important_substructures"].get(n)
            mat[i, j] = d["mean_importance"] if d else 0.0
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.55),
                                    max(6, len(ranked) * 0.25)))
    im = ax.imshow(mat, aspect="auto", cmap="YlGnBu")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=60, ha="right", fontsize=7)
    ax.set_yticks(range(len(ranked)))
    ax.set_yticklabels([r["smiles"][:28] for r in ranked], fontsize=6)
    fig.colorbar(im, label="mean importance")
    ax.set_title("Molecule x substructure importance")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
