"""CSV -> fixed-shape padded batches (port of
``mgat_graphsage_tpu/data/dataset.py``, numpy only).

Read a ``Smiles,pchembl`` CSV, standardize targets with a train-fit
scaler (reference ``train.py:173-181``), featurize each molecule with the
pure-Python chemistry layer, and pad every molecule to one
``(max_nodes, max_edges)`` budget: ``nodes [n, N, F]``,
``edges [n, 2, E]``, ``node_mask [n, N]``, ``edge_mask [n, E]``,
``fp [n, nbits]``.  Dense adjacency is built on the device from the edge
lists (``ops/graph.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chem import smiles_to_graph
from ..chem.fingerprints import FINGERPRINTS

__all__ = [
    "StandardScaler",
    "MolecularDataset",
    "load_csv",
    "pad_to_multiple",
]


class StandardScaler:
    """Mean/std target scaler (sklearn semantics: ddof=0), two floats."""

    def __init__(self, mean: float = 0.0, scale: float = 1.0):
        self.mean_ = float(mean)
        self.scale_ = float(scale)

    def fit(self, y: np.ndarray) -> "StandardScaler":
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        self.mean_ = float(y.mean())
        std = float(y.std())
        self.scale_ = std if std > 0 else 1.0
        return self

    def fit_transform(self, y: np.ndarray) -> np.ndarray:
        return self.fit(y).transform(y)

    def transform(self, y):
        return (np.asarray(y, dtype=np.float32) - self.mean_) / self.scale_

    def inverse_transform(self, y):
        return np.asarray(y, dtype=np.float32) * self.scale_ + self.mean_

    def to_dict(self) -> Dict[str, float]:
        return {"mean": self.mean_, "scale": self.scale_}

    @classmethod
    def from_dict(cls, d) -> "StandardScaler":
        return cls(d["mean"], d["scale"])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def load_csv(path: str, smiles_column: str = "Smiles",
             target_column: str = "pchembl") -> Tuple[List[str], np.ndarray]:
    """CSV reader for the reference ``Smiles,pchembl`` schema
    (``train.py:163-168``).  Stdlib ``csv``, so RFC-4180 quoting parses;
    extra columns are ignored and column order is free."""
    import csv

    smiles, targets = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            smiles.append(row[smiles_column])
            targets.append(float(row[target_column]))
    return smiles, np.asarray(targets, dtype=np.float32)


class MolecularDataset:
    """Featurized, padded dataset.

    Invalid SMILES are skipped with a log line (reference
    ``train.py:184-194``); with an explicit ``(max_nodes, max_edges)``
    budget, molecules over it are dropped too.  ``kept_indices`` maps
    every kept molecule back to its input row.
    """

    def __init__(
        self,
        smiles: List[str],
        targets: np.ndarray,
        scaler: Optional[StandardScaler] = None,
        fit_scaler: bool = False,
        fingerprint: Optional[str] = "ecfp1024",
        featurizer: str = "35",
        max_nodes: Optional[int] = None,
        max_edges: Optional[int] = None,
        node_multiple: int = 8,
        verbose: bool = True,
    ):
        targets = np.asarray(targets, dtype=np.float32).reshape(-1)
        graphs, fps, kept_targets, kept_smiles, kept_indices = \
            [], [], [], [], []
        fp_fn = FINGERPRINTS[fingerprint] if fingerprint else None
        for i, (smi, y) in enumerate(zip(smiles, targets)):
            try:
                feats, edge_index = smiles_to_graph(str(smi),
                                                    featurizer=featurizer)
                fp = fp_fn(str(smi))[0] if fp_fn else None
            except ValueError as e:
                if verbose:
                    print(e)
                continue
            graphs.append((feats, edge_index))
            fps.append(fp)
            kept_targets.append(y)
            kept_smiles.append(str(smi))
            kept_indices.append(i)

        if not graphs:
            raise ValueError("No valid molecules in dataset")

        # drop molecules over an explicit (max_nodes, max_edges) budget
        # BEFORE allocating arrays, so indices stay consistent
        if max_nodes is not None or max_edges is not None:
            budget_n = max_nodes or 10 ** 9
            budget_e = max_edges or 10 ** 9
            keep = [i for i, (g, e) in enumerate(graphs)
                    if g.shape[0] <= budget_n and e.shape[1] <= budget_e]
            if len(keep) < len(graphs):
                if verbose:
                    print(f"[data] dropped {len(graphs) - len(keep)} "
                          f"molecules over the ({budget_n},{budget_e}) "
                          f"budget")
                graphs = [graphs[i] for i in keep]
                fps = [fps[i] for i in keep]
                kept_targets = [kept_targets[i] for i in keep]
                kept_smiles = [kept_smiles[i] for i in keep]
                kept_indices = [kept_indices[i] for i in keep]
            if not graphs:
                raise ValueError("No molecules fit the shape budget")

        self.smiles = kept_smiles
        self.kept_indices = np.asarray(kept_indices, dtype=np.int64)
        self.y_orig = np.asarray(kept_targets, dtype=np.float32)
        if scaler is None:
            scaler = StandardScaler()
        if fit_scaler:
            scaler.fit(self.y_orig)
        self.scaler = scaler
        self.y = scaler.transform(self.y_orig).astype(np.float32)

        obs_nodes = max(g[0].shape[0] for g in graphs)
        obs_edges = max(g[1].shape[1] for g in graphs)
        self.max_nodes = max_nodes or pad_to_multiple(obs_nodes, node_multiple)
        self.max_edges = max_edges or pad_to_multiple(max(obs_edges, 1), 16)
        self.feature_dim = graphs[0][0].shape[1]
        self.fp_dim = len(fps[0]) if fps[0] is not None else 0
        self.fingerprint = fingerprint

        n = len(graphs)
        self.nodes = np.zeros((n, self.max_nodes, self.feature_dim), np.float32)
        self.edges = np.zeros((n, 2, self.max_edges), np.int32)
        self.node_mask = np.zeros((n, self.max_nodes), np.float32)
        self.edge_mask = np.zeros((n, self.max_edges), np.float32)
        self.fp = np.zeros((n, max(self.fp_dim, 1)), np.float32)
        for i, (feats, edge_index) in enumerate(graphs):
            nn, ne = feats.shape[0], edge_index.shape[1]
            self.nodes[i, :nn] = feats
            self.edges[i, :, :ne] = edge_index
            self.node_mask[i, :nn] = 1.0
            self.edge_mask[i, :ne] = 1.0
            if fps[i] is not None:
                self.fp[i] = fps[i]
        self.n = n

    def __len__(self) -> int:
        return self.n
