"""CSV -> fixed-shape padded batches (port of
``mgat_graphsage_tpu/data/dataset.py``, numpy only).

Read a ``Smiles,pchembl`` CSV, standardize targets with a train-fit
scaler (reference ``train.py:173-181``), featurize each molecule, and pad
every molecule to one ``(max_nodes, max_edges)`` budget:
``nodes [n, N, F]``, ``edges [n, 2, E]``, ``node_mask [n, N]``,
``edge_mask [n, E]``, ``fp [n, nbits]``.  Dense adjacency is built on the
device from the edge lists (``ops/graph.py``).

With ``structure=True`` (the graph transformer's presets,
``TrainConfig.needs_structure``) it also holds, at the same budget,
``degree [n, N]``, ``spd [n, N, N]`` and ``path_types [n, N, N, hops]``,
int8 (``chem/featurize.py::graph_structure``; -1 in ``spd`` for padding
and for atoms in different components).

Featurisation goes through the native C++ library by default
(``chem/native.py``; bit for bit the Python chemistry layer's output),
through the Python layer with ``use_native=False`` or for a configuration
the library does not cover.  As in the reference package, the native path
featurises within a ``(128, 288)`` budget and drops a molecule past it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..chem import smiles_to_graph
from ..chem.featurize import MAX_HOPS, smiles_to_structure
from ..chem.fingerprints import FINGERPRINTS
from ..utils import telemetry

__all__ = [
    "StandardScaler",
    "GraphBatch",
    "MolecularDataset",
    "load_csv",
    "pad_to_multiple",
    "write_csv",
]

# the native library's per-molecule budget (atoms, directed edges), as in
# the reference package; a molecule past it is dropped
NATIVE_BUDGET = (128, 288)
# fingerprint -> (bits, FCFP invariants) for the ones the library computes
_NATIVE_FPS = {None: (0, False), "ecfp1024": (1024, False),
               "ecfp2048": (2048, False), "morgan1024": (1024, False),
               "morgan2048": (2048, False), "fcfp1024": (1024, True)}


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


@dataclasses.dataclass
class GraphBatch:
    """One fixed-shape batch of numpy arrays on the host."""

    nodes: np.ndarray        # [B, N, F] float32
    edges: np.ndarray        # [B, 2, E] int32 (COO, both directions)
    node_mask: np.ndarray    # [B, N] float32
    edge_mask: np.ndarray    # [B, E] float32
    fp: np.ndarray           # [B, nbits] float32 (zeros if no fingerprint)
    y: np.ndarray            # [B] float32 (normalized target)
    y_orig: np.ndarray       # [B] float32 (original-scale target)
    sample_mask: np.ndarray  # [B] float32 (0 = padding row)
    # the graph transformer's structure (None unless the dataset has it)
    degree: Optional[np.ndarray] = None      # [B, N] int8
    spd: Optional[np.ndarray] = None         # [B, N, N] int8
    path_types: Optional[np.ndarray] = None  # [B, N, N, hops] int8

    def as_dict(self) -> Dict[str, np.ndarray]:
        """The arrays by name; the structure's only where the batch has
        it."""
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @property
    def batch_size(self) -> int:
        return self.nodes.shape[0]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def load_csv(path: str, smiles_column: str = "Smiles",
             target_column: str = "pchembl") -> Tuple[List[str], np.ndarray]:
    """CSV reader for the reference ``Smiles,pchembl`` schema
    (``train.py:163-168``).  Stdlib ``csv``, so RFC-4180 quoting parses;
    extra columns are ignored and column order is free.  A bundled split
    path that does not exist (an installed package's cache) is written
    first (``data.ensure_bundled_datasets``)."""
    import csv

    if not os.path.exists(path):
        from . import (FULL_CSV, TEST_CSV, TRAIN_CSV, VAL_CSV,
                       ensure_bundled_datasets)

        if path in (TRAIN_CSV, VAL_CSV, TEST_CSV, FULL_CSV):
            ensure_bundled_datasets()

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
    budget, molecules over it are dropped too, and so are molecules past
    :data:`NATIVE_BUDGET` on the native path.  ``kept_indices`` maps every
    kept molecule back to its input row.
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
        use_native: bool = True,
        structure: bool = False,
    ):
        targets = np.asarray(targets, dtype=np.float32).reshape(-1)
        native = use_native and fingerprint in _NATIVE_FPS \
            and featurizer in ("35", "5")
        featurize = self._featurize_native if native \
            else self._featurize_python
        graphs, fps, kept_targets, kept_smiles, kept_indices = featurize(
            smiles, targets, fingerprint, featurizer, verbose, structure)

        if not graphs:
            raise ValueError("No valid molecules in dataset")
        if structure:
            structs = [g[2:] for g in graphs]
            graphs = [g[:2] for g in graphs]

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
                if structure:
                    structs = [structs[i] for i in keep]
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
        self.degree = self.spd = self.path_types = None
        if structure:
            mn = self.max_nodes
            self.degree = np.zeros((n, mn), np.int8)
            self.spd = np.full((n, mn, mn), -1, np.int8)
            self.path_types = np.zeros((n, mn, mn, MAX_HOPS), np.int8)
            for i, (deg, spd, path) in enumerate(structs):
                k = deg.shape[0]
                self.degree[i, :k] = deg
                self.spd[i, :k, :k] = spd
                self.path_types[i, :k, :k] = path

    @staticmethod
    def _featurize_python(smiles, targets, fingerprint, featurizer,
                          verbose, structure=False):
        """(graphs, fps, targets, smiles, indices) of the molecules that
        parse, through the Python chemistry layer; with ``structure`` a
        graph is ``(features, edge_index, degree, spd, path_types)``."""
        graphs, fps, kept_targets, kept_smiles, kept_indices = \
            [], [], [], [], []
        fp_fn = FINGERPRINTS[fingerprint] if fingerprint else None
        for i, (smi, y) in enumerate(zip(smiles, targets)):
            try:
                graph = smiles_to_structure(str(smi), featurizer) \
                    if structure else smiles_to_graph(str(smi),
                                                      featurizer=featurizer)
                fp = fp_fn(str(smi))[0] if fp_fn else None
            except ValueError as e:
                if verbose:
                    print(e)
                continue
            graphs.append(graph)
            fps.append(fp)
            kept_targets.append(y)
            kept_smiles.append(str(smi))
            kept_indices.append(i)
        return graphs, fps, kept_targets, kept_smiles, kept_indices

    @staticmethod
    def _featurize_native(smiles, targets, fingerprint, featurizer,
                          verbose, structure=False):
        """The same lists as :meth:`_featurize_python`, through the C++
        library (bit for bit the same graphs, fingerprints and structure),
        for the molecules that parse and fit :data:`NATIVE_BUDGET`; the
        library's call is the ``featurize.native`` span
        (``utils/telemetry.py``)."""
        from ..chem.native import (featurize_batch_native,
                                   featurize_structure_native)

        fp_bits, use_features = _NATIVE_FPS[fingerprint]
        args = ([str(s) for s in smiles], 35 if featurizer == "35" else 5,
                *NATIVE_BUDGET)
        with telemetry.span("featurize.native"):
            if structure:
                (nodes, edges, _, edge_mask, fp, status, _, degree, spd,
                 path) = featurize_structure_native(
                    *args, fp_bits=fp_bits, use_features=use_features,
                    hops=MAX_HOPS)
            else:
                nodes, edges, _, edge_mask, fp, status = \
                    featurize_batch_native(*args, fp_bits=fp_bits,
                                           use_features=use_features)
        graphs, fps, kept_targets, kept_smiles, kept_indices = \
            [], [], [], [], []
        n_edges = edge_mask.sum(axis=1).astype(np.int64)
        for i, smi in enumerate(smiles):
            if status[i] <= 0:
                if verbose:
                    print(f"Invalid SMILES string: {smi!r}"
                          if status[i] == -1 else
                          f"[data] molecule exceeds native budget: {smi!r}")
                continue
            k = status[i]
            graphs.append((nodes[i, :k], edges[i, :, :n_edges[i]]) + (
                (degree[i, :k], spd[i, :k, :k], path[i, :k, :k])
                if structure else ()))
            fps.append(fp[i] if fp is not None else None)
            kept_targets.append(targets[i])
            kept_smiles.append(str(smi))
            kept_indices.append(i)
        return graphs, fps, kept_targets, kept_smiles, kept_indices

    def __len__(self) -> int:
        return self.n

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False,
                pad_final: bool = True) -> Iterator[GraphBatch]:
        """Yield fixed-shape batches; the final partial batch is padded to
        ``batch_size`` with ``sample_mask`` zeros (rows of molecule 0)."""
        idx = np.arange(self.n)
        if shuffle:
            idx = np.random.default_rng(seed).permutation(self.n)
        for start in range(0, self.n, batch_size):
            sel = idx[start:start + batch_size]
            mask = np.ones(len(sel), np.float32)
            if len(sel) < batch_size:
                if drop_last:
                    return
                if pad_final:
                    pad = batch_size - len(sel)
                    sel = np.concatenate([sel, np.zeros(pad, sel.dtype)])
                    mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield self._batch(sel, mask)

    def _batch(self, sel: np.ndarray, mask: np.ndarray,
               nodes: Optional[int] = None, edges: Optional[int] = None
               ) -> GraphBatch:
        """Rows ``sel``, trimmed to ``nodes`` and ``edges`` when given."""
        st = {}
        if self.spd is not None:
            st = dict(degree=self.degree[sel, :nodes],
                      spd=self.spd[sel, :nodes, :nodes],
                      path_types=self.path_types[sel, :nodes, :nodes])
        return GraphBatch(
            **st,
            nodes=self.nodes[sel, :nodes],
            edges=self.edges[sel, :, :edges],
            node_mask=self.node_mask[sel, :nodes],
            edge_mask=self.edge_mask[sel, :edges],
            fp=self.fp[sel],
            y=self.y[sel],
            y_orig=self.y_orig[sel],
            sample_mask=mask,
        )

    def num_batches(self, batch_size: int, drop_last: bool = False) -> int:
        if drop_last:
            return self.n // batch_size
        return (self.n + batch_size - 1) // batch_size

    # ---- multi-bucket batching ----
    def bucket_plan(self, buckets: Tuple[int, ...] = (32, 48, 64, 96)
                    ) -> List[Tuple[int, int, np.ndarray]]:
        """Route each molecule to the smallest node bucket it fits.

        Returns ``[(bucket_nodes, bucket_edges, indices), ...]`` for the
        non-empty buckets, in ascending bucket order.  ``bucket_nodes`` is
        capped at ``self.max_nodes``; molecules over the largest bucket
        land in a final ``self.max_nodes`` bucket.  Each bucket's edge
        budget is the member maximum padded to a multiple of 16.
        """
        n_atoms = self.node_mask.sum(axis=1).astype(np.int64)
        n_edges = self.edge_mask.sum(axis=1).astype(np.int64)
        bounds = sorted({min(b, self.max_nodes) for b in buckets if b > 0})
        if not bounds or bounds[-1] < self.max_nodes:
            bounds.append(self.max_nodes)
        plan: List[Tuple[int, int, np.ndarray]] = []
        assigned = np.zeros(self.n, dtype=bool)
        for bn in bounds:
            idx = np.nonzero(~assigned & (n_atoms <= bn))[0]
            if idx.size == 0:
                continue
            assigned[idx] = True
            be = pad_to_multiple(max(int(n_edges[idx].max()), 1), 16)
            plan.append((bn, min(be, self.max_edges), idx))
        return plan

    def bucket_view(self, bucket_nodes: int, bucket_edges: int,
                    idx: np.ndarray) -> "MolecularDataset":
        """A dataset restricted to ``idx`` and trimmed to a bucket's
        ``(bucket_nodes, bucket_edges)`` budget: array slicing of the
        featurised arrays, no featurisation.  Valid edge indices are
        below ``n_atoms <= bucket_nodes`` by :meth:`bucket_plan`'s
        construction; the trimmed tails are padding only."""
        idx = np.asarray(idx, dtype=np.int64)
        ds = object.__new__(MolecularDataset)
        ds.smiles = [self.smiles[i] for i in idx]
        ds.kept_indices = self.kept_indices[idx]
        ds.y_orig = self.y_orig[idx]
        ds.scaler = self.scaler
        ds.y = self.y[idx]
        ds.max_nodes = int(bucket_nodes)
        ds.max_edges = int(bucket_edges)
        ds.feature_dim = self.feature_dim
        ds.fp_dim = self.fp_dim
        ds.fingerprint = self.fingerprint
        # contiguous copies: a view would pin the full-width arrays
        ds.nodes = np.ascontiguousarray(self.nodes[idx][:, :bucket_nodes])
        ds.edges = np.ascontiguousarray(self.edges[idx][:, :, :bucket_edges])
        ds.node_mask = np.ascontiguousarray(
            self.node_mask[idx][:, :bucket_nodes])
        ds.edge_mask = np.ascontiguousarray(
            self.edge_mask[idx][:, :bucket_edges])
        ds.fp = self.fp[idx]
        ds.degree = ds.spd = ds.path_types = None
        if self.spd is not None:
            ds.degree = np.ascontiguousarray(
                self.degree[idx][:, :bucket_nodes])
            ds.spd = np.ascontiguousarray(
                self.spd[idx][:, :bucket_nodes, :bucket_nodes])
            ds.path_types = np.ascontiguousarray(
                self.path_types[idx][:, :bucket_nodes, :bucket_nodes])
        ds.n = int(idx.size)
        return ds

    def bucketed_batches(self, batch_size: int,
                         buckets: Tuple[int, ...] = (32, 48, 64, 96),
                         shuffle: bool = False, seed: int = 0,
                         pad_final: bool = True) -> Iterator[GraphBatch]:
        """Fixed-shape batches per node bucket, trimmed to the bucket's
        (nodes, edges) budget.  Shuffling permutes within each bucket; a
        final partial batch is padded with masked copies of its first
        row."""
        rng = np.random.default_rng(seed)
        for bn, be, idx in self.bucket_plan(buckets):
            if shuffle:
                idx = rng.permutation(idx)
            for start in range(0, idx.size, batch_size):
                sel = idx[start:start + batch_size]
                mask = np.ones(sel.size, np.float32)
                if sel.size < batch_size and pad_final:
                    pad = batch_size - sel.size
                    sel = np.concatenate([sel, np.full(pad, sel[0],
                                                       sel.dtype)])
                    mask = np.concatenate([mask, np.zeros(pad, np.float32)])
                yield self._batch(sel, mask, bn, be)


def write_csv(path: str, smiles: List[str], targets) -> None:
    """``Smiles,pchembl`` CSV, targets to 4 decimals."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Smiles,pchembl\n")
        for s, y in zip(smiles, targets):
            f.write(f"{s},{y:.4f}\n")
