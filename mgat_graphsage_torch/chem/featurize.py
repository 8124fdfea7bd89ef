"""Atom featurizers and graph builders (copy of
``mgat_graphsage_tpu/chem/featurize.py``).

- the 35-dim one-hot atom featurizer + graph builder of reference
  ``train.py:19-55``;
- the 5-dim "raw" featurizer of the GCN baseline (``gnn/gcn.py:14-40``).

``smiles_to_graph`` gives the unpadded ``(features [N, F], edge_index
[2, 2E])`` pair, which ``data/dataset.py`` pads to the dataset's
``(max_nodes, max_edges)`` budget; ``smiles_to_padded_graph`` pads one
molecule to a given budget.

``bond_types`` and ``graph_structure`` give what the graph transformer
reads beside the features (``models/zoo.py::GraphormerNet``): a bond type
per directed edge, and per molecule the atoms' degrees, the all-pairs
shortest-path distances in bonds and the first ``hops`` bond types along
one fixed shortest path, by the breadth-first rule that
``csrc/featurizer.cpp`` follows too, bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .smiles import Mol, parse_smiles

__all__ = [
    "ATOM_SYMBOLS",
    "DEGREES",
    "IMPLICIT_VALENCES",
    "HYBRIDIZATIONS",
    "TOTAL_HS",
    "NUM_ATOM_FEATURES",
    "NUM_RAW_FEATURES",
    "one_of_k_encoding_unk",
    "atom_features_35",
    "atom_features_5",
    "mol_to_graph",
    "smiles_to_graph",
    "smiles_to_padded_graph",
    "BOND_TYPES",
    "MAX_HOPS",
    "UNREACHABLE",
    "bond_types",
    "graph_structure",
    "smiles_to_structure",
]

# bond type codes per directed edge; 0 is padding and "no bond"
BOND_TYPES = {"single": 1, "double": 2, "triple": 3, "aromatic": 4}
# bonds of a shortest path whose types are kept (the public Graphormer's
# multi_hop_max_dist)
MAX_HOPS = 5
# the distance of a pair in different components, and of a padded pair
UNREACHABLE = -1

# Vocabularies — byte-for-byte the lists from reference train.py:34-42.
ATOM_SYMBOLS = ["C", "N", "O", "S", "F", "P", "Cl", "Br", "I", "Unknown"]
DEGREES = [0, 1, 2, 3, 4, 5, 6]
IMPLICIT_VALENCES = [0, 1, 2, 3, 4, 5, 6]
HYBRIDIZATIONS = ["SP", "SP2", "SP3", "SP3D", "SP3D2"]
TOTAL_HS = [0, 1, 2, 3, 4]

NUM_ATOM_FEATURES = (
    len(ATOM_SYMBOLS) + len(DEGREES) + len(IMPLICIT_VALENCES)
    + len(HYBRIDIZATIONS) + 1 + len(TOTAL_HS)
)  # = 35
NUM_RAW_FEATURES = 5


def one_of_k_encoding_unk(x, valid_entries: Sequence) -> List[int]:
    """One-hot with out-of-vocabulary mapped to ``'Unknown'``.

    When ``'Unknown'`` is not in ``valid_entries`` (degree / valence /
    hybridization / H-count), an out-of-vocabulary value yields an
    all-zero vector, as in reference ``train.py:19-22``.
    """
    if x not in valid_entries:
        x = "Unknown"
    return [1 if entry == x else 0 for entry in valid_entries]


def atom_features_35(mol: Mol) -> np.ndarray:
    """[N, 35] float32 feature matrix (reference ``train.py:33-44``)."""
    feats = np.zeros((mol.GetNumAtoms(), NUM_ATOM_FEATURES), dtype=np.float32)
    for i, atom in enumerate(mol.GetAtoms()):
        row = (
            one_of_k_encoding_unk(atom.GetSymbol(), ATOM_SYMBOLS)
            + one_of_k_encoding_unk(atom.GetDegree(), DEGREES)
            + one_of_k_encoding_unk(atom.GetImplicitValence(), IMPLICIT_VALENCES)
            + one_of_k_encoding_unk(atom.GetHybridization(), HYBRIDIZATIONS)
            + [1 if atom.GetIsAromatic() else 0]
            + one_of_k_encoding_unk(atom.GetTotalNumHs(), TOTAL_HS)
        )
        feats[i] = row
    return feats


def atom_features_5(mol: Mol) -> np.ndarray:
    """[N, 5] raw features (``gnn/gcn.py:21-29``): atomic number, degree,
    implicit valence, formal charge, aromatic flag."""
    feats = np.zeros((mol.GetNumAtoms(), NUM_RAW_FEATURES), dtype=np.float32)
    for i, atom in enumerate(mol.GetAtoms()):
        feats[i] = (
            atom.GetAtomicNum(),
            atom.GetDegree(),
            atom.GetImplicitValence(),
            atom.GetFormalCharge(),
            1.0 if atom.GetIsAromatic() else 0.0,
        )
    return feats


def mol_to_graph(mol: Mol, featurizer: str = "35") -> Tuple[np.ndarray, np.ndarray]:
    """(atom_features [N, F], edge_index [2, 2E]) — COO with both directions.

    Edges are sorted by (src, dst), the row-major order of the reference's
    ``adj.nonzero().t()`` (reference ``train.py:46-55``).
    """
    feats = atom_features_35(mol) if featurizer == "35" else atom_features_5(mol)
    n = mol.GetNumAtoms()
    pairs = set()
    for b in mol.GetBonds():
        pairs.add((b.a1, b.a2))
        pairs.add((b.a2, b.a1))
    if pairs:
        edge_index = np.array(sorted(pairs), dtype=np.int32).T
    else:
        edge_index = np.zeros((2, 0), dtype=np.int32)
    assert edge_index.shape[1] <= n * n
    return feats, edge_index


def smiles_to_graph(smiles: str, featurizer: str = "35") -> Tuple[np.ndarray, np.ndarray]:
    """Parse + featurize; raises ``ValueError`` on bad SMILES
    (reference ``train.py:25-28`` skip semantics)."""
    mol = parse_smiles(smiles)  # raises SmilesParseError (a ValueError)
    return mol_to_graph(mol, featurizer=featurizer)


def smiles_to_padded_graph(
    smiles: str,
    max_nodes: int,
    max_edges: int,
    featurizer: str = "35",
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Fixed-shape graph: (nodes [N_max,F], edges [2,E_max], node_mask,
    edge_mask).

    Padded edge slots point at node ``0`` but are masked; padded node rows are
    zero.  Returns ``None`` if the molecule exceeds the budget (caller decides
    whether to re-bucket or skip).
    """
    feats, edge_index = smiles_to_graph(smiles, featurizer=featurizer)
    n, e = feats.shape[0], edge_index.shape[1]
    if n > max_nodes or e > max_edges:
        return None
    fdim = feats.shape[1]
    nodes = np.zeros((max_nodes, fdim), dtype=np.float32)
    nodes[:n] = feats
    edges = np.zeros((2, max_edges), dtype=np.int32)
    edges[:, :e] = edge_index
    node_mask = np.zeros((max_nodes,), dtype=np.float32)
    node_mask[:n] = 1.0
    edge_mask = np.zeros((max_edges,), dtype=np.float32)
    edge_mask[:e] = 1.0
    return nodes, edges, node_mask, edge_mask


def bond_types(mol: Mol, edge_index: np.ndarray) -> np.ndarray:
    """``[E]`` int8: the type code (:data:`BOND_TYPES`) of each directed
    edge of ``edge_index``: aromatic, else the bond order.  Of two bonds
    between one pair of atoms the first in the molecule's bond order
    counts."""
    code: dict = {}
    for b in mol.GetBonds():
        t = 4 if (b.aromatic or b.order == 1.5) else int(b.order)
        code.setdefault((b.a1, b.a2), t)
        code.setdefault((b.a2, b.a1), t)
    return np.array([code[(int(s), int(d))] for s, d in edge_index.T],
                    dtype=np.int8)


def graph_structure(n: int, edge_index: np.ndarray, edge_types: np.ndarray,
                    hops: int = MAX_HOPS
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(degree [n] int8, spd [n, n] int8, path_types [n, n, hops] int8)``
    of one molecule's graph.

    A breadth-first search from each atom visits a node's neighbours in
    ``edge_index`` order, and a node's predecessor is the node that
    discovered it first; that fixes one shortest path per pair.
    ``spd[i, j]`` is its length in bonds (:data:`UNREACHABLE` for atoms in
    different components, as in a salt), and ``path_types[i, j, :L]`` the
    types of its first ``L = min(spd, hops)`` bonds from ``i``, zero
    after."""
    src, dst = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    nbrs: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for k in range(src.shape[0]):
        nbrs[src[k]].append((int(dst[k]), int(edge_types[k])))
    degree = np.array([len(a) for a in nbrs], dtype=np.int8)
    spd = np.full((n, n), UNREACHABLE, dtype=np.int8)
    path = np.zeros((n, n, hops), dtype=np.int8)
    for s in range(n):
        dist, row = spd[s], path[s]
        dist[s] = 0
        queue = [s]
        head = 0
        while head < len(queue):
            u = queue[head]
            head += 1
            du = int(dist[u])
            for v, t in nbrs[u]:
                if dist[v] == UNREACHABLE:
                    dist[v] = du + 1
                    row[v] = row[u]
                    if du < hops:
                        row[v, du] = t
                    queue.append(v)
    return degree, spd, path


def smiles_to_structure(smiles: str, featurizer: str = "35",
                        hops: int = MAX_HOPS):
    """``(features, edge_index, degree, spd, path_types)`` of one SMILES
    (:func:`smiles_to_graph` and :func:`graph_structure`); raises
    ``ValueError`` on a bad SMILES."""
    mol = parse_smiles(smiles)
    feats, edge_index = mol_to_graph(mol, featurizer=featurizer)
    types = bond_types(mol, edge_index)
    return (feats, edge_index) + graph_structure(
        feats.shape[0], edge_index, types, hops)
