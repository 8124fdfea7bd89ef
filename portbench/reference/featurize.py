"""Frozen copy of the program's Python featuriser at commit 157b929: the
35-dim atom features and graph builder of
``mgat_graphsage_torch/chem/featurize.py`` and the ECFP (Morgan, CRC32
bit layout) of ``mgat_graphsage_torch/chem/fingerprints.py``, with the
padding of ``mgat_graphsage_torch/data/dataset.py``.  The benchmark's
reference featurises every SMILES it checks with this copy, so it takes
nothing from the program's native featuriser.

:func:`featurize` gives, per SMILES, the padded arrays the model reads or
``None`` where the SMILES does not parse or its graph exceeds the budget:
the rows for which the program must answer NaN.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .smiles import Mol, parse_smiles

ATOM_SYMBOLS = ["C", "N", "O", "S", "F", "P", "Cl", "Br", "I", "Unknown"]
DEGREES = [0, 1, 2, 3, 4, 5, 6]
IMPLICIT_VALENCES = [0, 1, 2, 3, 4, 5, 6]
HYBRIDIZATIONS = ["SP", "SP2", "SP3", "SP3D", "SP3D2"]
TOTAL_HS = [0, 1, 2, 3, 4]
NUM_ATOM_FEATURES = 35

_TAG_ECFP0 = 1
_TAG_ITER = 3


def one_of_k_encoding_unk(x, valid_entries: Sequence) -> List[int]:
    if x not in valid_entries:
        x = "Unknown"
    return [1 if entry == x else 0 for entry in valid_entries]


def atom_features_35(mol: Mol) -> np.ndarray:
    feats = np.zeros((mol.GetNumAtoms(), NUM_ATOM_FEATURES), dtype=np.float32)
    for i, atom in enumerate(mol.GetAtoms()):
        feats[i] = (
            one_of_k_encoding_unk(atom.GetSymbol(), ATOM_SYMBOLS)
            + one_of_k_encoding_unk(atom.GetDegree(), DEGREES)
            + one_of_k_encoding_unk(atom.GetImplicitValence(),
                                    IMPLICIT_VALENCES)
            + one_of_k_encoding_unk(atom.GetHybridization(), HYBRIDIZATIONS)
            + [1 if atom.GetIsAromatic() else 0]
            + one_of_k_encoding_unk(atom.GetTotalNumHs(), TOTAL_HS))
    return feats


def mol_to_graph(mol: Mol) -> Tuple[np.ndarray, np.ndarray]:
    """(atom features [N, 35], edge_index [2, 2E]), both directions, sorted
    by (src, dst)."""
    pairs = set()
    for b in mol.GetBonds():
        pairs.add((b.a1, b.a2))
        pairs.add((b.a2, b.a1))
    edge_index = (np.array(sorted(pairs), dtype=np.int32).T if pairs
                  else np.zeros((2, 0), dtype=np.int32))
    return atom_features_35(mol), edge_index


def _crc_ints(tag: int, ints: Sequence[int]) -> int:
    vals = [tag] + [v & 0xFFFFFFFF for v in ints]
    return zlib.crc32(struct.pack("<%dI" % len(vals), *vals)) & 0xFFFFFFFF


def _ecfp_invariant(atom) -> int:
    return _crc_ints(_TAG_ECFP0, [
        atom.GetAtomicNum(), atom.GetDegree(), atom.GetTotalNumHs(),
        atom.GetFormalCharge(), int(atom.IsInRing()),
        int(atom.GetIsAromatic()), atom.isotope])


def ecfp(mol: Mol, radius: int = 2, n_bits: int = 1024) -> np.ndarray:
    """Morgan / ECFP bits folded to ``n_bits`` (CRC32 layout), with
    duplicate-environment removal per round."""
    ids = [_ecfp_invariant(a) for a in mol.GetAtoms()]
    fp = np.zeros((n_bits,), dtype=np.float32)
    env_bonds = [frozenset() for _ in mol.GetAtoms()]
    seen_envs = set()
    for atom_id in ids:
        fp[atom_id % n_bits] = 1.0
    for r in range(1, radius + 1):
        new_ids, new_envs, round_items = list(ids), list(env_bonds), []
        for a in mol.GetAtoms():
            nb = []
            bonds_here = set(env_bonds[a.idx])
            for bidx in a._bond_idxs:
                b = mol.GetBonds()[bidx]
                j = b.other(a.idx)
                nb.append((int(b.GetBondTypeAsDouble() * 2), ids[j]))
                bonds_here.add(bidx)
                bonds_here |= env_bonds[j]
            nb.sort()
            stream = [r, ids[a.idx]]
            for code, nid in nb:
                stream.extend((code, nid))
            new_id = _crc_ints(_TAG_ITER, stream)
            new_ids[a.idx] = new_id
            new_envs[a.idx] = frozenset(bonds_here)
            round_items.append((a.idx, new_id, frozenset(bonds_here)))
        for _, new_id, env in sorted(round_items, key=lambda t: t[1]):
            if env and env in seen_envs:
                continue
            if env:
                seen_envs.add(env)
            fp[new_id % n_bits] = 1.0
        ids, env_bonds = new_ids, new_envs
    return fp


def featurize_one(smiles: str, max_nodes: int, max_edges: int,
                  fp_bits: int = 1024) -> Optional[tuple]:
    """``(nodes [N, 35], edges [2, E], node_mask [N], edge_mask [E],
    fp [fp_bits])`` padded to the budget, or None (no parse, or past the
    budget)."""
    try:
        mol = parse_smiles(smiles)
    except ValueError:
        return None
    feats, edge_index = mol_to_graph(mol)
    n, e = feats.shape[0], edge_index.shape[1]
    if n > max_nodes or e > max_edges:
        return None
    nodes = np.zeros((max_nodes, NUM_ATOM_FEATURES), np.float32)
    nodes[:n] = feats
    edges = np.zeros((2, max_edges), np.int32)
    edges[:, :e] = edge_index
    node_mask = np.zeros(max_nodes, np.float32)
    node_mask[:n] = 1.0
    edge_mask = np.zeros(max_edges, np.float32)
    edge_mask[:e] = 1.0
    return nodes, edges, node_mask, edge_mask, ecfp(mol, 2, fp_bits)


def featurize(smiles: Sequence[str], max_nodes: int, max_edges: int,
              fp_bits: int = 1024):
    """Stacked arrays of the SMILES that featurise, and ``kept`` (bool per
    input): ``(kept, nodes, edges, node_mask, edge_mask, fp)``."""
    rows = [featurize_one(s, max_nodes, max_edges, fp_bits) for s in smiles]
    kept = np.array([r is not None for r in rows], dtype=bool)
    good = [r for r in rows if r is not None]
    if not good:
        z = np.zeros
        return (kept, z((0, max_nodes, 35), np.float32),
                z((0, 2, max_edges), np.int32), z((0, max_nodes), np.float32),
                z((0, max_edges), np.float32), z((0, fp_bits), np.float32))
    return (kept,) + tuple(np.stack(col) for col in zip(*good))
