"""Deterministic synthetic molecular dataset generator.

The reference's ``data/`` directory (``README.md:11``: train/validation/test
CSVs with ``Smiles,pchembl`` columns, reference ``train.py:163-168``) is
absent from the snapshot, so this framework bundles frozen synthetic splits
with the same schema and scale: drug-like SMILES spanning the reference's
reported 11-94 atom coverage range (``README.md:127``) and a ~961-row test
set (``gnnexplainer.py:1439``).

Molecules are assembled from a library of chemically valid fragment
templates (scaffolds with substitution sites + terminal groups + linkers),
every generated SMILES is re-validated with the bundled parser, and the
pChEMBL target is a deterministic structure-dependent function (descriptor
blend + seeded noise) so models have real signal to learn.

A copy of ``mgat_graphsage_tpu/data/synth.py``
(the port imports nothing of that package); keep the two in step.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..chem import parse_smiles
from ..chem import descriptors as D

__all__ = ["generate_dataset", "generate_splits"]

# Scaffolds with one or two substitution sites ({0}, {1}); all validated in
# tests by round-tripping through the parser.
_SCAFFOLDS_1 = [
    "c1ccc({0})cc1",            # benzene
    "c1ccc2c(c1)cccc2{0}",      # naphthalene
    "c1ccnc({0})c1",            # pyridine
    "c1cnc({0})cn1",            # pyrazine
    "c1cc({0})[nH]c1",          # pyrrole
    "c1cc({0})oc1",             # furan
    "c1cc({0})sc1",             # thiophene
    "c1nc({0})[nH]n1",          # triazole
    "C1CCN({0})CC1",            # piperidine
    "C1CN({0})CCN1C",           # N-methylpiperazine
    "C1CCC({0})CC1",            # cyclohexane
    "c1ccc2[nH]c({0})nc2c1",    # benzimidazole
    "c1ccc2oc({0})nc2c1",       # benzoxazole
    # Quinazolinedione-like scaffold.  Written so the string's FIRST atom
    # is the ring N (an atom that can accept one extra single bond): when
    # a scaffold is nested after a linker (``linker.format(inner)``) or
    # wrapped in ``generate_dataset``, composition bonds the previous atom
    # to the fragment's first atom.  The round-2 form started with the
    # exocyclic carbonyl O (``O=C1...``), so every nested use produced a
    # trivalent neutral oxygen — the VERDICT r2 dataset-chemistry bug.
    # The substitution site moves to a benzo carbon, which is always safe.
    "N1C(=O)NC(=O)c2cc({0})ccc21",
]
_SCAFFOLDS_2 = [
    "c1cc({0})ccc1{1}",
    "c1cc({0})cc({1})c1",
    "c1nc({0})cc({1})n1",       # pyrimidine disub
    "c1cc({0})c({1})cc1F",
    "C1CC({0})CCC1{1}",
    "c1c({0})sc({1})c1",
]
_TERMINALS = [
    "C", "CC", "CCC", "C(C)C", "O", "OC", "N", "NC", "N(C)C", "F", "Cl",
    "Br", "C(=O)O", "C(=O)N", "C(=O)OC", "C#N", "S(=O)(=O)N", "S(=O)(=O)C",
    "C(F)(F)F", "OC(F)(F)F", "C=C", "C#C", "CO", "CN", "CCl", "C(=O)C",
    "NC(=O)C", "OCC", "CCO", "N1CCCC1", "N1CCOCC1",
]
_LINKERS = [
    "C{0}", "CC{0}", "CCC{0}", "O{0}", "OC{0}", "N{0}", "NC(=O){0}",
    "C(=O)N{0}", "C(=O){0}", "S{0}", "C=C{0}", "OCC{0}", "NC{0}", "CN{0}",
]


def _shift_ring_labels(smi: str, start: int = 3) -> str:
    """Renumber all ring-closure labels in ``smi`` to a contiguous range
    starting at ``start`` so a fragment can be nested inside a template that
    uses labels 1-2 without the inner labels closing the outer rings."""
    out: List[str] = []
    mapping = {}
    nxt = start
    i = 0
    while i < len(smi):
        c = smi[i]
        if c == "[":
            j = smi.find("]", i)
            out.append(smi[i:j + 1])
            i = j + 1
            continue
        if c == "%":
            lab = int(smi[i + 1:i + 3])
            i += 3
        elif c.isdigit():
            lab = int(c)
            i += 1
        else:
            out.append(c)
            i += 1
            continue
        if lab not in mapping:
            mapping[lab] = nxt
            nxt += 1
        nl = mapping[lab]
        out.append(str(nl) if nl < 10 else f"%{nl:02d}")
    return "".join(out)


def _random_group(rng: np.random.Generator, depth: int = 0) -> str:
    """Generate one substituent: a terminal, or a linker into a scaffold."""
    roll = rng.random()
    if depth >= 2 or roll < 0.55:
        return str(rng.choice(_TERMINALS))
    linker = str(rng.choice(_LINKERS))
    inner = _random_scaffold(rng, depth + 1)
    return linker.format(inner)


def _random_scaffold(rng: np.random.Generator, depth: int = 0) -> str:
    if rng.random() < 0.75 or depth > 0:
        tpl = str(rng.choice(_SCAFFOLDS_1))
        return tpl.format(_shift_ring_labels(_random_group(rng, depth)))
    tpl = str(rng.choice(_SCAFFOLDS_2))
    return tpl.format(_shift_ring_labels(_random_group(rng, depth)),
                      _shift_ring_labels(_random_group(rng, depth)))


def _gen_o_class_r3(mol, a) -> str:
    """FROZEN generation-time Crippen O-typing (the round-3 rules).

    The live descriptor layer's O-typing was corrected in round 4
    (PARITY.md "Crippen decomposition audit": ester -O- is a plain
    O3/O4 ether, carbonyl =O splits O9/O10/O11 by the carbonyl C's
    substituents).  The frozen seed-42 datasets were GENERATED with the
    round-3 rules, and dataset generation must stay bit-stable so
    `make_dataset.py` regenerates the committed splits identically
    (`tests/test_data.py::test_bundled_splits_frozen`) — so this module
    pins its own copy of the old O-branch instead of tracking the live
    (corrected) `descriptors.mol_logp`.  Generation only needs a
    deterministic structure→activity signal, not chemical accuracy.
    """
    atoms, bonds = mol.GetAtoms(), mol.GetBonds()
    nbrs = [atoms[bonds[bi].other(a.idx)] for bi in a._bond_idxs]
    nbr_bonds = [bonds[bi] for bi in a._bond_idxs]
    if a.GetIsAromatic():
        return "O1"
    if a.GetFormalCharge() < 0:
        carboxylate = any(
            n.GetSymbol() == "C" and any(
                bonds[bj].order == 2 and
                atoms[bonds[bj].other(n.idx)].GetSymbol() == "O"
                for bj in n._bond_idxs) for n in nbrs)
        return "O12" if carboxylate else "OS"
    if any(b.order == 2 for b in nbr_bonds):
        n = nbrs[0]
        if n.GetSymbol() in ("N", "O", "S", "P"):
            return "O5"
        if n.GetIsAromatic():
            return "O8"
        other_o = any(
            atoms[bonds[bj].other(n.idx)].GetSymbol() == "O"
            and bonds[bj].order == 1 for bj in n._bond_idxs)
        return "O9" if other_o else "O10"
    if a.GetTotalNumHs() >= 1:
        return "O2"
    ester = any(
        n.GetSymbol() == "C" and any(
            bonds[bj].order == 2 and
            atoms[bonds[bj].other(n.idx)].GetSymbol() in ("O", "N", "S")
            for bj in n._bond_idxs) for n in nbrs)
    if ester:
        return "O11"
    if any(n.GetIsAromatic() for n in nbrs):
        return "O4"
    return "O3"


# round-3 logP constants for the classes whose values moved in round 4
_R3_O_LOGP = {"O4": 0.4833, "O11": -0.1540}


def _gen_logp_r3(mol) -> float:
    """Frozen generation-time MolLogP (see ``_gen_o_class_r3``)."""
    lp = 0.0
    for a in mol.GetAtoms():
        if a.GetSymbol() == "O":
            cls = _gen_o_class_r3(mol, a)
            lp += _R3_O_LOGP.get(cls, D._CRIPPEN[cls][0])
        else:
            lp += D._CRIPPEN[D._crippen_class(mol, a)][0]
        lp += D._CRIPPEN[D._h_class(mol, a)][0] * a.GetTotalNumHs()
    return lp


def _target_from_structure(mol, rng: np.random.Generator) -> float:
    """Deterministic structure->activity mapping with seeded noise.

    A blend of descriptors shaped to produce a pChEMBL-like distribution in
    roughly [3.5, 10.5] with learnable structure dependence.  Uses the
    FROZEN generation-time logP (``_gen_logp_r3``), not the live
    descriptor, so the committed splits regenerate bit-identically.
    """
    y = (
        4.2
        + 0.42 * D.num_aromatic_rings(mol)
        + 0.28 * D.num_h_donors(mol)
        + 0.12 * D.num_h_acceptors(mol)
        + 0.35 * np.tanh(_gen_logp_r3(mol) / 3.0)
        - 0.0035 * abs(D.mol_weight(mol) - 380.0)
        + 0.08 * D.num_rotatable_bonds(mol)
        - 0.004 * D.tpsa(mol)
    )
    y += rng.normal(0.0, 0.35)
    return float(np.clip(y, 3.5, 10.5))


def generate_dataset(n: int, seed: int = 42,
                     min_atoms: int = 11, max_atoms: int = 94
                     ) -> Tuple[List[str], List[float]]:
    """Generate ``n`` unique valid SMILES + targets, deterministically."""
    rng = np.random.default_rng(seed)
    smiles_list: List[str] = []
    targets: List[float] = []
    seen = set()
    attempts = 0
    while len(smiles_list) < n and attempts < n * 200:
        attempts += 1
        smi = _random_scaffold(rng)
        # optionally wrap into a larger scaffold (grows molecule size)
        for _ in range(int(rng.integers(0, 3))):
            linker = str(rng.choice(_LINKERS)).format(_shift_ring_labels(smi))
            tpl = str(rng.choice(_SCAFFOLDS_1))
            smi = tpl.format(linker)
        try:
            mol = parse_smiles(smi)
        except ValueError:
            continue
        if not (min_atoms <= mol.GetNumAtoms() <= max_atoms):
            continue
        if smi in seen:
            continue
        seen.add(smi)
        smiles_list.append(smi)
        targets.append(_target_from_structure(mol, rng))
    if len(smiles_list) < n:
        raise RuntimeError(f"Only generated {len(smiles_list)}/{n} molecules")
    return smiles_list, targets


def generate_splits(n_train: int = 3000, n_val: int = 500, n_test: int = 961,
                    seed: int = 42):
    """Generate disjoint train/val/test splits as (smiles, target) lists."""
    total = n_train + n_val + n_test
    smiles, targets = generate_dataset(total, seed=seed)
    rng = np.random.default_rng(seed + 1)
    order = rng.permutation(total)
    sm = [smiles[i] for i in order]
    tg = [targets[i] for i in order]
    return (
        (sm[:n_train], tg[:n_train]),
        (sm[n_train:n_train + n_val], tg[n_train:n_train + n_val]),
        (sm[n_train + n_val:], tg[n_train + n_val:]),
    )
