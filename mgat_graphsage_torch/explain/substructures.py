"""Chemical substructure identification + importance attribution.

Reference ``gnnexplainer.py:115-232`` (``SubstructureIdentifier``) and
``:965-1178`` (``find_important_substructures`` /
``analyze_full_dataset_substructures``): a vocabulary of ~30 named
substructure patterns, per-molecule matching, radius-2 atom-environment
fragments around important atoms, functional-group counts, and the
"important substructures" analysis (threshold importance -> important atom
set -> intersect with pattern matches -> per-substructure mean importance
+ important edges).

Pattern matching uses the bundled mini-SMARTS engine instead of RDKit.
The vocabulary reproduces the reference's quirks deliberately: 'hydroxyl'
is bare ``O`` (matches any aliphatic oxygen, ethers included), 'amino' is
bare ``N``, 'methylene' is ``CC`` (every aliphatic C-C pair), etc.

A copy of ``mgat_graphsage_tpu/explain/substructures.py``
(the port imports nothing of that package); keep the two in step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem.smiles import Mol, parse_smiles
from ..chem.write import atom_environment, fragment_to_smiles
from .smarts import SmartsPattern, find_matches, parse_smarts

__all__ = [
    "COMMON_SUBSTRUCTURES",
    "FUNCTIONAL_GROUPS",
    "SubstructureIdentifier",
    "find_important_substructures",
    "analyze_full_dataset_substructures",
]

# The reference's pattern vocabulary (gnnexplainer.py:117-149), verbatim
# names and patterns — including its loose definitions.
COMMON_SUBSTRUCTURES: Dict[str, str] = {
    "hydroxyl": "O",
    "amino": "N",
    "carboxyl": "C(=O)O",
    "carbonyl": "C=O",
    "ester": "C(=O)O[C,c]",
    "amide": "C(=O)N",
    "ether": "[C,c]O[C,c]",
    "nitro": "N(=O)=O",
    "sulfonyl": "S(=O)(=O)",
    "phosphate": "P(=O)",
    "benzene": "c1ccccc1",
    "pyridine": "c1ccncc1",
    "pyrimidine": "c1cncnc1",
    "imidazole": "c1c[nH]cn1",
    "thiophene": "c1ccsc1",
    "furan": "c1ccoc1",
    "indole": "c1ccc2[nH]ccc2c1",
    "quinoline": "c1ccc2ncccc2c1",
    "piperidine": "C1CCNCC1",
    "piperazine": "C1CNCCN1",
    "morpholine": "C1COCCN1",
    "pyrrolidine": "C1CCNC1",
    "tetrahydrofuran": "C1CCOC1",
    "methylene": "CC",
    "ethylene": "CCC",
    "propylene": "CCCC",
    "vinyl": "C=C",
    "acetylene": "C#C",
}

# RDKit Fragments.fr_* style functional-group counters
# (reference gnnexplainer.py:199-232) via the same pattern engine.
FUNCTIONAL_GROUPS: Dict[str, str] = {
    "fr_alcohol": "CO",
    "fr_carboxylic_acid": "C(=O)O",
    "fr_ester": "C(=O)O[C,c]",
    "fr_amide": "C(=O)N",
    "fr_primary_amine": "[NH2]",
    "fr_ether": "[C,c]O[C,c]",
    "fr_nitrile": "C#N",
    "fr_halogen_F": "F",
    "fr_halogen_Cl": "Cl",
    "fr_halogen_Br": "Br",
    "fr_sulfonamide": "S(=O)(=O)N",
    "fr_benzene": "c1ccccc1",
    "fr_pyridine": "c1ccncc1",
    "fr_ketone": "C(=O)[C,c]",
    "fr_thiophene": "c1ccsc1",
}


class SubstructureIdentifier:
    """Compiled pattern vocabulary + per-molecule analysis
    (reference ``gnnexplainer.py:115-232``)."""

    def __init__(self,
                 patterns: Optional[Dict[str, str]] = None):
        self.patterns: Dict[str, SmartsPattern] = {}
        for name, smarts in (patterns or COMMON_SUBSTRUCTURES).items():
            try:
                self.patterns[name] = parse_smarts(smarts)
            except ValueError:
                pass
        self._fg = {name: parse_smarts(s)
                    for name, s in FUNCTIONAL_GROUPS.items()}

    def identify_substructures(self, mol: Mol
                               ) -> Dict[str, List[Tuple[int, ...]]]:
        """{name: [atom-index tuples]} for every matching pattern."""
        out: Dict[str, List[Tuple[int, ...]]] = {}
        for name, pat in self.patterns.items():
            m = find_matches(mol, pat)
            if m:
                out[name] = m
        return out

    def atom_environments(self, mol: Mol, atom_ids: Sequence[int],
                          radius: int = 2) -> Dict[int, str]:
        """Radius-2 fragment SMILES around each given atom
        (reference ``gnnexplainer.py:171-197``)."""
        envs = {}
        for a in atom_ids:
            if 0 <= a < mol.GetNumAtoms():
                envs[a] = fragment_to_smiles(
                    mol, atom_environment(mol, a, radius))
        return envs

    def functional_group_counts(self, mol: Mol) -> Dict[str, int]:
        """RDKit ``Fragments.fr_*``-style counts
        (reference ``gnnexplainer.py:199-232``)."""
        return {name: len(find_matches(mol, pat))
                for name, pat in self._fg.items()
                if find_matches(mol, pat)}


def find_important_substructures(
    smiles: str,
    node_importance: np.ndarray,
    importance_threshold: float = 0.5,
    identifier: Optional[SubstructureIdentifier] = None,
) -> Dict:
    """Per-molecule importance/substructure intersection
    (reference ``gnnexplainer.py:965-1076``).

    Returns dict with: important_atoms, important_substructures (name ->
    {matches, mean_importance, coverage}), important_edges (bonds whose
    both endpoints are important), atom_environments for important atoms.
    """
    identifier = identifier or _default_identifier()
    mol = parse_smiles(smiles)
    imp = np.asarray(node_importance, dtype=float)[:mol.GetNumAtoms()]
    important_atoms = set(np.nonzero(imp >= importance_threshold)[0].tolist())

    sub_hits: Dict[str, Dict] = {}
    for name, matches in identifier.identify_substructures(mol).items():
        rel = []
        for m in matches:
            inter = important_atoms.intersection(m)
            if inter:
                rel.append(m)
        if rel:
            atoms_in = sorted({a for m in rel for a in m})
            sub_hits[name] = {
                "matches": rel,
                "count": len(rel),
                "mean_importance": float(imp[atoms_in].mean()),
                "coverage": len(important_atoms.intersection(atoms_in))
                / max(len(important_atoms), 1),
            }

    important_edges = []
    for b in mol.GetBonds():
        if b.a1 in important_atoms and b.a2 in important_atoms:
            important_edges.append((b.a1, b.a2))

    return {
        "smiles": smiles,
        "num_atoms": mol.GetNumAtoms(),
        "important_atoms": sorted(important_atoms),
        "important_substructures": sub_hits,
        "important_edges": important_edges,
        "atom_environments": identifier.atom_environments(
            mol, sorted(important_atoms)),
        "functional_groups": identifier.functional_group_counts(mol),
    }


def analyze_full_dataset_substructures(
    smiles_list: Sequence[str],
    importances: Sequence[np.ndarray],
    importance_threshold: float = 0.3,
    identifier: Optional[SubstructureIdentifier] = None,
    verbose: bool = False,
) -> Dict:
    """Aggregate the per-molecule analysis over a whole dataset
    (reference ``gnnexplainer.py:1078-1178``): frequency and mean
    importance per substructure name."""
    identifier = identifier or _default_identifier()
    freq: Dict[str, int] = {}
    imp_sum: Dict[str, float] = {}
    per_mol = []
    for i, (smi, imp) in enumerate(zip(smiles_list, importances)):
        try:
            res = find_important_substructures(
                smi, imp, importance_threshold, identifier)
        except ValueError:
            continue
        per_mol.append(res)
        for name, d in res["important_substructures"].items():
            freq[name] = freq.get(name, 0) + 1
            imp_sum[name] = imp_sum.get(name, 0.0) + d["mean_importance"]
        if verbose and (i + 1) % 100 == 0:
            print(f"  analyzed {i + 1}/{len(smiles_list)}")
    mean_imp = {k: imp_sum[k] / freq[k] for k in freq}
    return {
        "per_molecule": per_mol,
        "substructure_frequency": dict(
            sorted(freq.items(), key=lambda kv: -kv[1])),
        "substructure_mean_importance": mean_imp,
        "n_molecules": len(per_mol),
    }


_IDENT = None


def _default_identifier() -> SubstructureIdentifier:
    global _IDENT
    if _IDENT is None:
        _IDENT = SubstructureIdentifier()
    return _IDENT
