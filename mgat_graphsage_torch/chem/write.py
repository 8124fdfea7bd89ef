"""SMILES writing (non-canonical) for molecules and fragments.

Replaces the RDKit calls the reference interpretability pipeline makes to
render atom environments (``gnnexplainer.py:171-197``:
``FindAtomEnvironmentOfRadiusN`` + ``MolFragmentToSmiles``).  Output is a
valid (parser-round-trippable) SMILES of the induced subgraph, written by
DFS with ring-closure digits; aromatic atoms are lowercased; bracket atoms
carry charge/H as needed.

A copy of ``mgat_graphsage_tpu/chem/write.py``
(the port imports nothing of that package); keep the two in step.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set

from .smiles import Mol

__all__ = ["mol_to_smiles", "fragment_to_smiles", "atom_environment"]

_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}


def atom_environment(mol: Mol, center: int, radius: int = 2) -> Set[int]:
    """Atom indices within ``radius`` bonds of ``center``."""
    seen = {center}
    frontier = [center]
    for _ in range(radius):
        nxt = []
        for v in frontier:
            for nb in mol.GetAtoms()[v]._neighbors:
                if nb not in seen:
                    seen.add(nb)
                    nxt.append(nb)
        frontier = nxt
    return seen


def _atom_token(mol: Mol, idx: int) -> str:
    a = mol.GetAtoms()[idx]
    sym = a.GetSymbol()
    body = sym.lower() if a.GetIsAromatic() else sym
    needs_bracket = (
        sym not in _ORGANIC
        or a.GetFormalCharge() != 0
        or a.isotope != 0
        or (a.GetIsAromatic() and sym == "N" and a.GetTotalNumHs() > 0)
    )
    if not needs_bracket:
        return body
    h = a.GetTotalNumHs()
    htxt = "" if h == 0 else ("H" if h == 1 else f"H{h}")
    chg = a.GetFormalCharge()
    if chg == 0:
        ctxt = ""
    else:
        sign = "+" if chg > 0 else "-"
        ctxt = sign if abs(chg) == 1 else f"{sign}{abs(chg)}"
    iso = str(a.isotope) if a.isotope else ""
    return f"[{iso}{body}{htxt}{ctxt}]"


def _bond_token(mol: Mol, i: int, j: int) -> str:
    b = mol.GetBondBetweenAtoms(i, j)
    if b is None or b.aromatic:
        return ""
    return {1.0: "", 2.0: "=", 3.0: "#"}.get(b.order, "")


def fragment_to_smiles(mol: Mol, atom_ids: Iterable[int]) -> str:
    """SMILES of the induced subgraph over ``atom_ids``; disconnected
    components are joined with ``.``."""
    keep = sorted(set(atom_ids))
    if not keep:
        return ""
    keep_set = set(keep)
    # split into connected components; emit each and join with '.'
    comp_seen: Set[int] = set()
    components = []
    for start in keep:
        if start in comp_seen:
            continue
        comp = {start}
        stack = [start]
        while stack:
            v = stack.pop()
            for nb in mol.GetAtoms()[v]._neighbors:
                if nb in keep_set and nb not in comp:
                    comp.add(nb)
                    stack.append(nb)
        comp_seen |= comp
        components.append(comp)
    if len(components) > 1:
        return ".".join(_connected_fragment_to_smiles(mol, c)
                        for c in components)
    return _connected_fragment_to_smiles(mol, keep_set)


def _connected_fragment_to_smiles(mol: Mol, keep_set: Set[int]) -> str:
    keep = sorted(keep_set)

    def neighbors_in(idx: int) -> List[int]:
        return [nb for nb in mol.GetAtoms()[idx]._neighbors
                if nb in keep_set]

    # spanning-tree pre-pass: identify ring-closure (back) edges
    root = keep[0]
    tree_parent = {root: None}
    stack = [root]
    seen = {root}
    back_edges: Set[frozenset] = set()
    while stack:
        v = stack.pop()
        for nb in neighbors_in(v):
            if nb not in seen:
                seen.add(nb)
                tree_parent[nb] = v
                stack.append(nb)
            elif tree_parent.get(v) != nb:
                back_edges.add(frozenset((v, nb)))
    ring_labels = {}
    for d, e in enumerate(sorted(back_edges, key=sorted), start=1):
        ring_labels[e] = str(d) if d < 10 else f"%{d:02d}"

    out: List[str] = []
    visited: Set[int] = set()

    def dfs(idx: int, parent: Optional[int]):
        visited.add(idx)
        out.append(_atom_token(mol, idx))
        # ring-closure digits: emitted at both endpoints, when written
        for nb in neighbors_in(idx):
            key = frozenset((idx, nb))
            if key in ring_labels and nb != parent:
                out.append(_bond_token(mol, idx, nb) + ring_labels[key])
        children = [nb for nb in neighbors_in(idx)
                    if nb != parent and nb not in visited
                    and frozenset((idx, nb)) not in ring_labels]
        for k, nb in enumerate(children):
            if nb in visited:  # reached via another branch meanwhile
                continue
            btok = _bond_token(mol, idx, nb)
            remaining = [c for c in children[k + 1:] if c not in visited]
            if remaining:
                out.append("(" + btok)
                dfs(nb, idx)
                out.append(")")
            else:
                out.append(btok)
                dfs(nb, idx)

    dfs(root, None)
    return "".join(out)


def mol_to_smiles(mol: Mol) -> str:
    return fragment_to_smiles(mol, range(mol.GetNumAtoms()))
