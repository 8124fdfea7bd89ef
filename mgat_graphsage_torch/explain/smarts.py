"""Mini-SMARTS substructure matcher (subgraph isomorphism).

Replaces RDKit's ``GetSubstructMatches`` for the pattern vocabulary the
reference interpretability pipeline uses (``gnnexplainer.py:117-149`` —
plain element/aromatic atoms, ``[C,c]`` alternation, ``[nH]``, bond orders,
rings, branches).  Supported SMARTS subset:

- atom primitives: ``C N O S P F Cl Br I`` (aliphatic), ``c n o s p``
  (aromatic), ``*`` (any), bracket atoms with alternation ``[C,c]``,
  H-count ``[nH]/[NH2]``, charge ``[N+]``, and ``[#6]`` atomic numbers;
- bonds: default (single-or-aromatic), ``-``, ``=``, ``#``, ``:``, ``~``;
- branches and ring-closure digits.

Matching is backtracking subgraph isomorphism (molecules are <=94 atoms
and patterns <=10 atoms, so VF2-style pruning is unnecessary).  Matches are
deduplicated by atom-index set, mirroring ``uniquify=True``.

A copy of ``mgat_graphsage_tpu/explain/smarts.py``
(the port imports nothing of that package); keep the two in step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..chem.smiles import Mol, _ATOMIC_NUMBERS

__all__ = ["SmartsPattern", "parse_smarts", "find_matches", "has_match"]


@dataclass
class AtomSpec:
    """One pattern atom: a disjunction of primitive constraints."""
    options: List[Dict] = field(default_factory=list)  # each: {symbol, aromatic, hcount, charge}

    def matches(self, atom) -> bool:
        for opt in self.options:
            if self._match_one(opt, atom):
                return True
        return False

    @staticmethod
    def _match_one(opt: Dict, atom) -> bool:
        sym = opt.get("symbol")
        if sym == "*":
            pass
        elif sym is not None:
            if atom.GetSymbol() != sym:
                return False
            arom = opt.get("aromatic")
            if arom is not None and atom.GetIsAromatic() != arom:
                return False
        num = opt.get("atomic_num")
        if num is not None and atom.GetAtomicNum() != num:
            return False
        hc = opt.get("hcount")
        if hc is not None and atom.GetTotalNumHs() != hc:
            return False
        chg = opt.get("charge")
        if chg is not None and atom.GetFormalCharge() != chg:
            return False
        return True


@dataclass
class BondSpec:
    a1: int
    a2: int
    kind: str = "default"   # default | single | double | triple | aromatic | any

    def matches(self, bond) -> bool:
        if self.kind == "any":
            return True
        if self.kind == "default":
            return bond.aromatic or bond.order == 1
        if self.kind == "single":
            return bond.order == 1 and not bond.aromatic
        if self.kind == "double":
            return bond.order == 2
        if self.kind == "triple":
            return bond.order == 3
        if self.kind == "aromatic":
            return bond.aromatic
        return False


@dataclass
class SmartsPattern:
    atoms: List[AtomSpec]
    bonds: List[BondSpec]
    smarts: str = ""

    def adjacency(self) -> List[List[Tuple[int, BondSpec]]]:
        adj: List[List[Tuple[int, BondSpec]]] = [[] for _ in self.atoms]
        for b in self.bonds:
            adj[b.a1].append((b.a2, b))
            adj[b.a2].append((b.a1, b))
        return adj


_TWO_CHAR = ("Cl", "Br")
_BONDS = {"-": "single", "=": "double", "#": "triple", ":": "aromatic",
          "~": "any"}


def _parse_bracket_spec(body: str) -> AtomSpec:
    spec = AtomSpec()
    for alt in body.split(","):
        opt: Dict = {}
        i = 0
        while i < len(alt):
            c = alt[i]
            if c == "#":
                j = i + 1
                num = ""
                while j < len(alt) and alt[j].isdigit():
                    num += alt[j]
                    j += 1
                opt["atomic_num"] = int(num)
                i = j
            elif alt[i:i + 2] in _TWO_CHAR:
                opt["symbol"] = alt[i:i + 2]
                opt["aromatic"] = False
                i += 2
            elif c == "H":
                # hcount primitive (explicit H atoms are folded away by the
                # parser, so bare [H] as a hydrogen atom never matches)
                j = i + 1
                num = ""
                while j < len(alt) and alt[j].isdigit():
                    num += alt[j]
                    j += 1
                opt["hcount"] = int(num) if num else 1
                i = j
            elif c.isupper():
                opt["symbol"] = c
                opt["aromatic"] = False
                i += 1
            elif c.islower() and c in "bcnops":
                opt["symbol"] = c.upper()
                opt["aromatic"] = True
                i += 1
            elif c == "*":
                opt["symbol"] = "*"
                i += 1
            elif c in "+-":
                sign = 1 if c == "+" else -1
                j = i + 1
                num = ""
                while j < len(alt) and alt[j].isdigit():
                    num += alt[j]
                    j += 1
                opt["charge"] = sign * (int(num) if num else 1)
                i = j
            else:
                i += 1  # ignore unsupported primitives (X, D, R...)
        spec.options.append(opt)
    return spec


def parse_smarts(smarts: str) -> SmartsPattern:
    atoms: List[AtomSpec] = []
    bonds: List[BondSpec] = []
    prev = -1
    stack: List[int] = []
    pending: Optional[str] = None
    ring_marks: Dict[int, Tuple[int, Optional[str]]] = {}
    i = 0
    n = len(smarts)

    def add_atom(spec: AtomSpec):
        nonlocal prev, pending
        atoms.append(spec)
        idx = len(atoms) - 1
        if prev >= 0:
            bonds.append(BondSpec(prev, idx, pending or "default"))
        prev = idx
        pending = None

    while i < n:
        c = smarts[i]
        if c == "[":
            j = smarts.find("]", i)
            if j < 0:
                raise ValueError(f"bad SMARTS {smarts!r}")
            add_atom(_parse_bracket_spec(smarts[i + 1:j]))
            i = j + 1
        elif smarts[i:i + 2] in _TWO_CHAR:
            add_atom(AtomSpec([{"symbol": smarts[i:i + 2],
                                "aromatic": False}]))
            i += 2
        elif c.isupper():
            add_atom(AtomSpec([{"symbol": c, "aromatic": False}]))
            i += 1
        elif c in "bcnops":
            add_atom(AtomSpec([{"symbol": c.upper(), "aromatic": True}]))
            i += 1
        elif c == "*":
            add_atom(AtomSpec([{"symbol": "*"}]))
            i += 1
        elif c in _BONDS:
            pending = _BONDS[c]
            i += 1
        elif c.isdigit():
            num = int(c)
            if num in ring_marks:
                other, obond = ring_marks.pop(num)
                bonds.append(BondSpec(other, prev,
                                      pending or obond or "default"))
            else:
                ring_marks[num] = (prev, pending)
            pending = None
            i += 1
        elif c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            prev = stack.pop()
            i += 1
        else:
            raise ValueError(f"unsupported SMARTS char {c!r} in {smarts!r}")
    return SmartsPattern(atoms, bonds, smarts)


def find_matches(mol: Mol, pattern, uniquify: bool = True
                 ) -> List[Tuple[int, ...]]:
    """All subgraph matches as tuples of molecule atom indices (one per
    pattern atom), deduplicated by atom set when ``uniquify``."""
    if isinstance(pattern, str):
        pattern = parse_smarts(pattern)
    padj = pattern.adjacency()
    np_atoms = len(pattern.atoms)
    matches: List[Tuple[int, ...]] = []
    seen: Set[frozenset] = set()

    # match order: BFS from pattern atom 0 so each new atom connects back
    order = [0]
    placed = {0}
    while len(order) < np_atoms:
        progressed = False
        for b in pattern.bonds:
            if b.a1 in placed and b.a2 not in placed:
                order.append(b.a2)
                placed.add(b.a2)
                progressed = True
            elif b.a2 in placed and b.a1 not in placed:
                order.append(b.a1)
                placed.add(b.a1)
                progressed = True
        if not progressed:  # disconnected pattern: take any unplaced
            for k in range(np_atoms):
                if k not in placed:
                    order.append(k)
                    placed.add(k)
                    break

    mapping: Dict[int, int] = {}
    used: Set[int] = set()

    def backtrack(pos: int):
        if pos == np_atoms:
            mt = tuple(mapping[k] for k in range(np_atoms))
            if uniquify:
                key = frozenset(mt)
                if key in seen:
                    return
                seen.add(key)
            matches.append(mt)
            return
        p_idx = order[pos]
        spec = pattern.atoms[p_idx]
        # candidates: neighbors of already-mapped pattern neighbors
        anchors = [(q, b) for q, b in padj[p_idx] if q in mapping]
        if anchors:
            q0, b0 = anchors[0]
            cand = [mol.GetBonds()[bi].other(mapping[q0])
                    for bi in mol.GetAtoms()[mapping[q0]]._bond_idxs]
        else:
            cand = list(range(mol.GetNumAtoms()))
        for m_idx in cand:
            if m_idx in used:
                continue
            if not spec.matches(mol.GetAtoms()[m_idx]):
                continue
            ok = True
            for q, bspec in anchors:
                mb = mol.GetBondBetweenAtoms(m_idx, mapping[q])
                if mb is None or not bspec.matches(mb):
                    ok = False
                    break
            if not ok:
                continue
            mapping[p_idx] = m_idx
            used.add(m_idx)
            backtrack(pos + 1)
            del mapping[p_idx]
            used.discard(m_idx)

    backtrack(0)
    return matches


def has_match(mol: Mol, pattern) -> bool:
    return bool(find_matches(mol, pattern))
