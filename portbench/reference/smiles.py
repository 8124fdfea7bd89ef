"""Frozen copy of mgat_graphsage_torch/chem/smiles.py at commit 157b929
(the benchmark's reference featuriser; the program may change, this
copy does not).  The original docstring follows.

A self-contained SMILES parser and molecular perception engine.

The reference framework (JiaCZ-Computational-Biology/M-GAT-GraphSAGE) relies on
RDKit for all chemistry: ``Chem.MolFromSmiles`` plus per-atom properties
(``GetSymbol/GetDegree/GetImplicitValence/GetHybridization/GetIsAromatic/
GetTotalNumHs``, see reference ``train.py:25-55``).  RDKit is not part of this
build's dependency set, so this module implements the subset of molecular
perception those featurizers require, from scratch.  It is a verbatim copy of
``mgat_graphsage_tpu/chem/smiles.py`` (the port imports nothing of that
package); keep the two in step:

- full SMILES grammar for drug-like molecules: organic subset atoms, bracket
  atoms (isotope / chirality / explicit H / charge / atom map), single,
  double, triple and aromatic bonds, directional bonds (parsed, treated as
  single), branches, ring-bond closures (including ``%nn``), dot-separated
  fragments;
- ring perception (cyclomatic ring membership is exact via bridge
  detection; ring-size enumeration covers rings up to ``MAX_RING`` = 24
  members, which includes common macrocyclic drugs — larger rings keep
  ``in_ring=True`` but get no ``ring_sizes`` entry);
- aromaticity perception for Kekule-written rings (Hückel 4n+2 on 5/6-rings,
  iterated to a fixpoint so fused systems such as indole converge) in
  addition to lowercase aromatic input;
- implicit hydrogen assignment per the Daylight valence model, with
  pyrrole-type lone-pair donors keeping their hydrogen (RDKit semantics);
- hybridization assignment via the steric-number model RDKit uses
  (``MolOps::setHybridization``): orbitals = sigma bonds (heavy degree +
  total Hs) + lone pairs, mapped 2→SP, 3→SP2, 4→SP3, 5→SP3D, 6→SP3D2 —
  so hypervalent S/P (sulfones, sulfoxides, phosphates) come out SP3 as
  RDKit reports them.

Everything downstream (featurizers, fingerprints, descriptors, SMARTS
matching) is built on the ``Mol`` object defined here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Atom",
    "Bond",
    "Mol",
    "MolFromSmiles",
    "parse_smiles",
    "SmilesParseError",
]


class SmilesParseError(ValueError):
    """Raised when a SMILES string cannot be parsed."""


# Daylight organic-subset default valences. Multi-valued entries follow the
# "lowest valence that fits" rule for implicit-H assignment.
_DEFAULT_VALENCES: Dict[str, Tuple[int, ...]] = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}

_ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_SYMBOLS = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}

_ATOMIC_NUMBERS: Dict[str, int] = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "Pt": 78,
    "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83,
}

# Valence (outer-shell) electron counts for main-group elements, used by the
# steric-number hybridization model (lone pairs = (outer - charge - bonded
# valence) / 2).  Transition metals are absent deliberately: they get no
# lone-pair term.
_OUTER_ELECS: Dict[str, int] = {
    "H": 1, "He": 2, "Li": 1, "Be": 2, "B": 3, "C": 4, "N": 5, "O": 6,
    "F": 7, "Ne": 8, "Na": 1, "Mg": 2, "Al": 3, "Si": 4, "P": 5, "S": 6,
    "Cl": 7, "Ar": 8, "K": 1, "Ca": 2, "Ga": 3, "Ge": 4, "As": 5, "Se": 6,
    "Br": 7, "Kr": 8, "Rb": 1, "Sr": 2, "In": 3, "Sn": 4, "Sb": 5, "Te": 6,
    "I": 7, "Xe": 8, "Cs": 1, "Ba": 2, "Tl": 3, "Pb": 4, "Bi": 5,
}

# Pauling electronegativities for the handful of elements that matter in
# drug-like chemistry (used by descriptor code, e.g. Gasteiger-ish charges).
_MASSES: Dict[str, float] = {
    "H": 1.008, "B": 10.811, "C": 12.011, "N": 14.007, "O": 15.999,
    "F": 18.998, "Na": 22.990, "Mg": 24.305, "Si": 28.086, "P": 30.974,
    "S": 32.065, "Cl": 35.453, "K": 39.098, "Ca": 40.078, "Fe": 55.845,
    "Zn": 65.38, "Se": 78.971, "Br": 79.904, "I": 126.904,
}

# Hybridization labels (string enum; the featurizer one-hots a fixed subset).
SP = "SP"
SP2 = "SP2"
SP3 = "SP3"
SP3D = "SP3D"
SP3D2 = "SP3D2"
S_HYB = "S"
UNSPECIFIED = "UNSPECIFIED"


@dataclass
class Atom:
    """One heavy atom of a molecule.

    Mirrors the RDKit atom-property surface used by the reference featurizer
    (reference ``train.py:33-44``): symbol, degree, implicit valence,
    hybridization, aromaticity, total H count; plus charge / ring data used
    by descriptors and fingerprints.
    """

    symbol: str
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    explicit_hs: int = 0          # H count given in brackets; -1 = not given
    is_bracket: bool = False
    chirality: str = ""
    atom_map: int = 0
    idx: int = -1

    # Perception results (filled by Mol._perceive):
    implicit_hs: int = 0
    in_ring: bool = False
    ring_sizes: Tuple[int, ...] = ()
    hybridization: str = UNSPECIFIED
    _lp_donor: bool = False       # aromatized by donating a lone pair
    _degree: int = 0
    _neighbors: List[int] = field(default_factory=list)
    _bond_idxs: List[int] = field(default_factory=list)

    # --- RDKit-compatible accessors (reference train.py:34-42) ---
    def GetSymbol(self) -> str:
        return self.symbol

    def GetAtomicNum(self) -> int:
        return _ATOMIC_NUMBERS.get(self.symbol, 0)

    def GetDegree(self) -> int:
        """Number of explicit (heavy-atom) connections."""
        return self._degree

    def GetImplicitValence(self) -> int:
        """Number of implicit hydrogens (RDKit semantics)."""
        return self.implicit_hs

    def GetTotalNumHs(self) -> int:
        return self.implicit_hs + max(self.explicit_hs, 0)

    def GetFormalCharge(self) -> int:
        return self.charge

    def GetIsAromatic(self) -> bool:
        return self.aromatic

    def GetHybridization(self) -> str:
        return self.hybridization

    def GetIdx(self) -> int:
        return self.idx

    def IsInRing(self) -> bool:
        return self.in_ring

    def GetMass(self) -> float:
        return _MASSES.get(self.symbol, 0.0)

    def GetNeighbors(self) -> List[int]:
        return list(self._neighbors)

    def total_connections(self) -> int:
        return self._degree + self.GetTotalNumHs()


@dataclass
class Bond:
    a1: int
    a2: int
    order: float = 1.0            # 1, 2, 3, or 1.5 for aromatic
    aromatic: bool = False
    in_ring: bool = False
    direction: str = ""           # "/" or "\\" as written (stereo hint only)
    idx: int = -1

    def GetBeginAtomIdx(self) -> int:
        return self.a1

    def GetEndAtomIdx(self) -> int:
        return self.a2

    def GetBondTypeAsDouble(self) -> float:
        return self.order

    def GetIsAromatic(self) -> bool:
        return self.aromatic

    def IsInRing(self) -> bool:
        return self.in_ring

    def other(self, i: int) -> int:
        return self.a2 if i == self.a1 else self.a1


class Mol:
    """A perceived molecule: atoms, bonds, rings, implicit Hs, hybridization."""

    def __init__(self, atoms: List[Atom], bonds: List[Bond], smiles: str = ""):
        self.atoms = atoms
        self.bonds = bonds
        self.smiles = smiles
        for i, a in enumerate(self.atoms):
            a.idx = i
        for i, b in enumerate(self.bonds):
            b.idx = i
        self._rings: List[List[int]] = []
        self._perceive()

    # --- RDKit-compatible surface ---
    def GetNumAtoms(self) -> int:
        return len(self.atoms)

    def GetNumBonds(self) -> int:
        return len(self.bonds)

    def GetAtoms(self) -> List[Atom]:
        return self.atoms

    def GetBonds(self) -> List[Bond]:
        return self.bonds

    def GetAtomWithIdx(self, i: int) -> Atom:
        return self.atoms[i]

    def GetBondBetweenAtoms(self, i: int, j: int) -> Optional[Bond]:
        for bidx in self.atoms[i]._bond_idxs:
            b = self.bonds[bidx]
            if b.other(i) == j:
                return b
        return None

    def GetRingInfo(self) -> List[List[int]]:
        return self._rings

    def NumRings(self) -> int:
        """Cyclomatic number == SSSR ring count."""
        n_comp = self._num_components()
        return len(self.bonds) - len(self.atoms) + n_comp

    # --- perception pipeline ---
    def _num_components(self) -> int:
        seen = [False] * len(self.atoms)
        n = 0
        for start in range(len(self.atoms)):
            if seen[start]:
                continue
            n += 1
            stack = [start]
            seen[start] = True
            while stack:
                cur = stack.pop()
                for nb in self.atoms[cur]._neighbors:
                    if not seen[nb]:
                        seen[nb] = True
                        stack.append(nb)
        return n

    def _perceive(self) -> None:
        self._build_adjacency()
        self._find_rings()
        self._aromatize_kekule_rings()
        self._assign_implicit_hs()
        self._assign_hybridization()

    def _build_adjacency(self) -> None:
        for a in self.atoms:
            a._neighbors = []
            a._bond_idxs = []
        for b in self.bonds:
            self.atoms[b.a1]._neighbors.append(b.a2)
            self.atoms[b.a2]._neighbors.append(b.a1)
            self.atoms[b.a1]._bond_idxs.append(b.idx)
            self.atoms[b.a2]._bond_idxs.append(b.idx)
        for a in self.atoms:
            a._degree = len(a._neighbors)

    #: Upper bound on enumerated ring sizes.  Ring *membership* is exact
    #: for any size (bridge detection); only ``ring_sizes`` / aromaticity
    #: enumeration is bounded.  24 covers common macrocyclic drugs
    #: (erythromycin 14, rapamycin 31 is beyond it); atoms of larger rings
    #: keep ``in_ring=True`` with empty ``ring_sizes``.  The BFS per ring
    #: bond is O(V+E) regardless of this bound, so raising it is cheap.
    MAX_RING = 24

    def _find_rings(self) -> None:
        """Enumerate rings (size <= MAX_RING) and mark ring membership.

        Ring membership uses the exact criterion "edge lies on some cycle"
        (computed via bridge detection), so fused systems are handled
        correctly.  Ring enumeration (for ring sizes / aromaticity) finds
        the shortest cycle through each ring bond via bounded BFS.
        """
        n = len(self.atoms)
        # --- bridge detection (Tarjan) to mark ring bonds/atoms exactly ---
        disc = [-1] * n
        low = [0] * n
        is_bridge = [False] * len(self.bonds)
        timer = [0]

        for root in range(n):
            if disc[root] != -1:
                continue
            # iterative DFS
            stack = [(root, -1, iter(self.atoms[root]._bond_idxs))]
            disc[root] = low[root] = timer[0]
            timer[0] += 1
            while stack:
                v, pedge, it = stack[-1]
                advanced = False
                for bidx in it:
                    if bidx == pedge:
                        continue
                    b = self.bonds[bidx]
                    w = b.other(v)
                    if disc[w] == -1:
                        disc[w] = low[w] = timer[0]
                        timer[0] += 1
                        stack.append((w, bidx, iter(self.atoms[w]._bond_idxs)))
                        advanced = True
                        break
                    else:
                        low[v] = min(low[v], disc[w])
                if not advanced:
                    stack.pop()
                    if stack:
                        pv = stack[-1][0]
                        low[pv] = min(low[pv], low[v])
                        if low[v] > disc[pv]:
                            is_bridge[pedge] = True

        for b in self.bonds:
            b.in_ring = not is_bridge[b.idx]
        for a in self.atoms:
            a.in_ring = any(self.bonds[bi].in_ring for bi in a._bond_idxs)

        # --- small ring enumeration via bounded cycle search per ring bond ---
        rings: List[List[int]] = []
        seen_rings = set()
        MAX_RING = self.MAX_RING
        for b in self.bonds:
            if not b.in_ring:
                continue
            # shortest cycle through bond b: BFS from a1 to a2 avoiding b
            src, dst = b.a1, b.a2
            prev = {src: -1}
            frontier = [src]
            found = False
            depth = 0
            while frontier and not found and depth < MAX_RING:
                nxt = []
                for v in frontier:
                    for bidx in self.atoms[v]._bond_idxs:
                        if bidx == b.idx:
                            continue
                        nb = self.bonds[bidx]
                        if not nb.in_ring:
                            continue
                        w = nb.other(v)
                        if w in prev:
                            continue
                        prev[w] = v
                        if w == dst:
                            found = True
                            break
                        nxt.append(w)
                    if found:
                        break
                frontier = nxt
                depth += 1
            if found:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                key = frozenset(path)
                if key not in seen_rings and len(path) <= MAX_RING:
                    seen_rings.add(key)
                    rings.append(path)
        self._rings = rings
        for ring in rings:
            for ai in ring:
                a = self.atoms[ai]
                if len(ring) not in a.ring_sizes:
                    a.ring_sizes = tuple(sorted(a.ring_sizes + (len(ring),)))

    def _aromatize_kekule_rings(self) -> None:
        """Perceive aromaticity on Kekule-written rings (Hückel 4n+2).

        Lowercase SMILES input already marks atoms aromatic; this pass
        additionally recognises alternating single/double 5- and 6-membered
        rings of sp2 C/N/O/S so that e.g. ``C1=CC=CC=C1`` equals ``c1ccccc1``.
        The candidate loop iterates to a fixpoint so fused Kekule systems
        (indole, benzofuran, ...) converge regardless of ring order: a bond
        already aromatized by a neighbouring ring counts as a pi contributor
        for atoms of this ring.

        Atoms that aromatize by donating a lone pair (pyrrole-type N/O/S,
        the ``pi += 2`` branch) are flagged ``_lp_donor`` — implicit-H
        assignment must NOT give them the aromatic +1 formal-double-bond
        valence bump (a Kekule-written pyrrole N keeps its hydrogen,
        matching RDKit's ``GetTotalNumHs() == 1``).
        """
        candidates = [r for r in self._rings if len(r) in (5, 6)]
        done = [False] * len(candidates)
        changed = True
        while changed:
            changed = False
            for ri, ring in enumerate(candidates):
                if done[ri]:
                    continue
                if all(self.atoms[i].aromatic for i in ring):
                    self._mark_ring_aromatic(ring)
                    done[ri] = True
                    changed = True
                    continue
                pi = 0
                ok = True
                donors: List[int] = []
                ring_set = set(ring)
                for ai in ring:
                    a = self.atoms[ai]
                    if a.symbol not in ("C", "N", "O", "S"):
                        ok = False
                        break
                    pi_in_ring = any(
                        (self.bonds[bi].order == 2 or self.bonds[bi].aromatic)
                        and self.bonds[bi].other(ai) in ring_set
                        for bi in a._bond_idxs
                    )
                    exo_dbl_hetero = exo_dbl_carbon = False
                    for bi in a._bond_idxs:
                        b = self.bonds[bi]
                        if b.order == 2 and b.other(ai) not in ring_set:
                            if self.atoms[b.other(ai)].symbol in \
                                    ("O", "S", "N"):
                                exo_dbl_hetero = True
                            else:
                                exo_dbl_carbon = True
                    if pi_in_ring:
                        pi += 1
                    elif exo_dbl_hetero:
                        # RDKit model: exocyclic double bond to a more
                        # electronegative atom -> the ring atom stays in
                        # the pi system contributing ZERO electrons
                        # (2-pyridone aromatizes; quinone stays at 4
                        # electrons and correctly fails Hueckel)
                        pi += 0
                    elif exo_dbl_carbon:
                        ok = False  # fulvene-type cross-conjugation
                        break
                    elif a.symbol in ("N", "O", "S"):
                        pi += 2  # lone pair donated into the ring
                        donors.append(ai)
                    else:
                        ok = False
                        break
                if ok and pi % 4 == 2:
                    for ai in donors:
                        self.atoms[ai]._lp_donor = True
                    self._mark_ring_aromatic(ring)
                    done[ri] = True
                    changed = True

    def _mark_ring_aromatic(self, ring: List[int]) -> None:
        ring_set = set(ring)
        for ai in ring:
            self.atoms[ai].aromatic = True
        for b in self.bonds:
            if b.a1 in ring_set and b.a2 in ring_set and b.in_ring:
                b.aromatic = True
                b.order = 1.5

    def _assign_implicit_hs(self) -> None:
        """Assign implicit hydrogens AND validate total bond order.

        Valence validation (round-3 VERDICT #1a): a neutral atom whose
        total bond order exceeds its highest Daylight valence is
        chemically impossible (RDKit — the reference's toolchain,
        reference ``train.py:26-28`` — rejects such SMILES at
        sanitization), so ``parse_smiles("CO=C")`` raises here instead
        of silently producing a trivalent neutral oxygen.  Charged
        bracket atoms are exempt: a formal charge shifts the allowed
        valence (``[O-]``, ``[N+]``, ...) and such species are taken
        as written, matching this parser's bracket-H semantics.
        """
        for a in self.atoms:
            valences = _DEFAULT_VALENCES.get(a.symbol)
            if a.is_bracket:
                # bracket atoms: H count is exactly what the brackets say
                a.implicit_hs = 0
                if valences is not None and a.charge == 0:
                    order_sum = sum(
                        1.0 if self.bonds[bi].aromatic else self.bonds[bi].order
                        for bi in a._bond_idxs)
                    total = int(round(order_sum)) + max(a.explicit_hs, 0)
                    if total > valences[-1]:
                        raise SmilesParseError(
                            f"Valence {total} on neutral {a.symbol} (atom "
                            f"{a.idx}) exceeds maximum {valences[-1]} in "
                            f"{self.smiles!r}")
                continue
            if valences is None:
                a.implicit_hs = 0
                continue
            order_sum = 0.0
            n_aromatic = 0
            for bi in a._bond_idxs:
                b = self.bonds[bi]
                if b.aromatic:
                    n_aromatic += 1
                    order_sum += 1.0
                else:
                    order_sum += b.order
            total = int(round(order_sum))
            if a.aromatic and not a._lp_donor and total + 1 <= valences[0]:
                # Daylight rule of thumb: an aromatic atom participates in
                # one formal double bond within the ring system — but only
                # when that fits its lowest normal valence, and only when
                # the atom was NOT aromatized by donating a lone pair
                # (pyrrole-type N keeps its H: RDKit GetTotalNumHs() == 1).
                total += 1
            for v in valences:
                if total <= v:
                    a.implicit_hs = v - total
                    break
            else:
                raise SmilesParseError(
                    f"Valence {total} on neutral {a.symbol} (atom {a.idx}) "
                    f"exceeds maximum {valences[-1]} in {self.smiles!r}")

    def _assign_hybridization(self) -> None:
        """Steric-number model (RDKit ``MolOps::setHybridization``):

            orbitals = sigma bonds (heavy degree + total Hs) + lone pairs
            lone pairs = (outer-shell electrons - charge - bonded valence) / 2

        where bonded valence counts bond orders (aromatic as 1.5) plus Hs.
        Mapping: 2 -> SP, 3 -> SP2, 4 -> SP3, 5 -> SP3D, 6+ -> SP3D2.
        This gets hypervalent S/P right where a multiple-bond-count rule
        does not: sulfone/sulfonamide S and phosphate P are SP3 (4 sigma
        bonds, 0 lone pairs), sulfoxide S is SP3 (3 sigma + 1 lone pair) —
        matching RDKit on drug-like atoms.
        """
        for a in self.atoms:
            total_hs = a.GetTotalNumHs()
            if a._degree == 0 and total_hs == 0:
                a.hybridization = S_HYB
                continue
            order_sum = sum(self.bonds[bi].order for bi in a._bond_idxs)
            bonded = int(order_sum + 0.5) + total_hs
            outer = _OUTER_ELECS.get(a.symbol)
            lone_pairs = 0 if outer is None else max(
                0, (outer - a.charge - bonded) // 2)
            steric = a._degree + total_hs + lone_pairs
            if steric <= 1:
                a.hybridization = S_HYB
            elif steric == 2:
                a.hybridization = SP
            elif steric == 3:
                a.hybridization = SP2
            elif steric == 4:
                a.hybridization = SP3
            elif steric == 5:
                a.hybridization = SP3D
            else:
                a.hybridization = SP3D2


# ---------------------------------------------------------------------------
# Tokenizer / parser
# ---------------------------------------------------------------------------

_TWO_CHAR_ORGANIC = ("Cl", "Br")
_BOND_CHARS = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5, "/": 1.0, "\\": 1.0}


def _parse_bracket(smiles: str, pos: int) -> Tuple[Atom, int]:
    """Parse a bracket atom starting at ``smiles[pos] == '['``."""
    end = smiles.find("]", pos)
    if end < 0:
        raise SmilesParseError(f"Unclosed bracket at {pos} in {smiles!r}")
    body = smiles[pos + 1:end]
    i = 0
    isotope = 0
    while i < len(body) and body[i].isdigit():
        isotope = isotope * 10 + int(body[i])
        i += 1
    # element symbol (allow aromatic lowercase and two-letter symbols)
    sym = ""
    if i < len(body):
        if i + 1 < len(body) and body[i:i + 2] in ("se", "as", "te"):
            sym = body[i:i + 2]
            i += 2
        elif body[i].isupper():
            if i + 1 < len(body) and body[i + 1].islower() and \
                    body[i:i + 2] in _ATOMIC_NUMBERS:
                sym = body[i:i + 2]
                i += 2
            else:
                sym = body[i]
                i += 1
        elif body[i].islower():
            sym = body[i]
            i += 1
        elif body[i] == "*":
            sym = "*"
            i += 1
    if not sym:
        raise SmilesParseError(f"Bad bracket atom {body!r} in {smiles!r}")
    aromatic = sym[0].islower() and sym != "*"
    symbol = sym[0].upper() + sym[1:] if aromatic else sym

    chirality = ""
    while i < len(body) and body[i] == "@":
        chirality += "@"
        i += 1
    if chirality and i < len(body) and body[i:i + 2] in ("TH", "AL", "SP"):
        chirality += body[i:i + 2]
        i += 2

    hs = 0
    if i < len(body) and body[i] == "H":
        i += 1
        hs = 1
        num = ""
        while i < len(body) and body[i].isdigit():
            num += body[i]
            i += 1
        if num:
            hs = int(num)

    charge = 0
    while i < len(body) and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        num = ""
        while i < len(body) and body[i].isdigit():
            num += body[i]
            i += 1
        if num:
            charge += sign * int(num)
        else:
            charge += sign
            # allow ++ / -- runs
            while i < len(body) and body[i] == ("+" if sign > 0 else "-"):
                charge += sign
                i += 1

    atom_map = 0
    if i < len(body) and body[i] == ":":
        i += 1
        num = ""
        while i < len(body) and body[i].isdigit():
            num += body[i]
            i += 1
        atom_map = int(num) if num else 0

    if i != len(body):
        raise SmilesParseError(
            f"Trailing bracket content {body[i:]!r} in {smiles!r}")

    atom = Atom(symbol=symbol, aromatic=aromatic, charge=charge,
                isotope=isotope, explicit_hs=hs, is_bracket=True,
                chirality=chirality, atom_map=atom_map)
    return atom, end + 1


def parse_smiles(smiles: str) -> Mol:
    """Parse a SMILES string into a perceived :class:`Mol`.

    Raises :class:`SmilesParseError` on malformed input (mirroring the
    reference's ``ValueError`` on ``MolFromSmiles(...) is None``,
    reference ``train.py:26-28``).
    """
    if not isinstance(smiles, str) or not smiles or smiles.lower() == "nan":
        raise SmilesParseError(f"Invalid SMILES string: {smiles!r}")

    atoms: List[Atom] = []
    bonds: List[Bond] = []
    prev_atom: int = -1
    branch_stack: List[int] = []
    pending_bond: Optional[float] = None
    pending_dir = ""
    ring_marks: Dict[int, Tuple[int, Optional[float], str]] = {}

    def add_atom(atom: Atom) -> None:
        nonlocal prev_atom, pending_bond, pending_dir
        atoms.append(atom)
        idx = len(atoms) - 1
        if prev_atom >= 0:
            order = pending_bond
            aromatic = False
            if order is None:
                if atoms[prev_atom].aromatic and atom.aromatic:
                    order, aromatic = 1.5, True
                else:
                    order = 1.0
            elif order == 1.5:
                aromatic = True
            bonds.append(Bond(prev_atom, idx, order, aromatic,
                              direction=pending_dir))
        prev_atom = idx
        pending_bond = None
        pending_dir = ""

    def close_ring(num: int) -> None:
        nonlocal pending_bond, pending_dir
        if prev_atom < 0:
            raise SmilesParseError(f"Ring closure before atom in {smiles!r}")
        if num in ring_marks:
            other, o_bond, o_dir = ring_marks.pop(num)
            order = pending_bond if pending_bond is not None else o_bond
            aromatic = False
            if order is None:
                if atoms[other].aromatic and atoms[prev_atom].aromatic:
                    order, aromatic = 1.5, True
                else:
                    order = 1.0
            elif order == 1.5:
                aromatic = True
            if other == prev_atom:
                raise SmilesParseError(f"Self-bond ring closure in {smiles!r}")
            bonds.append(Bond(other, prev_atom, order, aromatic,
                              direction=pending_dir or o_dir))
        else:
            ring_marks[num] = (prev_atom, pending_bond, pending_dir)
        pending_bond = None
        pending_dir = ""

    i = 0
    n = len(smiles)
    while i < n:
        c = smiles[i]
        if c == "[":
            atom, i = _parse_bracket(smiles, i)
            add_atom(atom)
        elif c.isupper():
            if smiles[i:i + 2] in _TWO_CHAR_ORGANIC:
                sym = smiles[i:i + 2]
                i += 2
            else:
                sym = c
                i += 1
            if sym not in _ORGANIC_SUBSET:
                raise SmilesParseError(
                    f"Atom {sym!r} needs brackets in {smiles!r}")
            add_atom(Atom(symbol=sym))
        elif c in "bcnops":
            add_atom(Atom(symbol=c.upper(), aromatic=True))
            i += 1
        elif c in _BOND_CHARS:
            if pending_bond is not None and c not in "/\\":
                raise SmilesParseError(f"Double bond symbol at {i} in {smiles!r}")
            pending_bond = _BOND_CHARS[c]
            if c in "/\\":
                pending_dir = c
                pending_bond = 1.0
            i += 1
        elif c.isdigit():
            close_ring(int(c))
            i += 1
        elif c == "%":
            if i + 2 >= n or not smiles[i + 1:i + 3].isdigit():
                raise SmilesParseError(f"Bad %-ring closure in {smiles!r}")
            close_ring(int(smiles[i + 1:i + 3]))
            i += 3
        elif c == "(":
            if prev_atom < 0:
                raise SmilesParseError(f"Branch before atom in {smiles!r}")
            branch_stack.append(prev_atom)
            i += 1
        elif c == ")":
            if not branch_stack:
                raise SmilesParseError(f"Unbalanced ')' in {smiles!r}")
            prev_atom = branch_stack.pop()
            i += 1
        elif c == ".":
            prev_atom = -1
            pending_bond = None
            pending_dir = ""
            i += 1
        elif c in " \t":
            break  # SMILES ends at whitespace (title field)
        else:
            raise SmilesParseError(f"Unexpected character {c!r} at {i} in {smiles!r}")

    if branch_stack:
        raise SmilesParseError(f"Unbalanced '(' in {smiles!r}")
    if ring_marks:
        raise SmilesParseError(f"Unclosed ring bond(s) {sorted(ring_marks)} in {smiles!r}")
    if not atoms:
        raise SmilesParseError(f"Empty SMILES: {smiles!r}")

    # Drop explicit-H bracket atoms bonded to heavy atoms, folding them into
    # the neighbour's H count (RDKit's default: Hs are implicit properties).
    h_idxs = [i for i, a in enumerate(atoms)
              if a.symbol == "H" and a.isotope == 0 and a.charge == 0]
    mol_atoms, mol_bonds = atoms, bonds
    if h_idxs:
        keep = [i for i in range(len(atoms)) if i not in set(h_idxs)]
        remap = {old: new for new, old in enumerate(keep)}
        extra_h: Dict[int, int] = {}
        new_bonds: List[Bond] = []
        for b in bonds:
            if b.a1 in remap and b.a2 in remap:
                new_bonds.append(Bond(remap[b.a1], remap[b.a2], b.order,
                                      b.aromatic, direction=b.direction))
            else:
                heavy = b.a1 if b.a1 in remap else (b.a2 if b.a2 in remap else None)
                if heavy is not None:
                    extra_h[remap[heavy]] = extra_h.get(remap[heavy], 0) + 1
        new_atoms = []
        for old in keep:
            a = atoms[old]
            new_atoms.append(Atom(symbol=a.symbol, aromatic=a.aromatic,
                                  charge=a.charge, isotope=a.isotope,
                                  explicit_hs=max(a.explicit_hs, 0),
                                  is_bracket=a.is_bracket,
                                  chirality=a.chirality, atom_map=a.atom_map))
        for ni, cnt in extra_h.items():
            new_atoms[ni].explicit_hs = max(new_atoms[ni].explicit_hs, 0) + cnt
            new_atoms[ni].is_bracket = True
        mol_atoms, mol_bonds = new_atoms, new_bonds
        for i2, a in enumerate(mol_atoms):
            a.idx = i2
        for i2, b in enumerate(mol_bonds):
            b.idx = i2

    return Mol(mol_atoms, mol_bonds, smiles=smiles)


def MolFromSmiles(smiles: str) -> Optional[Mol]:
    """RDKit-style wrapper: returns ``None`` instead of raising."""
    try:
        return parse_smiles(smiles)
    except SmilesParseError:
        return None
