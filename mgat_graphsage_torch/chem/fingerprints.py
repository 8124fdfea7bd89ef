"""Molecular fingerprints, implemented from scratch (no RDKit): a copy of
``mgat_graphsage_tpu/chem/fingerprints.py`` (the port imports nothing of
that package).

- **Morgan / ECFP** circular fingerprints, the default CRC32 bit layout
  and the opt-in RDKit layout (reference ``train.py:58-63``,
  ``fingerprint/morgan=1024.py``, ``morgan=2048.py``, ``ecfp=2024.py``);
- **FCFP**, Morgan with pharmacophoric invariants (``fingerprint/fcfp.py``);
- **MACCS-like 167-bit structural keys** (``fingerprint/maccs.py``);
- **SMIFP**, the SMILES n-gram fingerprint (``fingerprint/SMIFP.py:55-92``)
  over a deterministic CRC hash where the original used Python's salted
  ``hash()``;
- **BCI**, a layered path fingerprint (512 bits) beside a descriptor block
  padded to 512 (``fingerprint/BCI.py:55-155``, ``chem/descriptors.py``).

All functions return float32 arrays of shape ``[1, nBits]``.  Only the
default Morgan layouts have a native path (``chem/native.py``); the rest
featurise in Python.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import descriptors as D
from .smiles import Mol, parse_smiles

__all__ = [
    "morgan_fingerprint",
    "get_ecfp",
    "get_morgan_fingerprint",
    "get_fcfp",
    "get_maccs",
    "get_smifp",
    "get_bci_fingerprint",
    "FINGERPRINTS",
    "FINGERPRINT_DIMS",
]


def _stable_hash(*parts) -> int:
    """Deterministic 32-bit hash of a tuple (CRC32 over repr bytes)."""
    return zlib.crc32(repr(parts).encode("utf-8")) & 0xFFFFFFFF


# Morgan hashing uses a language-portable integer stream (uint32 LE +
# CRC32), so the native featuriser (csrc/featurizer.cpp) makes the same
# bits. Tags namespace the hash families.
_TAG_ECFP0 = 1
_TAG_FCFP0 = 2
_TAG_ITER = 3


def _crc_ints(tag: int, ints: Sequence[int]) -> int:
    vals = [tag] + [v & 0xFFFFFFFF for v in ints]
    return zlib.crc32(struct.pack("<%dI" % len(vals), *vals)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Morgan / ECFP / FCFP
# ---------------------------------------------------------------------------

def _ecfp_invariant(atom) -> int:
    """Standard ECFP initial atom invariant (Rogers & Hahn 2010)."""
    return _crc_ints(_TAG_ECFP0, [
        atom.GetAtomicNum(),
        atom.GetDegree(),
        atom.GetTotalNumHs(),
        atom.GetFormalCharge(),
        int(atom.IsInRing()),
        int(atom.GetIsAromatic()),
        atom.isotope,
    ])


def _fcfp_invariant(atom) -> int:
    """FCFP pharmacophoric invariant: (donor, acceptor, basic, acidic,
    aromatic, halogen) flags."""
    sym = atom.GetSymbol()
    donor = int(sym in ("N", "O", "S") and atom.GetTotalNumHs() > 0)
    acceptor = int(sym in ("N", "O") and atom.GetFormalCharge() <= 0)
    basic = int(sym == "N" and not atom.GetIsAromatic()
                and atom.GetFormalCharge() >= 0)
    acidic = int(sym == "O" and atom.GetFormalCharge() < 0)
    aromatic = int(atom.GetIsAromatic())
    halogen = int(sym in ("F", "Cl", "Br", "I"))
    return _crc_ints(_TAG_FCFP0, [donor, acceptor, basic, acidic,
                                  aromatic, halogen])


# --- RDKit-layout Morgan hashing (opt-in, VERDICT r3 next #2b) -----------
#
# RDKit positions Morgan bits with its own pipeline: ECFP connectivity
# invariants hashed with the vendored 32-bit boost ``hash_range``
# (hash_combine: seed ^= v + 0x9e3779b9 + (seed<<6) + (seed>>2)), bond
# codes from the BondType enum (SINGLE=1, DOUBLE=2, TRIPLE=3,
# AROMATIC=12), and folding by ``invariant % nBits``
# (GraphMol/Fingerprints/MorganFingerprints.cpp).  The functions below
# implement that published scheme so checkpoints whose CNN branch was
# trained on RDKit-layout bits (reference ``train.py:58-63``) can be fed
# matching inputs (``fingerprint="ecfp1024_rdkit"`` etc.).
#
# HONESTY NOTE: bit-exactness against a live RDKit CANNOT be verified in
# this image (no RDKit wheel, no network egress, and no trustworthy
# published full-vector Morgan goldens).  What IS pinned by tests:
# determinism, renumbering/Kekulé invariance, sane density, and that the
# layout differs from the CRC32 default.  Treat imported-checkpoint
# parity through this layout as best-effort until validated against a
# real RDKit once (docs/MIGRATION.md "Fingerprint bit layout").

def _boost_hash_u32(vals: Sequence[int]) -> int:
    """32-bit boost::hash_range over uint32 values (RDKit's gboost)."""
    seed = 0
    for v in vals:
        v &= 0xFFFFFFFF
        seed ^= (v + 0x9E3779B9 + ((seed << 6) & 0xFFFFFFFF)
                 + (seed >> 2)) & 0xFFFFFFFF
        seed &= 0xFFFFFFFF
    return seed


def _rdkit_connectivity_invariant(atom) -> int:
    """RDKit getConnectivityInvariants(): [atomicNum, totalDegree,
    totalNumHs, charge, deltaMass, (1 if in ring)] — the ring flag is
    appended only when set (variable-length vector, as in the C++)."""
    comps = [
        atom.GetAtomicNum(),
        atom.GetDegree() + atom.GetTotalNumHs(),   # totalDegree
        atom.GetTotalNumHs(),
        atom.GetFormalCharge() & 0xFFFFFFFF,       # two's complement u32
        int(round(atom.isotope - atom.GetMass())) & 0xFFFFFFFF
        if atom.isotope else 0,                    # deltaMass
    ]
    if atom.IsInRing():
        comps.append(1)
    return _boost_hash_u32(comps)


def _rdkit_feature_invariant(atom) -> int:
    """RDKit getFeatureInvariants(): a bitmask over the six pharmacophore
    features in definition order Donor, Acceptor, Aromatic, Halogen,
    Basic, Acidic (bit i = feature i matched) — no hash."""
    sym = atom.GetSymbol()
    donor = int(sym in ("N", "O", "S") and atom.GetTotalNumHs() > 0)
    acceptor = int(sym in ("N", "O") and atom.GetFormalCharge() <= 0)
    aromatic = int(atom.GetIsAromatic())
    halogen = int(sym in ("F", "Cl", "Br", "I"))
    basic = int(sym == "N" and not atom.GetIsAromatic()
                and atom.GetFormalCharge() >= 0)
    acidic = int(sym == "O" and atom.GetFormalCharge() < 0)
    return (donor | acceptor << 1 | aromatic << 2 | halogen << 3
            | basic << 4 | acidic << 5)


def _rdkit_bond_code(bond) -> int:
    """RDKit BondType enum value as used by the Morgan neighbor pairs."""
    if bond.aromatic:
        return 12
    return {1: 1, 2: 2, 3: 3}.get(int(bond.order), 1)


def morgan_fingerprint(
    mol: Mol,
    radius: int = 2,
    n_bits: int = 1024,
    use_features: bool = False,
    bit_layout: str = "crc32",
) -> np.ndarray:
    """Circular (Morgan/ECFP) bit fingerprint, folded to ``n_bits``.

    Iterative neighborhood hashing with duplicate-environment removal per
    round, as in the canonical ECFP algorithm.

    ``bit_layout``: ``"crc32"`` (default — this repo's language-portable
    hash, shared bit-identically with the C++ featurizer) or ``"rdkit"``
    (RDKit's published invariant + boost-hash-combine pipeline, for
    feeding checkpoints trained on RDKit bit positions; see the honesty
    note at ``_boost_hash_u32`` — bit-exactness vs live RDKit is
    unverified in this image).
    """
    if bit_layout not in ("crc32", "rdkit"):
        raise ValueError(f"unknown bit_layout {bit_layout!r}")
    rdkit = bit_layout == "rdkit"
    if rdkit:
        inv_fn = (_rdkit_feature_invariant if use_features
                  else _rdkit_connectivity_invariant)
    else:
        inv_fn = _fcfp_invariant if use_features else _ecfp_invariant
    ids = [inv_fn(a) for a in mol.GetAtoms()]
    fp = np.zeros((n_bits,), dtype=np.float32)
    # environment tracking: (frozen bond set) -> dedupe within a round
    env_bonds: List[frozenset] = [frozenset() for _ in mol.GetAtoms()]
    seen_envs = set()
    for atom_id in ids:
        fp[atom_id % n_bits] = 1.0

    for r in range(1, radius + 1):
        new_ids = list(ids)
        new_envs = list(env_bonds)
        round_items: List[Tuple[int, int, frozenset]] = []
        for a in mol.GetAtoms():
            if rdkit and not a._bond_idxs:
                # RDKit emits ONLY the radius-0 invariant for isolated
                # atoms (degree 0 -> no environment to grow; ECFP4 of
                # methane is exactly one bit).  The crc32 layout keeps
                # its original behavior — it is this repo's own frozen
                # layout and committed artifacts depend on it.
                continue
            nb = []
            bonds_here = set(env_bonds[a.idx])
            for bidx in a._bond_idxs:
                b = mol.GetBonds()[bidx]
                j = b.other(a.idx)
                code = (_rdkit_bond_code(b) if rdkit
                        else int(b.GetBondTypeAsDouble() * 2))
                nb.append((code, ids[j]))
                bonds_here.add(bidx)
                bonds_here |= env_bonds[j]
            nb.sort()
            stream = [r, ids[a.idx]]
            for code, nid in nb:
                stream.extend((code, nid))
            new_id = (_boost_hash_u32(stream) if rdkit
                      else _crc_ints(_TAG_ITER, stream))
            new_ids[a.idx] = new_id
            new_envs[a.idx] = frozenset(bonds_here)
            round_items.append((a.idx, new_id, frozenset(bonds_here)))
        # dedupe: identical environments (same bond set) set one bit
        for _, new_id, env in sorted(round_items, key=lambda t: t[1]):
            if env and env in seen_envs:
                continue
            if env:
                seen_envs.add(env)
            fp[new_id % n_bits] = 1.0
        ids, env_bonds = new_ids, new_envs
    return fp.reshape(1, -1)


def get_ecfp(smiles: str, radius: int = 2, nBits: int = 1024) -> np.ndarray:
    """Reference ``train.py:58-63`` equivalent."""
    mol = parse_smiles(smiles)
    return morgan_fingerprint(mol, radius=radius, n_bits=nBits)


def get_morgan_fingerprint(smiles: str, radius: int = 2,
                           nBits: int = 1024) -> np.ndarray:
    """Reference ``fingerprint/morgan=1024.py:55-60`` equivalent."""
    return get_ecfp(smiles, radius=radius, nBits=nBits)


def get_fcfp(smiles: str, radius: int = 2, nBits: int = 1024) -> np.ndarray:
    """Reference ``fingerprint/fcfp.py:55-59`` (Morgan ``useFeatures=True``)."""
    mol = parse_smiles(smiles)
    return morgan_fingerprint(mol, radius=radius, n_bits=nBits,
                              use_features=True)


# ---------------------------------------------------------------------------
# MACCS-like 167-bit structural keys
# ---------------------------------------------------------------------------

def get_maccs(smiles: str) -> np.ndarray:
    """167-bit structural-key fingerprint (reference ``fingerprint/maccs.py``).

    The true MACCS keys are 166 proprietary-SMARTS definitions; this is an
    open reimplementation over the same bit budget: element presence/counts,
    ring sizes and counts, bond classes, heteroatom environments, and common
    functional groups, each assigned a fixed key index.  Bit 0 is always
    zero, matching RDKit's 167-long layout.
    """
    mol = parse_smiles(smiles)
    bits = np.zeros((167,), dtype=np.float32)

    def setb(i: int, cond: bool = True) -> None:
        if cond:
            bits[i] = 1.0

    atoms = mol.GetAtoms()
    bonds = mol.GetBonds()
    syms = [a.GetSymbol() for a in atoms]
    counts: Dict[str, int] = {}
    for s in syms:
        counts[s] = counts.get(s, 0) + 1

    # 1-20: element presence
    element_keys = ["C", "N", "O", "S", "F", "Cl", "Br", "I", "P", "B",
                    "Si", "Se", "Na", "K", "Li", "Ca", "Mg", "Zn", "Fe", "*"]
    for k, el in enumerate(element_keys[:-1]):
        setb(1 + k, el in counts)
    setb(20, any(s not in element_keys for s in syms))

    # 21-40: element count thresholds
    for k, (el, th) in enumerate([("C", 4), ("C", 8), ("C", 12), ("C", 16),
                                  ("C", 20), ("N", 1), ("N", 2), ("N", 3),
                                  ("N", 4), ("O", 1), ("O", 2), ("O", 3),
                                  ("O", 4), ("S", 1), ("S", 2), ("F", 1),
                                  ("F", 2), ("Cl", 1), ("Br", 1), ("I", 1)]):
        setb(21 + k, counts.get(el, 0) >= th)

    # 41-50: ring statistics
    rings = mol.GetRingInfo()
    ring_sizes = [len(r) for r in rings]
    setb(41, len(rings) >= 1)
    setb(42, len(rings) >= 2)
    setb(43, len(rings) >= 3)
    setb(44, len(rings) >= 4)
    setb(45, 3 in ring_sizes)
    setb(46, 4 in ring_sizes)
    setb(47, 5 in ring_sizes)
    setb(48, 6 in ring_sizes)
    setb(49, 7 in ring_sizes)
    setb(50, 8 in ring_sizes)

    # 51-60: aromatic-ring statistics
    n_arom_rings = sum(1 for r in rings
                       if all(atoms[i].GetIsAromatic() for i in r))
    setb(51, n_arom_rings >= 1)
    setb(52, n_arom_rings >= 2)
    setb(53, n_arom_rings >= 3)
    n_het_arom = sum(1 for r in rings
                     if all(atoms[i].GetIsAromatic() for i in r)
                     and any(syms[i] != "C" for i in r))
    setb(54, n_het_arom >= 1)
    setb(55, n_het_arom >= 2)
    n_sat_rings = sum(1 for r in rings
                      if all(not atoms[i].GetIsAromatic() for i in r))
    setb(56, n_sat_rings >= 1)
    setb(57, n_sat_rings >= 2)
    setb(58, any(syms[i] == "N" and atoms[i].IsInRing() for i in range(len(atoms))))
    setb(59, any(syms[i] == "O" and atoms[i].IsInRing() for i in range(len(atoms))))
    setb(60, any(syms[i] == "S" and atoms[i].IsInRing() for i in range(len(atoms))))

    # 61-70: bond classes
    setb(61, any(b.order == 2 and not b.aromatic for b in bonds))
    setb(62, any(b.order == 3 for b in bonds))
    setb(63, any(b.aromatic for b in bonds))
    setb(64, sum(1 for b in bonds if b.order == 2 and not b.aromatic) >= 2)
    def has_bond(s1, s2, order):
        for b in bonds:
            pair = {syms[b.a1], syms[b.a2]}
            if pair == {s1, s2} or (s1 == s2 and pair == {s1}):
                if b.order == order:
                    return True
        return False
    setb(65, has_bond("C", "O", 2))   # carbonyl
    setb(66, has_bond("C", "N", 2))   # imine
    setb(67, has_bond("C", "N", 3))   # nitrile
    setb(68, has_bond("C", "S", 2))   # thiocarbonyl
    setb(69, has_bond("N", "O", 1) or has_bond("N", "O", 2))
    setb(70, has_bond("S", "O", 2))   # sulfonyl-ish

    # 71-100: functional-group environments via neighbor analysis
    def neighbors_syms(i):
        return sorted(syms[j] for j in atoms[i]._neighbors)

    for i, a in enumerate(atoms):
        ns = neighbors_syms(i)
        deg = a.GetDegree()
        hs = a.GetTotalNumHs()
        if syms[i] == "O" and hs >= 1 and deg == 1:
            # hydroxyl; carboxylic if attached C has =O
            setb(71)
            j = a._neighbors[0]
            if syms[j] == "C":
                for bi in atoms[j]._bond_idxs:
                    b = bonds[bi]
                    k = b.other(j)
                    if syms[k] == "O" and b.order == 2:
                        setb(72)  # carboxylic acid
        if syms[i] == "N" and hs >= 2:
            setb(73)  # primary amine
        if syms[i] == "N" and hs == 1 and deg == 2 and not a.GetIsAromatic():
            setb(74)  # secondary amine
        if syms[i] == "N" and deg == 3 and hs == 0 and not a.GetIsAromatic():
            setb(75)  # tertiary amine
        if syms[i] == "O" and deg == 2 and hs == 0 and not a.GetIsAromatic():
            setb(76)  # ether
        if syms[i] == "S" and hs >= 1:
            setb(77)  # thiol
        if syms[i] == "C" and a.GetIsAromatic() and any(
                s in ("F", "Cl", "Br", "I") for s in ns):
            setb(78)  # aryl halide
        if syms[i] == "C" and not a.GetIsAromatic() and any(
                s in ("F", "Cl", "Br", "I") for s in ns):
            setb(79)  # alkyl halide
        if syms[i] == "N" and a.GetFormalCharge() > 0:
            setb(80)
        if syms[i] == "O" and a.GetFormalCharge() < 0:
            setb(81)
        if syms[i] == "C" and ns.count("N") >= 2:
            setb(82)  # amidine/guanidine-like
        if syms[i] == "C" and ns.count("O") >= 2:
            setb(83)  # acetal / ester / acid carbon
        if syms[i] == "S" and ns.count("O") >= 2:
            setb(84)  # sulfone / sulfonamide S
        if syms[i] == "P":
            setb(85)
        if syms[i] == "C" and hs == 0 and deg == 4:
            setb(86)  # quaternary carbon
        if a.GetIsAromatic() and syms[i] == "N" and hs == 1:
            setb(87)  # pyrrole-type NH
        if a.GetIsAromatic() and syms[i] == "N" and hs == 0:
            setb(88)  # pyridine-type N
    # amide: C(=O)N
    for b in bonds:
        i, j = b.a1, b.a2
        for c, n in ((i, j), (j, i)):
            if syms[c] == "C" and syms[n] == "N" and b.order == 1:
                for bi in atoms[c]._bond_idxs:
                    b2 = bonds[bi]
                    if syms[b2.other(c)] == "O" and b2.order == 2:
                        setb(89)  # amide
        # ester: C(=O)O-C
        for c, o in ((i, j), (j, i)):
            if syms[c] == "C" and syms[o] == "O" and b.order == 1 \
                    and atoms[o].GetDegree() == 2:
                for bi in atoms[c]._bond_idxs:
                    b2 = bonds[bi]
                    if syms[b2.other(c)] == "O" and b2.order == 2:
                        setb(90)  # ester

    # 101-130: path/size statistics
    n = len(atoms)
    setb(101, n >= 10)
    setb(102, n >= 15)
    setb(103, n >= 20)
    setb(104, n >= 25)
    setb(105, n >= 30)
    setb(106, n >= 40)
    n_hetero = sum(1 for s in syms if s not in ("C",))
    for k, th in enumerate((1, 2, 3, 4, 5, 7, 9)):
        setb(107 + k, n_hetero >= th)
    n_branch = sum(1 for a in atoms if a.GetDegree() >= 3)
    for k, th in enumerate((1, 2, 3, 4, 6)):
        setb(114 + k, n_branch >= th)
    setb(119, any(a.GetDegree() >= 4 for a in atoms))
    n_rot = D.num_rotatable_bonds(mol)
    for k, th in enumerate((1, 2, 3, 5, 7, 10)):
        setb(120 + k, n_rot >= th)

    # 131-166: pairwise element adjacency (folded)
    pair_keys = [("C", "C"), ("C", "N"), ("C", "O"), ("C", "S"), ("C", "F"),
                 ("C", "Cl"), ("C", "Br"), ("C", "I"), ("C", "P"), ("N", "N"),
                 ("N", "O"), ("N", "S"), ("O", "O"), ("O", "S"), ("O", "P"),
                 ("S", "S"), ("N", "P")]
    for b in bonds:
        pair = tuple(sorted((syms[b.a1], syms[b.a2])))
        for k, pk in enumerate(pair_keys):
            if pair == tuple(sorted(pk)):
                setb(131 + k)
    # aromatic vs aliphatic fractions
    n_arom = sum(1 for a in atoms if a.GetIsAromatic())
    setb(150, n_arom > 0)
    setb(151, n_arom >= 6)
    setb(152, n_arom >= 10)
    setb(153, n_arom * 2 >= n)
    setb(154, n - n_arom >= 5)
    setb(155, mol.NumRings() >= 1 and n - sum(len(r) for r in rings) >= 3)
    # charge states
    setb(156, any(a.GetFormalCharge() > 0 for a in atoms))
    setb(157, any(a.GetFormalCharge() < 0 for a in atoms))
    setb(158, sum(a.GetFormalCharge() for a in atoms) != 0)
    # H-bonding capacity
    setb(159, D.num_h_donors(mol) >= 1)
    setb(160, D.num_h_donors(mol) >= 2)
    setb(161, D.num_h_acceptors(mol) >= 1)
    setb(162, D.num_h_acceptors(mol) >= 3)
    setb(163, D.num_h_acceptors(mol) >= 5)
    setb(164, len([1 for a in atoms if a.GetTotalNumHs() == 0 and a.GetDegree() >= 3]) >= 2)
    setb(165, len(rings) >= 1 and any(len(r) >= 7 for r in rings))
    setb(166, mol.GetNumBonds() - len(atoms) + 1 >= 3)

    return bits.reshape(1, -1)


# ---------------------------------------------------------------------------
# SMIFP (reference's custom SMILES n-gram fingerprint)
# ---------------------------------------------------------------------------

_SMIFP_CHARSET = ['C', 'N', 'O', 'S', 'P', 'F', 'Cl', 'Br', 'I', 'H',
                  '(', ')', '[', ']', '=', '#', '@', '+', '-', '\\', '/',
                  '1', '2', '3', '4', '5', '6', '7', '8', '9', '0',
                  'c', 'n', 'o', 's', 'p']


def get_smifp(smiles: str, nbits: int = 1024) -> np.ndarray:
    """SMILES n-gram fingerprint (reference ``fingerprint/SMIFP.py:55-92``).

    Three feature families hashed into one bit vector: (1) all 1-3 character
    n-grams, (2) per-character occurrence counts (capped at 10) for a fixed
    charset, (3) unary-coded string length mod 100.  Divergence from the
    reference: we hash with CRC32 instead of Python's process-salted
    ``hash()`` so fingerprints are reproducible across runs; the reference's
    are not unless PYTHONHASHSEED is pinned.
    """
    fp = np.zeros((nbits,), dtype=np.float32)
    if not smiles:
        return fp.reshape(1, -1)
    for ng in range(1, 4):
        for i in range(len(smiles) - ng + 1):
            fp[_stable_hash("ngram", smiles[i:i + ng]) % nbits] = 1.0
    char_counts: Dict[str, int] = {}
    for ch in smiles:
        if ch in _SMIFP_CHARSET:
            char_counts[ch] = char_counts.get(ch, 0) + 1
    for ch, cnt in char_counts.items():
        for j in range(min(cnt, 10)):
            fp[_stable_hash("charcount", ch, j) % nbits] = 1.0
    for i in range(len(smiles) % 100):
        fp[_stable_hash("length", i) % nbits] = 1.0
    return fp.reshape(1, -1)


# ---------------------------------------------------------------------------
# BCI (layered path fingerprint + descriptor block)
# ---------------------------------------------------------------------------

def _layered_fingerprint(mol: Mol, fp_size: int = 512,
                         max_path: int = 7) -> np.ndarray:
    """Linear bond-path fingerprint in the spirit of RDKit's
    ``LayeredFingerprint`` — hashes all simple bond paths up to ``max_path``
    bonds under several "layers" (bond order / aromaticity / element)."""
    fp = np.zeros((fp_size,), dtype=np.float32)
    bonds = mol.GetBonds()
    syms = [a.GetSymbol() for a in mol.GetAtoms()]

    def dfs(atom: int, path: List[int], visited_bonds: set) -> None:
        if path:
            # emit the path under three layers
            bond_desc = []
            elem_desc = [syms[atom]]
            cur = atom
            for bidx in reversed(path):
                b = bonds[bidx]
                prev = b.other(cur)
                bond_desc.append(("ar" if b.aromatic else b.order))
                elem_desc.append(syms[prev])
                cur = prev
            fp[_stable_hash("layer_bond", tuple(bond_desc)) % fp_size] = 1.0
            fp[_stable_hash("layer_elem", tuple(elem_desc)) % fp_size] = 1.0
            fp[_stable_hash("layer_both", tuple(bond_desc),
                            tuple(elem_desc)) % fp_size] = 1.0
        if len(path) >= max_path:
            return
        for bidx in mol.GetAtoms()[atom]._bond_idxs:
            if bidx in visited_bonds:
                continue
            nxt = bonds[bidx].other(atom)
            visited_bonds.add(bidx)
            path.append(bidx)
            dfs(nxt, path, visited_bonds)
            path.pop()
            visited_bonds.discard(bidx)

    for start in range(mol.GetNumAtoms()):
        dfs(start, [], set())
    return fp


def get_bci_fingerprint(smiles: str, nBits: int = 1024) -> np.ndarray:
    """Layered-FP(512) concatenated with a descriptor block padded to 512
    (reference ``fingerprint/BCI.py:55-155``)."""
    mol = parse_smiles(smiles)
    base = _layered_fingerprint(mol, fp_size=512)
    desc = np.asarray(D.bci_descriptor_block(mol), dtype=np.float32)
    desc = np.nan_to_num(desc, nan=0.0, posinf=1.0, neginf=-1.0)
    if len(desc) < 512:
        desc = np.pad(desc, (0, 512 - len(desc)))
    else:
        desc = desc[:512]
    fp = np.concatenate([base, desc])
    if len(fp) > nBits:
        fp = fp[:nBits]
    elif len(fp) < nBits:
        fp = np.pad(fp, (0, nBits - len(fp)))
    return fp.astype(np.float32).reshape(1, -1)


# Registry used by the data pipeline / config presets.
def _morgan_rdkit(s: str, n_bits: int, use_features: bool = False):
    return morgan_fingerprint(parse_smiles(s), radius=2, n_bits=n_bits,
                              use_features=use_features,
                              bit_layout="rdkit")


FINGERPRINTS = {
    "ecfp1024": lambda s: get_ecfp(s, radius=2, nBits=1024),
    "ecfp2048": lambda s: get_ecfp(s, radius=2, nBits=2048),
    "morgan1024": lambda s: get_morgan_fingerprint(s, radius=2, nBits=1024),
    "morgan2048": lambda s: get_morgan_fingerprint(s, radius=2, nBits=2048),
    "fcfp1024": lambda s: get_fcfp(s, radius=2, nBits=1024),
    "maccs": lambda s: get_maccs(s),
    "smifp": lambda s: get_smifp(s, nbits=1024),
    "bci": lambda s: get_bci_fingerprint(s, nBits=1024),
    # RDKit-bit-position variants (VERDICT r3 next #2b): same Morgan
    # algorithm, RDKit's published invariant+hash pipeline, for feeding
    # imported checkpoints whose CNN branch was trained on RDKit bits
    # (use with e.g. get_config("flagship", fingerprint="ecfp1024_rdkit")
    # or `mgat-compat import --fingerprint-layout rdkit`).  Python-only:
    # the C++ fast path covers the default layout and falls back cleanly.
    "ecfp1024_rdkit": lambda s: _morgan_rdkit(s, 1024),
    "ecfp2048_rdkit": lambda s: _morgan_rdkit(s, 2048),
    "morgan1024_rdkit": lambda s: _morgan_rdkit(s, 1024),
    "morgan2048_rdkit": lambda s: _morgan_rdkit(s, 2048),
    "fcfp1024_rdkit": lambda s: _morgan_rdkit(s, 1024, use_features=True),
}

FINGERPRINT_DIMS = {
    "ecfp1024": 1024, "ecfp2048": 2048, "morgan1024": 1024,
    "morgan2048": 2048, "fcfp1024": 1024, "maccs": 167,
    "smifp": 1024, "bci": 1024,
    "ecfp1024_rdkit": 1024, "ecfp2048_rdkit": 2048,
    "morgan1024_rdkit": 1024, "morgan2048_rdkit": 2048,
    "fcfp1024_rdkit": 1024,
}
