"""Morgan / ECFP / FCFP circular fingerprints, implemented from scratch (no
RDKit).

The Morgan part of ``mgat_graphsage_tpu/chem/fingerprints.py``, copied so
that the port imports nothing of that package: the default CRC32 bit
layout (reference ``train.py:58-63``, ``fingerprint/morgan=1024.py``,
``morgan=2048.py``, ``ecfp=2024.py``, ``fcfp.py``) and the opt-in RDKit
layout.  The MACCS, SMIFP and BCI families are not ported yet.

All functions return float32 arrays of shape ``[1, nBits]``.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from .smiles import Mol, parse_smiles

__all__ = [
    "morgan_fingerprint",
    "get_ecfp",
    "get_morgan_fingerprint",
    "get_fcfp",
    "FINGERPRINTS",
    "FINGERPRINT_DIMS",
]


# Morgan hashing uses a language-portable integer stream (uint32 LE +
# CRC32), shared bit-identically with the reference package's C++
# featurizer. Tags namespace the hash families.
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
    "ecfp1024_rdkit": lambda s: _morgan_rdkit(s, 1024),
    "ecfp2048_rdkit": lambda s: _morgan_rdkit(s, 2048),
    "morgan1024_rdkit": lambda s: _morgan_rdkit(s, 1024),
    "morgan2048_rdkit": lambda s: _morgan_rdkit(s, 2048),
    "fcfp1024_rdkit": lambda s: _morgan_rdkit(s, 1024, use_features=True),
}

FINGERPRINT_DIMS = {
    "ecfp1024": 1024, "ecfp2048": 2048, "morgan1024": 1024,
    "morgan2048": 2048, "fcfp1024": 1024,
    "ecfp1024_rdkit": 1024, "ecfp2048_rdkit": 2048,
    "morgan1024_rdkit": 1024, "morgan2048_rdkit": 2048,
    "fcfp1024_rdkit": 1024,
}
