"""Chemistry layer: SMILES parsing, featurization, fingerprints,
descriptors and SMILES writing.

Self-contained copies of the reference package's numpy-only chemistry
(no RDKit, no JAX)."""

from .smiles import Mol, MolFromSmiles, parse_smiles, SmilesParseError
from .featurize import (
    ATOM_SYMBOLS,
    NUM_ATOM_FEATURES,
    NUM_RAW_FEATURES,
    atom_features_35,
    atom_features_5,
    mol_to_graph,
    one_of_k_encoding_unk,
    smiles_to_graph,
    smiles_to_padded_graph,
)

__all__ = [
    "Mol", "MolFromSmiles", "parse_smiles", "SmilesParseError",
    "ATOM_SYMBOLS", "NUM_ATOM_FEATURES", "NUM_RAW_FEATURES",
    "atom_features_35", "atom_features_5", "mol_to_graph",
    "one_of_k_encoding_unk", "smiles_to_graph", "smiles_to_padded_graph",
]
