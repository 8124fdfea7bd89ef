"""Data layer: CSV ingestion, target scaling, native or Python
featurisation, fixed-shape padding and batching, bucketing, compact
storage (``packed.py``), and the paths of the bundled splits
(``<repo>/datasets``)."""

import os as _os

from .dataset import (
    GraphBatch,
    MolecularDataset,
    StandardScaler,
    load_csv,
    pad_to_multiple,
    write_csv,
)

DATASET_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(
    _os.path.dirname(_os.path.abspath(__file__)))), "datasets")
TRAIN_CSV = _os.path.join(DATASET_DIR, "train_data.csv")
VAL_CSV = _os.path.join(DATASET_DIR, "validation_data.csv")
TEST_CSV = _os.path.join(DATASET_DIR, "test_data.csv")
FULL_CSV = _os.path.join(DATASET_DIR, "full_data.csv")

__all__ = [
    "GraphBatch", "MolecularDataset", "StandardScaler", "load_csv",
    "pad_to_multiple", "write_csv",
    "DATASET_DIR", "TRAIN_CSV", "VAL_CSV", "TEST_CSV", "FULL_CSV",
]
