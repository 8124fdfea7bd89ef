"""Data layer: CSV ingestion, target scaling, native or Python
featurisation, fixed-shape padding and batching, bucketing, compact
storage (``packed.py``), the synthetic dataset generator (``synth.py``)
and the paths of the bundled splits.

In a source checkout the splits are the committed ``<repo>/datasets``.
An installed package has no repo tree above it, so the paths point into
``~/.cache/mgat_graphsage_torch/datasets`` instead, and the splits are
written there on first use (:func:`ensure_bundled_datasets`):
``generate_splits(seed=42)`` is the generator that froze the committed
files, and writes them byte for byte.
"""

import os as _os

from .dataset import (
    GraphBatch,
    MolecularDataset,
    StandardScaler,
    load_csv,
    pad_to_multiple,
    write_csv,
)
from .synth import generate_dataset, generate_splits

CACHE_DIR = _os.path.join(_os.path.expanduser("~"), ".cache",
                          "mgat_graphsage_torch", "datasets")


def _resolve_dataset_dir(root: str) -> str:
    """``<root>/datasets`` if it holds ``train_data.csv``, else the cache.
    The probe is for the split file, not the directory: in site-packages a
    foreign ``datasets`` package would satisfy a directory check."""
    local = _os.path.join(root, "datasets")
    if _os.path.isfile(_os.path.join(local, "train_data.csv")):
        return local
    return CACHE_DIR


DATASET_DIR = _resolve_dataset_dir(_os.path.dirname(_os.path.dirname(
    _os.path.dirname(_os.path.abspath(__file__)))))
TRAIN_CSV = _os.path.join(DATASET_DIR, "train_data.csv")
VAL_CSV = _os.path.join(DATASET_DIR, "validation_data.csv")
TEST_CSV = _os.path.join(DATASET_DIR, "test_data.csv")
FULL_CSV = _os.path.join(DATASET_DIR, "full_data.csv")


def ensure_bundled_datasets() -> str:
    """Write the seed-42 splits to the bundled paths if any is missing
    (~7 s once); a no-op in a source checkout.  Returns the directory."""
    paths = (TRAIN_CSV, VAL_CSV, TEST_CSV, FULL_CSV)
    if all(_os.path.exists(p) for p in paths):
        return _os.path.dirname(TRAIN_CSV)
    _os.makedirs(_os.path.dirname(TRAIN_CSV), exist_ok=True)
    (tr_s, tr_y), (va_s, va_y), (te_s, te_y) = generate_splits(
        n_train=3000, n_val=500, n_test=961, seed=42)
    write_csv(TRAIN_CSV, tr_s, tr_y)
    write_csv(VAL_CSV, va_s, va_y)
    write_csv(TEST_CSV, te_s, te_y)
    write_csv(FULL_CSV, tr_s + va_s + te_s,
              list(tr_y) + list(va_y) + list(te_y))
    return _os.path.dirname(TRAIN_CSV)


__all__ = [
    "GraphBatch", "MolecularDataset", "StandardScaler", "load_csv",
    "pad_to_multiple", "write_csv", "generate_dataset", "generate_splits",
    "DATASET_DIR", "TRAIN_CSV", "VAL_CSV", "TEST_CSV", "FULL_CSV",
    "ensure_bundled_datasets",
]
