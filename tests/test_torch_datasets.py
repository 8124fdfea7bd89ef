"""The port's bundled-dataset fallback (``mgat_graphsage_torch/data``):
where ``<repo>/datasets/train_data.csv`` is missing, an installed package
reads its splits from ``~/.cache/mgat_graphsage_torch/datasets`` and
writes them there on first use, byte for byte the committed CSVs, with
the generator copied from the reference package (``data/synth.py``)."""

import filecmp
import os

import pytest

import mgat_graphsage_torch.data as tdata
from mgat_graphsage_torch.data import (
    ensure_bundled_datasets,
    generate_dataset,
    load_csv,
)
from mgat_graphsage_tpu.data import generate_dataset as jgenerate_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("train_data.csv", "validation_data.csv", "test_data.csv",
         "full_data.csv")
KEYS = ("TRAIN_CSV", "VAL_CSV", "TEST_CSV", "FULL_CSV")


def _point_at(monkeypatch, directory):
    for key, name in zip(KEYS, NAMES):
        monkeypatch.setattr(tdata, key, str(directory / name))


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    """``load_csv`` of a bundled split path in an empty directory: it
    writes all four splits there first (``ensure_bundled_datasets``; the
    one ~7 s generation of this file).  Returns the directory and what
    was read."""
    directory = tmp_path_factory.mktemp("cache") / "datasets"
    mp = pytest.MonkeyPatch()
    _point_at(mp, directory)
    try:
        assert not directory.exists()
        loaded = load_csv(str(directory / "validation_data.csv"))
    finally:
        mp.undo()
    return directory, loaded


@pytest.mark.parametrize("name", NAMES)
def test_regenerated_split_is_byte_identical(regenerated, name):
    directory, _ = regenerated
    assert filecmp.cmp(directory / name,
                       os.path.join(REPO, "datasets", name), shallow=False)


def test_load_csv_reads_the_regenerated_split(regenerated):
    _, (smiles, y) = regenerated
    want_smiles, want_y = load_csv(os.path.join(REPO, "datasets",
                                                "validation_data.csv"))
    assert len(smiles) == 500
    assert smiles == want_smiles and (y == want_y).all()


def test_ensure_is_a_no_op_when_present(regenerated, monkeypatch):
    directory, _ = regenerated
    _point_at(monkeypatch, directory)
    before = {n: os.stat(directory / n).st_mtime_ns for n in NAMES}
    assert ensure_bundled_datasets() == str(directory)
    assert before == {n: os.stat(directory / n).st_mtime_ns for n in NAMES}


def test_load_csv_of_a_missing_foreign_path_raises(tmp_path, monkeypatch):
    _point_at(monkeypatch, tmp_path / "datasets")
    with pytest.raises(FileNotFoundError):
        load_csv(str(tmp_path / "elsewhere.csv"))
    assert not (tmp_path / "datasets").exists()


def test_dataset_dir_resolution(tmp_path):
    """A checkout with the split file resolves to it; a foreign
    ``datasets/`` without ``train_data.csv``, or none, to the port's own
    cache (never the reference package's)."""
    assert tdata._resolve_dataset_dir(REPO) == os.path.join(REPO,
                                                            "datasets")
    foreign = tmp_path / "site"
    (foreign / "datasets").mkdir(parents=True)
    (foreign / "datasets" / "__init__.py").write_text("")
    cache = os.path.join(os.path.expanduser("~"), ".cache",
                         "mgat_graphsage_torch", "datasets")
    assert tdata._resolve_dataset_dir(str(foreign)) == cache
    assert tdata._resolve_dataset_dir(str(tmp_path / "none")) == cache
    assert tdata.CACHE_DIR == cache
    assert tdata.DATASET_DIR == os.path.join(REPO, "datasets")


@pytest.mark.parametrize("n,seed", [(40, 42), (25, 7)])
def test_generate_dataset_matches_reference(n, seed):
    smiles, targets = generate_dataset(n, seed=seed)
    jsmiles, jtargets = jgenerate_dataset(n, seed=seed)
    assert smiles == jsmiles
    assert targets == jtargets
