"""The port's native featuriser (``csrc/featurizer.cpp`` through
``chem/native.py``) on the CPU: bit for bit the port's Python chemistry
layer and the reference package's native library, on the same SMILES.

Tolerance: none; every array is compared for equality.
"""

import os
import shutil
import threading

import numpy as np
import pytest

from mgat_graphsage_tpu.chem.native import (
    featurize_batch_native as jax_featurize_batch_native,
)
from mgat_graphsage_tpu.data import MolecularDataset as JaxDataset
from mgat_graphsage_tpu.data import write_csv as jax_write_csv

from mgat_graphsage_torch.chem import native, smiles_to_graph
from mgat_graphsage_torch.chem.fingerprints import get_ecfp, get_fcfp
from mgat_graphsage_torch.data import (
    TEST_CSV,
    TRAIN_CSV,
    MolecularDataset,
    load_csv,
    write_csv,
)
from mgat_graphsage_torch.data.dataset import NATIVE_BUDGET
from mgat_graphsage_torch.ops import _build

CORPUS = [
    "C", "CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O",
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "C1CC2CCC1CC2", "CS(=O)(=O)c1ccccc1",
    "c1cc[nH]c1", "C1CN(CCc2ccccc2)CCN1C", "[NH4+].[Cl-]",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "N#Cc1ccccc1F", "C/C=C/C(=O)O",
    "c1ccc2[nH]c(Sc3ccccc3)nc2c1", "OCC(O)C(O)C(O)C(O)CO",
]
FIELDS = ("nodes", "edges", "node_mask", "edge_mask", "fp", "kept_indices",
          "y", "y_orig")


def _assert_same_outputs(ours, ref):
    for i, (a, b) in enumerate(zip(ours, ref)):
        if b is None:
            assert a is None, i
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")


def _assert_matches_python(res, smiles, featurizer="35", fp_fn=get_ecfp):
    nodes, edges, node_mask, edge_mask, fp, status = res
    for i, smi in enumerate(smiles):
        pf, pe = smiles_to_graph(smi, featurizer=featurizer)
        assert status[i] == pf.shape[0], smi
        np.testing.assert_array_equal(nodes[i, :pf.shape[0]], pf,
                                      err_msg=smi)
        assert not nodes[i, pf.shape[0]:].any(), smi
        np.testing.assert_array_equal(edges[i, :, :pe.shape[1]], pe,
                                      err_msg=smi)
        assert not edges[i, :, pe.shape[1]:].any(), smi
        assert int(node_mask[i].sum()) == pf.shape[0] \
            and node_mask[i, :pf.shape[0]].all()
        assert int(edge_mask[i].sum()) == pe.shape[1] \
            and edge_mask[i, :pe.shape[1]].all()
        if fp is not None:
            np.testing.assert_array_equal(fp[i], fp_fn(smi).reshape(-1),
                                          err_msg=smi)


@pytest.fixture(scope="module")
def train_sample():
    return load_csv(TRAIN_CSV)[0][:150]


@pytest.mark.parametrize("which", ["corpus", "train150"])
def test_equal_to_python_path_and_reference_library(which, train_sample):
    smiles, budget = (CORPUS, (64, 160)) if which == "corpus" \
        else (train_sample, (96, 224))
    res = native.featurize_batch_native(smiles, 35, *budget, fp_bits=1024)
    _assert_matches_python(res, smiles)
    _assert_same_outputs(res, jax_featurize_batch_native(
        smiles, 35, *budget, fp_bits=1024))


def test_fcfp_variant():
    res = native.featurize_batch_native(CORPUS, 35, 64, 160, fp_bits=1024,
                                        use_features=True)
    _assert_matches_python(res, CORPUS, fp_fn=get_fcfp)
    _assert_same_outputs(res, jax_featurize_batch_native(
        CORPUS, 35, 64, 160, fp_bits=1024, use_features=True))


def test_raw5_featurizer():
    res = native.featurize_batch_native(CORPUS, 5, 64, 160)
    assert res[4] is None
    _assert_matches_python(res, CORPUS, featurizer="5")
    _assert_same_outputs(res, jax_featurize_batch_native(CORPUS, 5, 64, 160))


def test_error_codes():
    status = native.featurize_batch_native(
        ["C1CC(", "xx", "", "CCO"], 35, 64, 160)[5]
    assert list(status[:3]) == [-1, -1, -1] and status[3] == 3
    # a NUL inside a SMILES fails to parse as in the Python path, rather
    # than cutting the string short at the NUL
    nodes, _, node_mask, _, fp, status = native.featurize_batch_native(
        ["CCO\x00X", "CCO"], 35, 64, 160, fp_bits=1024)
    assert list(status) == [-1, 3]
    assert not nodes[0].any() and not node_mask[0].any() and not fp[0].any()
    with pytest.raises(ValueError):
        smiles_to_graph("CCO\x00X")
    nodes, _, node_mask, edge_mask, _, status = \
        native.featurize_batch_native(["CCCCCCCCCC", "CC"], 35, 4, 160)
    assert status[0] == -2 and status[1] == 2
    assert not node_mask[0].any() and not edge_mask[0].any()
    # 10 carbons fit 16 nodes, but their 18 directed edges not 16
    assert native.featurize_batch_native(["CCCCCCCCCC"], 35, 16, 16)[5][0] \
        == -3
    assert all(len(a) == 0 for a in native.featurize_batch_native(
        [], 35, 8, 16)[:4])


def test_dataset_native_equals_python_path_on_the_test_csv():
    smiles, y = load_csv(TEST_CSV)
    smiles = smiles[:300] + ["C1CC("] + smiles[300:]
    y = np.concatenate([y[:300], [5.0], y[300:]])
    ours = MolecularDataset(smiles, y, fit_scaler=True, verbose=False)
    python = MolecularDataset(smiles, y, fit_scaler=True, verbose=False,
                              use_native=False)
    assert len(ours) == len(smiles) - 1 and 300 not in ours.kept_indices
    assert ours.smiles == python.smiles
    assert (ours.max_nodes, ours.max_edges) == (python.max_nodes,
                                                python.max_edges)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(python, name), err_msg=name)


@pytest.mark.parametrize("fingerprint,featurizer", [
    ("ecfp2048", "35"), ("fcfp1024", "35"), (None, "5"), ("morgan1024", "5")])
def test_dataset_native_covers_the_library_configs(fingerprint, featurizer):
    smiles, y = CORPUS + ["C1CC("], np.arange(16, dtype=np.float32)
    kw = dict(fingerprint=fingerprint, featurizer=featurizer, verbose=False)
    ours = MolecularDataset(smiles, y, **kw)
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(ours, name),
            getattr(MolecularDataset(smiles, y, use_native=False, **kw),
                    name), err_msg=name)
        np.testing.assert_array_equal(
            getattr(ours, name), getattr(JaxDataset(smiles, y, **kw), name),
            err_msg=name)


@pytest.fixture(scope="module")
def test_csv_datasets():
    """(the port's, the reference's) dataset of the bundled test CSV."""
    smiles, y = load_csv(TEST_CSV)
    return (MolecularDataset(smiles, y, fit_scaler=True, verbose=False),
            JaxDataset(smiles, y, fit_scaler=True, verbose=False))


BATCHINGS = {
    "batches": lambda ds: ds.batches(100),
    "batches_shuffled": lambda ds: ds.batches(100, shuffle=True, seed=3),
    "batches_drop_last": lambda ds: ds.batches(100, shuffle=True, seed=1,
                                               drop_last=True),
    "batches_unpadded": lambda ds: ds.batches(100, pad_final=False),
    "bucketed": lambda ds: ds.bucketed_batches(64),
    "bucketed_shuffled": lambda ds: ds.bucketed_batches(
        64, buckets=(16, 24, 40), shuffle=True, seed=2),
    "bucketed_unpadded": lambda ds: ds.bucketed_batches(64, pad_final=False),
}


@pytest.mark.parametrize("how", sorted(BATCHINGS))
def test_batches_equal_the_reference_datasets(how, test_csv_datasets):
    """Every array of every batch, pad rows included, as the reference
    dataset yields it from the same CSV."""
    ours, ref = test_csv_datasets
    got, want = list(BATCHINGS[how](ours)), list(BATCHINGS[how](ref))
    assert len(got) == len(want) > 1
    for i, (a, b) in enumerate(zip(got, want)):
        b = b.as_dict()
        assert a.as_dict().keys() == b.keys()
        for name, v in a.as_dict().items():
            assert v.dtype == b[name].dtype, (i, name)
            np.testing.assert_array_equal(v, b[name], err_msg=f"{i} {name}")
    for drop_last in (False, True):
        assert ours.num_batches(100, drop_last) == \
            ref.num_batches(100, drop_last)


def test_bucket_plan_view_and_csv_equal_the_reference(test_csv_datasets,
                                                      tmp_path):
    ours, ref = test_csv_datasets
    for buckets in ((32, 48, 64, 96), (16, 24, 40), (1000,)):
        got, want = ours.bucket_plan(buckets), ref.bucket_plan(buckets)
        assert [(n, e) for n, e, _ in got] == [(n, e) for n, e, _ in want]
        for (_, _, a), (_, _, b) in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for bn, be, idx in ours.bucket_plan((16, 24, 40)):
        a, b = ours.bucket_view(bn, be, idx), ref.bucket_view(bn, be, idx)
        assert a.smiles == b.smiles
        for name in ("max_nodes", "max_edges", "feature_dim", "fp_dim",
                     "fingerprint", "n"):
            assert getattr(a, name) == getattr(b, name), name
        for name in FIELDS:
            assert getattr(a, name).dtype == getattr(b, name).dtype, name
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
    paths = [str(tmp_path / w / "out.csv") for w in ("ours", "ref")]
    write_csv(paths[0], ours.smiles, ours.y_orig)
    jax_write_csv(paths[1], ref.smiles, ref.y_orig)
    got, want = (open(p, "rb").read() for p in paths)
    assert got == want and got.startswith(b"Smiles,pchembl\n")


def test_molecule_past_the_native_budget_is_dropped_as_the_reference_does(
        capsys):
    big = "C" * (NATIVE_BUDGET[0] + 2)                  # 130 atoms
    smiles = ["CCO", big, "c1ccccc1"]
    y = np.array([5.0, 6.0, 7.0], np.float32)
    ours = MolecularDataset(smiles, y)
    out = capsys.readouterr().out
    assert f"[data] molecule exceeds native budget: {big!r}" in out
    ref = JaxDataset(smiles, y, verbose=False)
    np.testing.assert_array_equal(ours.kept_indices, [0, 2])
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name), err_msg=name)
    # the Python path keeps it
    python = MolecularDataset(smiles, y, use_native=False, verbose=False)
    assert list(python.kept_indices) == [0, 1, 2]
    assert python.max_nodes == 136


def _featurize(monkeypatch, workers, smiles, *args, **kwargs):
    """``featurize_batch_native`` with the library asked for ``workers``
    threads in place of the rule's."""
    monkeypatch.setattr(native, "worker_count", lambda n: workers)
    return native.featurize_batch_native(smiles, *args, **kwargs)


@pytest.mark.parametrize("workers", [None, 4])
def test_threads_featurise_at_once(train_sample, workers, monkeypatch):
    """Four callers at once, each with the rule's workers or four of its
    own: every call returns the one-thread bytes."""
    rule = native.worker_count
    want = _featurize(monkeypatch, 1, train_sample, 35, 96, 224,
                      fp_bits=1024)
    monkeypatch.setattr(native, "worker_count",
                        rule if workers is None else lambda n: workers)
    got, errors = [None] * 4, []
    gate = threading.Barrier(4)

    def work(i):
        try:
            gate.wait()
            got[i] = [native.featurize_batch_native(
                train_sample, 35, 96, 224, fp_bits=1024)
                for _ in range(3)]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for runs in got:
        for res in runs:
            _assert_same_outputs(res, want)


# a failing SMILES of each kind, for the budget (64, 100): -1 unparseable,
# -2 past 64 atoms, -3 past 100 directed edges (55 carbons: 108), -1 a NUL
FAILING = {"C1CC(": -1, "C" * 70: -2, "C" * 55: -3, "CCO\x00X": -1}
# the first and last molecules of the library's blocks of 16
BLOCK_EDGES = (0, 15, 16, 17, 31, 32, 47, 48, 63)


def _mixed(n):
    """``n`` bundled SMILES with the failing ones placed on block edges."""
    pool = load_csv(TRAIN_CSV)[0]
    smiles = [pool[i % len(pool)] for i in range(n)]
    edges = sorted({i for i in BLOCK_EDGES if i < n} | {n - 1} if n else ())
    for k, i in enumerate(edges):
        smiles[i] = list(FAILING)[k % len(FAILING)]
    return smiles


_ONE_THREAD = {}


def _one_thread(n, monkeypatch):
    if n not in _ONE_THREAD:
        _ONE_THREAD[n] = _featurize(monkeypatch, 1, _mixed(n), 35, 64, 100,
                                    fp_bits=1024)
    return _ONE_THREAD[n]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 64, 1000])
@pytest.mark.parametrize("workers", [2, 3, 8])
def test_workers_give_the_one_thread_bytes(workers, n, monkeypatch):
    """Split over workers, a call returns bit for bit what one thread
    returns, failing molecules on the blocks' edges included."""
    smiles, want = _mixed(n), _one_thread(n, monkeypatch)
    status = want[5]
    for i, smi in enumerate(smiles):
        assert status[i] == FAILING.get(smi, status[i]) and status[i] != 0, i
    if n >= 17:
        assert {-1, -2, -3} <= set(status.tolist()) and (status > 0).any()
    _assert_same_outputs(_featurize(monkeypatch, workers, smiles, 35, 64,
                                    100, fp_bits=1024), want)


@pytest.mark.parametrize("n,workers,ran", [
    (0, 4, 1), (1, 16, 1), (5, 1000, 1), (40, 64, 3), (1000, 1000, 63)])
def test_more_workers_than_molecules(n, workers, ran, monkeypatch):
    """More workers than molecules (or blocks of 16 of them) work, give the
    one-thread bytes, and are counted as the workers the library ran: one
    a block at most."""
    before = native.counts()
    res = _featurize(monkeypatch, workers, _mixed(n), 35, 64, 100,
                     fp_bits=1024)
    after = native.counts()
    assert len(res[5]) == n
    assert {k: after[k] - before[k] for k in native.COUNTERS} == {
        "calls": 1, "parallel_calls": int(ran > 1), "molecules": n,
        "workers": ran}
    _assert_same_outputs(res, _one_thread(n, monkeypatch))


@pytest.mark.parametrize("cpus,cpu_max,n,want", [
    (8, None, 0, 1), (8, None, 1, 1), (8, None, 127, 1), (64, None, 127, 1),
    (8, None, 128, 2), (8, None, 4096, 8), (64, None, 4096, 64),
    (2, None, 4096, 2), (1, None, 4096, 1), (8, "max 100000", 4096, 8),
    (8, "200000 100000", 4096, 2), (8, "150000 100000", 4096, 2),
    (8, "50000 100000", 4096, 1), (2, "800000 100000", 4096, 2),
    (8, "garbled", 4096, 8), (8, "x 100000", 4096, 8), (8, "1 0", 4096, 8),
])
def test_worker_rule(cpus, cpu_max, n, want, monkeypatch, tmp_path):
    """One worker below 128 molecules; else one per 64 molecules, never more
    than the CPUs of the process's affinity or its cgroup quota (rounded
    up)."""
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(cpus)))
    path = tmp_path / "cpu.max"
    if cpu_max is not None:
        path.write_text(cpu_max + "\n")
    monkeypatch.setattr(native, "CGROUP_CPU_MAX", str(path))
    assert native.worker_count(n) == want
    assert native.worker_count(n) <= native.usable_cpus() <= cpus


class _FailingLib:
    """Stands in for the library: returns the failure code, as a worker
    that caught ``std::bad_alloc`` makes the call do."""

    def __init__(self):
        self.workers = []

    def mgat_featurize_batch(self, *args):
        self.workers.append(args[-1])
        return -1


@pytest.mark.parametrize("workers", [1, 4])
def test_library_failure_raises(workers, monkeypatch):
    lib = _FailingLib()
    monkeypatch.setattr(native, "_lib", lib)
    before = native.counts()
    with pytest.raises(RuntimeError, match="native featuriser failed"):
        _featurize(monkeypatch, workers, CORPUS, 35, 64, 160)
    assert lib.workers == [workers]
    assert native.counts() == before


def test_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "featurizer.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    first = native.library_path()
    assert os.path.dirname(first) == str(tmp_path / "build")
    assert os.path.basename(first).startswith("featurizer-")
    with open(src, "a") as f:
        f.write("// edited\n")
    assert native.library_path() != first
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-g"])
    assert len({first, native.library_path()}) == 2


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                    capsys):
    src = tmp_path / "featurizer.cpp"
    src.write_text(open(native.SOURCE).read()
                   + "\nthis is not C++ at all;\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ building") as info:
        native.get_lib()
    assert "error" in str(info.value)                 # the compiler's output
    assert os.listdir(tmp_path / "build") == []       # no half-built file
    assert native.native_available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ building"):
        MolecularDataset(["CCO"], [5.0], verbose=False)
    # asked for, the Python path still runs
    assert len(MolecularDataset(["CCO"], [5.0], use_native=False,
                                verbose=False)) == 1
    # a compiler that is not there raises too
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(OSError):
        native.get_lib()


def test_binding_names_nothing_of_the_reference_tree():
    text = open(native.__file__).read()
    assert "mgat_graphsage_tpu" not in text and "libmgatchem" not in text
    assert os.path.dirname(native.SOURCE) == _build.CSRC_DIR
    assert os.path.basename(os.path.dirname(_build.CSRC_DIR)) == \
        "mgat_graphsage_torch"
