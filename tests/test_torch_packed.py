"""Compact dataset storage of the port (``data/packed.py``) on the CPU: the
packed arrays equal the reference package's, the unpacked batch equals the
plain one bit for bit, and ``dataset_storage="compact"`` trains the same
trajectory as ``"float32"``, exactly.
"""

import copy
import os
import types

import numpy as np
import pytest
import torch

from mgat_graphsage_tpu.data import MolecularDataset as JaxDataset
from mgat_graphsage_tpu.data.packed import pack_dataset as jax_pack_dataset

from mgat_graphsage_torch.data import (
    TRAIN_CSV,
    VAL_CSV,
    MolecularDataset,
    load_csv,
)
from mgat_graphsage_torch.data.packed import (
    gather_batch,
    is_packed,
    pack_dataset,
    packed_nbytes,
    plain_nbytes,
    to_device,
)
from mgat_graphsage_torch.train import Trainer, get_config
from mgat_graphsage_torch.train.run import main as run_main

PLAIN = ("nodes", "edges", "node_mask", "edge_mask", "fp", "y", "y_orig")


@pytest.fixture(scope="module")
def fp_data():
    sm, y = load_csv(TRAIN_CSV)
    vs, vy = load_csv(VAL_CSV)
    train = MolecularDataset(sm[:128], y[:128], fit_scaler=True,
                             verbose=False)
    val = MolecularDataset(vs[:64], vy[:64], scaler=train.scaler,
                           max_nodes=train.max_nodes,
                           max_edges=train.max_edges, verbose=False)
    return train, val, sm[:128], y[:128]


def _plain(ds):
    return to_device({k: getattr(ds, k) for k in PLAIN}, "cpu")


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_pack_equals_reference_and_unpacks_bit_for_bit(fp_data):
    train, _, sm, y = fp_data
    packed = pack_dataset(train)
    ref = jax_pack_dataset(JaxDataset(sm, y, fit_scaler=True, verbose=False))
    assert set(packed) == set(ref)
    for k in ref:
        assert packed[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(packed[k], ref[k], err_msg=k)
    assert packed["edges_p"].dtype == np.uint8 and is_packed(packed)
    idx = torch.tensor([0, 3, 7, 127, 64, 1, 3])
    fp_dim = train.fp.shape[1]
    got = gather_batch(to_device(packed, "cpu"), idx, fp_dim)
    _assert_batches_equal(got, gather_batch(_plain(train), idx, fp_dim))
    assert got["edges"].dtype == torch.int32 and got["edges"].is_contiguous()


def test_pack_unpack_5dim_featurizer():
    # the raw featurizer carries atomic numbers and formal charges (some
    # negative): small integers, exact in int8
    sm, y = load_csv(TRAIN_CSV)
    smiles = sm[:64] + ["[O-]C(=O)c1ccccc1"]
    targets = np.concatenate([y[:64], [5.0]])
    ds = MolecularDataset(smiles, targets, fit_scaler=True, fingerprint=None,
                          featurizer="5", verbose=False)
    assert ds.nodes.min() < 0
    packed = pack_dataset(ds)
    ref = jax_pack_dataset(JaxDataset(smiles, targets, fit_scaler=True,
                                      fingerprint=None, featurizer="5",
                                      verbose=False))
    for k in ref:
        np.testing.assert_array_equal(packed[k], ref[k], err_msg=k)
    idx = torch.arange(len(ds))
    _assert_batches_equal(
        gather_batch(to_device(packed, "cpu"), idx, ds.fp.shape[1]),
        gather_batch(_plain(ds), idx, ds.fp.shape[1]))


def test_non_binary_fingerprint_stays_f32(fp_data):
    train = fp_data[0]
    ds = copy.copy(train)
    ds.fp = train.fp.copy()
    ds.fp[0, 0] = 0.37                     # a descriptor-valued stream
    packed = pack_dataset(ds)
    assert "fp" in packed and "fp_packed" not in packed
    assert packed["fp"].dtype == np.float32
    idx = torch.tensor([0, 1])
    _assert_batches_equal(
        gather_batch(to_device(packed, "cpu"), idx, ds.fp.shape[1]),
        gather_batch(_plain(ds), idx, ds.fp.shape[1]))


def test_odd_width_fingerprint_roundtrip(fp_data):
    # 167 bits (MACCS' width) is not a multiple of 8: the unpack trims the
    # padded tail of the last byte
    train = fp_data[0]
    ds = copy.copy(train)
    rng = np.random.default_rng(0)
    ds.fp = rng.integers(0, 2, size=(train.n, 167)).astype(np.float32)
    ds.fp_dim = 167
    packed = pack_dataset(ds)
    assert packed["fp_packed"].shape == (train.n, 21)
    idx = torch.tensor([5, 2, 9])
    got = gather_batch(to_device(packed, "cpu"), idx, 167)["fp"]
    assert got.shape == (3, 167)
    assert torch.equal(got, torch.from_numpy(ds.fp[idx.numpy()]))


def test_wide_graphs_keep_uint16_edges(fp_data):
    """Past 256 nodes the edges pack to uint16, which goes to the device as
    the int16 of the same bits and comes back as int32."""
    train = fp_data[0]
    ds = copy.copy(train)
    ds.max_nodes = 300
    ds.nodes = np.zeros((train.n, 300, train.feature_dim), np.float32)
    ds.node_mask = np.zeros((train.n, 300), np.float32)
    ds.node_mask[:, :290] = 1.0
    ds.edges = train.edges.copy()
    ds.edges[:, 0, 0] = 280                            # past uint8's range
    ds.edges[:, 1, 0] = 299
    packed = pack_dataset(ds)
    assert packed["edges_p"].dtype == np.uint16
    dev = to_device(packed, "cpu")
    assert dev["edges_p"].dtype == torch.int16
    idx = torch.tensor([4, 0, 11])
    _assert_batches_equal(gather_batch(dev, idx, ds.fp.shape[1]),
                          gather_batch(_plain(ds), idx, ds.fp.shape[1]))
    # indices past 32767 are negative as int16 and must come back whole
    n = 40_000
    wide = types.SimpleNamespace(
        max_nodes=n, nodes=np.zeros((2, n, 1), np.float32),
        node_mask=np.ones((2, n), np.float32),
        edges=np.array([[[39_999, 32_768, 5, 0], [32_767, 39_998, 0, 0]]] * 2,
                       np.int32),
        edge_mask=np.array([[1, 1, 1, 0]] * 2, np.float32),
        fp=np.ones((2, 8), np.float32), y=np.zeros(2, np.float32),
        y_orig=np.zeros(2, np.float32))
    idx = torch.tensor([1, 0])
    got = gather_batch(to_device(pack_dataset(wide), "cpu"), idx, 8)
    _assert_batches_equal(got, gather_batch(_plain(wide), idx, 8))


def test_compression_factor(fp_data):
    train = fp_data[0]
    factor = plain_nbytes(train) / packed_nbytes(train)
    assert factor > 4.0, factor
    assert packed_nbytes(train) == sum(v.nbytes for v in
                                       pack_dataset(train).values())


@pytest.mark.parametrize("what", ["non_integral", "out_of_int8",
                                  "not_leading_ones", "edge_range"])
def test_pack_rejects(fp_data, what):
    """What counts and int8 cannot hold is refused, loudly."""
    ds = copy.copy(fp_data[0])
    if what in ("non_integral", "out_of_int8"):
        ds.nodes = ds.nodes.copy()
        ds.nodes[0, 0, 0] = 0.5 if what == "non_integral" else 200.0
        match = "non-integral" if what == "non_integral" else "outside"
    elif what == "not_leading_ones":
        ds.node_mask = ds.node_mask.copy()
        ds.node_mask[0, :] = 0.0
        ds.node_mask[0, -1] = 1.0             # same count, wrong positions
        match = "leading-ones"
    else:
        ds.edges = ds.edges.copy()
        ds.edges[0, 0, 0] = ds.max_nodes
        match = "edge indices"
    with pytest.raises(ValueError, match=match):
        pack_dataset(ds)


def test_compact_training_is_the_float32_run_exactly(fp_data):
    train, val, _, _ = fp_data
    cfg = get_config("flagship", epochs=2, batch_size=32, cnn_fc_hidden=16)
    runs = {}
    for storage in ("float32", "compact"):
        trainer = Trainer(cfg.replace(dataset_storage=storage), train, val,
                          device="cpu")
        final, _, hist = trainer.fit(verbose=False, save_best=False)
        runs[storage] = (hist, final.model.state_dict(),
                         trainer._device_dataset(train))
    (h32, sd32, d32), (hc, sdc, dc) = runs["float32"], runs["compact"]
    assert "nodes_i8" in dc and "nodes" in d32
    assert len(hc) == 2
    for a, b in zip(h32, hc):
        for k in ("train_loss", "val_mse", "original_mse"):
            assert a[k] == b[k], k
    for k in sd32:
        assert torch.equal(sd32[k], sdc[k]), k


def test_cli_dataset_storage_compact(fp_data, tmp_path, capsys):
    run_main(["--preset", "flagship", "--limit", "40", "--epochs", "1",
              "--batch-size", "16", "--device", "cpu", "--dataset-storage",
              "compact", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Epoch    1" in out and "Training completed" in out
    assert os.path.exists(tmp_path / "flagship" / "best_model.pt")
    with pytest.raises(ValueError, match="dataset_storage"):
        Trainer(get_config("flagship", dataset_storage="int4"), fp_data[0],
                device="cpu")
