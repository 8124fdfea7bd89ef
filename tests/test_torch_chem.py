"""The port's chemistry and dataset layers against the reference package:
the padded arrays must be bitwise equal (both are the same numpy code)."""

import numpy as np
import pytest

from mgat_graphsage_tpu.chem import fingerprints as jfp
from mgat_graphsage_tpu.data import MolecularDataset as JaxDataset
from mgat_graphsage_tpu.data import StandardScaler as JaxScaler

from mgat_graphsage_torch.chem.fingerprints import (
    FINGERPRINT_DIMS,
    FINGERPRINTS,
)
from mgat_graphsage_torch.data import (
    TEST_CSV,
    MolecularDataset,
    StandardScaler,
    load_csv,
)

FIELDS = ("nodes", "edges", "node_mask", "edge_mask", "fp", "kept_indices",
          "y", "y_orig")


@pytest.fixture(scope="module")
def smiles_targets():
    smiles, y = load_csv(TEST_CSV)
    smiles = smiles[:100]
    y = y[:100]
    # an unparseable SMILES mid-list: skipped, kept_indices stay aligned
    return smiles[:40] + ["C1CC("] + smiles[40:], \
        np.concatenate([y[:40], [5.0], y[40:]]).astype(np.float32)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["reference_native", "reference_python"])
def test_dataset_bitwise_vs_reference(smiles_targets, use_native):
    smiles, y = smiles_targets
    ours = MolecularDataset(smiles, y, scaler=StandardScaler(6.0, 1.5),
                            max_nodes=80, max_edges=176, verbose=False)
    ref = JaxDataset(smiles, y, scaler=JaxScaler(6.0, 1.5), max_nodes=80,
                     max_edges=176, verbose=False, use_native=use_native)
    assert ours.smiles == ref.smiles
    assert (ours.max_nodes, ours.max_edges) == (80, 176)
    assert 40 not in ours.kept_indices and len(ours) == 100
    for name in FIELDS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_dataset_budget_drop_and_fit_scaler(smiles_targets):
    smiles, y = smiles_targets
    ours = MolecularDataset(smiles, y, fit_scaler=True, max_nodes=24,
                            verbose=False)
    ref = JaxDataset(smiles, y, fit_scaler=True, max_nodes=24,
                     verbose=False, use_native=False)
    np.testing.assert_array_equal(ours.kept_indices, ref.kept_indices)
    assert ours.max_edges == ref.max_edges
    assert ours.scaler.to_dict() == ref.scaler.to_dict()
    np.testing.assert_array_equal(ours.edges, ref.edges)


@pytest.mark.parametrize("name", sorted(FINGERPRINTS))
def test_fingerprints_bitwise_vs_reference(smiles_targets, name):
    smiles = [s for s in smiles_targets[0][:30] if s != "C1CC("]
    for s in smiles:
        np.testing.assert_array_equal(FINGERPRINTS[name](s),
                                      jfp.FINGERPRINTS[name](s), err_msg=s)
    assert FINGERPRINT_DIMS[name] == jfp.FINGERPRINT_DIMS[name]
