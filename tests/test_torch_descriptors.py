"""The port's descriptors (``chem/descriptors.py``), the MACCS, SMIFP and
BCI fingerprints (``chem/fingerprints.py``), ``smiles_to_padded_graph``
and SMILES writing (``chem/write.py``) against the reference package, on
the CPU.

The panel: the first 64 bundled train SMILES, the SMILES of the
reference's chemistry goldens (``tests/test_chem_goldens.py``,
``tests/test_fingerprints.py``) and of its MACCS goldens.  Both packages
run the same float64 numpy code, so every value must be equal (``==``),
not close.
"""

import inspect

import numpy as np
import pytest

from test_chem_goldens import (
    COUNTS_GOLDEN,
    FEATURE_GOLDEN,
    LOGP_DERIVED,
    LOGP_GOLDEN,
    MOLWT_GOLDEN,
    TPSA_GOLDEN,
)
from test_fingerprints import PERMUTATION_PANEL
from test_maccs_goldens import GOLDENS as MACCS_GOLDENS
from test_write import CORPUS as WRITE_CORPUS

from mgat_graphsage_tpu.chem import descriptors as JD
from mgat_graphsage_tpu.chem import fingerprints as JF
from mgat_graphsage_tpu.chem import parse_smiles as jparse
from mgat_graphsage_tpu.chem import smiles_to_padded_graph as jpadded
from mgat_graphsage_tpu.chem import write as JW

from mgat_graphsage_torch.chem import descriptors as D
from mgat_graphsage_torch.chem import fingerprints as F
from mgat_graphsage_torch.chem import parse_smiles, smiles_to_padded_graph
from mgat_graphsage_torch.chem import write as W
from mgat_graphsage_torch.data import TRAIN_CSV, load_csv


def _panel():
    train, _ = load_csv(TRAIN_CSV)
    extra = [row[0] for rows in (COUNTS_GOLDEN, FEATURE_GOLDEN, LOGP_DERIVED,
                                 LOGP_GOLDEN, MOLWT_GOLDEN, TPSA_GOLDEN)
             for row in rows]
    extra += PERMUTATION_PANEL + sorted(MACCS_GOLDENS)
    return list(dict.fromkeys(train[:64] + extra))


PANEL = _panel()


def _public_functions(module):
    return sorted(n for n, f in vars(module).items()
                  if inspect.isfunction(f) and f.__module__ == module.__name__
                  and not n.startswith("_"))


DESCRIPTORS = _public_functions(JD)


@pytest.fixture(scope="module")
def mols():
    return [(parse_smiles(s), jparse(s)) for s in PANEL]


def test_descriptor_surface_is_the_reference_one():
    assert D.__all__ == JD.__all__
    assert _public_functions(D) == DESCRIPTORS
    assert len(DESCRIPTORS) == 34


@pytest.mark.parametrize("name", DESCRIPTORS)
def test_descriptor_equals_reference(name, mols):
    ours, ref = getattr(D, name), getattr(JD, name)
    for smi, (m, jm) in zip(PANEL, mols):
        got, want = ours(m), ref(jm)
        assert type(got) is type(want), (smi, type(got), type(want))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"{name}({smi!r})")


@pytest.mark.parametrize("name", ["get_maccs", "get_smifp",
                                  "get_bci_fingerprint"])
def test_fingerprint_equals_reference_bit_for_bit(name):
    ours, ref = getattr(F, name), getattr(JF, name)
    for smi in PANEL:
        got, want = ours(smi), ref(smi)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), f"{name}({smi!r})"


def test_fingerprint_registry_equals_reference():
    assert F.FINGERPRINT_DIMS == JF.FINGERPRINT_DIMS
    assert sorted(F.FINGERPRINTS) == sorted(JF.FINGERPRINTS)
    for name, fn in F.FINGERPRINTS.items():
        fp = fn("CC(=O)Oc1ccccc1C(=O)O")
        assert fp.shape == (1, F.FINGERPRINT_DIMS[name])
        assert fp.tobytes() == JF.FINGERPRINTS[name](
            "CC(=O)Oc1ccccc1C(=O)O").tobytes(), name


@pytest.mark.parametrize("smiles", sorted(MACCS_GOLDENS))
def test_maccs_hand_derived_golden(smiles):
    """The reference's hand-derived MACCS goldens, against the port."""
    bits = F.get_maccs(smiles).reshape(-1)
    assert bits.shape == (167,) and bits[0] == 0.0
    got = {i for i in range(167) if bits[i] > 0}
    assert got == MACCS_GOLDENS[smiles], (
        f"missing {sorted(MACCS_GOLDENS[smiles] - got)}, "
        f"unexpected {sorted(got - MACCS_GOLDENS[smiles])}")


@pytest.mark.parametrize("featurizer", ["35", "5"])
def test_smiles_to_padded_graph_equals_reference(featurizer):
    for smi in PANEL:
        for budget in ((96, 224), (12, 24)):
            got = smiles_to_padded_graph(smi, *budget, featurizer=featurizer)
            want = jpadded(smi, *budget, featurizer=featurizer)
            if want is None:
                assert got is None, smi
                continue
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w, err_msg=smi)


@pytest.mark.parametrize("smiles", WRITE_CORPUS + ["[13C](=O)([O-])O"]
                         + PANEL[:16])
def test_write_equals_reference(smiles):
    """``mol_to_smiles``, ``fragment_to_smiles`` and ``atom_environment``
    give the reference's strings and atom sets, and the written SMILES
    parses back to the same atom count."""
    m, jm = parse_smiles(smiles), jparse(smiles)
    out = W.mol_to_smiles(m)
    assert out == JW.mol_to_smiles(jm)
    assert parse_smiles(out).GetNumAtoms() == m.GetNumAtoms()
    for atom in range(m.GetNumAtoms()):
        env = W.atom_environment(m, atom, 2)
        assert env == JW.atom_environment(jm, atom, 2)
        assert W.fragment_to_smiles(m, env) == JW.fragment_to_smiles(jm,
                                                                      env)
