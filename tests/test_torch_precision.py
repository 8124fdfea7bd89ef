"""``TrainConfig.matmul_precision`` in the port: the train step, the
trainer's evaluation and ``predict_dataset`` (the serving path) all run
the model under one rule, ``models/layers.py::matmul_precision``.  For f32
compute both of its values mean IEEE f32: TF32 off in cuBLAS and cuDNN.

The flags are process-wide, so a caller's TF32 setting would reach the
model if an entry point did not set them.  Each case turns TF32 on, runs
one entry point on the CPU at a tiny width (the flagship with a CNN fc1 of
8 units), records both flags inside the model's forward, and checks that
they are back on afterwards.  The flags are plain settings, so the CPU
shows what the card would be told.
"""

import pytest
import torch

from mgat_graphsage_torch.data import TRAIN_CSV, MolecularDataset, load_csv
from mgat_graphsage_torch.eval.predict import predict_dataset
from mgat_graphsage_torch.models import matmul_precision
from mgat_graphsage_torch.train import Trainer, get_config

ENTRY_POINTS = ("train_step", "evaluate", "predict_dataset")
BATCH = 8


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_flags(matmul, cudnn):
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@pytest.fixture(scope="module")
def data():
    smiles, y = load_csv(TRAIN_CSV)
    return MolecularDataset(smiles[:BATCH], y[:BATCH], fit_scaler=True,
                            verbose=False)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_runs_the_model_in_ieee_f32(data, entry, precision):
    cfg = get_config("flagship", cnn_fc_hidden=8, batch_size=BATCH,
                     eval_batch_size=BATCH, matmul_precision=precision)
    trainer = Trainer(cfg, data, data, device="cpu")
    state = trainer.init_state()
    seen = []
    state.model.register_forward_hook(
        lambda module, args, out: seen.append(_flags()))
    prev = _flags()
    _set_flags(True, True)
    try:
        if entry == "train_step":
            trainer.train_step(state, next(trainer._batches(data, BATCH)))
        elif entry == "evaluate":
            trainer.evaluate(state)
        else:
            predict_dataset(state.model, cfg, data.scaler, data, BATCH)
        after = _flags()
    finally:
        _set_flags(*prev)
    assert seen and all(s == (False, False) for s in seen), seen
    assert after == (True, True)


def test_unknown_matmul_precision_raises():
    with pytest.raises(ValueError, match="matmul_precision"):
        matmul_precision("tf32")


def _bf16_flags():
    return (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            ) + _flags()


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_bf16_entry_point_accumulates_products_in_f32(data, entry):
    """Under bf16 compute each entry point runs the model with cuBLAS's
    bf16 split-K reduction off and TF32 off (``models/layers.py::
    bf16_products``), in bf16, and restores the caller's three flags."""
    cfg = get_config("flagship", cnn_fc_hidden=8, batch_size=BATCH,
                     eval_batch_size=BATCH, compute_dtype="bfloat16")
    trainer = Trainer(cfg, data, data, device="cpu")
    state = trainer.init_state()
    seen = []
    state.model.register_forward_hook(
        lambda module, args, out: seen.append((_bf16_flags(), out[0].dtype)))
    prev = _bf16_flags()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    _set_flags(True, True)
    try:
        if entry == "train_step":
            trainer.train_step(state, next(trainer._batches(data, BATCH)))
        elif entry == "evaluate":
            trainer.evaluate(state)
        else:
            # cast once, as ``Predictor`` casts its model
            predict_dataset(state.model.to(torch.bfloat16), cfg, data.scaler,
                            data, BATCH, infer_dtype="bfloat16")
        after = _bf16_flags()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            prev[0]
        _set_flags(*prev[1:])
    assert seen and all(s == ((False,) * 3, torch.bfloat16)
                        for s in seen), seen
    assert after == (True,) * 3
