"""Prediction pipeline of the port (``mgat_graphsage_tpu/eval/predict.py``
on PyTorch and CUDA).

A checkpoint of the port (``train/checkpoint.py``) plus SMILES in,
de-normalised pChEMBL out.  The SMILES are featurised on the host by the
native library (``chem/native.py``, through ``MolecularDataset``), as in
the reference package.  The fields the model reads go to the device
once; batches of ``batch_size``, built as the trainer builds them
(``data/packed.py``, ``models/zoo.py::model_inputs``), run in a Python
loop under ``torch.inference_mode()``, each through the adjacency
kernel, the graph branch (with the attention kernel), the CNN branch and
the head.  Results come back in one copy.  Every model of
``models/zoo.py`` serves this way: a baseline or a ``gat_graphsage``
checkpoint has no fingerprint branch, so none is computed, GIN's batch
norms serve with their running statistics (the model is in eval mode),
and the graph transformer reads the molecules' structure in place of the
adjacency (its attention through the biased-attention kernel in bf16 on
CUDA, through the explicit path in f32 or on the CPU).

``infer_dtype="bfloat16"`` serves in bf16 (reference ``make_scan_predict``):
the parameters are cast to bf16 once (``Predictor``; the batch norms'
running statistics stay f32) and the inputs per batch, the products
accumulate in f32, the attention and the adjacency run in f32 as in
training, and the prediction is cast back to f32 before the
de-normalisation.  A checkpoint with a bf16 master serves at f32 with its
parameters upcast.

Entry points run on CUDA unless given ``device="cpu"`` (CLI:
``--device cpu``); without CUDA they raise.

    python -m mgat_graphsage_torch.eval.predict CKPT CSV [--out FILE]
           [--batch-size 64] [--device cuda|cpu]

writes the reference's columns ``SMILES,True_Value,Predicted_Value,
Absolute_Error`` (reference ``test.py:225-232``) and prints MSE, RMSE, MAE
and Pearson r.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data import MolecularDataset, StandardScaler, load_csv
from ..data.packed import batch_indices, batches, device_dataset, to_device
from ..device import resolve_device
from ..models import build_model, matmul_precision
from ..models.zoo import model_fields, model_inputs, model_outputs
from ..train.checkpoint import load_checkpoint
from ..train.config import TrainConfig
from ..utils import telemetry
from .metrics import regression_metrics

__all__ = ["load_model_from_checkpoint", "predict_dataset", "predict_csv",
           "Predictor", "main"]

# Predictor.last_timings: key -> the span of the call it reads
_TIMINGS = {"featurize_s": "predict.featurize",
            "dispatch_s": "predict.dispatch",
            "native_s": "featurize.native",
            "upload_s": "predict.upload",
            "readback_s": "predict.readback"}


def _check_infer_dtype(infer_dtype: Optional[str]) -> str:
    """``infer_dtype`` -> the compute dtype's name (None means f32)."""
    if infer_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unknown infer_dtype {infer_dtype!r}: None, "
                         "'float32' or 'bfloat16'")
    return infer_dtype or "float32"


def load_model_from_checkpoint(ckpt_path: str, device=None):
    """Rebuild ``(model, cfg, scaler, (max_nodes, max_edges))`` from a
    port checkpoint and its JSON sidecar; the model is in eval mode on
    ``device``."""
    dev = resolve_device(device)
    with open(ckpt_path + ".json") as f:
        meta = json.load(f)
    cfg = TrainConfig(**meta["config"])
    scaler = StandardScaler.from_dict(meta["scaler"])
    budgets = (int(meta["max_nodes"]), int(meta["max_edges"]))
    model = build_model(cfg)
    state_dict, _, _ = load_checkpoint(ckpt_path, map_location="cpu")
    model.load_state_dict(state_dict)
    model.to(dev).eval()
    return model, cfg, scaler, budgets


def predict_dataset(model, cfg: TrainConfig, scaler: StandardScaler,
                    ds: MolecularDataset, batch_size: int = 64,
                    infer_dtype: Optional[str] = None) -> np.ndarray:
    """De-normalised predictions for every molecule in ``ds``, on the
    model's device.

    Padded rows of the last batch repeat molecule 0 with their node mask
    zeroed, so they are inert; their outputs are dropped.  The batches are
    ``Trainer.evaluate``'s: the same predictions, bit for bit, at
    ``eval_batch_size == batch_size``.  The batch count is not rounded up
    to a power of two as the reference package's ``bucket=True`` does to
    share one compiled program between request sizes: eager PyTorch has
    no program to share, and the extra inert batches only cost time
    (``PERF.md``).  The batches run at the train step's
    numerics for ``cfg.matmul_precision`` and the compute dtype
    ``infer_dtype`` (``models/layers.py::matmul_precision``).
    ``"bfloat16"`` takes a model already cast to bf16, as ``Predictor``
    casts it.  The spans ``predict.upload`` (the fields the model reads
    and the batches' index arrays to the device) and ``predict.readback``
    (the predictions to the host, which waits there for the device) time
    the host's part of each (``utils/telemetry.py``).
    """
    compute = _check_infer_dtype(infer_dtype)
    cdt = torch.bfloat16 if compute == "bfloat16" else None
    first = next(model.parameters())
    if cdt is not None and first.dtype != cdt:
        raise ValueError("infer_dtype='bfloat16' takes a model cast to "
                         f"bf16, not one in {first.dtype}")
    dev = first.device
    with telemetry.span("predict.upload"):
        data = device_dataset(ds, model_fields(cfg), dev)
        index = to_device(batch_indices(len(ds), batch_size), dev)
    mean, scale = float(scaler.mean_), float(scaler.scale_)
    preds = []
    with torch.inference_mode(), matmul_precision(cfg.matmul_precision,
                                                  compute):
        for batch in batches(data, index, ds.fp.shape[1]):
            pred, _ = model_outputs(cfg, model(*model_inputs(cfg, batch, cdt)),
                                    latent=False)
            preds.append(pred.reshape(-1) * scale + mean)
        with telemetry.span("predict.readback"):
            out = torch.cat(preds).cpu().numpy()
    return out[:len(ds)]


def predict_csv(ckpt_path: str, csv_path: str,
                out_csv: Optional[str] = "model_prediction_results.csv",
                batch_size: int = 64, verbose: bool = True, device=None
                ) -> Tuple[Dict, np.ndarray]:
    """Checkpoint + CSV -> metrics + results CSV (reference ``test.py``)."""
    model, cfg, scaler, (mn, me) = load_model_from_checkpoint(ckpt_path,
                                                              device)
    smiles, targets = load_csv(csv_path)
    ds = MolecularDataset(smiles, targets, scaler=scaler,
                          fingerprint=cfg.fingerprint,
                          featurizer=cfg.featurizer,
                          max_nodes=mn, max_edges=me, verbose=verbose,
                          structure=cfg.structure)
    preds = predict_dataset(model, cfg, scaler, ds, batch_size)
    metrics = regression_metrics(ds.y_orig, preds)
    if verbose:
        print("\nModel evaluation results:")
        print(f"Number of test samples: {metrics['n']}")
        print(f"MSE: {metrics['mse']:.4f}")
        print(f"RMSE: {metrics['rmse']:.4f}")
        print(f"MAE: {metrics['mae']:.4f}")
        print(f"Pearson correlation: {metrics['pearson_r']:.4f} "
              f"(p-value: {metrics['pearson_p']:.4e})")
    if out_csv:
        with open(out_csv, "w") as f:
            f.write("SMILES,True_Value,Predicted_Value,Absolute_Error\n")
            for smi, t, p in zip(ds.smiles, ds.y_orig, preds):
                f.write(f"{smi},{t:.6f},{p:.6f},{abs(t - p):.6f}\n")
        if verbose:
            print(f"Prediction results saved to {out_csv}")
    return metrics, preds


class Predictor:
    """Serving handle: load once, predict many.

    >>> p = Predictor("checkpoints/flagship/best_model.pt")
    >>> p(["CCO", "c1ccccc1O"])          # -> np.ndarray of pChEMBL values

    The output is index-aligned with the input: unparseable or
    over-budget molecules get NaN (past the checkpoint's budget, or past
    the native featuriser's ``data/dataset.py::NATIVE_BUDGET``).
    ``infer_dtype="bfloat16"`` casts the
    parameters to bf16 once, here, and serves in bf16.  A call is a
    ``predict_call`` unit of ``utils/telemetry.py``; ``last_timings`` holds
    the split of the latest call in seconds, from its spans:
    ``featurize_s`` (host) and ``dispatch_s`` (upload, device work and the
    copy back), and within them ``native_s`` (the native featuriser's
    call), ``upload_s`` and ``readback_s``.
    """

    def __init__(self, ckpt_path: str, infer_dtype: Optional[str] = None,
                 device=None):
        _check_infer_dtype(infer_dtype)
        self.infer_dtype = infer_dtype
        (self.model, self.cfg, self.scaler,
         (self.max_nodes, self.max_edges)) = \
            load_model_from_checkpoint(ckpt_path, device)
        if infer_dtype == "bfloat16":
            self.model.to(torch.bfloat16)
        self.device = next(self.model.parameters()).device
        self.last_timings = dict.fromkeys(_TIMINGS, 0.0)

    def __call__(self, smiles, batch_size: int = 64) -> np.ndarray:
        if isinstance(smiles, str):
            smiles = [smiles]
        smiles = list(smiles)
        out = np.full(len(smiles), np.nan, dtype=np.float32)
        with telemetry.unit("predict_call", molecules=len(smiles)) as rec:
            try:
                with telemetry.span("predict.featurize"):
                    ds = MolecularDataset(
                        smiles, np.zeros(len(smiles), np.float32),
                        scaler=self.scaler, fingerprint=self.cfg.fingerprint,
                        featurizer=self.cfg.featurizer,
                        max_nodes=self.max_nodes, max_edges=self.max_edges,
                        verbose=False, structure=self.cfg.structure)
            except ValueError:
                ds = None   # no valid molecules at all
            if ds is not None:
                with telemetry.span("predict.dispatch"):
                    out[ds.kept_indices] = predict_dataset(
                        self.model, self.cfg, self.scaler, ds, batch_size,
                        infer_dtype=self.infer_dtype)
        self.last_timings = {key: rec.spans.get(name, 0.0)
                             for key, name in _TIMINGS.items()}
        return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Predict pChEMBL for a Smiles,pchembl CSV with a "
                    "checkpoint of the PyTorch port.")
    ap.add_argument("checkpoint")
    ap.add_argument("csv")
    ap.add_argument("--out", default="model_prediction_results.csv")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    predict_csv(args.checkpoint, args.csv, args.out, args.batch_size,
                device=args.device)


if __name__ == "__main__":
    main()
