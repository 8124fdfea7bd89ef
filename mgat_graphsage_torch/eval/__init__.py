"""Metrics and the prediction pipeline."""

from .metrics import pearsonr, regression_metrics
from .predict import (
    Predictor,
    load_model_from_checkpoint,
    predict_csv,
    predict_dataset,
)

__all__ = ["regression_metrics", "pearsonr", "Predictor",
           "load_model_from_checkpoint", "predict_csv", "predict_dataset"]
