"""Evaluation metrics matching the reference's reporting surface.

Reference ``test.py:213-223``: MSE, RMSE, MAE, Pearson r with two-sided
p-value.  Pearson's p-value uses the exact beta-distribution formulation
(the same math scipy.stats.pearsonr implements).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

__all__ = ["regression_metrics", "pearsonr"]


def pearsonr(x: np.ndarray, y: np.ndarray):
    """Pearson correlation + two-sided p-value (beta survival function)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    n = x.size
    if n < 2:
        return float("nan"), float("nan")
    xm = x - x.mean()
    ym = y - y.mean()
    denom = math.sqrt((xm * xm).sum() * (ym * ym).sum())
    if denom == 0:
        return float("nan"), float("nan")
    r = float(np.clip((xm * ym).sum() / denom, -1.0, 1.0))
    if n == 2:
        return r, 1.0
    try:
        from scipy import special
        ab = n / 2.0 - 1.0
        p = float(2.0 * special.btdtr(ab, ab, 0.5 * (1.0 - abs(r)))) \
            if hasattr(special, "btdtr") else \
            float(2.0 * special.betainc(ab, ab, 0.5 * (1.0 - abs(r))))
    except Exception:  # scipy unavailable: t-distribution via normal approx
        t = r * math.sqrt((n - 2) / max(1e-12, 1 - r * r))
        p = float(2.0 * 0.5 * math.erfc(abs(t) / math.sqrt(2.0)))
    return r, p


def regression_metrics(y_true, y_pred) -> Dict[str, float]:
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1)
    y_pred = np.asarray(y_pred, dtype=np.float64).reshape(-1)
    err = y_pred - y_true
    mse = float((err ** 2).mean())
    r, p = pearsonr(y_true, y_pred)
    ss_res = float((err ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    return {
        "mse": mse,
        "rmse": math.sqrt(mse),
        "mae": float(np.abs(err).mean()),
        "pearson_r": r,
        "pearson_p": p,
        "r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan"),
        "n": int(y_true.size),
    }
