"""Gradient-based node importance, the primary importance engine (port of
``mgat_graphsage_tpu/explain/gradients.py``).

Reference ``gnnexplainer.py:640-659`` (``simple_gradient_explanation``):
forward the graph branch, take d(pred)/d(x), importance = per-atom L2
norm of that gradient, then min-max normalised per molecule
(``process_node_importance``, ``gnnexplainer.py:692-721``).

Here one ``torch.autograd.grad`` of ``pred.sum()`` w.r.t. the node
features explains a whole batch: molecules are independent, so the sum's
gradient holds each molecule's own.  The adjacency comes from
``ops/graph.py::dense_adjacency`` (the ``csrc/adjacency.cu`` kernel on
CUDA) and the M-GAT layer's attention from ``csrc/attention.cu``; the
input gradient runs its backward kernel, ``csrc/attention_bwd.cu``.
``torch.autograd.grad`` (not ``.backward()``) leaves no ``.grad`` on the
model's weights.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops import dense_adjacency

__all__ = [
    "make_gradient_explainer",
    "make_scan_gradient_explainer",
    "process_node_importance",
    "process_node_importance_batch",
]


def process_node_importance(raw: np.ndarray,
                            num_atoms: int) -> np.ndarray:
    """Normalize an importance vector/matrix to per-atom [0, 1] scores
    (reference ``gnnexplainer.py:692-721``): feature matrices reduce to row
    L2 norms; pad/trim to ``num_atoms``; min-max scale; flat inputs (max ==
    min) fall back to 0.5 everywhere."""
    arr = np.asarray(raw, dtype=np.float64)
    if num_atoms <= 0:
        return np.zeros(0)
    if arr.ndim == 2:
        arr = np.linalg.norm(arr, axis=1)
    arr = arr.reshape(-1)
    if arr.shape[0] < num_atoms:
        arr = np.pad(arr, (0, num_atoms - arr.shape[0]))
    else:
        arr = arr[:num_atoms]
    lo, hi = float(arr.min()), float(arr.max())
    if hi - lo < 1e-12:
        return np.full(num_atoms, 0.5)
    return (arr - lo) / (hi - lo)


def process_node_importance_batch(raw: np.ndarray,
                                  num_atoms: np.ndarray) -> list:
    """Vectorised :func:`process_node_importance` over a whole dataset.
    ``raw [M, N]`` already row-reduced (per-atom scores), ``num_atoms
    [M]``.  Returns a list of M arrays, molecule i trimmed to its
    ``num_atoms[i]`` and min-max scaled exactly as the per-molecule
    function does (float64 min-max, 0.5 flat fallback)."""
    raw = np.asarray(raw, dtype=np.float64)
    num_atoms = np.asarray(num_atoms, dtype=np.int64)
    m, n_max = raw.shape
    valid = np.arange(n_max)[None, :] < num_atoms[:, None]
    any_valid = num_atoms > 0
    lo = np.where(any_valid, np.where(valid, raw, np.inf).min(axis=1), 0.0)
    hi = np.where(any_valid, np.where(valid, raw, -np.inf).max(axis=1), 0.0)
    rng = hi - lo
    flat = rng < 1e-12
    denom = np.where(flat, 1.0, rng)
    scaled = np.where(flat[:, None], 0.5,
                      (raw - lo[:, None]) / denom[:, None])
    return [scaled[i, :num_atoms[i]] for i in range(m)]


def _batch_importance(graph_apply: Callable, nodes, edges, edge_mask,
                      node_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-atom L2 norm of d(pred)/d(x) ``[B, N]`` and the predictions
    ``[B]`` of one batch, from one forward and one backward."""
    adj = dense_adjacency(edges, edge_mask, nodes.shape[1])
    with torch.enable_grad():
        x = nodes.detach().requires_grad_(True)
        preds = graph_apply(x, adj, node_mask).reshape(-1)
        (grads,) = torch.autograd.grad(preds.sum(), x)     # [B, N, F]
    raw = torch.linalg.vector_norm(grads, dim=-1) * node_mask
    return raw, preds.detach()


def make_gradient_explainer(graph_apply: Callable) -> Callable:
    """Batched gradient explainer.

    ``graph_apply(nodes, adj, node_mask) -> [B, 1]`` is an eval-mode
    model (or its graph branch).  Returns ``explain(nodes, edges,
    edge_mask, node_mask) -> (raw_importance [B, N], predictions [B])``
    where raw importance is the per-atom gradient L2 norm (un-normalised;
    callers apply :func:`process_node_importance` per molecule).
    """

    def explain(nodes, edges, edge_mask, node_mask):
        return _batch_importance(graph_apply, nodes, edges, edge_mask,
                                 node_mask)

    return explain


def make_scan_gradient_explainer(graph_apply: Callable) -> Callable:
    """Whole-dataset gradient importance over a dataset held on the
    device, one batch after another (the reference's one ``lax.scan``).

    Returns ``explain_all(nodes, edges, edge_mask, node_mask, perm) ->
    (raw [nb*B, N], preds [nb*B])`` where ``perm [nb, B]`` indexes
    batches into the dataset and outputs are flattened in ``perm`` order
    (callers slice the first M rows when the last batch wraps).
    """

    def explain_all(nodes, edges, edge_mask, node_mask, perm):
        raws, preds = [], []
        for idx in perm:
            raw, pred = _batch_importance(graph_apply, nodes[idx],
                                          edges[idx], edge_mask[idx],
                                          node_mask[idx])
            raws.append(raw)
            preds.append(pred)
        return torch.cat(raws), torch.cat(preds)

    return explain_all
