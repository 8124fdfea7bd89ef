"""GNNExplainer: learned node-feature and edge masks (port of
``mgat_graphsage_tpu/explain/gnnexplainer.py``).

Reference ``gnnexplainer.py:607-690``: PyG ``Explainer(GNNExplainer(
epochs=100, lr=0.01), node_mask_type='attributes', edge_mask_type=
'object')``.  The same mask optimisation, batched over the molecules of a
batch: sigmoid-parameterised feature mask ``[B, N, F]`` and edge mask
``[B, E]``, initialised N(0, 0.1), ``torch.optim.Adam(lr=0.01)``, 100
steps in a Python loop.

Loss (PyG GNNExplainer regression objective), every ``mean`` over all
``[B, E]`` or ``[B, N, F]`` elements, padded ones included, as in the
reference:
  sum (pred_masked - pred_orig)^2
  + c_es * sum(edge_mask)       (edge size,       c_es = 0.005)
  + c_ee * mean H(edge_mask)    (edge entropy,    c_ee = 1.0)
  + c_ns * mean(feat_mask)      (feature size,    c_ns = 1.0)
  + c_ne * mean H(feat_mask)    (feature entropy, c_ne = 0.1)

The target prediction takes its adjacency from ``dense_adjacency`` (the
``csrc/adjacency.cu`` kernel on CUDA); the loss's adjacency is
``dense_adjacency_einsum``, plain PyTorch, because the edge mask is
differentiated through it.  Each step runs the graph branch forward
(``csrc/attention.cu``) and its backward (``csrc/attention_bwd.cu``).
Gradients are taken with ``torch.autograd.grad`` w.r.t. the two masks
only, so nothing piles up on the model's weights.

The initial masks come from a ``torch.Generator`` on the CPU (the same
draws on every device), or are passed in as ``init``: the reference
draws them from ``jax.random``, which the port does not reproduce.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops import dense_adjacency
from ..ops.graph import dense_adjacency_einsum

__all__ = ["make_gnn_explainer", "make_scan_gnn_explainer",
           "optimize_masks"]

_COEFFS = dict(edge_size=0.005, edge_ent=1.0, node_feat_size=1.0,
               node_feat_ent=0.1)


def _entropy(p: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    p = torch.clamp(p, eps, 1 - eps)
    return -(p * torch.log(p) + (1 - p) * torch.log(1 - p))


def optimize_masks(graph_apply: Callable, nodes, edges, edge_mask,
                   node_mask, epochs: int = 100, lr: float = 0.01,
                   init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` Adam steps on the masks of one batch; returns the sigmoid
    feature mask ``[B, N, F]`` and edge mask ``[B, E]``, padding zeroed.
    ``init`` gives the initial ``(feat, edge)`` parameters; without it
    they are drawn on the CPU from ``generator``, N(0, 0.1) as in PyG,
    the feature mask first."""
    b, n, f = nodes.shape
    with torch.no_grad():
        target = graph_apply(nodes, dense_adjacency(edges, edge_mask, n),
                             node_mask)
    if init is None:
        init = (0.1 * torch.randn((b, n, f), generator=generator),
                0.1 * torch.randn((b, edges.shape[-1]), generator=generator))
    feat, edge = (t.detach().clone().to(nodes.device).requires_grad_(True)
                  for t in init)
    opt = torch.optim.Adam([feat, edge], lr=lr)
    nmask = node_mask.unsqueeze(-1)

    def loss_fn():
        fm = torch.sigmoid(feat)
        em = torch.sigmoid(edge)
        adj = dense_adjacency_einsum(edges, edge_mask * em, n)
        pred = graph_apply(nodes * fm, adj, node_mask)
        return (((pred - target) ** 2).sum()
                + _COEFFS["edge_size"] * (em * edge_mask).sum()
                + _COEFFS["edge_ent"] * (_entropy(em) * edge_mask).mean()
                + _COEFFS["node_feat_size"] * (fm * nmask).mean()
                + _COEFFS["node_feat_ent"] * (_entropy(fm) * nmask).mean())

    with torch.enable_grad():
        for _ in range(epochs):
            feat.grad, edge.grad = torch.autograd.grad(loss_fn(),
                                                       [feat, edge])
            opt.step()
    with torch.no_grad():
        return torch.sigmoid(feat) * nmask, torch.sigmoid(edge) * edge_mask


def make_gnn_explainer(graph_apply: Callable, epochs: int = 100,
                       lr: float = 0.01) -> Callable:
    """Batched GNNExplainer.

    ``graph_apply(nodes, adj, node_mask) -> [B, 1]`` is an eval-mode
    model.  Returns ``explain(nodes, edges, edge_mask, node_mask,
    generator=None, init=None) -> (node_feat_mask [B, N, F], edge_mask
    [B, E])`` with the sigmoid applied.
    """

    def explain(nodes, edges, edge_mask, node_mask, generator=None,
                init=None):
        return optimize_masks(graph_apply, nodes, edges, edge_mask,
                              node_mask, epochs, lr, init, generator)

    return explain


def make_scan_gnn_explainer(graph_apply: Callable, epochs: int = 100,
                            lr: float = 0.01) -> Callable:
    """GNNExplainer over a selection of a dataset held on the device, one
    batch after another, each the full mask optimisation of
    :func:`make_gnn_explainer` (the reference's one ``lax.scan``).

    Returns ``explain_all(nodes, edges, edge_mask, node_mask, perm,
    generator) -> node_importance [nb*B, N]``: the per-atom L2 norm of
    the learned sigmoid feature mask, flattened in ``perm`` order.  The
    batches draw their initial masks from ``generator`` in turn.
    """

    def explain_all(nodes, edges, edge_mask, node_mask, perm, generator):
        imps = []
        for idx in perm:
            fm, _ = optimize_masks(graph_apply, nodes[idx], edges[idx],
                                   edge_mask[idx], node_mask[idx], epochs,
                                   lr, generator=generator)
            imps.append(torch.linalg.vector_norm(fm, dim=-1))   # [B, N]
        return torch.cat(imps)

    return explain_all
