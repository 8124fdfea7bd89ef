"""Dense, mask-aware graph primitives (port of
``mgat_graphsage_tpu/ops/graph.py``).

Molecules are small graphs, so message passing is phrased as batched dense
products over a per-molecule adjacency ``[B, N, N]`` built once per batch
from the padded edge list.  All ops are masked so padding never leaks into
results.
"""

from __future__ import annotations

import torch

from .adjacency import dense_adjacency_cuda

__all__ = [
    "dense_adjacency",
    "dense_adjacency_einsum",
    "add_self_loops",
    "degree",
    "gcn_norm_adjacency",
    "masked_softmax",
    "segment_max_pool",
    "segment_mean_pool",
    "segment_sum_pool",
]

_NEG_INF = -1e9


def dense_adjacency(edges: torch.Tensor, edge_mask: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """``[B, 2, E]`` COO edges (``edges[:, 0]`` source, ``edges[:, 1]``
    destination) + ``[B, E]`` mask -> ``[B, N, N]`` f32 with
    ``adj[b, dst, src] = min(sum mask, 1)``: row ``i`` holds the
    in-neighbourhood of node ``i``, so ``adj @ x`` aggregates sources into
    destinations.  On CUDA this is the ``csrc/adjacency.cu`` kernel at any
    ``N``; on the CPU its plain scatter version."""
    return dense_adjacency_cuda(edges, edge_mask, num_nodes)


def dense_adjacency_einsum(edges: torch.Tensor, edge_mask: torch.Tensor,
                           num_nodes: int) -> torch.Tensor:
    """:func:`dense_adjacency` as a batched product of one-hot matrices,
    the form to use where ``edge_mask`` is differentiated (the explainer's
    mask optimisation): ``adj[b, i, j] = min(sum_e [dst_e = i] [src_e = j]
    mask_e, 1)``, and its gradient w.r.t. ``edge_mask`` is a product too.
    Plain PyTorch on every device, as it is plain ``einsum`` in the
    reference."""
    src, dst = edges[..., 0, :], edges[..., 1, :]               # [B, E]
    iota = torch.arange(num_nodes, dtype=edges.dtype, device=edges.device)
    d1 = (dst.unsqueeze(-2) == iota.unsqueeze(-1)).float()      # [B, N, E]
    s1 = (src.unsqueeze(-2) == iota.unsqueeze(-1)).float() \
        * edge_mask.unsqueeze(-2)
    return torch.clamp_max(torch.matmul(d1, s1.transpose(-1, -2)), 1.0)


def add_self_loops(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """adj + I on valid nodes only."""
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    loops = eye * node_mask.unsqueeze(-2) * node_mask.unsqueeze(-1)
    return torch.clamp_max(adj + loops, 1.0)


def degree(adj: torch.Tensor) -> torch.Tensor:
    """Row degree ``[B, N]`` (the in-degree under the dst-row
    convention)."""
    return adj.sum(-1)


def gcn_norm_adjacency(adj: torch.Tensor,
                       node_mask: torch.Tensor) -> torch.Tensor:
    """Symmetric GCN normalisation ``D^-1/2 (A + I) D^-1/2`` (PyG
    ``GCNConv`` with ``add_self_loops=True``); the self-loops go on valid
    nodes only, and a node of degree 0 gets 0."""
    adj = add_self_loops(adj, node_mask)
    deg = degree(adj)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp_min(deg, 1e-12)),
                           torch.zeros((), dtype=deg.dtype,
                                       device=deg.device))
    return adj * inv_sqrt.unsqueeze(-1) * inv_sqrt.unsqueeze(-2)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with masked entries excluded.

    ``mask`` broadcasts against ``scores``; fully-masked rows return zeros
    (not NaN).  The row max is detached, as in the reference.
    """
    valid = mask > 0
    s = scores + torch.where(valid, 0.0, _NEG_INF)
    s_max = s.amax(dim=dim, keepdim=True).detach()
    unnorm = torch.exp(s - s_max) * valid
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / torch.clamp_min(denom, 1e-16)


def segment_max_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Masked global max pool ``[B, N, F] -> [B, F]``; graphs with no valid
    node pool to 0."""
    neg = torch.where(node_mask.unsqueeze(-1) > 0, 0.0, _NEG_INF).to(x.dtype)
    pooled = (x + neg).amax(dim=-2)
    any_valid = node_mask.amax(dim=-1, keepdim=True) > 0
    return torch.where(any_valid, pooled, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def segment_mean_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Masked global mean pool."""
    s = (x * node_mask.unsqueeze(-1)).sum(-2)
    cnt = torch.clamp_min(node_mask.sum(-1, keepdim=True), 1.0)
    return s / cnt


def segment_sum_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Masked global add pool."""
    return (x * node_mask.unsqueeze(-1)).sum(-2)
