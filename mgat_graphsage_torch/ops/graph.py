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
    "add_self_loops",
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


def add_self_loops(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """adj + I on valid nodes only."""
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    loops = eye * node_mask.unsqueeze(-2) * node_mask.unsqueeze(-1)
    return torch.clamp_max(adj + loops, 1.0)


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
