"""Dense per-molecule adjacency: CUDA kernel (``csrc/adjacency.cu``) and
its plain PyTorch version.

Port of ``mgat_graphsage_tpu/ops/pallas_adjacency.py``.  Semantics:
``adj[b, dst, src] = min(sum_e edge_mask[b, e], 1)`` with
``edges[b, 0] = src`` and ``edges[b, 1] = dst``; duplicate edges sum
before the clamp, padded edges point at node 0 with mask 0, and indices
outside ``[0, N)`` are dropped.  No gradient: the adjacency is a constant
of the model.

The kernel takes any ``N >= 1`` and sums each cell in ascending edge order,
as the plain version does on the CPU (on one thread, or below 32,768 edges
in the batch: past that PyTorch's CPU ``index_put_`` adds floats from
several threads), so the two agree bit for bit, fractional masks included.
"""

from __future__ import annotations

import torch

__all__ = ["dense_adjacency_cuda", "dense_adjacency_plain"]


def dense_adjacency_plain(edges: torch.Tensor, edge_mask: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """Scatter-add version: ``[B, 2, E]`` int + ``[B, E]`` f32 ->
    ``[B, N, N]`` f32."""
    b, _, e = edges.shape
    n = int(num_nodes)
    src = edges[:, 0].long()
    dst = edges[:, 1].long()
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    m = torch.where(ok, edge_mask.float(), torch.zeros((), device=edges.device))
    batch = torch.arange(b, device=edges.device).unsqueeze(1).expand(b, e)
    adj = torch.zeros((b, n, n), dtype=torch.float32, device=edges.device)
    adj.index_put_((batch, dst.clamp(0, n - 1), src.clamp(0, n - 1)), m,
                   accumulate=True)
    return adj.clamp_max(1.0)


def dense_adjacency_cuda(edges: torch.Tensor, edge_mask: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """``[B, 2, E]`` int32 edges + ``[B, E]`` f32 mask -> ``[B, N, N]`` f32.

    On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
    it returns :func:`dense_adjacency_plain`.
    """
    if edges.device.type == "cpu":
        return dense_adjacency_plain(edges, edge_mask, num_nodes)
    if edges.device.type != "cuda" or edge_mask.device != edges.device:
        raise ValueError(f"dense_adjacency_cuda: edges on {edges.device}, "
                         f"edge_mask on {edge_mask.device}; both must be "
                         "on one CUDA device")
    if edges.dtype != torch.int32 or edge_mask.dtype != torch.float32:
        raise TypeError("dense_adjacency_cuda takes int32 edges and f32 "
                        f"edge_mask, got {edges.dtype} and {edge_mask.dtype}")
    if edges.dim() != 3 or edges.shape[1] != 2 \
            or tuple(edge_mask.shape) != (edges.shape[0], edges.shape[2]):
        raise ValueError(f"dense_adjacency_cuda: edges {tuple(edges.shape)} "
                         f"and edge_mask {tuple(edge_mask.shape)} are not "
                         "[B, 2, E] and [B, E]")
    if not (edges.is_contiguous() and edge_mask.is_contiguous()):
        raise ValueError("dense_adjacency_cuda takes contiguous tensors")
    n = int(num_nodes)
    if n < 1:
        raise ValueError(f"dense_adjacency_cuda takes N >= 1, got {n}")
    from ._build import load

    b, _, e = edges.shape
    out = torch.empty((b, n, n), dtype=torch.float32, device=edges.device)
    with torch.cuda.device(edges.device):
        stream = torch.cuda.current_stream(edges.device).cuda_stream
        err = load("adjacency")(edges.data_ptr(), edge_mask.data_ptr(),
                                out.data_ptr(), b, e, n, stream)
    if err:
        raise RuntimeError(f"dense_adjacency kernel launch failed: "
                           f"cudaError {err}")
    dense_adjacency_cuda.launches += 1
    return out


dense_adjacency_cuda.launches = 0
