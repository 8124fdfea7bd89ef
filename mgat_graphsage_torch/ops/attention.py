"""Per-molecule fused masked attention (forward): CUDA kernel
(``csrc/attention.cu``) and its plain PyTorch version.

Port of the forward of ``mgat_graphsage_tpu/ops/pallas_attention.py::
fused_masked_attention``.  Per molecule, with the reference layer's
transposed query/key roles::

    scores = k_new @ q^T / sqrt(F)          (keys masked by node_mask)
    attn   = masked_softmax(scores)         (fully-masked rows give 0)
    out    = attn @ v  (+ v when residual)

The kernel has no backward yet: on CUDA it runs where no gradient is
required (``torch.inference_mode()`` on the serving path) and raises
otherwise.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fused_masked_attention_cuda", "attention_plain", "MAX_N",
           "MAX_F"]

MAX_N = 128
MAX_F = 128


def attention_plain(q: torch.Tensor, k_new: torch.Tensor, v: torch.Tensor,
                    node_mask, residual: bool = True) -> torch.Tensor:
    """Plain version; ``node_mask=None`` attends over every key."""
    from .graph import masked_softmax

    scores = torch.matmul(k_new, q.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if node_mask is None:
        attn = torch.softmax(scores, dim=-1)
    else:
        attn = masked_softmax(scores, node_mask.unsqueeze(-2), dim=-1)
    out = torch.matmul(attn, v)
    return out + v if residual else out


def fused_masked_attention_cuda(q: torch.Tensor, k_new: torch.Tensor,
                                v: torch.Tensor, node_mask: torch.Tensor,
                                residual: bool = True) -> torch.Tensor:
    """q, k_new, v ``[B, N, F]`` f32, node_mask ``[B, N]`` f32 ->
    ``[B, N, F]`` f32.

    On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
    it returns :func:`attention_plain`.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k_new, v, node_mask, residual)
    ts = (q, k_new, v, node_mask)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("fused_masked_attention_cuda: all inputs must be "
                         "on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("fused_masked_attention_cuda takes f32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    if q.dim() != 3 or k_new.shape != q.shape or v.shape != q.shape \
            or tuple(node_mask.shape) != tuple(q.shape[:2]):
        raise ValueError("fused_masked_attention_cuda: shapes "
                         f"{[tuple(t.shape) for t in ts]} are not "
                         "3 x [B, N, F] and [B, N]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_masked_attention_cuda takes contiguous "
                         "tensors")
    b, n, f = q.shape
    if not (1 <= n <= MAX_N and 1 <= f <= MAX_F):
        raise ValueError(f"fused_masked_attention_cuda takes N <= {MAX_N} "
                         f"and F <= {MAX_F}, got N={n}, F={f}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "fused_masked_attention_cuda is forward-only (its backward "
            "kernel is not ported yet): call it under torch.no_grad() or "
            "torch.inference_mode()")
    from ._build import load

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = load("attention")(q.data_ptr(), k_new.data_ptr(), v.data_ptr(),
                                node_mask.data_ptr(), out.data_ptr(), b, n,
                                f, 1.0 / math.sqrt(f), int(bool(residual)),
                                stream)
    if err:
        raise RuntimeError(f"masked_attention kernel launch failed: "
                           f"cudaError {err}")
    fused_masked_attention_cuda.launches += 1
    return out


fused_masked_attention_cuda.launches = 0
