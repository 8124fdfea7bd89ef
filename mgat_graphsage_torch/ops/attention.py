"""Per-molecule fused masked attention: CUDA kernels for the forward
(``csrc/attention.cu``) and the backward (``csrc/attention_bwd.cu``), their
plain PyTorch versions, and the ``autograd.Function`` that joins them.

Port of ``mgat_graphsage_tpu/ops/pallas_attention.py::
fused_masked_attention`` and its custom VJP.  Per molecule, with the
reference layer's transposed query/key roles::

    scores = k_new @ q^T / sqrt(F)          (keys masked by node_mask)
    attn   = masked_softmax(scores)         (fully-masked rows give 0)
    out    = attn @ v  (+ v when residual)

The backward recomputes ``attn`` (nothing ``[B, N, N]`` is saved) and
returns ``dq, dk_new, dv``; the mask gets no gradient.

Shape limit of the kernels: ``1 <= N <= 128``, ``1 <= F <= 128`` (the
forward fits every such shape: :func:`forward_smem_bytes`) and the
backward's shared memory, ``((2 N + 2 N4) F4 + 2 N4 N8 + N) * 4`` bytes
with ``N4``, ``F4`` rounded up to 4 and ``N8`` to 8, within the 227 KB a block may use
(N <= 128 at the flagship's F = 35, N <= 84 at F = 128).  :func:`kernels_support` is that test; ``ModifiedGATLayer``
asks it before any launch and takes the plain path past the limit, as the
reference layer takes its XLA path past its kernel's (N > 512).  The
wrappers themselves never choose: on a CUDA tensor they launch their
kernel or raise.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fused_masked_attention", "fused_masked_attention_cuda",
           "attention_bwd_cuda", "attention_plain", "attention_bwd_plain",
           "kernels_support", "forward_smem_bytes", "MAX_N", "MAX_F"]

MAX_N = 128
MAX_F = 128
_SMEM_LIMIT = 232448     # bytes of shared memory a block may opt into
_FWD_ROWS = 4            # csrc/attention.cu: kRows, query rows per half-warp
_FWD_MAX_WARPS = 16      # csrc/attention.cu: kMaxWarps


def _fwd_smem_floats(n: int, fp: int, tiles: int, warps: int) -> int:
    """``csrc/attention.cu::smem_floats``: q and v (v padded to N4 rows),
    the mask, the block's ``tiles`` row tiles of k_new and an attn
    scratch of one row tile per half-warp."""
    n4 = (n + 3) & ~3
    return ((n + n4) * fp + n4 + _FWD_ROWS * tiles * fp
            + 2 * _FWD_ROWS * warps * n4)


def forward_smem_bytes(n: int, f: int, groups: int = 1) -> int:
    """Shared memory of one forward block, as the launcher works it out:
    the rows of a molecule in ``groups`` row groups (of row tiles, a
    half-warp's rows each), or in more until the block fits the 227 KB a
    block may use."""
    fp = ((f + 3) & ~3) | 4              # an odd number of float4
    nt = -(-n // _FWD_ROWS)
    while True:
        tiles = -(-nt // groups)
        warps = min((tiles + 1) // 2, _FWD_MAX_WARPS)
        smem = 4 * _fwd_smem_floats(n, fp, tiles, warps)
        if smem <= _SMEM_LIMIT or tiles == 1:
            return smem
        groups += 1


def _forward_fits(n: int, f: int) -> bool:
    return (1 <= n <= MAX_N and 1 <= f <= MAX_F
            and forward_smem_bytes(n, f) <= _SMEM_LIMIT)


def kernels_support(n: int, f: int) -> bool:
    """True if both attention kernels take ``[*, n, f]`` (the forward
    alone takes any N, F <= 128)."""
    n4, n8, f4 = -(-n // 4) * 4, -(-n // 8) * 8, -(-f // 4) * 4
    smem = ((2 * n + 2 * n4) * f4 + 2 * n4 * n8 + n) * 4
    return _forward_fits(n, f) and smem <= _SMEM_LIMIT


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


def attention_bwd_plain(q: torch.Tensor, k_new: torch.Tensor,
                        v: torch.Tensor, node_mask: torch.Tensor,
                        g: torch.Tensor, residual: bool = True):
    """Plain version of the backward: ``(dq, dk_new, dv)`` for the output
    gradient ``g``, by the explicit formula of the reference VJP."""
    from .graph import masked_softmax

    scale = 1.0 / math.sqrt(q.shape[-1])
    attn = masked_softmax(torch.matmul(k_new, q.transpose(-1, -2)) * scale,
                          node_mask.unsqueeze(-2), dim=-1)
    dv = torch.matmul(attn.transpose(-1, -2), g)
    if residual:
        dv = dv + g
    dattn = torch.matmul(g, v.transpose(-1, -2))
    dscores = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    dk = scale * torch.matmul(dscores, q)
    dq = scale * torch.matmul(dscores.transpose(-1, -2), k_new)
    return dq, dk, dv


def _check(name: str, ts, n_shaped: int, fits) -> None:
    """Device, dtype, shape and layout checks of a kernel wrapper: the
    first ``n_shaped`` tensors are ``[B, N, F]``, the one after them the
    ``[B, N]`` mask, the rest ``[B, N, F]``; ``fits(N, F)`` is the
    kernel's shape limit."""
    q = ts[0]
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name} takes f32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    mask = ts[n_shaped]
    others = ts[:n_shaped] + ts[n_shaped + 1:]
    if q.dim() != 3 or any(t.shape != q.shape for t in others) \
            or tuple(mask.shape) != tuple(q.shape[:2]):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]} "
                         "are not [B, N, F] with a [B, N] mask")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    _, n, f = q.shape
    if not fits(n, f):
        raise ValueError(f"{name} takes N <= {MAX_N}, F <= {MAX_F} within "
                         f"its shared-memory limit, got N={n}, F={f}; gate "
                         "with kernels_support")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_masked_attention_cuda(q: torch.Tensor, k_new: torch.Tensor,
                                v: torch.Tensor, node_mask: torch.Tensor,
                                residual: bool = True) -> torch.Tensor:
    """Forward kernel: q, k_new, v ``[B, N, F]`` f32, node_mask ``[B, N]``
    f32 -> ``[B, N, F]`` f32.  Records no gradient (use
    :func:`fused_masked_attention` for that).

    On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
    it returns :func:`attention_plain`.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k_new, v, node_mask, residual)
    _check("fused_masked_attention_cuda", (q, k_new, v, node_mask), 3,
           _forward_fits)
    from ._build import load

    b, n, f = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = load("attention")(q.data_ptr(), k_new.data_ptr(), v.data_ptr(),
                                node_mask.data_ptr(), out.data_ptr(), b, n,
                                f, 1.0 / math.sqrt(f), int(bool(residual)),
                                _stream(q))
    if err:
        raise RuntimeError(f"masked_attention kernel launch failed: "
                           f"cudaError {err}")
    fused_masked_attention_cuda.launches += 1
    return out


fused_masked_attention_cuda.launches = 0


def attention_bwd_cuda(q: torch.Tensor, k_new: torch.Tensor,
                       v: torch.Tensor, node_mask: torch.Tensor,
                       g: torch.Tensor, residual: bool = True):
    """Backward kernel: the forward's inputs plus the output gradient
    ``g [B, N, F]`` f32 -> ``(dq, dk_new, dv)``, each ``[B, N, F]`` f32.

    On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
    it returns :func:`attention_bwd_plain`.
    """
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k_new, v, node_mask, g, residual)
    _check("attention_bwd_cuda", (q, k_new, v, node_mask, g), 3,
           kernels_support)
    from ._build import load

    b, n, f = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        err = load("attention_bwd")(
            q.data_ptr(), k_new.data_ptr(), v.data_ptr(),
            node_mask.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, n, f, 1.0 / math.sqrt(f),
            int(bool(residual)), _stream(q))
    if err:
        raise RuntimeError(f"masked_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    attention_bwd_cuda.launches += 1
    return dq, dk, dv


attention_bwd_cuda.launches = 0


class _FusedMaskedAttention(torch.autograd.Function):
    """Forward kernel 2, backward kernel 3; saves only the inputs."""

    @staticmethod
    def forward(ctx, q, k_new, v, node_mask, residual):
        ctx.residual = residual
        ctx.save_for_backward(q, k_new, v, node_mask)
        return fused_masked_attention_cuda(q, k_new, v, node_mask, residual)

    @staticmethod
    def backward(ctx, g):
        q, k_new, v, node_mask = ctx.saved_tensors
        dq, dk, dv = attention_bwd_cuda(q, k_new, v, node_mask,
                                        g.contiguous(), ctx.residual)
        return dq, dk, dv, None, None


def fused_masked_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v: torch.Tensor, node_mask: torch.Tensor,
                           residual: bool = True) -> torch.Tensor:
    """Differentiable fused masked attention (no gradient to the mask):
    q, k_new, v ``[B, N, F]`` f32 contiguous, node_mask ``[B, N]`` f32."""
    return _FusedMaskedAttention.apply(q, k_new, v, node_mask, residual)
