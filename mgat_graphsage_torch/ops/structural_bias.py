"""Graphormer's structural attention bias (``models/layers.py::
StructuralBias``; Ying et al. 2021, Eq. 6-7).

For ``spd [B, n, n]`` and ``path_types [B, n, n, hops]`` (int8, as
``models/zoo.py::model_inputs`` leaves them; -1 in ``spd`` for unreachable
and padded pairs, type 0 for no bond) and the f32 tables ``spatial [S,
H]``, ``virtual [1, H]`` and ``table [hops, 5, H]`` (the edge encoding's
rows, ``table[m][t] = edge_type[t] @ edge_hop[m]``, formed by the caller;
``table[m][0]`` is the padding type's zero), the bias ``[B, H, n + 1, n +
1]`` f32::

    r = S - 1 where spd < 0, else min(spd, S - 2)
    c = (table[0][t_0] + ... + table[hops-1][t_hops-1]) / clamp(spd, 1, hops)
    bias[:, :, 1:, 1:] = spatial[r] + c       (heads first)
    bias[:, :, 0, :] = bias[:, :, :, 0] = virtual

with the hop terms added in that order.  Two paths compute it:

- the kernels (``csrc/structural_bias.cu``), on CUDA for the calls
  :func:`kernels_support` takes (int8 structure, ``n <= 128``, ``H <=
  32``, ``hops <= 5``, 5 bond-type rows): one forward launch
  (:func:`structural_bias_cuda`), the explicit path's result bit for bit,
  and one backward (:func:`structural_bias_bwd_cuda`) that reads the
  output's gradient once and sums it by table row, with no index sort and
  no int64 copy, the same bits on every run; joined by
  :class:`StructuralBiasKernel`, which saves only the int8 structure.  A
  call that needs no gradient runs the forward alone;
- :func:`structural_bias_explicit`, gathers and adds in plain torch ops
  whose autograd sums the tables' gradients through ``F.embedding``'s
  backward: on the CPU and past the kernels' limits.

:func:`structural_bias_fwd_plain` and :func:`structural_bias_bwd_plain`
are the kernels' algorithm in plain torch, for the tests and
``chip_smoke.py``; the kernel wrappers return them for CPU tensors.

The forward runs inside the caller's ``graphormer.bias`` device span
(``models/zoo.py::GraphormerNet``); the kernel path's backward is the
``graphormer.bias_grad`` device span (``utils/telemetry.py``).  The calls
of the two paths are counted (:func:`counts`, ``/health``'s telemetry),
the kernels' launches on their wrappers.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..utils import telemetry

__all__ = ["StructuralBiasKernel", "structural_bias",
           "structural_bias_explicit", "structural_bias_cuda",
           "structural_bias_bwd_cuda", "structural_bias_fwd_plain",
           "structural_bias_bwd_plain", "kernels_support", "counts",
           "MAX_N", "MAX_HOPS", "MAX_HEADS", "TYPES"]

MAX_N = 128      # atoms (keys n + 1 <= 129): csrc kMaxN
MAX_HOPS = 5     # csrc kMaxHops: the descriptor's 5 bond types
MAX_HEADS = 32   # a backward warp's lanes
TYPES = 5        # bond-type rows of a hop: 0 (none) and 4 bond types

_count_lock = threading.Lock()
_COUNTS = {"explicit": 0, "kernel": 0}


def _count(path: str) -> None:
    with _count_lock:
        _COUNTS[path] += 1


def counts() -> Dict[str, int]:
    """The process's structural bias builds by path (``explicit``,
    ``kernel``)."""
    with _count_lock:
        return dict(_COUNTS)


def kernels_support(spd, path_types, spatial, table) -> bool:
    """True if the kernels take the call: int8 ``spd [B, n, n]`` and
    ``path_types [B, n, n, hops]`` with ``1 <= n <= 128`` and ``1 <= hops
    <= 5``; f32 ``spatial [S, H]`` with ``S >= 2`` and ``H <= 32``, and
    ``table [hops, 5, H]`` f32."""
    if spd.dim() != 3 or path_types.dim() != 4 or spatial.dim() != 2:
        return False
    b, n = spd.shape[:2]
    s, h = spatial.shape
    hops = path_types.shape[-1]
    return (spd.dtype == path_types.dtype == torch.int8
            and tuple(spd.shape) == (b, n, n)
            and tuple(path_types.shape[:3]) == (b, n, n)
            and 1 <= n <= MAX_N and 1 <= hops <= MAX_HOPS
            and 2 <= s and 1 <= h <= MAX_HEADS
            and spatial.dtype == table.dtype == torch.float32
            and tuple(table.shape) == (hops, TYPES, h))


def _rows(d: torch.Tensor, num_spatial: int) -> torch.Tensor:
    """The distance table's row of each distance ``d`` (int64)."""
    return torch.where(d < 0, num_spatial - 1, d.clamp_max(num_spatial - 2))


def structural_bias_explicit(spd, path_types, spatial, virtual, table):
    """The explicit path (module docstring): gathers through
    ``F.embedding``, whose backward sums each table's gradient."""
    b, n = spd.shape[0], spd.shape[1]
    h, hops = spatial.shape[1], table.shape[0]
    d = spd.long()
    inner = F.embedding(_rows(d, spatial.shape[0]), spatial)   # [B,n,n,H]
    types = path_types.long()
    edge = F.embedding(types[..., 0], table[0])
    for m in range(1, hops):
        edge = edge + F.embedding(types[..., m], table[m])
    inner = inner + edge / d.clamp(1, hops).unsqueeze(-1).to(edge.dtype)
    t = virtual.reshape(1, 1, 1, h)
    body = torch.cat([t.expand(b, n, 1, h), inner], dim=2)
    full = torch.cat([t.expand(b, 1, n + 1, h), body], dim=1)
    return full.permute(0, 3, 1, 2).contiguous()


# ---- the kernels' algorithm in plain torch ---------------------------------

def structural_bias_fwd_plain(spd, path_types, spatial, virtual, table):
    """The forward kernel's algorithm: per pair, its distance row and its
    hops' rows of the flattened edge table (types outside 0..4 clamped,
    as the kernel reads them), the hop terms added in order, divided by
    the hop count, added to the distance term; the graph token's row and
    column ``virtual``.  The explicit path's values bit for bit."""
    b, n = spd.shape[0], spd.shape[1]
    (s, h), hops = spatial.shape, table.shape[0]
    d = spd.long()
    types = path_types.long().clamp(0, TYPES - 1)
    flat = table.reshape(hops * TYPES, h)
    c = flat[types[..., 0]]
    for m in range(1, hops):
        c = c + flat[m * TYPES + types[..., m]]
    body = spatial[_rows(d, s)] + c / d.clamp(1, hops).unsqueeze(-1).to(
        c.dtype)
    out = spatial.new_empty(b, h, n + 1, n + 1)
    out[:, :, 0, :] = virtual.reshape(1, h, 1)
    out[:, :, 1:, 0] = virtual.reshape(1, h, 1)
    out[:, :, 1:, 1:] = body.permute(0, 3, 1, 2)
    return out


def structural_bias_bwd_plain(grad, spd, path_types, num_spatial: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's algorithm: ``(d_spatial [S, H], d_virtual [1,
    H], d_table [hops, 5, H])`` from the output's gradient ``grad [B, H,
    n + 1, n + 1]``, summed by table row: each pair's gradient into its
    distance row, and divided by its hop count into the row ``(m, t_m)``
    of each hop whose type is not 0 (type 0 is the constant zero: its rows
    stay 0); the graph token's row and column into ``d_virtual``."""
    h = grad.shape[1]
    hops = path_types.shape[-1]
    d_virtual = (grad[:, :, 0, :].sum(dim=(0, 2))
                 + grad[:, :, 1:, 0].sum(dim=(0, 2))).reshape(1, h)
    body = grad[:, :, 1:, 1:].permute(0, 2, 3, 1).reshape(-1, h)
    d = spd.long().reshape(-1)
    d_spatial = grad.new_zeros(num_spatial, h).index_add_(
        0, _rows(d, num_spatial), body)
    v = body / d.clamp(1, hops).unsqueeze(-1).to(grad.dtype)
    types = path_types.long().clamp(0, TYPES - 1).reshape(-1, hops)
    d_table = grad.new_zeros(hops * TYPES, h)
    for m in range(hops):
        t = types[:, m]
        bond = t > 0
        d_table.index_add_(0, m * TYPES + t[bond], v[bond])
    return d_spatial, d_virtual, d_table.reshape(hops, TYPES, h)


# ---- the kernels ------------------------------------------------------------

def _check(name: str, spd, path_types, *rest) -> None:
    ts = (spd, path_types) + rest
    if spd.device.type != "cuda" or any(t.device != spd.device for t in ts):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def structural_bias_cuda(spd, path_types, spatial, virtual, table):
    """Forward kernel: the bias ``[B, H, n + 1, n + 1]`` f32.  Records no
    gradient (:func:`structural_bias` does).  On a CUDA tensor it launches
    the kernel (or raises); on a CPU tensor it returns
    :func:`structural_bias_fwd_plain`."""
    if spd.device.type == "cpu":
        return structural_bias_fwd_plain(spd, path_types, spatial, virtual,
                                         table)
    _check("structural_bias_cuda", spd, path_types, spatial, virtual, table)
    if not kernels_support(spd, path_types, spatial, table) \
            or virtual.numel() != spatial.shape[1] \
            or virtual.dtype != torch.float32:
        raise ValueError(
            "structural_bias_cuda takes int8 spd [B, n, n] and path_types "
            f"[B, n, n, hops] (n <= {MAX_N}, hops <= {MAX_HOPS}), f32 "
            f"spatial [S >= 2, H <= {MAX_HEADS}], virtual [1, H] and table "
            f"[hops, {TYPES}, H]; got {spd.dtype} {tuple(spd.shape)}, "
            f"{path_types.dtype} {tuple(path_types.shape)}, "
            f"{[(t.dtype, tuple(t.shape)) for t in (spatial, virtual, table)]}"
            "; gate with kernels_support")
    from ._build import load

    b, n = spd.shape[0], spd.shape[1]
    (s, h), hops = spatial.shape, table.shape[0]
    spd, path_types = spd.contiguous(), path_types.contiguous()
    spatial, virtual, table = (t.contiguous()
                               for t in (spatial, virtual, table))
    out = torch.empty(b, h, n + 1, n + 1, dtype=torch.float32,
                      device=spd.device)
    with torch.cuda.device(spd.device):
        err = load("structural_bias")(
            spd.data_ptr(), path_types.data_ptr(), spatial.data_ptr(),
            virtual.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, n, s,
            hops, _stream(spd))
    if err:
        raise RuntimeError(f"structural_bias kernel launch failed: "
                           f"cudaError {err}")
    structural_bias_cuda.launches += 1
    return out


structural_bias_cuda.launches = 0


def structural_bias_bwd_cuda(grad, spd, path_types, num_spatial: int):
    """Backward kernel: ``(d_spatial [S, H], d_virtual [1, H], d_table
    [hops, 5, H])`` f32 for the output's gradient ``grad [B, H, n + 1, n +
    1]`` f32 (two launches: each block's sums, then their total in block
    order).  On a CUDA tensor it launches the kernel (or raises); on a CPU
    tensor it returns :func:`structural_bias_bwd_plain`."""
    if grad.device.type == "cpu":
        return structural_bias_bwd_plain(grad, spd, path_types, num_spatial)
    _check("structural_bias_bwd_cuda", spd, path_types, grad)
    b, h = grad.shape[0], grad.shape[1]
    n = spd.shape[1]
    hops = path_types.shape[-1]
    if grad.dtype != torch.float32 \
            or tuple(grad.shape) != (b, h, n + 1, n + 1) \
            or spd.dtype != torch.int8 or path_types.dtype != torch.int8 \
            or tuple(spd.shape) != (b, n, n) \
            or tuple(path_types.shape[:3]) != (b, n, n) \
            or not (1 <= n <= MAX_N and 1 <= hops <= MAX_HOPS
                    and 1 <= h <= MAX_HEADS and num_spatial >= 2):
        raise ValueError(
            "structural_bias_bwd_cuda takes f32 grad [B, H, n + 1, n + 1] "
            f"(H <= {MAX_HEADS}, n <= {MAX_N}) and the forward's int8 "
            f"structure (hops <= {MAX_HOPS}), num_spatial >= 2; got "
            f"{grad.dtype} {tuple(grad.shape)}, {spd.dtype} "
            f"{tuple(spd.shape)}, {path_types.dtype} "
            f"{tuple(path_types.shape)}, S={num_spatial}")
    from ._build import load

    grad = grad.contiguous()
    spd, path_types = spd.contiguous(), path_types.contiguous()
    dev = grad.device
    d_spatial = torch.zeros(num_spatial, h, dtype=torch.float32, device=dev)
    d_virtual = torch.empty(1, h, dtype=torch.float32, device=dev)
    d_table = torch.zeros(hops, TYPES, h, dtype=torch.float32, device=dev)
    bins = min(n, num_spatial - 1) + 1 + hops * (TYPES - 1) + 1
    with torch.cuda.device(dev):
        blocks = load("structural_bias", "structural_bias_bwd_blocks")(
            b, h, n, num_spatial, hops)
        if blocks < 0:
            raise RuntimeError(f"structural_bias_bwd grid query failed: "
                               f"cudaError {-blocks}")
        partial = torch.empty(blocks, bins, 32, dtype=torch.float32,
                              device=dev)
        err = load("structural_bias", "structural_bias_bwd_launch")(
            grad.data_ptr(), spd.data_ptr(), path_types.data_ptr(),
            partial.data_ptr(), d_spatial.data_ptr(), d_virtual.data_ptr(),
            d_table.data_ptr(), b, h, n, num_spatial, hops, blocks,
            _stream(grad))
    if err:
        raise RuntimeError(f"structural_bias_bwd kernel launch failed: "
                           f"cudaError {err}")
    structural_bias_bwd_cuda.launches += 1
    return d_spatial, d_virtual, d_table


structural_bias_bwd_cuda.launches = 0


class StructuralBiasKernel(torch.autograd.Function):
    """The kernel path with its gradient: saves the int8 structure and
    nothing in f32; the backward is the ``graphormer.bias_grad`` device
    span."""

    @staticmethod
    def forward(ctx, spd, path_types, spatial, virtual, table):
        out = structural_bias_cuda(spd, path_types, spatial, virtual, table)
        ctx.save_for_backward(spd, path_types)
        ctx.num_spatial = spatial.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        spd, path_types = ctx.saved_tensors
        with telemetry.device_span("graphormer.bias_grad", g.device):
            d_spatial, d_virtual, d_table = structural_bias_bwd_cuda(
                g, spd, path_types, ctx.num_spatial)
        return None, None, d_spatial, d_virtual, d_table


def structural_bias(spd, path_types, spatial, virtual,
                    table) -> torch.Tensor:
    """``[B, H, n + 1, n + 1]`` f32: the bias of the module docstring.  On
    CUDA, where :func:`kernels_support` takes the call, the kernels (the
    backward where a table needs a gradient, the forward alone where none
    does); else the explicit path."""
    if spd.is_cuda and kernels_support(spd, path_types, spatial, table):
        _count("kernel")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (spatial, virtual, table)):
            return StructuralBiasKernel.apply(spd, path_types, spatial,
                                              virtual, table)
        return structural_bias_cuda(spd, path_types, spatial, virtual, table)
    _count("explicit")
    return structural_bias_explicit(spd, path_types, spatial, virtual, table)
