"""Multi-head attention with an additive per-head bias and a key mask: the
graph transformers' attention (``models/layers.py::GraphormerLayer``, and
``GPSLayer`` without a bias).

For ``q, k, v [B, H, N, d]``, ``bias [B, H, N, N]`` (f32, or None for no
bias) and ``key_mask [B, N]`` (True where a key may be attended to)::

    A = softmax(scale * q k^T + bias, masked keys at -inf)
    out = dropout(A) v

A row with no valid key reads 0 on every path (a padded molecule of
GraphGPS's batch has none).  With ``bias=None`` no path reads a bias or
forms its gradient: the kernels read and write nothing ``[B, H, N, N]``
but the keep-mask, and the bias's gradient is None.

The dropout is a keep-mask given by the caller (drawn from the trainer's
dropout generator, so a reference can draw the same), kept probabilities
scaled by ``1 / (1 - p)``.  Two paths compute it:

- the kernel (``csrc/biased_attention.cu``), on CUDA for the shapes
  :func:`kernels_support` takes (bf16, ``N <= 128``, ``d`` in 8, 16, 24,
  32): one launch a layer forward (:func:`biased_attention_cuda`) and one
  backward (:func:`biased_attention_bwd_cuda`), joined by
  :class:`BiasedAttentionKernel`.  The logits, the softmax and the dropout
  stay on chip in f32, the products take bf16 operands with f32 sums; the
  forward writes the rows' log-sum-exp, from which the backward recomputes
  the probabilities, and nothing ``[B, H, N, N]`` is saved or written but
  the bias gradient.  A call that needs no gradient runs the forward
  alone, without the statistics;
- :class:`BiasedAttention`, the explicit path in plain torch ops, on the
  CPU and past the kernel's limits: the logits and the softmax in f32 (the
  products in the inputs' dtype with f32 accumulation), and a backward
  that saves the f32 probabilities.

:func:`biased_attention_fwd_plain` and :func:`biased_attention_bwd_plain`
are the kernel's own algorithm in plain torch (what the kernel rounds to
bf16, they round too), for the tests and ``chip_smoke.py``; the kernel
wrappers return them for CPU tensors.  :func:`biased_attention_sdpa`
(``scaled_dot_product_attention`` with the float bias as its mask) is no
path of the port: ``chip_smoke.py`` times it as the library's yardstick
and a CPU test holds the explicit path against it; it is not counted.

Each forward and backward is a ``graphormer.attention`` device span
(``utils/telemetry.py``); the calls of the two paths are counted, and
those made without a bias apart as ``unbiased`` (:func:`counts`,
``/health``'s telemetry), the kernels' launches on their wrappers.

EGT's gated attention (:func:`gated_attention`; ``models/layers.py::
EGTLayer``) is a mode of its own beside these, with the pair stream's
bias ``E`` and gate logits ``G [B, H, N, N]``, the clip ``c`` and ``V``
virtual nodes first::

    H^ = clamp(scale * q k^T, -c, c) + E
    A  = softmax(H^, masked keys at -inf) * sigmoid(G), masked keys 0
    s  = ln(1 + sum_j sigmoid(G)), masked keys 0; 1 on the first V rows
    out = s * dropout(A) v ;  returns (out, H^)

``H^`` (every slot's) is the layer's pair update's input, and its
gradient comes back into the op's backward.  Two paths compute it, on
separate code from the biased attention's:

- the kernel (``csrc/gated_attention.cu``), on CUDA for the shapes
  :func:`gated_kernels_support` takes (bf16, ``N <= 128``, ``d`` in
  :data:`HEAD_DIMS` but 32 past ``N = 96``, heads a multiple of 8): one
  launch a layer forward (:func:`gated_attention_cuda`) and one backward
  (:func:`gated_attention_bwd_cuda`), joined by
  :class:`GatedAttentionKernel`.  ``E``, ``G``, ``H^`` and their
  gradients are read and written in the pair stream's own ``[B, N, N,
  H]`` layout, bf16 (the ``[B, H, N, N]`` tensors are its permuted
  views); the logits, the clip, the softmax, the gates and the scaler
  stay on chip in f32, and the forward saves two f32 row statistics (the
  log-sum-exp and the gate sum), from which the backward recomputes the
  rest.  A call that needs no gradient runs the forward alone, without
  the statistics;
- :class:`GatedAttention`, the explicit path in plain torch ops, on the
  CPU and past the kernel's limits: the logits, the clip, the softmax,
  the gate and the scaler in f32, the products in the inputs' dtype with
  f32 sums, ``H^`` returned in f32; its forward saves the f32
  probabilities and gates.

:func:`gated_attention_fwd_plain` and :func:`gated_attention_bwd_plain`
are the kernel's own algorithm in plain torch, rounding where it rounds;
the kernel wrappers return them for CPU tensors.  Each forward and
backward is an ``egt.attention`` device span; :func:`gated_counts`
counts the calls by path (``explicit``, ``kernel``), the real pairs of
keys (``pairs``, of the valid keys of each row, summed on the device and
read only there) and the ``[B, N, N]`` slots they ran over
(``pair_slots``); the kernels' launches on their wrappers.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import telemetry

__all__ = ["BiasedAttention", "BiasedAttentionKernel", "biased_attention",
           "biased_attention_cuda", "biased_attention_bwd_cuda",
           "biased_attention_fwd_plain", "biased_attention_bwd_plain",
           "biased_attention_sdpa", "kernels_support", "counts", "MAX_N",
           "HEAD_DIMS", "GatedAttention", "GatedAttentionKernel",
           "gated_attention", "gated_attention_cuda",
           "gated_attention_bwd_cuda", "gated_attention_fwd_plain",
           "gated_attention_bwd_plain", "gated_kernels_support",
           "gated_counts"]

MAX_N = 128                 # keys (and rows) of a block: csrc KT <= 8
HEAD_DIMS = (8, 16, 24, 32)  # csrc D8 = d / 8 in 1..4

_count_lock = threading.Lock()
_COUNTS = {"explicit": 0, "kernel": 0, "unbiased": 0}
_GATED = {"explicit": 0, "kernel": 0, "pair_slots": 0}
GATED_HEADS = 8             # heads a block of csrc/gated_attention.cu
_PAIRS: Dict[torch.device, torch.Tensor] = {}   # device -> int64 sum


def _count(path: str) -> None:
    with _count_lock:
        _COUNTS[path] += 1


def counts() -> Dict[str, int]:
    """The process's attention calls by path (``explicit``, ``kernel``),
    and those of either path made without a bias (``unbiased``)."""
    with _count_lock:
        return dict(_COUNTS)


def kernels_support(n: int, d: int, dtype: torch.dtype) -> bool:
    """True if the two kernels take ``[B, H, n, d]`` inputs of ``dtype``:
    bf16, ``1 <= n <= 128`` and ``d`` in :data:`HEAD_DIMS`.  Every such
    shape fits a block's shared memory (at most ~124 KB, at N = 128)."""
    return dtype == torch.bfloat16 and 1 <= n <= MAX_N and d in HEAD_DIMS


def _logits(q, k, bias, key_mask, scale):
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if bias is not None:
        s = s + bias
    return s.masked_fill(~key_mask[:, None, None, :], float("-inf"))


def _softmax(s, key_mask):
    """The probabilities of logits ``s``; 0 in a row with no valid key
    (where the softmax of -inf alone is NaN)."""
    a = torch.softmax(s, dim=-1)
    return torch.where(key_mask.any(-1)[:, None, None, None], a,
                       a.new_zeros(()))


class BiasedAttention(torch.autograd.Function):
    """The explicit path (module docstring).  ``bias`` is f32 ``[B, H, N,
    N]`` or None; ``keep`` is a bool keep-mask ``[B, H, N, N]`` or None,
    and ``p`` its drop rate; kept probabilities are scaled by ``1 / (1 -
    p)``."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_mask, keep: Optional[torch.Tensor],
                p: float, scale: float):
        with telemetry.device_span("graphormer.attention", q.device):
            a = _softmax(_logits(q, k, bias, key_mask, scale), key_mask)
            ad = a if keep is None else a * keep / (1.0 - p)
            out = torch.matmul(ad.to(v.dtype), v)
        ctx.save_for_backward(q, k, v, a, keep)
        ctx.p, ctx.scale, ctx.biased = p, scale, bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, a, keep = ctx.saved_tensors
        p, scale = ctx.p, ctx.scale
        with telemetry.device_span("graphormer.attention", q.device):
            g = g.to(v.dtype)
            ad = a if keep is None else a * keep / (1.0 - p)
            dv = torch.matmul(ad.to(v.dtype).transpose(-1, -2), g)
            da = torch.matmul(g, v.transpose(-1, -2)).float()
            if keep is not None:
                da = da * keep / (1.0 - p)
            ds = a * (da - (da * a).sum(dim=-1, keepdim=True))
            dsq = ds.to(q.dtype)
            dq = torch.matmul(dsq, k) * scale
            dk = torch.matmul(dsq.transpose(-1, -2), q) * scale
        return dq, dk, dv, ds if ctx.biased else None, None, None, None, \
            None


# ---- the kernel's algorithm in plain torch ---------------------------------

def _rscale(p: float) -> float:
    """``1 / (1 - p)`` in f32, as the kernel takes it."""
    return float(np.float32(1.0) / np.float32(1.0 - p))


def _plain_logits(q, k, bias, key_mask, scale, ct):
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(ct)
    return s.masked_fill(~key_mask[:, None, None, :], float("-inf"))


def _keep_scale(keep, p, ct):
    return 1.0 if keep is None else keep.to(ct) * _rscale(p)


def biased_attention_fwd_plain(q, k, v, bias, key_mask,
                               keep: Optional[torch.Tensor] = None,
                               p: float = 0.0,
                               scale: Optional[float] = None):
    """The forward kernel's algorithm: ``(out, lse)``, ``out`` in the
    inputs' dtype, ``lse [B, H, N]`` (+inf for a row with no valid key,
    whose ``out`` is 0).  Computed in f32 (f64 for f64 inputs); the
    dropped probabilities are rounded to the inputs' dtype before ``A v``,
    as the kernel rounds them."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    ct, dt = torch.promote_types(q.dtype, torch.float32), q.dtype
    s = _plain_logits(q, k, bias, key_mask, scale, ct)
    m = s.amax(dim=-1, keepdim=True)
    m = m.masked_fill(m == float("-inf"), 0.0)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
    a = e * inv * _keep_scale(keep, p, ct)
    out = torch.matmul(a.to(dt).to(ct), v.to(ct)).to(dt)
    lse = torch.where(total > 0, m + torch.log(total),
                      torch.full_like(total, float("inf")))
    return out, lse.squeeze(-1)


def biased_attention_bwd_plain(q, k, v, out, g, bias, key_mask, lse,
                               keep: Optional[torch.Tensor] = None,
                               p: float = 0.0,
                               scale: Optional[float] = None):
    """The backward kernel's algorithm: ``(dq, dk, dv, dbias)`` from the
    forward's inputs, its ``out`` and ``lse`` and the output gradient
    ``g``: the probabilities recomputed from ``lse``, ``D = rowsum(g *
    out)``, ``dS = P * (dP - D)`` the bias gradient (in the bias's dtype),
    and ``dS`` and the dropped probabilities rounded to the inputs' dtype
    before their products; ``dbias`` is None without a bias."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    ct, dt = torch.promote_types(q.dtype, torch.float32), q.dtype
    s = _plain_logits(q, k, bias, key_mask, scale, ct)
    prob = torch.exp(s - lse.to(ct).unsqueeze(-1))
    kp = _keep_scale(keep, p, ct)
    gc = g.to(ct)
    dsum = (gc * out.to(ct)).sum(dim=-1, keepdim=True)
    ds = prob * (torch.matmul(gc, v.to(ct).transpose(-1, -2)) * kp - dsum)
    dsq = ds.to(dt).to(ct)
    dq = (torch.matmul(dsq, k.to(ct)) * scale).to(dt)
    dk = (torch.matmul(dsq.transpose(-1, -2), q.to(ct)) * scale).to(dt)
    dv = torch.matmul((prob * kp).to(dt).to(ct).transpose(-1, -2),
                      gc).to(dt)
    return dq, dk, dv, None if bias is None else ds.to(bias.dtype)


# ---- the kernels ------------------------------------------------------------

def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, H, N, d] as the kernels read it: d contiguous, the other
    strides multiples of 8 elements and a 16-byte aligned start (a copy
    only where it is not)."""
    if t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _check(name: str, q, k, v, bias, key_mask, keep) -> None:
    ts = [t for t in (q, k, v, bias, key_mask, keep) if t is not None]
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share a [B, H, N, d] "
                         f"shape, got {[tuple(t.shape) for t in (q, k, v)]}")
    b, h, n, d = q.shape
    if not kernels_support(n, d, q.dtype) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bf16 q, k, v with N <= {MAX_N} and "
                         f"d in {HEAD_DIMS}, got N={n}, d={d}, "
                         f"{[t.dtype for t in (q, k, v)]}; gate with "
                         "kernels_support")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (b, h, n, n)):
        raise ValueError(f"{name}: bias must be f32 [B, H, N, N] or None, "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, n):
        raise ValueError(f"{name}: key_mask must be bool [B, N], got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    if keep is not None and (keep.dtype != torch.bool
                             or tuple(keep.shape) != (b, h, n, n)):
        raise ValueError(f"{name}: keep must be bool [B, H, N, N], got "
                         f"{keep.dtype} {tuple(keep.shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def biased_attention_cuda(q, k, v, bias, key_mask,
                          keep: Optional[torch.Tensor] = None,
                          p: float = 0.0, scale: Optional[float] = None,
                          stats: bool = False):
    """Forward kernel: ``(out, lse)``, ``out [B, H, N, d]`` bf16 (the
    transpose of a ``[B, N, H, d]`` buffer) and ``lse [B, H, N]`` f32 when
    ``stats``, else None.  Records no gradient (:func:`biased_attention`
    does).  On a CUDA tensor it launches the kernel (or raises); on a CPU
    tensor it returns :func:`biased_attention_fwd_plain`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out, lse = biased_attention_fwd_plain(q, k, v, bias, key_mask, keep,
                                              p, scale)
        return out, (lse if stats else None)
    _check("biased_attention_cuda", q, k, v, bias, key_mask, keep)
    from ._build import load

    b, h, n, d = q.shape
    q, k, v = _rows(q), _rows(k), _rows(v)
    if not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = None if bias is None else bias.contiguous()
    key_mask = key_mask.contiguous()
    keep = None if keep is None else keep.contiguous()
    out = torch.empty(b, n, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device) \
        if stats else None
    with torch.cuda.device(q.device):
        err = load("biased_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            key_mask.data_ptr(), _ptr(keep), out.data_ptr(), _ptr(lse), b, h,
            n, d, *q.stride()[:3], scale, _rscale(p), _stream(q))
    if err:
        raise RuntimeError(f"biased_attention kernel launch failed: "
                           f"cudaError {err}")
    biased_attention_cuda.launches += 1
    return out.transpose(1, 2), lse


biased_attention_cuda.launches = 0


def biased_attention_bwd_cuda(q, k, v, out, g, bias, key_mask, lse,
                              keep: Optional[torch.Tensor] = None,
                              p: float = 0.0, scale: Optional[float] = None):
    """Backward kernel: ``(dq, dk, dv, dbias)`` for the output gradient
    ``g``, the first three bf16 ``[B, H, N, d]`` (transposes of ``[B, N,
    H, d]`` buffers), ``dbias [B, H, N, N]`` f32, or None (neither
    allocated nor written) without a bias.  On a CUDA tensor it
    launches the kernel (or raises); on a CPU tensor it returns
    :func:`biased_attention_bwd_plain`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return biased_attention_bwd_plain(q, k, v, out, g, bias, key_mask,
                                          lse, keep, p, scale)
    _check("biased_attention_bwd_cuda", q, k, v, bias, key_mask, keep)
    if out.shape != q.shape or g.shape != q.shape \
            or out.dtype != q.dtype or g.dtype != q.dtype:
        raise ValueError("biased_attention_bwd_cuda: out and g must be "
                         "q's shape and dtype")
    from ._build import load

    b, h, n, d = q.shape
    q, k, v = _rows(q), _rows(k), _rows(v)
    if not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, g = _rows(out), _rows(g)
    bias = None if bias is None else bias.contiguous()
    key_mask = key_mask.contiguous()
    keep = None if keep is None else keep.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(b, n, h, d, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dbias = None if bias is None else torch.empty_like(bias)
    with torch.cuda.device(q.device):
        err = load("biased_attention", "biased_attention_bwd_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), _ptr(bias), key_mask.data_ptr(), _ptr(keep),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(dbias), b, h, n, d, *q.stride()[:3], *out.stride()[:3],
            *g.stride()[:3], scale, _rscale(p), _stream(q))
    if err:
        raise RuntimeError(f"biased_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    biased_attention_bwd_cuda.launches += 1
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), dbias


biased_attention_bwd_cuda.launches = 0


class BiasedAttentionKernel(torch.autograd.Function):
    """The kernel path with its gradient: saves ``q``, ``k``, ``v``,
    ``out``, ``lse``, ``keep`` (and the bias, if any, and the key mask it
    recomputes from), no ``[B, H, N, N]`` probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_mask, keep: Optional[torch.Tensor],
                p: float, scale: float):
        with telemetry.device_span("graphormer.attention", q.device):
            out, lse = biased_attention_cuda(q, k, v, bias, key_mask, keep,
                                             p, scale, stats=True)
        ctx.save_for_backward(q, k, v, out, bias, key_mask, lse, keep)
        ctx.p, ctx.scale = p, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, bias, key_mask, lse, keep = ctx.saved_tensors
        with telemetry.device_span("graphormer.attention", q.device):
            dq, dk, dv, dbias = biased_attention_bwd_cuda(
                q, k, v, out, g.to(q.dtype), bias, key_mask, lse, keep,
                ctx.p, ctx.scale)
        return dq, dk, dv, dbias, None, None, None, None


def biased_attention_sdpa(q, k, v, bias, key_mask, scale: float):
    """``scaled_dot_product_attention`` with the masked bias as its float
    ``attn_mask``: no dropout, no gradient of the bias.  The library's
    yardstick (``chip_smoke.py``) and a CPU cross-check, not a path, and
    not counted."""
    mask = bias.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    with telemetry.device_span("graphormer.attention", q.device):
        return F.scaled_dot_product_attention(q, k, v,
                                              attn_mask=mask.to(q.dtype),
                                              scale=scale)


def biased_attention(q, k, v, bias, key_mask,
                     keep: Optional[torch.Tensor] = None, p: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``[B, H, N, d]``: the attention of the module docstring (``bias``
    None for none).  On CUDA, where :func:`kernels_support` takes the
    shape, the kernel (with its backward where a gradient is needed, the
    forward alone where none is); else the explicit path."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    n, d = q.shape[-2:]
    if bias is None:
        _count("unbiased")
    if q.is_cuda and kernels_support(n, d, q.dtype):
        _count("kernel")
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, bias)):
            return BiasedAttentionKernel.apply(q, k, v, bias, key_mask, keep,
                                               p, scale)
        with telemetry.device_span("graphormer.attention", q.device):
            return biased_attention_cuda(q, k, v, bias, key_mask, keep, p,
                                         scale)[0]
    _count("explicit")
    return BiasedAttention.apply(q, k, v, bias, key_mask, keep, p, scale)


# ---- EGT's gated attention --------------------------------------------------

def gated_counts() -> Dict[str, int]:
    """The process's gated attention calls by path (``explicit``,
    ``kernel``), the real pairs they ran over (``pairs``: valid query and
    key) and their ``[B, N, N]`` slots (``pair_slots``)."""
    with _count_lock:
        out = dict(_GATED)
        pairs = list(_PAIRS.values())
    out["pairs"] = int(sum(int(t) for t in pairs))
    return out


def _count_gated(key_mask: torch.Tensor, path: str) -> None:
    real = key_mask.detach().sum(-1, dtype=torch.int64).square().sum()
    b, n = key_mask.shape
    with _count_lock:
        _GATED[path] += 1
        _GATED["pair_slots"] += b * n * n
        dev = real.device
        _PAIRS[dev] = _PAIRS[dev] + real if dev in _PAIRS else real


class GatedAttention(torch.autograd.Function):
    """EGT's gated attention (module docstring): ``(out [B, H, N, d], H^
    [B, H, N, N])`` for ``q, k, v [B, H, N, d]``, the pair stream's ``bias``
    and ``gate`` logits ``[B, H, N, N]``, ``key_mask [B, N]``, a bool
    keep-mask ``[B, H, N, N]`` or None and its rate ``p``, ``scale``, the
    clip ``clip`` and ``fixed``, the leading rows whose scaler is 1.  The
    clip passes no gradient outside ``[-clip, clip]``, as ``clamp`` does; a
    row with no valid key reads 0.  Saves the f32 probabilities and gates,
    where the clip passed, the keep-mask and the unscaled output."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gate, key_mask,
                keep: Optional[torch.Tensor], p: float, scale: float,
                clip: float, fixed: int):
        ct = torch.promote_types(q.dtype, torch.float32)
        with telemetry.device_span("egt.attention", q.device):
            s = torch.matmul(q, k.transpose(-1, -2)).to(ct) * scale
            inside = (s >= -clip) & (s <= clip)
            hh = s.clamp(-clip, clip) + bias.to(ct)
            km = key_mask[:, None, None, :]
            a = _softmax(hh.masked_fill(~km, float("-inf")), key_mask)
            g = torch.sigmoid(gate.to(ct)).masked_fill(~km, 0.0)
            ad = a * g if keep is None else a * g * keep / (1.0 - p)
            o = torch.matmul(ad.to(v.dtype), v)
            sc = torch.log1p(g.sum(-1))
            sc[:, :, :fixed] = 1.0
            out = (o.to(ct) * sc.unsqueeze(-1)).to(v.dtype)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, a, g, inside, keep, o, sc)
        ctx.p, ctx.scale, ctx.fixed = p, scale, fixed
        ctx.dtypes = (bias.dtype, gate.dtype)
        return out, hh

    @staticmethod
    def backward(ctx, g_out, g_hh):
        q, k, v, a, g, inside, keep, o, sc = ctx.saved_tensors
        p, ct = ctx.p, a.dtype
        with telemetry.device_span("egt.attention", q.device):
            go = g_out.to(ct)
            dsc = (go * o.to(ct)).sum(-1)
            dsc[:, :, :ctx.fixed] = 0.0
            go = (go * sc.unsqueeze(-1)).to(v.dtype)
            ad = a * g if keep is None else a * g * keep / (1.0 - p)
            dv = torch.matmul(ad.to(v.dtype).transpose(-1, -2), go)
            dad = torch.matmul(go, v.transpose(-1, -2)).to(ct)
            if keep is not None:
                dad = dad * keep / (1.0 - p)
            da = dad * g
            dg = dad * a + (dsc / (1.0 + g.sum(-1))).unsqueeze(-1)
            dgate = dg * g * (1.0 - g)
            dhh = a * (da - (da * a).sum(dim=-1, keepdim=True))
            if g_hh is not None:
                dhh = dhh + g_hh.to(ct)
            ds = (torch.where(inside, dhh, 0.0) * ctx.scale).to(q.dtype)
            dq = torch.matmul(ds, k)
            dk = torch.matmul(ds.transpose(-1, -2), q)
        return (dq, dk, dv, dhh.to(ctx.dtypes[0]), dgate.to(ctx.dtypes[1]),
                None, None, None, None, None, None)


def gated_kernels_support(n: int, heads: int, d: int,
                          dtype: torch.dtype) -> bool:
    """True if the gated attention kernels take ``[B, heads, n, d]``
    inputs of ``dtype``: bf16, ``1 <= n <= 128``, ``d`` in
    :data:`HEAD_DIMS` (but 32 past ``n = 96``, where ``k`` and ``v`` of a
    block's 8 heads alone fill its shared memory) and ``heads`` a multiple
    of :data:`GATED_HEADS`."""
    return dtype == torch.bfloat16 and 1 <= n <= MAX_N \
        and d in HEAD_DIMS and not (d == 32 and n > 96) \
        and heads > 0 and heads % GATED_HEADS == 0


# ---- the gated kernels' algorithm in plain torch ----------------------------

def _gated_parts(q, k, bias, gate, key_mask, scale, clip, ct):
    """The logits ``s``, ``H^`` (f32 or f64) and the masked gates."""
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    hh = s.clamp(-clip, clip) + bias.to(ct)
    km = key_mask[:, None, None, :]
    gt = torch.sigmoid(gate.to(ct)).masked_fill(~km, 0.0)
    return s, hh, gt


def _scaler(gsum, fixed):
    sc = torch.log1p(gsum)
    sc[:, :, :fixed] = 1.0
    return sc


def gated_attention_fwd_plain(q, k, v, bias, gate, key_mask,
                              keep: Optional[torch.Tensor] = None,
                              p: float = 0.0, scale: Optional[float] = None,
                              clip: float = 5.0, fixed: int = 0):
    """The forward kernel's algorithm: ``(out, H^, lse, gsum)``, ``out``
    in the inputs' dtype, ``H^`` in the bias's, ``lse`` and the gate sum
    ``gsum [B, H, N]`` (``lse`` +inf for a row with no valid key, whose
    ``out`` is 0).  Computed in f32 (f64 for f64 inputs); the gated,
    dropped probabilities are rounded to the inputs' dtype before ``P v``,
    and the output once, after the scaler, as the kernel rounds them."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    ct, dt = torch.promote_types(q.dtype, torch.float32), q.dtype
    _, hh, gt = _gated_parts(q, k, bias, gate, key_mask, scale, clip, ct)
    x = hh.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    m = x.amax(dim=-1, keepdim=True)
    m = m.masked_fill(m == float("-inf"), 0.0)
    e = torch.exp(x - m)
    total = e.sum(dim=-1, keepdim=True)
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
    pd = e * inv * gt * _keep_scale(keep, p, ct)
    gsum = gt.sum(-1)
    o = torch.matmul(pd.to(dt).to(ct), v.to(ct))
    out = (o * _scaler(gsum, fixed).unsqueeze(-1)).to(dt)
    lse = torch.where(total > 0, m + torch.log(total),
                      torch.full_like(total, float("inf")))
    return out, hh.to(bias.dtype), lse.squeeze(-1), gsum


def gated_attention_bwd_plain(q, k, v, out, g, g_hh, bias, gate, key_mask,
                              lse, gsum, keep: Optional[torch.Tensor] = None,
                              p: float = 0.0, scale: Optional[float] = None,
                              clip: float = 5.0, fixed: int = 0):
    """The backward kernel's algorithm: ``(dq, dk, dv, dE, dG)`` from the
    forward's inputs, its ``out``, ``lse`` and ``gsum``, the output's
    gradient ``g`` and ``H^``'s ``g_hh`` (or None): the probabilities
    recomputed from ``lse``; ``do = sc g`` rounded to the inputs' dtype;
    one row sum ``D = rowsum(g * out)``, which is both the softmax's
    ``sum_j dA_j A_j`` and ``sc`` times the scaler's gradient;
    ``dE = A (dP G - D) + g_hh`` and ``dG = (dP A + dsc / (1 + gsum)) g (1
    - g)`` on every slot; ``dS`` (scaled, 0 outside the clip) and the
    dropped probabilities rounded to the inputs' dtype before their
    products."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    ct, dt = torch.promote_types(q.dtype, torch.float32), q.dtype
    s, hh, gt = _gated_parts(q, k, bias, gate, key_mask, scale, clip, ct)
    a = torch.exp(hh - lse.to(ct).unsqueeze(-1)).masked_fill(
        ~key_mask[:, None, None, :], 0.0)
    gsum = gsum.to(ct)
    sc = _scaler(gsum, fixed)
    gc = g.to(ct)
    dsum = (gc * out.to(ct)).sum(-1)
    dsc = torch.where(sc > 0, dsum / (sc * (1.0 + gsum)),
                      torch.zeros_like(dsum))
    dsc[:, :, :fixed] = 0.0
    do = (gc * sc.unsqueeze(-1)).to(dt).to(ct)
    dam = torch.matmul(do, v.to(ct).transpose(-1, -2)) \
        * _keep_scale(keep, p, ct)
    dhh = a * (dam * gt - dsum.unsqueeze(-1))
    if g_hh is not None:
        dhh = dhh + g_hh.to(ct)
    dgate = (dam * a + dsc.unsqueeze(-1)) * gt * (1.0 - gt)
    inside = (s >= -clip) & (s <= clip)
    ds = (torch.where(inside, dhh, 0.0) * scale).to(dt).to(ct)
    pd = (a * gt * _keep_scale(keep, p, ct)).to(dt).to(ct)
    dq = torch.matmul(ds, k.to(ct)).to(dt)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(ct)).to(dt)
    dv = torch.matmul(pd.transpose(-1, -2), do).to(dt)
    return dq, dk, dv, dhh.to(bias.dtype), dgate.to(gate.dtype)


# ---- the gated kernels ------------------------------------------------------

def _pairs(t: torch.Tensor) -> torch.Tensor:
    """A ``[B, N, N, H]`` pair tensor (or a keep-mask) as the kernels read
    it: contiguous and 16-byte aligned (``t`` itself where it is, as the
    pair Linears' output and its gradient are)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _gated_check(name, q, k, v, bias, gate, key_mask, keep) -> None:
    ts = [t for t in (q, k, v, bias, gate, key_mask, keep) if t is not None]
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share a [B, H, N, d] "
                         f"shape, got {[tuple(t.shape) for t in (q, k, v)]}")
    b, h, n, d = q.shape
    if not gated_kernels_support(n, h, d, q.dtype) or any(
            t.dtype != torch.bfloat16 for t in (k, v, bias, gate)):
        raise ValueError(f"{name} takes bf16 q, k, v, bias and gate with "
                         f"N <= {MAX_N}, d in {HEAD_DIMS} and heads a "
                         f"multiple of {GATED_HEADS}, got N={n}, d={d}, "
                         f"H={h}, {[t.dtype for t in (q, k, v, bias, gate)]}"
                         "; gate with gated_kernels_support")
    for nm, t in (("bias", bias), ("gate", gate)):
        if tuple(t.shape) != (b, h, n, n):
            raise ValueError(f"{name}: {nm} must be [B, H, N, N], got "
                             f"{tuple(t.shape)}")
    if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, n):
        raise ValueError(f"{name}: key_mask must be bool [B, N], got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    if keep is not None and (keep.dtype != torch.bool
                             or tuple(keep.shape) != (b, h, n, n)):
        raise ValueError(f"{name}: keep must be bool [B, H, N, N], got "
                         f"{keep.dtype} {tuple(keep.shape)}")


def _variant(n: int, d: int):
    """The library of ``csrc/gated_attention.cu`` for N and d: its tile
    shape (KT = 2 ceil(N / 32) tiles of 16, d / 8)."""
    return 2 * (-(-n // 32)), d // 8


def _qkv(q, k, v):
    q, k, v = _rows(q), _rows(k), _rows(v)
    if not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def gated_attention_cuda(q, k, v, bias, gate, key_mask,
                         keep: Optional[torch.Tensor] = None, p: float = 0.0,
                         scale: Optional[float] = None, clip: float = 5.0,
                         fixed: int = 0, stats: bool = False):
    """Forward kernel: ``(out, H^, lse, gsum)``, ``out [B, H, N, d]`` bf16
    (the transpose of a ``[B, N, H, d]`` buffer), ``H^ [B, H, N, N]`` bf16
    (the permuted view of a ``[B, N, N, H]`` buffer) and, when ``stats``,
    ``lse`` and ``gsum [B, H, N]`` f32, else None.  ``bias`` and ``gate``
    are read in their ``[B, N, N, H]`` layout (no copy where they are its
    views).  Records no gradient (:func:`gated_attention` does).  On a
    CUDA tensor it launches the kernel (or raises); on a CPU tensor it
    returns :func:`gated_attention_fwd_plain`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out, hh, lse, gsum = gated_attention_fwd_plain(
            q, k, v, bias, gate, key_mask, keep, p, scale, clip, fixed)
        return (out, hh) + ((lse, gsum) if stats else (None, None))
    _gated_check("gated_attention_cuda", q, k, v, bias, gate, key_mask, keep)
    from ._build import load

    b, h, n, d = q.shape
    q, k, v = _qkv(q, k, v)
    e_pairs = _pairs(bias.permute(0, 2, 3, 1))
    g_pairs = _pairs(gate.permute(0, 2, 3, 1))
    key_mask = key_mask.contiguous()
    keep = None if keep is None else _pairs(keep)
    out = torch.empty(b, n, h, d, dtype=q.dtype, device=q.device)
    hh = torch.empty(b, n, n, h, dtype=q.dtype, device=q.device)
    lse, gsum = ((torch.empty(b, h, n, dtype=torch.float32, device=q.device)
                  for _ in range(2)) if stats else (None, None))
    with torch.cuda.device(q.device):
        err = load("gated_attention", variant=_variant(n, d))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e_pairs.data_ptr(),
            g_pairs.data_ptr(), key_mask.data_ptr(), _ptr(keep),
            out.data_ptr(), hh.data_ptr(), _ptr(lse), _ptr(gsum), b, h, n, d,
            *q.stride()[:3], scale, float(clip), _rscale(p), int(fixed),
            _stream(q))
    if err:
        raise RuntimeError(f"gated_attention kernel launch failed: "
                           f"cudaError {err}")
    gated_attention_cuda.launches += 1
    return out.transpose(1, 2), hh.permute(0, 3, 1, 2), lse, gsum


gated_attention_cuda.launches = 0


def gated_attention_bwd_cuda(q, k, v, out, g, g_hh, bias, gate, key_mask,
                             lse, gsum, keep: Optional[torch.Tensor] = None,
                             p: float = 0.0, scale: Optional[float] = None,
                             clip: float = 5.0, fixed: int = 0):
    """Backward kernel: ``(dq, dk, dv, dE, dG)`` for the output gradient
    ``g`` and ``H^``'s gradient ``g_hh`` (or None, which is not read), the
    first three bf16 ``[B, H, N, d]`` (transposes of ``[B, N, H, d]``
    buffers), ``dE`` and ``dG`` bf16 ``[B, H, N, N]`` (permuted views of
    ``[B, N, N, H]`` buffers); ``g_hh`` is read in that layout.  On a CUDA
    tensor it launches the kernel (or raises); on a CPU tensor it returns
    :func:`gated_attention_bwd_plain`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return gated_attention_bwd_plain(q, k, v, out, g, g_hh, bias, gate,
                                         key_mask, lse, gsum, keep, p, scale,
                                         clip, fixed)
    _gated_check("gated_attention_bwd_cuda", q, k, v, bias, gate, key_mask,
                 keep)
    if out.shape != q.shape or g.shape != q.shape \
            or out.dtype != q.dtype or g.dtype != q.dtype:
        raise ValueError("gated_attention_bwd_cuda: out and g must be "
                         "q's shape and dtype")
    if g_hh is not None and (g_hh.shape != bias.shape
                             or g_hh.dtype != torch.bfloat16):
        raise ValueError("gated_attention_bwd_cuda: g_hh must be bf16 "
                         f"[B, H, N, N], got {g_hh.dtype} "
                         f"{tuple(g_hh.shape)}")
    from ._build import load

    b, h, n, d = q.shape
    q, k, v = _qkv(q, k, v)
    out, g = _rows(out), _rows(g)
    e_pairs = _pairs(bias.permute(0, 2, 3, 1))
    g_pairs = _pairs(gate.permute(0, 2, 3, 1))
    dh_pairs = None if g_hh is None else _pairs(g_hh.permute(0, 2, 3, 1))
    key_mask = key_mask.contiguous()
    keep = None if keep is None else _pairs(keep)
    lse, gsum = lse.contiguous(), gsum.contiguous()
    dq, dk, dv = (torch.empty(b, n, h, d, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    de, dg = (torch.empty(b, n, n, h, dtype=q.dtype, device=q.device)
              for _ in range(2))
    with torch.cuda.device(q.device):
        err = load("gated_attention", "gated_attention_bwd_launch",
                   _variant(n, d))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), _ptr(dh_pairs), e_pairs.data_ptr(),
            g_pairs.data_ptr(), key_mask.data_ptr(), _ptr(keep),
            lse.data_ptr(), gsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), de.data_ptr(), dg.data_ptr(), b, h, n, d,
            *q.stride()[:3], *out.stride()[:3], *g.stride()[:3], scale,
            float(clip), _rscale(p), int(fixed), _stream(q))
    if err:
        raise RuntimeError(f"gated_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    gated_attention_bwd_cuda.launches += 1
    return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
            de.permute(0, 3, 1, 2), dg.permute(0, 3, 1, 2))


gated_attention_bwd_cuda.launches = 0


class GatedAttentionKernel(torch.autograd.Function):
    """The kernel path with its gradient: saves ``q``, ``k``, ``v``,
    ``out``, ``E``, ``G``, the key mask, the keep-mask and the two row
    statistics, nothing ``[B, H, N, N]`` in f32; forward and backward are
    each an ``egt.attention`` device span."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gate, key_mask,
                keep: Optional[torch.Tensor], p: float, scale: float,
                clip: float, fixed: int):
        with telemetry.device_span("egt.attention", q.device):
            out, hh, lse, gsum = gated_attention_cuda(
                q, k, v, bias, gate, key_mask, keep, p, scale, clip, fixed,
                stats=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, bias, gate, key_mask, keep, lse,
                              gsum)
        ctx.p, ctx.scale, ctx.clip, ctx.fixed = p, scale, clip, fixed
        return out, hh

    @staticmethod
    def backward(ctx, g_out, g_hh):
        q, k, v, out, bias, gate, key_mask, keep, lse, gsum = \
            ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        with telemetry.device_span("egt.attention", q.device):
            dq, dk, dv, dbias, dgate = gated_attention_bwd_cuda(
                q, k, v, out, g_out.to(q.dtype), g_hh, bias, gate, key_mask,
                lse, gsum, keep, ctx.p, ctx.scale, ctx.clip, ctx.fixed)
        return (dq, dk, dv, dbias, dgate, None, None, None, None, None,
                None)


def gated_attention(q, k, v, bias, gate, key_mask,
                    keep: Optional[torch.Tensor] = None, p: float = 0.0,
                    scale: Optional[float] = None, clip: float = 5.0,
                    fixed: int = 0):
    """``(out [B, H, N, d], H^ [B, H, N, N])`` of the module docstring,
    counted in :func:`gated_counts`.  On CUDA, where
    :func:`gated_kernels_support` takes the shape and ``bias`` and
    ``gate`` are bf16 too, the kernels (the backward where an input needs
    a gradient, the forward alone where none does); else
    :class:`GatedAttention`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    b, h, n, d = q.shape
    if q.is_cuda and gated_kernels_support(n, h, d, q.dtype) \
            and bias.dtype == gate.dtype == torch.bfloat16:
        _count_gated(key_mask, "kernel")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, bias, gate)):
            return GatedAttentionKernel.apply(q, k, v, bias, gate, key_mask,
                                              keep, p, scale, float(clip),
                                              int(fixed))
        with telemetry.device_span("egt.attention", q.device):
            return gated_attention_cuda(q, k, v, bias, gate, key_mask, keep,
                                        p, scale, clip, fixed)[:2]
    _count_gated(key_mask, "explicit")
    return GatedAttention.apply(q, k, v, bias, gate, key_mask, keep, p,
                                scale, float(clip), fixed)
