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

``H^`` (f32, every slot's) is the layer's pair update's input, and its
gradient comes back into the op's backward.  One path computes it,
:class:`GatedAttention`, in plain torch ops on every device: the logits,
the clip, the softmax, the gate and the scaler in f32, the products in
the inputs' dtype with f32 sums; its forward saves the f32 probabilities
and gates.  Each forward and backward is an ``egt.attention`` device
span; :func:`gated_counts` counts the calls by path (``explicit``), the
real pairs of keys (``pairs``, of the valid keys of each row, summed on
the device and read only there) and the ``[B, N, N]`` slots they ran over
(``pair_slots``).
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
           "HEAD_DIMS", "GatedAttention", "gated_attention", "gated_counts"]

MAX_N = 128                 # keys (and rows) of a block: csrc KT <= 8
HEAD_DIMS = (8, 16, 24, 32)  # csrc D8 = d / 8 in 1..4

_count_lock = threading.Lock()
_COUNTS = {"explicit": 0, "kernel": 0, "unbiased": 0}
_GATED = {"explicit": 0, "pair_slots": 0}
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
    """The process's gated attention calls by path (``explicit``), the
    real pairs they ran over (``pairs``: valid query and key) and their
    ``[B, N, N]`` slots (``pair_slots``)."""
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


def gated_attention(q, k, v, bias, gate, key_mask,
                    keep: Optional[torch.Tensor] = None, p: float = 0.0,
                    scale: Optional[float] = None, clip: float = 5.0,
                    fixed: int = 0):
    """``(out [B, H, N, d], H^ [B, H, N, N])``: :class:`GatedAttention`
    (module docstring), counted in :func:`gated_counts`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    _count_gated(key_mask, "explicit")
    return GatedAttention.apply(q, k, v, bias, gate, key_mask, keep, p,
                                scale, float(clip), fixed)
