"""Multi-head attention with an additive per-head bias and a key mask: the
graph transformer's attention (``models/layers.py::GraphormerLayer``).

For ``q, k, v [B, H, N, d]``, ``bias [B, H, N, N]`` (f32) and ``key_mask
[B, N]`` (True where a key may be attended to)::

    A = softmax(scale * q k^T + bias, masked keys at -inf)
    out = dropout(A) v

Two paths compute it:

- :class:`BiasedAttention`, an ``autograd.Function`` in plain torch ops,
  for training: the logits and the softmax in f32 (the products in the
  inputs' dtype with f32 accumulation), the dropout as a keep-mask given
  by the caller (drawn from the trainer's dropout generator, so a
  reference can draw the same), and a backward that returns the gradient
  of the bias as well as of ``q``, ``k`` and ``v``;
- ``F.scaled_dot_product_attention`` with the masked bias as its float
  ``attn_mask``, where nothing needs a gradient and no dropout applies
  (evaluation and scoring on CUDA).

Each call is a ``graphormer.attention`` device span
(``utils/telemetry.py``), the explicit path's backward too; the calls
are counted by path (:func:`counts`, ``/health``'s telemetry).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..utils import telemetry

__all__ = ["BiasedAttention", "biased_attention", "biased_attention_sdpa",
           "counts"]

_count_lock = threading.Lock()
_COUNTS = {"explicit": 0, "sdpa": 0}


def _count(path: str) -> None:
    with _count_lock:
        _COUNTS[path] += 1


def counts() -> Dict[str, int]:
    """The process's attention calls by path (``explicit``, ``sdpa``)."""
    with _count_lock:
        return dict(_COUNTS)


def _logits(q, k, bias, key_mask, scale):
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale + bias
    return s.masked_fill(~key_mask[:, None, None, :], float("-inf"))


class BiasedAttention(torch.autograd.Function):
    """The explicit path (module docstring).  ``keep`` is a bool keep-mask
    ``[B, H, N, N]`` or None, and ``p`` its drop rate; kept
    probabilities are scaled by ``1 / (1 - p)``."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_mask, keep: Optional[torch.Tensor],
                p: float, scale: float):
        with telemetry.device_span("graphormer.attention", q.device):
            a = torch.softmax(_logits(q, k, bias, key_mask, scale), dim=-1)
            ad = a if keep is None else a * keep / (1.0 - p)
            out = torch.matmul(ad.to(v.dtype), v)
        ctx.save_for_backward(q, k, v, a, keep)
        ctx.p, ctx.scale = p, scale
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
        return dq, dk, dv, ds, None, None, None, None


def biased_attention_sdpa(q, k, v, bias, key_mask, scale: float):
    """The ``scaled_dot_product_attention`` path: no dropout, and no
    gradient of the bias."""
    _count("sdpa")
    mask = bias.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    with telemetry.device_span("graphormer.attention", q.device):
        return F.scaled_dot_product_attention(q, k, v,
                                              attn_mask=mask.to(q.dtype),
                                              scale=scale)


def biased_attention(q, k, v, bias, key_mask,
                     keep: Optional[torch.Tensor] = None, p: float = 0.0,
                     scale: Optional[float] = None,
                     sdpa: Optional[bool] = None) -> torch.Tensor:
    """``[B, H, N, d]``: the attention of the module docstring.  ``sdpa``
    None takes the SDPA path on CUDA where no dropout applies and nothing
    needs a gradient, else the explicit one; True or False forces one
    (the SDPA path takes no ``keep``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if sdpa is None:
        sdpa = q.is_cuda and keep is None and not (
            torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, bias)))
    if sdpa:
        if keep is not None:
            raise ValueError("the SDPA path takes no dropout keep-mask")
        return biased_attention_sdpa(q, k, v, bias, key_mask, scale)
    _count("explicit")
    return BiasedAttention.apply(q, k, v, bias, key_mask, keep, p, scale)
