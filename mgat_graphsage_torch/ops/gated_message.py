"""GraphGPS's gated message passing over a padded batch of edge lists: the
local branch of ``models/layers.py::GatedGCNLayer`` (Bresson and Laurent's
residual gated graph convnet, as the public GraphGPS code runs it).

For node states projected four ways, ``dh``, ``eh``, ``bh [B, N, D]``, the
edge states' projection ``ce [B, E, D]``, the directed edges ``edges [B,
2, E]`` (row 0 the source ``j``, row 1 the target ``i``) and ``edge_mask
[B, E]``::

    e_ji = dh_i + eh_j + ce_ji ;  s_ji = sigmoid(e_ji)
    agg_i = (sum_{j->i} s_ji * bh_j) / (sum_{j->i} s_ji + 1e-6)

over the real edges only: a masked slot adds nothing to either sum.  It
returns ``(agg [B, N, D], e [B, E, D])`` in the inputs' dtype; ``e`` is
the edge stream's next value before its norm, every slot's.

:class:`GatedMessage` is one ``torch.autograd.Function`` with an explicit
forward and backward in plain torch ops: gathers by ``index_select`` and
sums by ``index_add_`` over flat ``[B * N]`` node indices, at the padded
edge slots' static shape, with no host sync.  The arithmetic runs in f32
(f64 for f64 inputs) whatever the inputs' dtype, the sums included; the
forward saves the gates and the normalised sum's factors, the backward
gathers again.  Its forward and backward are ``gps.message`` device spans
(``utils/telemetry.py``), and :func:`counts` counts the calls
(``explicit``), the real edges (``edges``) and the padded slots
(``edge_slots``) they ran over: the real edges are summed on the device
and read only by :func:`counts`.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from ..utils import telemetry

__all__ = ["GatedMessage", "gated_message", "counts", "EPS"]

EPS = 1e-6     # the public GatedGCNLayer's term in the denominator

_count_lock = threading.Lock()
_CALLS = {"explicit": 0, "edge_slots": 0}
_EDGES: Dict[torch.device, torch.Tensor] = {}   # device -> int64 sum


def counts() -> Dict[str, int]:
    """The process's gated message calls (``explicit``), the real edges
    (``edges``) and the edge slots (``edge_slots``) they ran over."""
    with _count_lock:
        out = dict(_CALLS)
        edges = list(_EDGES.values())
    out["edges"] = int(sum(int(t) for t in edges))
    return out


def _count(edge_mask: torch.Tensor) -> None:
    real = torch.count_nonzero(edge_mask.detach())
    with _count_lock:
        _CALLS["explicit"] += 1
        _CALLS["edge_slots"] += edge_mask.numel()
        dev = real.device
        _EDGES[dev] = _EDGES[dev] + real if dev in _EDGES else real


def _flat(edges: torch.Tensor, n: int):
    """Flat ``[B * E]`` source and target indices into ``[B * N]`` rows."""
    off = torch.arange(edges.shape[0], device=edges.device)[:, None] * n
    return (edges[:, 0].long() + off).reshape(-1), \
        (edges[:, 1].long() + off).reshape(-1)


class GatedMessage(torch.autograd.Function):
    """The gather, gate, normalised sum and edge output (the module
    docstring) with an explicit backward; ``src`` and ``dst`` are the flat
    indices of :func:`_flat`, ``mask`` the edge mask ``[B * E]``."""

    @staticmethod
    def forward(ctx, dh, eh, ce, bh, src, dst, mask):
        b, n, d = dh.shape
        ct = torch.promote_types(dh.dtype, torch.float32)
        with telemetry.device_span("gps.message", dh.device):
            e = dh.reshape(b * n, d).index_select(0, dst).to(ct) \
                + eh.reshape(b * n, d).index_select(0, src).to(ct) \
                + ce.reshape(-1, d).to(ct)
            gate = torch.sigmoid(e) * mask.to(ct)[:, None]
            bj = bh.reshape(b * n, d).index_select(0, src).to(ct)
            num = e.new_zeros(b * n, d).index_add_(0, dst, gate * bj)
            inv = 1.0 / (e.new_zeros(b * n, d).index_add_(0, dst, gate)
                         + EPS)
            agg = num * inv
        ctx.save_for_backward(bh, src, dst, gate, agg, inv)
        ctx.dtypes = (dh.dtype, eh.dtype, ce.dtype, bh.dtype)
        return agg.to(dh.dtype).view(b, n, d), \
            e.to(ce.dtype).view(ce.shape)

    @staticmethod
    def backward(ctx, g_agg, g_e):
        bh, src, dst, gate, agg, inv = ctx.saved_tensors
        b, n, d = bh.shape
        ct = gate.dtype
        with telemetry.device_span("gps.message", bh.device):
            de = torch.zeros_like(gate) if g_e is None \
                else g_e.reshape(-1, d).to(ct)
            dbh = None
            if g_agg is not None:
                g = g_agg.reshape(b * n, d).to(ct)
                dnum = (g * inv).index_select(0, dst)
                dden = (g * agg * inv).index_select(0, dst)
                bj = bh.reshape(b * n, d).index_select(0, src).to(ct)
                # d gate = dnum * bh_j - dden; through the sigmoid (a masked
                # slot's gate is 0, and so is its derivative)
                de = de + (dnum * bj - dden) * gate * (1.0 - gate)
                dbh = gate.new_zeros(b * n, d).index_add_(0, src,
                                                          dnum * gate)
            ddh = de.new_zeros(b * n, d).index_add_(0, dst, de)
            deh = de.new_zeros(b * n, d).index_add_(0, src, de)
        tdh, teh, tce, tbh = ctx.dtypes
        return (ddh.to(tdh).view(b, n, d), deh.to(teh).view(b, n, d),
                de.to(tce).view(b, -1, d),
                None if dbh is None else dbh.to(tbh).view(b, n, d),
                None, None, None)


def gated_message(dh: torch.Tensor, eh: torch.Tensor, ce: torch.Tensor,
                  bh: torch.Tensor, edges: torch.Tensor,
                  edge_mask: torch.Tensor):
    """``(agg [B, N, D], e [B, E, D])`` of the module docstring, through
    :class:`GatedMessage`; counted in :func:`counts`."""
    _count(edge_mask)
    src, dst = _flat(edges, dh.shape[1])
    return GatedMessage.apply(dh, eh, ce, bh, src, dst,
                              edge_mask.reshape(-1))
