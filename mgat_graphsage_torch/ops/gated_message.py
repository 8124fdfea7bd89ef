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
the edge stream's next value before its norm, every slot's.  The
arithmetic runs in f32 (f64 for f64 inputs) whatever the inputs' dtype,
the sums included; ``e`` is added in the order written, rounded once.
Two paths compute it:

- the kernels (``csrc/gated_message.cu``), on CUDA for the calls
  :func:`kernels_support` takes (bf16 or f32, all four inputs one dtype,
  ``N <= 128``, ``E <= 256``, ``D`` a multiple of 8): one forward launch
  (:func:`gated_message_cuda`; ``e`` the explicit path's bits) and one
  backward (:func:`gated_message_bwd_cuda`) that recomputes ``e``, the
  gates and the sums from the same inputs, so nothing edge-sized is kept
  between them; every sum runs over per-target or per-source slot lists
  in slot order, with no atomics: the same bits on every run.  Joined by
  :class:`GatedMessageKernel`, which saves only the inputs; a call that
  needs no gradient runs the forward alone;
- :class:`GatedMessage`, one ``torch.autograd.Function`` with an explicit
  forward and backward in plain torch ops: gathers by ``index_select``
  and sums by ``index_add_`` over flat ``[B * N]`` node indices, at the
  padded edge slots' static shape, with no host sync; its forward saves
  the gates and the normalised sum's factors, the backward gathers again.
  On the CPU, in f64 and past the kernels' limits.

:func:`gated_message_fwd_plain` and :func:`gated_message_bwd_plain` are
the kernels' algorithm in plain torch, for the tests and
``chip_smoke.py``; the kernel wrappers return them for CPU tensors.  The
kernels take a slot as real where its mask is not 0 and scale its gate by
the mask, as the explicit path does, and clamp node indices into ``[0,
N)``, which the explicit path's gathers refuse outside.

Both paths' forward and backward are ``gps.message`` device spans
(``utils/telemetry.py``), and :func:`counts` counts the calls by path
(``explicit``, ``kernel``), the real edges (``edges``) and the padded
slots (``edge_slots``) they ran over: the real edges are summed on the
device and read only by :func:`counts`.  The kernels' launches are counted
on their wrappers (``launches``, ``launches_bf16``).
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from ..utils import telemetry

__all__ = ["GatedMessage", "GatedMessageKernel", "gated_message",
           "gated_message_cuda", "gated_message_bwd_cuda",
           "gated_message_fwd_plain", "gated_message_bwd_plain",
           "kernels_support", "counts", "EPS", "MAX_N", "MAX_E"]

EPS = 1e-6     # the public GatedGCNLayer's term in the denominator
MAX_N = 128    # csrc kMaxN: a node index is one byte of shared memory
MAX_E = 256    # csrc kMaxE: a slot index is one byte of shared memory

_count_lock = threading.Lock()
_CALLS = {"explicit": 0, "kernel": 0, "edge_slots": 0}
_EDGES: Dict[torch.device, torch.Tensor] = {}   # device -> int64 sum


def counts() -> Dict[str, int]:
    """The process's gated message calls by path (``explicit``,
    ``kernel``), the real edges (``edges``) and the edge slots
    (``edge_slots``) they ran over."""
    with _count_lock:
        out = dict(_CALLS)
        edges = list(_EDGES.values())
    out["edges"] = int(sum(int(t) for t in edges))
    return out


def _count(edge_mask: torch.Tensor, path: str) -> None:
    real = torch.count_nonzero(edge_mask.detach())
    with _count_lock:
        _CALLS[path] += 1
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


def kernels_support(n: int, e: int, d: int, dtype: torch.dtype) -> bool:
    """True if the kernels take a call of ``n`` atoms, ``e`` edge slots and
    width ``d`` in ``dtype``: bf16 or f32, ``1 <= n <= 128``, ``1 <= e <=
    256`` (a node's and a slot's index are one byte each of the kernels'
    shared memory) and ``d`` a multiple of 8 (a thread's 8 columns)."""
    return (dtype in (torch.bfloat16, torch.float32)
            and 1 <= n <= MAX_N and 1 <= e <= MAX_E and d >= 8
            and d % 8 == 0)


# ---- the kernels' algorithm in plain torch ---------------------------------

def _slots(edges: torch.Tensor, edge_mask: torch.Tensor, n: int, ct):
    """Flat source and target rows of every slot (indices clamped into
    ``[0, n)``), the mask's values in ``ct`` and the real slots."""
    src, dst = _flat(edges.clamp(0, n - 1), n)
    m = edge_mask.reshape(-1).to(ct)
    return src, dst, m, m != 0


def _list_sum(rows: torch.Tensor, key: torch.Tensor, size: int
              ) -> torch.Tensor:
    """``[size, D]``: the rows summed by key, each key's rows taken in slot
    order (a stable sort's list, as the kernels walk it)."""
    order = torch.argsort(key, stable=True)
    return rows.new_zeros(size, rows.shape[1]).index_add_(
        0, key[order], rows[order])


def _gates(dh, eh, ce, bh, src, dst, m, real):
    """``e`` of every slot, and of the real ones the gates and ``bh_j``."""
    b, n, d = dh.shape
    ct = m.dtype
    e = dh.reshape(b * n, d)[dst].to(ct) + eh.reshape(b * n, d)[src].to(ct) \
        + ce.reshape(-1, d).to(ct)
    gate = torch.sigmoid(e[real]) * m[real][:, None]
    return e, gate, bh.reshape(b * n, d)[src[real]].to(ct)


def gated_message_fwd_plain(dh, eh, ce, bh, edges, edge_mask):
    """The forward kernel's algorithm: ``e`` at every slot, the gates at the
    real ones, ``num`` and ``den`` summed over each target's list of real
    slots; ``(agg, e)`` in the inputs' dtype."""
    b, n, d = dh.shape
    ct = torch.promote_types(dh.dtype, torch.float32)
    src, dst, m, real = _slots(edges, edge_mask, n, ct)
    e, gate, bj = _gates(dh, eh, ce, bh, src, dst, m, real)
    num = _list_sum(gate * bj, dst[real], b * n)
    den = _list_sum(gate, dst[real], b * n)
    agg = num * (1.0 / (den + EPS))
    return agg.to(dh.dtype).view(b, n, d), e.to(ce.dtype).view(ce.shape)


def gated_message_bwd_plain(g_agg, g_e, dh, eh, ce, bh, edges, edge_mask):
    """The backward kernel's algorithm from the forward's inputs alone:
    ``e``, the gates, ``num`` and ``den`` recomputed; ``de`` at every slot
    (``g_e``, and at a real slot the gate's term); ``ddh`` and ``deh`` its
    sums over each target's and each source's whole list, ``dbh`` the sum
    of ``dnum * s`` over each source's real slots.  ``(ddh, deh, dce,
    dbh)`` in the inputs' dtype, ``dbh`` None where ``g_agg`` is."""
    b, n, d = dh.shape
    ct = torch.promote_types(dh.dtype, torch.float32)
    src, dst, m, real = _slots(edges, edge_mask, n, ct)
    de = ce.new_zeros(ce.shape[0] * ce.shape[1], d, dtype=ct) \
        if g_e is None else g_e.reshape(-1, d).to(ct)
    dbh = None
    if g_agg is not None:
        e, gate, bj = _gates(dh, eh, ce, bh, src, dst, m, real)
        rd, rs = dst[real], src[real]
        inv = 1.0 / (_list_sum(gate, rd, b * n) + EPS)
        agg = _list_sum(gate * bj, rd, b * n) * inv
        g = g_agg.reshape(b * n, d).to(ct)
        dnum, dden = (g * inv)[rd], (g * agg * inv)[rd]
        de = de.clone()
        de[real] = de[real] + (dnum * bj - dden) * gate * (1.0 - gate)
        dbh = _list_sum(dnum * gate, rs, b * n).to(bh.dtype).view(b, n, d)
    ddh = _list_sum(de, dst, b * n)
    deh = _list_sum(de, src, b * n)
    return (ddh.to(dh.dtype).view(b, n, d), deh.to(eh.dtype).view(b, n, d),
            de.to(ce.dtype).view(ce.shape), dbh)


# ---- the kernels ------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' row
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_inputs(name: str, dh, eh, ce, bh, edges, edge_mask):
    """The inputs as the kernels take them (contiguous, 16-byte aligned,
    int32 edges, the mask in the rows' dtype) and the dtype code; raises
    on what they do not take."""
    ts = (dh, eh, ce, bh, edges, edge_mask)
    if any(t.device != dh.device for t in ts):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    b, n, d = dh.shape
    e = ce.shape[1]
    if not kernels_support(n, e, d, dh.dtype) \
            or any(t.dtype != dh.dtype for t in (eh, ce, bh)) \
            or tuple(eh.shape) != (b, n, d) or tuple(bh.shape) != (b, n, d) \
            or tuple(ce.shape) != (b, e, d) \
            or tuple(edges.shape) != (b, 2, e) \
            or tuple(edge_mask.shape) != (b, e):
        raise ValueError(
            f"{name} takes dh, eh, bh [B, N, D] and ce [B, E, D], all bf16 "
            f"or all f32 (N <= {MAX_N}, E <= {MAX_E}, D % 8 == 0), edges "
            f"[B, 2, E] and edge_mask [B, E]; got "
            f"{[(t.dtype, tuple(t.shape)) for t in ts]}; gate with "
            "kernels_support")

    rows = [_aligned(t) for t in (dh, eh, ce, bh)]
    return rows + [edges.to(torch.int32).contiguous(),
                   edge_mask.to(dh.dtype).contiguous()], \
        int(dh.dtype == torch.bfloat16)


def _counted(fn, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def gated_message_cuda(dh, eh, ce, bh, edges, edge_mask):
    """Forward kernel: ``(agg [B, N, D], e [B, E, D])``.  Records no
    gradient (:func:`gated_message` does).  On a CUDA tensor it launches the
    kernel (or raises); on a CPU tensor it returns
    :func:`gated_message_fwd_plain`."""
    if dh.device.type == "cpu":
        return gated_message_fwd_plain(dh, eh, ce, bh, edges, edge_mask)
    args, code = _kernel_inputs("gated_message_cuda", dh, eh, ce, bh, edges,
                                edge_mask)
    from ._build import load

    b, n, d = dh.shape
    e = ce.shape[1]
    agg, e_out = torch.empty_like(args[0]), torch.empty_like(args[2])
    with torch.cuda.device(dh.device):
        err = load("gated_message")(
            *(t.data_ptr() for t in args), agg.data_ptr(), e_out.data_ptr(),
            b, n, e, d, code, _stream(dh))
    if err:
        raise RuntimeError(f"gated_message kernel launch failed: "
                           f"cudaError {err}")
    _counted(gated_message_cuda, dh.dtype)
    return agg, e_out


gated_message_cuda.launches = 0
gated_message_cuda.launches_bf16 = 0


def gated_message_bwd_cuda(g_agg, g_e, dh, eh, ce, bh, edges, edge_mask):
    """Backward kernel: ``(ddh, deh, dce, dbh)`` from the outputs' gradients
    (either may be None) and the forward's inputs, in the inputs' dtype;
    ``dbh`` None where ``g_agg`` is.  On a CUDA tensor it launches the
    kernel (or raises); on a CPU tensor it returns
    :func:`gated_message_bwd_plain`."""
    if dh.device.type == "cpu":
        return gated_message_bwd_plain(g_agg, g_e, dh, eh, ce, bh, edges,
                                       edge_mask)
    args, code = _kernel_inputs("gated_message_bwd_cuda", dh, eh, ce, bh,
                                edges, edge_mask)
    grads = []
    for g, like in ((g_agg, args[0]), (g_e, args[2])):
        if g is not None and (g.shape != like.shape or g.dtype != like.dtype
                              or g.device != like.device):
            raise ValueError("gated_message_bwd_cuda: a gradient must have "
                             f"its output's shape and dtype {like.dtype} "
                             f"{tuple(like.shape)}, got {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
        grads.append(None if g is None else _aligned(g))
    from ._build import load

    b, n, d = dh.shape
    e = ce.shape[1]
    ddh, deh = torch.empty_like(args[0]), torch.empty_like(args[1])
    dce = torch.empty_like(args[2])
    dbh = None if g_agg is None else torch.empty_like(args[3])
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dh.device):
        err = load("gated_message", "gated_message_bwd_launch")(
            *(t.data_ptr() for t in args), *(ptr(g) for g in grads),
            ddh.data_ptr(), deh.data_ptr(), dce.data_ptr(), ptr(dbh),
            b, n, e, d, code, _stream(dh))
    if err:
        raise RuntimeError(f"gated_message_bwd kernel launch failed: "
                           f"cudaError {err}")
    _counted(gated_message_bwd_cuda, dh.dtype)
    return ddh, deh, dce, dbh


gated_message_bwd_cuda.launches = 0
gated_message_bwd_cuda.launches_bf16 = 0


class GatedMessageKernel(torch.autograd.Function):
    """The kernel path with its gradient: saves the four inputs, the edges
    and the mask, and nothing in f32; forward and backward are each a
    ``gps.message`` device span."""

    @staticmethod
    def forward(ctx, dh, eh, ce, bh, edges, edge_mask):
        with telemetry.device_span("gps.message", dh.device):
            agg, e = gated_message_cuda(dh, eh, ce, bh, edges, edge_mask)
        ctx.save_for_backward(dh, eh, ce, bh, edges, edge_mask)
        return agg, e

    @staticmethod
    def backward(ctx, g_agg, g_e):
        dh, eh, ce, bh, edges, edge_mask = ctx.saved_tensors
        with telemetry.device_span("gps.message", dh.device):
            ddh, deh, dce, dbh = gated_message_bwd_cuda(
                g_agg, g_e, dh, eh, ce, bh, edges, edge_mask)
        return ddh, deh, dce, dbh, None, None


def gated_message(dh: torch.Tensor, eh: torch.Tensor, ce: torch.Tensor,
                  bh: torch.Tensor, edges: torch.Tensor,
                  edge_mask: torch.Tensor):
    """``(agg [B, N, D], e [B, E, D])`` of the module docstring.  On CUDA,
    where :func:`kernels_support` takes the call and the four inputs share
    its dtype, the kernels (the backward where an input needs a gradient,
    the forward alone where none does); else :class:`GatedMessage`.
    Counted in :func:`counts`."""
    b, n, d = dh.shape
    if dh.is_cuda and kernels_support(n, ce.shape[1], d, dh.dtype) \
            and all(t.dtype == dh.dtype for t in (eh, ce, bh)):
        _count(edge_mask, "kernel")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (dh, eh, ce, bh)):
            return GatedMessageKernel.apply(dh, eh, ce, bh, edges,
                                            edge_mask)
        with telemetry.device_span("gps.message", dh.device):
            return gated_message_cuda(dh, eh, ce, bh, edges, edge_mask)
    _count(edge_mask, "explicit")
    src, dst = _flat(edges, n)
    return GatedMessage.apply(dh, eh, ce, bh, src, dst,
                              edge_mask.reshape(-1))
