"""Fused backward of the fingerprint CNN branch: CUDA kernels for the
masked fc1 input gradient (``csrc/cnn_dy3.cu``) and the conv3 -> conv2 ->
conv1 backward chain (``csrc/cnn_chain_bwd.cu``), their plain PyTorch
versions, and the ``cnn_tail`` ``autograd.Function`` around them.

Port of ``mgat_graphsage_tpu/ops/pallas_cnn.py`` (``_dy3_pallas``,
``cnn_chain_bwd``, ``cnn_tail``).  ``cnn_tail`` is the branch's conv stack
(1 -> 32 -> 64 -> 128 channels, k=3 SAME, ReLU), the pos-major flatten and
fc1, with the forward op for op the module path of ``CNNNet`` and the
backward through the two kernels.  The fc1 weight and bias gradients are
plain products (``torch.matmul``, a sum), as the reference leaves them to
XLA.  The fingerprint gets no gradient: where it requires one,
:func:`cnn_tail` raises.

Layouts are the forward's own, so no copy stands between its tensors and
the kernels: ``y1 [B, 32, W]`` and ``y2 [B, 64, W]`` (NCW, as the convs
write them), ``y3 [B, W, 128]`` (the pos-major flatten fc1 reads), and
``dy3 [B, W, 128]``.  The kernels take any ``B >= 1`` and ``W >= 1``; the
channel counts are the branch's (128, 64, 32).  On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it returns its
plain version.

Operands are f32 or bf16, one dtype a call (the bf16 working copy of
``compute_dtype="bfloat16"``); the chain's six results are f32 either way.
In bf16 the kernels and their plain versions round where the reference's
kernels do (``pallas_cnn.py:122``, ``:242``, ``:251``): products summed in
f32, ``dy3`` rounded once to bf16 before its mask, the conv dgrads ``d2``
and ``d1`` rounded to bf16 before theirs.  Each wrapper counts its f32
launches in ``launches`` and its bf16 launches in ``launches_bf16``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cnn_tail", "dy3_cuda", "dy3_plain", "cnn_chain_bwd_cuda",
           "cnn_chain_bwd_plain"]

C3, C2, C1 = 128, 64, 32
# output of the chain kernel: dw3 | db3 | dw2 | db2 | dw1 | db1
_SPLIT = [(C3 * C2 * 3, (C3, C2, 3)), (C3, (C3,)), (C2 * C1 * 3, (C2, C1, 3)),
          (C2, (C2,)), (C1 * 3, (C1, 1, 3)), (C1, (C1,))]
_NTOT = sum(n for n, _ in _SPLIT)
_TILE_W = 32                     # positions per tile of the f32 chain kernel
_TILE_W_BF16 = 128               # ... and of the bf16 one (kBTW)
_DY3_TILE_B = 128                # molecules per tile of the dy3 kernel
_DY3_MAX_H_BF16 = 512            # H of the bf16 dy3 kernel (kMaxH)


def _dtype(name: str, ts) -> torch.dtype:
    """The one dtype of ``ts``, f32 or bf16; raises for any other or a
    mix."""
    dts = {t.dtype for t in ts}
    if len(dts) != 1 or not dts <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"{name} takes f32 or bf16 inputs of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    return dts.pop()


def dy3_plain(dy: torch.Tensor, fc1_weight: torch.Tensor,
              y3: torch.Tensor) -> torch.Tensor:
    """``dy [B, H]``, ``fc1_weight [H, W*C]`` (pos-major columns),
    ``y3 [B, W, C]`` -> ``(dy @ fc1_weight).view(B, W, C)`` where
    ``y3 > 0``, else 0; in y3's dtype.  bf16: the product of the f32
    values, rounded once to bf16."""
    dt = _dtype("dy3_plain", (dy, fc1_weight, y3))
    dx = torch.matmul(dy.float(), fc1_weight.float()).to(dt).view(y3.shape)
    return torch.where(y3 > 0, dx, torch.zeros((), dtype=dt,
                                                device=dx.device))


def _wgrad(d: torch.Tensor, x: torch.Tensor):
    """Weight ``[O, I, 3]`` and bias ``[O]`` gradients of a k=3 SAME conv
    from ``d [B, O, W]`` (pre-activation gradient) and ``x [B, I, W]``."""
    w = d.shape[-1]
    xp = F.pad(x, (1, 1))
    dw = torch.stack([torch.einsum("bow,biw->oi", d, xp[..., k:k + w])
                      for k in range(3)], dim=-1)
    return dw, d.sum((0, 2))


def _dgrad(d: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Input gradient ``[B, I, W]`` of a k=3 SAME conv."""
    w = d.shape[-1]
    dp = F.pad(d, (1, 1))
    return sum(torch.einsum("oi,bow->biw", weight[:, :, k],
                            dp[..., 2 - k:2 - k + w]) for k in range(3))


def cnn_chain_bwd_plain(dy3: torch.Tensor, y2: torch.Tensor,
                        y1: torch.Tensor, fp: torch.Tensor,
                        w3: torch.Tensor, w2: torch.Tensor):
    """``dy3 [B, W, 128]`` (masked conv3 gradient), ``y2 [B, 64, W]``,
    ``y1 [B, 32, W]``, ``fp [B, W]``, ``w3 [128, 64, 3]``, ``w2 [64, 32,
    3]`` -> ``(dw3, db3, dw2, db2, dw1 [32, 1, 3], db1)`` in torch layouts,
    f32.  bf16: f32 math on the bf16 values, with the dgrads rounded to
    bf16 before their masks."""
    dt = _dtype("cnn_chain_bwd_plain", (dy3, y2, y1, fp, w3, w2))
    dy3, y2, y1, fp, w3, w2 = (t.float() for t in (dy3, y2, y1, fp, w3, w2))

    def stored(d):     # a dgrad as the compute dtype holds it
        return d if dt == torch.float32 else d.to(dt).float()

    d3 = dy3.transpose(1, 2)
    dw3, db3 = _wgrad(d3, y2)
    zero = torch.zeros((), device=dy3.device)
    d2 = torch.where(y2 > 0, stored(_dgrad(d3, w3)), zero)
    dw2, db2 = _wgrad(d2, y1)
    d1 = torch.where(y1 > 0, stored(_dgrad(d2, w2)), zero)
    dw1, db1 = _wgrad(d1, fp.unsqueeze(1))
    return dw3, db3, dw2, db2, dw1, db1


def _check(name: str, ts) -> torch.dtype:
    """Raises unless ``ts`` are contiguous, on one CUDA device and of one
    dtype, f32 or bf16; returns the dtype."""
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    dt = _dtype(name, ts)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    return dt


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dy3_cuda(dy: torch.Tensor, fc1_weight: torch.Tensor,
             y3: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`dy3_plain` (same arguments, f32 or
    bf16)."""
    if dy.device.type == "cpu":
        return dy3_plain(dy, fc1_weight, y3)
    dt = _check("dy3_cuda", (dy, fc1_weight, y3))
    b, h = dy.shape if dy.dim() == 2 else (-1, -1)
    if y3.dim() != 3 or y3.shape[0] != b or fc1_weight.dim() != 2 \
            or tuple(fc1_weight.shape) != (h, y3.shape[1] * y3.shape[2]):
        raise ValueError(f"dy3_cuda: shapes {tuple(dy.shape)}, "
                         f"{tuple(fc1_weight.shape)}, {tuple(y3.shape)} are "
                         "not [B, H], [H, W*C], [B, W, C]")
    k = fc1_weight.shape[1]
    if k % 4 or fc1_weight.data_ptr() % 16 or y3.data_ptr() % 16:
        raise ValueError("dy3_cuda needs W*C % 4 == 0 and 16-byte aligned "
                         "fc1_weight and y3")
    if dt == torch.bfloat16 and (k % 8 or h % 8 or h > _DY3_MAX_H_BF16
                                 or dy.data_ptr() % 16):
        raise ValueError("dy3_cuda in bf16 needs W*C % 8 == 0, H % 8 == 0, "
                         f"H <= {_DY3_MAX_H_BF16} (its weight slab [H, 64] "
                         "or [H, 128] stays in shared memory) and a 16-byte "
                         "aligned dy")
    from ._build import load

    out = torch.empty_like(y3)
    if dt == torch.bfloat16:
        with torch.cuda.device(dy.device):
            err = load("cnn_dy3", "cnn_dy3_bf16_launch")(
                dy.data_ptr(), fc1_weight.data_ptr(), y3.data_ptr(),
                out.data_ptr(), b, h, k, _stream(dy))
        if err:
            raise RuntimeError(f"cnn_dy3 bf16 kernel launch failed: "
                               f"cudaError {err}")
        dy3_cuda.launches_bf16 += 1
        return out
    # the kernel reads dy transposed, its columns padded to a whole tile
    bpad = -(-b // _DY3_TILE_B) * _DY3_TILE_B
    dyt = (dy.t() if bpad == b else F.pad(dy.t(), (0, bpad - b))).contiguous()
    with torch.cuda.device(dy.device):
        err = load("cnn_dy3")(dyt.data_ptr(), fc1_weight.data_ptr(),
                              y3.data_ptr(), out.data_ptr(), b, h, k,
                              _stream(dy))
    if err:
        raise RuntimeError(f"cnn_dy3 kernel launch failed: cudaError {err}")
    dy3_cuda.launches += 1
    return out


dy3_cuda.launches = 0
dy3_cuda.launches_bf16 = 0


def cnn_chain_bwd_cuda(dy3: torch.Tensor, y2: torch.Tensor,
                       y1: torch.Tensor, fp: torch.Tensor,
                       w3: torch.Tensor, w2: torch.Tensor):
    """Kernel version of :func:`cnn_chain_bwd_plain` (same arguments, f32
    or bf16, and results, f32)."""
    if dy3.device.type == "cpu":
        return cnn_chain_bwd_plain(dy3, y2, y1, fp, w3, w2)
    ts = (dy3, y2, y1, fp, w3, w2)
    dt = _check("cnn_chain_bwd_cuda", ts)
    b, w = fp.shape if fp.dim() == 2 else (0, 0)
    want = [(b, w, C3), (b, C2, w), (b, C1, w), (b, w), (C3, C2, 3),
            (C2, C1, 3)]
    if [tuple(t.shape) for t in ts] != want or b < 1 or w < 1:
        raise ValueError(f"cnn_chain_bwd_cuda: shapes "
                         f"{[tuple(t.shape) for t in ts]}, expected {want} "
                         "with B, W >= 1")
    if dy3.data_ptr() % 16:
        raise ValueError("cnn_chain_bwd_cuda needs a 16-byte aligned dy3")
    from ._build import load

    bf16 = dt == torch.bfloat16
    tiles = b * -(-w // (_TILE_W_BF16 if bf16 else _TILE_W))
    blocks = min(tiles, torch.cuda.get_device_properties(
        dy3.device).multi_processor_count)
    partials = torch.empty((blocks, _NTOT), dtype=torch.float32,
                           device=dy3.device)
    out = torch.empty(_NTOT, dtype=torch.float32, device=dy3.device)
    with torch.cuda.device(dy3.device):
        err = load("cnn_chain_bwd", "cnn_chain_bwd_bf16_launch" if bf16
                   else "")(
            dy3.data_ptr(), y2.data_ptr(), y1.data_ptr(), fp.data_ptr(),
            w3.data_ptr(), w2.data_ptr(), partials.data_ptr(),
            out.data_ptr(), b, w, blocks, _stream(dy3))
    if err:
        raise RuntimeError(f"cnn_chain_bwd{' bf16' if bf16 else ''} kernel "
                           f"launch failed: cudaError {err}")
    if bf16:
        cnn_chain_bwd_cuda.launches_bf16 += 1
    else:
        cnn_chain_bwd_cuda.launches += 1
    return tuple(part.view(shape) for part, (_, shape) in
                 zip(out.split([n for n, _ in _SPLIT]), _SPLIT))


cnn_chain_bwd_cuda.launches = 0
cnn_chain_bwd_cuda.launches_bf16 = 0


def _conv_relu(x, weight, bias):
    """Op for op ``TorchConv1d`` + ReLU (``models/layers.py``)."""
    return F.relu(F.conv1d(x, weight, bias, padding=weight.shape[2] // 2))


class _CNNTail(torch.autograd.Function):
    """Forward: the module path's ops.  Backward: kernels 4 and 5 plus the
    fc1 weight and bias gradients, each gradient in its parameter's dtype
    (``pallas_cnn.py:374-377``)."""

    @staticmethod
    def forward(ctx, fp, w1, b1, w2, b2, w3, b3, fc1_w, fc1_b):
        y1 = _conv_relu(fp.unsqueeze(1), w1, b1)
        y2 = _conv_relu(y1, w2, b2)
        y3 = _conv_relu(y2, w3, b3)
        xf = y3.transpose(1, 2).reshape(y3.shape[0], -1)   # pos-major
        ctx.save_for_backward(fp, w2, w3, fc1_w, y1, y2, xf)
        return F.linear(xf, fc1_w, fc1_b)

    @staticmethod
    def backward(ctx, g):
        fp, w2, w3, fc1_w, y1, y2, xf = ctx.saved_tensors
        g = g.contiguous()
        dfc1_b = g.sum(0)
        dfc1_w = torch.matmul(g.t(), xf)
        dy3 = dy3_cuda(g, fc1_w, xf.view(xf.shape[0], -1, C3))
        dw3, db3, dw2, db2, dw1, db1 = (
            d.to(w3.dtype) for d in cnn_chain_bwd_cuda(dy3, y2, y1, fp, w3,
                                                       w2))
        return None, dw1, db1, dw2, db2, dw3, db3, dfc1_w, dfc1_b


def cnn_tail(fp, w1, b1, w2, b2, w3, b3, fc1_w, fc1_b) -> torch.Tensor:
    """``fp [B, W]`` -> ``fc1(flatten(convs(fp)))`` ``[B, H]``, with the
    kernels' backward.  Raises if the fingerprint requires a gradient."""
    if torch.is_grad_enabled() and fp.requires_grad:
        raise RuntimeError("cnn_tail gives the fingerprint no gradient; "
                           "take CNNNet's module path (cnn_pallas_bwd=False) "
                           "to differentiate with respect to it")
    return _CNNTail.apply(fp, w1, b1, w2, b2, w3, b3, fc1_w, fc1_b)
