"""Plain PyTorch reference of the flagship M-GAT-GraphSAGE hybrid: its
forward pass, loss, and Adam step with L2 weight decay, written from the
architecture (reference ``train.py:70-246``) for the benchmark's checks.

It imports nothing of the program.  It takes its weights as a dict of
tensors named as the architecture names them (the benchmark makes them
from the seed, ``portbench/harness/weights.py``), and its inputs as padded
arrays that ``reference/featurize.py`` made.

Products run through a :class:`Numerics`: ``"f32"`` is IEEE float32 with
TF32 off in cuBLAS and cuDNN; ``"bf16"`` casts parameters and inputs to
bfloat16 with f32 accumulation, as a bf16 configuration states; the
attention's internals, the adjacency and the loss stay f32 in both.
``"tf32"`` and ``"fp8"`` are the controls, one step below each: the same
computation with every operand of every product rounded to TF32 (10-bit
mantissa) or, per tensor scaled, to float8 e4m3.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9


class Numerics:
    """How the reference takes its products (see the module docstring)."""

    MODES = ("f32", "tf32", "bf16", "fp8")

    def __init__(self, mode: str):
        if mode not in self.MODES:
            raise ValueError(f"unknown numerics {mode!r}: {self.MODES}")
        self.mode = mode
        self.dtype = torch.bfloat16 if mode in ("bf16", "fp8") \
            else torch.float32

    @contextlib.contextmanager
    def flags(self):
        """TF32 off, bf16 split-K reduction off; restored after."""
        mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        prev = (mm.allow_tf32, cudnn.allow_tf32,
                mm.allow_bf16_reduced_precision_reduction)
        mm.allow_tf32 = cudnn.allow_tf32 = False
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            yield
        finally:
            (mm.allow_tf32, cudnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction) = prev

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand as the product reads it."""
        if self.mode == "tf32":
            return _round_tf32(t)
        if self.mode == "fp8":
            return _round_e4m3(t)
        return t

    def q32(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of an f32 product inside the attention."""
        return _round_tf32(t) if self.mode == "tf32" else t

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv1d(self, x, w, b):
        return F.conv1d(self.q(x), self.q(w), b, padding=w.shape[2] // 2)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        bits = t.detach().float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return _RoundTF32.apply(g)


class _RoundE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = 448.0 / amax
        r = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
        return r.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return _RoundE4M3.apply(g)


def _round_tf32(t):
    return _RoundTF32.apply(t)


def _round_e4m3(t):
    return _RoundE4M3.apply(t)


def dense_adjacency(edges: torch.Tensor, edge_mask: torch.Tensor,
                    n: int) -> torch.Tensor:
    """``adj[b, dst, src] = min(sum of the edge masks, 1)``, f32."""
    b, _, e = edges.shape
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    batch = torch.arange(b, device=edges.device).unsqueeze(1).expand(b, e)
    adj = torch.zeros((b, n, n), dtype=torch.float32, device=edges.device)
    adj.index_put_((batch, dst, src), edge_mask.float(), accumulate=True)
    return adj.clamp_max(1.0)


def _masked_softmax(scores, mask):
    valid = mask > 0
    s = scores + torch.where(valid, 0.0, NEG_INF)
    s_max = s.amax(dim=-1, keepdim=True).detach()
    unnorm = torch.exp(s - s_max) * valid
    return unnorm / torch.clamp_min(unnorm.sum(dim=-1, keepdim=True), 1e-16)


def _max_pool(x, node_mask):
    neg = torch.where(node_mask.unsqueeze(-1) > 0, 0.0, NEG_INF).to(x.dtype)
    pooled = (x + neg).amax(dim=-2)
    any_valid = node_mask.amax(dim=-1, keepdim=True) > 0
    return torch.where(any_valid, pooled,
                       torch.zeros((), dtype=x.dtype, device=x.device))


DropFn = Callable[[torch.Tensor], torch.Tensor]


def forward(w: Dict[str, torch.Tensor], nodes, adj, node_mask, fp,
            num: Numerics, drop: Optional[DropFn] = None):
    """``(prediction [B], latent [B, 1 + fp_bits])`` in f32.

    ``w`` holds the parameters in ``num.dtype``; ``nodes``, ``adj``,
    ``node_mask``, ``fp`` are in ``num.dtype`` too.  ``drop(x)`` applies a
    dropout mask in training (the three dropouts in the order graph, CNN,
    head); None is evaluation."""
    drop = drop or (lambda x: x)
    g = "gat_graphsage."
    c = g + "conv1."
    feat = nodes.shape[-1]

    def lin(x, name, bias=True):
        return num.linear(x, w[name + ".weight"],
                          w[name + ".bias"] if bias else None)

    # M-GAT: Q, K, V; K through the centre taps of the k=3 and k=5 convs
    qv = lin(nodes, c + "query_transform")
    kv = lin(nodes, c + "key_transform")
    vv = lin(nodes, c + "value_transform")
    k3 = num.linear(kv, w[c + "conv3.weight"][:, :, 1], w[c + "conv3.bias"])
    k5 = num.linear(kv, w[c + "conv5.weight"][:, :, 2], w[c + "conv5.bias"])
    k_new = lin(torch.cat([k3, k5, kv], dim=-1), c + "linear_transform")
    qf, kf, vf = (t.float() for t in (qv, k_new, vv))
    scores = torch.matmul(num.q32(kf), num.q32(qf).transpose(-1, -2)) \
        / math.sqrt(feat)
    attn = _masked_softmax(scores, node_mask.float().unsqueeze(-2))
    x = (torch.matmul(num.q32(attn), num.q32(vf)) + vf).to(nodes.dtype)
    # SAGEConv (mean aggregation), ReLU, masked max pool, MLP
    x = F.relu(x)
    deg = adj.sum(-1, keepdim=True)
    agg = num.matmul(adj, x) / torch.clamp_min(deg, 1.0).to(x.dtype)
    x = F.relu(lin(agg, g + "conv2.lin_l") + lin(x, g + "conv2.lin_r",
                                                 bias=False))
    h = drop(F.relu(lin(_max_pool(x, node_mask), g + "fc_g1")))
    graph_out = lin(lin(h, g + "fc_g2"), g + "out")
    # fingerprint CNN: three convs over the bit axis, pos-major flatten
    y = fp.unsqueeze(1)
    for i in (1, 2, 3):
        y = F.relu(num.conv1d(y, w[f"cnn.conv{i}.weight"],
                              w[f"cnn.conv{i}.bias"]))
    y = lin(y.transpose(1, 2).reshape(y.shape[0], -1), "cnn.fc1")
    cnn_out = lin(drop(F.relu(y)), "cnn.fc2")
    latent = torch.cat([graph_out, cnn_out], dim=-1)
    pred = lin(drop(F.relu(lin(latent, "combined.fc1"))), "combined.fc2")
    return pred.reshape(-1).float(), latent.float()


def masked_mse(pred, target, sample_mask):
    err = (pred - target) ** 2
    return (err * sample_mask).sum() / torch.clamp_min(sample_mask.sum(), 1.0)


def kl_loss(latent, sample_mask):
    """KL(N(mu, var) || N(0, 1)) of the batch's latent, var unbiased."""
    wgt = sample_mask.unsqueeze(1)
    cnt = torch.clamp_min(wgt.sum(), 1.0)
    mean = (latent * wgt).sum(0) / cnt
    var = (((latent - mean) ** 2) * wgt).sum(0) \
        / torch.clamp_min(cnt - 1.0, 1.0)
    return -0.5 * torch.sum(1.0 + torch.log(var + 1e-10) - mean ** 2 - var)


def lr_at(count: int, lr: float, schedule: str, warmup_steps: int,
          final_ratio: float, total_steps: int) -> float:
    """The learning rate at the 1-based step ``count``: constant, or
    linear warmup then cosine decay to ``lr * final_ratio``, in f32."""
    if schedule == "constant":
        return lr
    f32 = np.float32
    warm = max(int(warmup_steps), 1)
    floor = lr * final_ratio
    span = max(int(total_steps) - warm, 1)
    c = f32(count)
    if c <= f32(warm):
        return float(f32(lr) * np.minimum(c / f32(warm), f32(1.0)))
    prog = np.clip((c - f32(warm)) / f32(span), f32(0.0), f32(1.0))
    return float(f32(floor) + f32(0.5 * (lr - floor))
                 * (f32(1.0) + np.cos(f32(np.pi) * prog)))


class Adam:
    """Adam with L2 weight decay in the gradient (the reference's
    ``torch.optim.Adam``) over f32 master parameters, which the forward
    reads cast to the compute dtype.  ``torch_adam``: the step is
    ``torch.optim.Adam``'s own (the all-f32 configuration); else it is
    written out, in f32 arithmetic, with the moments stored in
    ``moment_dtype`` (a bf16 configuration's)."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float,
                 moment_dtype=torch.float32, betas=(0.9, 0.999),
                 eps: float = 1e-8, torch_adam: bool = False):
        self.p = params
        self.wd, self.mdt, self.betas, self.eps = (weight_decay, moment_dtype,
                                                   betas, eps)
        self.opt = torch.optim.Adam(list(params.values()), betas=betas,
                                    eps=eps, weight_decay=weight_decay) \
            if torch_adam else None
        self.m = {k: torch.zeros_like(v, dtype=moment_dtype)
                  for k, v in params.items()}
        self.v = {k: torch.zeros_like(v, dtype=moment_dtype)
                  for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float
             ) -> Dict[str, torch.Tensor]:
        """Update in place; returns the gradients as the update read them
        (L2 term included)."""
        b1, b2 = self.betas
        self.t += 1
        seen = {k: grads[k].float() + self.wd * p for k, p in self.p.items()}
        if self.opt is not None:
            for k, p in self.p.items():
                p.grad = grads[k].float()
            for group in self.opt.param_groups:
                group["lr"] = lr
            self.opt.step()
            return seen
        f32 = np.float32
        c1 = float(f32(1.0) - f32(b1) ** f32(self.t))
        c2 = float(f32(1.0) - f32(b2) ** f32(self.t))
        for k, p in self.p.items():
            g = seen[k]
            m = self.m[k].float() * b1 + g * (1.0 - b1)
            v = self.v[k].float() * b2 + g * g * (1.0 - b2)
            self.m[k].copy_(m)
            self.v[k].copy_(v)
            p.add_((m / c1) * (-lr) / (torch.sqrt(v / c2) + self.eps))
        return seen
