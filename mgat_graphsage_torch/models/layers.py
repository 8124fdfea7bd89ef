"""Layers of the flagship hybrid and of the baselines (port of
``mgat_graphsage_tpu/models/layers.py``).

Every layer works on the padded-dense batch layout: node features
``x [B, N, F]``, dense adjacency ``adj [B, N, N]`` and ``node_mask
[B, N]``.  Weights follow PyTorch's layout (``Linear.weight [out, in]``,
``Conv1d.weight [out, in, k]``); ``models/convert.py`` carries the
reference package's flax trees over.  Initialisation is PyTorch's default,
U(+-1/sqrt(fan_in)), or PyG's Glorot-uniform for the baselines' layers,
drawn from an explicit ``torch.Generator``; so are the dropout masks in
training (``generator=`` of each ``forward``).  The baselines' dense
products are plain PyTorch, as they are plain ``einsum`` in the reference.

The graph transformer's layers (:class:`Table`, :class:`StructuralBias`,
:class:`GraphormerLayer`; ``models/zoo.py::GraphormerNet``) take the
Graphormer's inputs instead: the layer works on ``x [B, N, D]`` with the
graph token first, the structural bias ``[B, H, N, N]`` and the key mask.
Their dropout masks are drawn on f32 tensors of the masked shape whatever
the compute dtype, so a reference in f32 draws the same bits.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..chem.featurize import MAX_HOPS
from ..ops import (
    add_self_loops,
    attention_plain,
    cnn_tail,
    fused_masked_attention,
    gcn_norm_adjacency,
    masked_softmax,
)
from ..ops.attention import kernels_support
from ..ops.biased_attention import biased_attention
from ..parallel.distributed import (
    batch_sum,
    copy_to_group,
    current_batch_shard,
    gather_columns,
)

__all__ = [
    "TorchLinear",
    "TorchConv1d",
    "CenterTapConv1d",
    "ModifiedGATLayer",
    "SAGEConv",
    "GlorotLinear",
    "GCNConv",
    "GATConv",
    "GINConv",
    "ChebConvRef",
    "MaskedBatchNorm",
    "frozen_running_stats",
    "CNNNet",
    "CombinedNet",
    "Dropout",
    "ieee_f32",
    "bf16_products",
    "matmul_precision",
    "cnn_fc1_torch_to_pos_major",
    "cnn_fc1_pos_major_to_torch",
    "reset_parameters",
    "Table",
    "StructuralBias",
    "GraphormerLayer",
    "keep_mask",
]


def cnn_fc1_torch_to_pos_major(kernel, channels: int = 128):
    """Reorder a channel-major CNN fc1 kernel ``[C*W, H]`` (torch's
    ``x.view(B, -1)`` on ``[B, C, W]``: row ``c*W + w``) into pos-major
    rows (``w*C + c``), the layout :class:`CNNNet` flattens to.  Works on
    numpy arrays and tensors."""
    cw, h = kernel.shape
    return _swap01(kernel.reshape(channels, cw // channels, h)).reshape(cw, h)


def cnn_fc1_pos_major_to_torch(kernel, channels: int = 128):
    """Inverse of :func:`cnn_fc1_torch_to_pos_major`."""
    cw, h = kernel.shape
    return _swap01(kernel.reshape(cw // channels, channels, h)).reshape(cw, h)


def _swap01(a):
    return a.permute(1, 0, 2) if isinstance(a, torch.Tensor) \
        else a.transpose(1, 0, 2)


def _uniform_(t: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator]) -> None:
    """Glorot-uniform, U(+-sqrt(6 / (fan_in + fan_out)))."""
    _uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), generator)


class Dropout(nn.Module):
    """Inverted dropout (``nn.Dropout`` semantics) whose mask comes from
    the ``generator`` passed to ``forward`` (the global one when None);
    identity in eval mode.  Inside ``parallel.batch_shard`` the mask is
    drawn for the whole global batch and this rank keeps its rows, so a
    data-parallel run draws the single-process run's masks, as the
    reference's SPMD program does."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shard = current_batch_shard()
        if shard is None:
            keep = torch.empty_like(x)
        else:
            keep = x.new_empty((shard.rows,) + tuple(x.shape[1:]))
        keep.bernoulli_(1.0 - self.p, generator=generator)
        if shard is not None:
            keep = keep[shard.offset:shard.offset + x.shape[0]]
        return x * keep / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class TorchLinear(nn.Module):
    """``nn.Linear`` with torch's default init; ``weight [out, in]``.

    ``column_split`` (a ``parallel.ColumnSplit``, set by
    ``parallel.shard_state``) runs the layer split over a mesh's model
    axis, Megatron's column-parallel pair: ``weight`` and ``bias`` hold
    this rank's output rows, the input gradient is summed over the group
    (``copy_to_group``) and the columns are gathered into the whole
    ``[..., total]`` output (``gather_columns``).  Each split layer holds
    its own, so two split layers of one model keep their own widths."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.column_split = None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = self.column_split
        if split is None:
            return F.linear(x, self.weight, self.bias)
        return gather_columns(
            F.linear(copy_to_group(x, split.group), self.weight, self.bias),
            split.group, split.offset, split.total)


class TorchConv1d(nn.Module):
    """``nn.Conv1d`` (stride 1, SAME padding, odd k) on NCW input, with
    torch's default init; ``weight [out, in, k]``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2])
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight, self.bias,
                        padding=self.weight.shape[2] // 2)


class CenterTapConv1d(nn.Module):
    """The reference's Conv1d over a length-1 axis (``train.py:83-93``):
    only the center tap ever touches data, so the layer is a linear map
    with ``weight[:, :, k // 2]``.  The full ``[out, in, k]`` parameter is
    kept, with init over fan_in = in*k."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.kernel_size)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, self.kernel_size // 2],
                        self.bias)


class ModifiedGATLayer(nn.Module):
    """The "M-GAT" dense QKV attention layer (reference ``train.py:77-99``).

    Q, K, V = three Linear(F->F); K goes through the center-tap convs
    k=3 and k=5; ``K_new = Linear(3F->F)(cat[K3, K5, K])``;
    ``scores[i, j] = K_new[i] . Q[j] / sqrt(F)`` (transposed roles);
    ``out = softmax_j(scores) @ V (+ V when residual)``.

    ``flat=False`` (the default) attends within each molecule under
    ``node_mask`` through :func:`~..ops.attention.fused_masked_attention`,
    forward kernel ``csrc/attention.cu`` and backward kernel
    ``csrc/attention_bwd.cu``, whether or not a gradient is required.
    Gate: the kernels take ``N <= 128``, ``F <= 128`` within their
    shared-memory limit (``ops.attention.kernels_support``, asked with the
    shapes before any launch); past it the layer takes the plain path, as
    the reference layer does past its kernel's N = 512.  ``flat=True``
    attends over the whole batch as one node set (reference numerics) and
    always takes the plain path: the kernels keep one molecule's N x N
    scores on chip, which a batch-wide set does not fit.
    """

    def __init__(self, in_features: int, features: int,
                 residual: bool = True, flat: bool = False):
        super().__init__()
        self.features = features
        self.residual = residual
        self.flat = flat
        self.query_transform = TorchLinear(in_features, features)
        self.key_transform = TorchLinear(in_features, features)
        self.value_transform = TorchLinear(in_features, features)
        self.conv3 = CenterTapConv1d(features, features, 3)
        self.conv5 = CenterTapConv1d(features, features, 5)
        self.linear_transform = TorchLinear(3 * features, features)

    def forward(self, x: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        orig_shape = x.shape
        if self.flat and x.dim() == 3:
            x = x.reshape(1, -1, x.shape[-1])
            node_mask = None if node_mask is None else node_mask.reshape(1, -1)
        in_dtype = x.dtype
        q = self.query_transform(x)
        k = self.key_transform(x)
        v = self.value_transform(x)
        k_new = self.linear_transform(
            torch.cat([self.conv3(k), self.conv5(k), k], dim=-1))
        # attention internals run in f32 whatever the compute dtype
        q, k_new, v = (t.float() for t in (q, k_new, v))
        if node_mask is not None:
            node_mask = node_mask.float()
        if not self.flat and node_mask is not None and x.dim() == 3 \
                and kernels_support(q.shape[1], q.shape[2]):
            out = fused_masked_attention(
                q.contiguous(), k_new.contiguous(), v.contiguous(),
                node_mask.contiguous(), self.residual)
        else:
            out = attention_plain(q, k_new, v, node_mask, self.residual)
        out = out.to(in_dtype)
        if self.flat and len(orig_shape) == 3:
            out = out.reshape(orig_shape[:-1] + (self.features,))
        return out


class SAGEConv(nn.Module):
    """GraphSAGE mean aggregation, PyG semantics (reference
    ``train.py:106,117``): ``lin_l(mean_{j in N(i)} x_j) + lin_r(x_i)``,
    bias on ``lin_l`` only, no self-loops; dense form ``adj @ x / deg``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin_l = TorchLinear(in_features, features)
        self.lin_r = TorchLinear(in_features, features, bias=False)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        deg = adj.sum(-1, keepdim=True)
        agg = torch.matmul(adj, x) / torch.clamp_min(deg, 1.0).to(x.dtype)
        return self.lin_l(agg) + self.lin_r(x)


class GlorotLinear(nn.Module):
    """Bias-free dense layer with PyG's Glorot-uniform weight ``[out, in]``
    (the ``lin`` of :class:`GCNConv` and :class:`GATConv`, which add their
    own bias after the aggregation)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        out_f, in_f = self.weight.shape
        _glorot_(self.weight, in_f, out_f, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)


class GCNConv(nn.Module):
    """Kipf-Welling GCN conv, PyG semantics (reference ``gnn/gcn.py:46-48``):
    ``D^-1/2 (A + I) D^-1/2 (x W)`` with a Glorot ``lin`` (no bias) and a
    zero-initialised ``bias`` added after the aggregation, as PyG adds it
    (the two places differ once the bias trains away from zero)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin = GlorotLinear(in_features, features)
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        norm_adj = gcn_norm_adjacency(adj, node_mask)
        return torch.matmul(norm_adj, self.lin(x)) + self.bias


class GATConv(nn.Module):
    """Multi-head graph attention, PyG semantics (reference ``gnn/gat.py:
    54-55``, ``ablation/model1.py:57``)::

        e_ij = LeakyReLU_0.2(a_dst . (W x_i) + a_src . (W x_j))
        alpha_ij = softmax over j in N(i) + {i} of e_ij   (self-loops added)
        out_i = concat over heads of sum_j alpha_ij W x_j, + bias

    ``att_src`` and ``att_dst`` are ``[1, H, C]``; the attention
    coefficients ``[B, H, N, N]`` take dropout in training, from the
    ``generator`` of ``forward``."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.features = heads, features
        self.lin = GlorotLinear(in_features, heads * features)
        self.att_src = nn.Parameter(torch.empty(1, heads, features))
        self.att_dst = nn.Parameter(torch.empty(1, heads, features))
        self.bias = nn.Parameter(torch.zeros(heads * features))
        self.attn_dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        # flax's glorot over [1, H, C]: fan_in H, fan_out C
        for att in (self.att_src, self.att_dst):
            _glorot_(att, self.heads, self.features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        wx = self.lin(x).unflatten(-1, (self.heads, self.features))
        a_src = (wx * self.att_src).sum(-1).transpose(-1, -2)  # [B, H, N]
        a_dst = (wx * self.att_dst).sum(-1).transpose(-1, -2)
        # logits[b, h, i, j] = dst_i + src_j
        logits = F.leaky_relu(a_dst.unsqueeze(-1) + a_src.unsqueeze(-2), 0.2)
        attn = masked_softmax(logits,
                              add_self_loops(adj, node_mask).unsqueeze(-3))
        attn = self.attn_dropout(attn, generator).to(wx.dtype)
        out = torch.matmul(attn, wx.transpose(-2, -3)).transpose(-2, -3)
        return out.flatten(-2) + self.bias


class GINConv(nn.Module):
    """Graph isomorphism conv, PyG semantics (reference ``gnn/gin.py:64``):
    ``mlp_1(relu(mlp_0((1 + eps) x + sum_{j in N(i)} x_j)))`` with eps = 0,
    the MLP ``in -> dim -> dim``."""

    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.mlp_0 = TorchLinear(in_features, dim)
        self.mlp_1 = TorchLinear(dim, dim)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x + torch.matmul(adj, x)
        return self.mlp_1(F.relu(self.mlp_0(h)))


class ChebConvRef(nn.Module):
    """The reference's hand-rolled "Chebyshev" conv (``gnn/chebnet.py:
    50-73``), its nonstandard pseudo-Laplacian kept as it is::

        L = -(A + D);  T_0 = I, T_1 = L, T_2 = 2 L T_1 - T_0
        out = lin((T_0 + T_1 + T_2) x)                     (K = 3)

    Per molecule on the padded batch: edges never cross molecules, so the
    reference's batch-wide L is block-diagonal and gives the same
    numbers."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin = TorchLinear(in_features, features)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        lap = -adj - torch.diag_embed(adj.sum(-1))
        t1 = torch.matmul(lap, x)
        out = (x + t1) + (2.0 * torch.matmul(lap, t1) - x)
        return self.lin(out.to(x.dtype))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the node axis with padding-aware statistics
    (reference ``gnn/gin.py:65-80`` normalises the batch's real nodes).

    In training the statistics are taken in f32 (f64 for f64 input) over
    the nodes where ``node_mask`` is set (the biased variance), and the
    running ``mean``
    and ``var`` follow torch's convention: ``new = 0.9 old + 0.1 batch``,
    with the unbiased variance; in eval the running ones are used.  The
    running buffers stay f32 whatever dtype the module is cast to, as the
    reference keeps ``batch_stats`` f32 and casts only ``params``.
    ``update_running`` off (:func:`frozen_running_stats`) leaves them be.
    Inside ``parallel.batch_shard`` the masked sums are summed over the
    data axis, so the statistics (and the running buffers, equal on every
    rank) are the global batch's."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.update_running = True
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def _apply(self, fn, recurse=True):
        kept = {n: b for n, b in self._buffers.items()
                if b is not None and b.dtype == torch.float32}
        super()._apply(fn, recurse)
        for n, b in kept.items():
            new = self._buffers[n]
            if new.dtype != torch.float32:
                self._buffers[n] = b.to(new.device)
        return self

    def forward(self, x: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.mean, self.var
        else:
            acc = torch.promote_types(x.dtype, torch.float32)
            xf = x.to(acc)
            w = node_mask.to(acc).unsqueeze(-1)
            dims = tuple(range(x.dim() - 1))
            shard = current_batch_shard()
            cnt = torch.clamp_min(batch_sum(w.sum(), shard), 1.0)
            mean = batch_sum((xf * w).sum(dims), shard) / cnt
            var = batch_sum((((xf - mean) ** 2) * w).sum(dims), shard) / cnt
            if self.update_running:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * unbiased)
        return (x - mean.to(x.dtype)) \
            * torch.rsqrt(var + self.eps).to(x.dtype) * self.scale + self.bias


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Hold every :class:`MaskedBatchNorm`'s running statistics still
    (a forward recomputed for its backward must not update them twice)."""
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    prev = [m.update_running for m in bns]
    for m in bns:
        m.update_running = False
    try:
        yield
    finally:
        for m, p in zip(bns, prev):
            m.update_running = p


@contextlib.contextmanager
def ieee_f32():
    """Turn TF32 off for cuDNN convolutions and cuBLAS products, and
    restore both settings after: TF32 keeps ~3 decimal digits, and the f32
    presets are the reference-numerics mode.  The trainer holds it over
    the whole f32 train step, forward and backward, so the convolutions'
    dgrad and wgrad run in IEEE f32 too."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@contextlib.contextmanager
def bf16_products():
    """The numerics of the bf16 train step, evaluation and prediction:
    bf16 products accumulated in f32, as ``preferred_element_type=
    jnp.float32`` gives the reference in every layer.  cuBLAS may reduce
    the partial sums of a split-K bf16 product in bf16
    (``allow_bf16_reduced_precision_reduction``, on by default); this turns
    that off, with TF32 for the f32 parts of the step (the attention
    internals, the loss), and restores all three after.

    ``F.linear`` adds the bias in the GEMM's f32 epilogue and rounds once,
    where the reference rounds the product to bf16 and then adds a bf16
    bias: a difference inside the bf16 noise floor, left as it is."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        with ieee_f32():
            yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev


def matmul_precision(precision: str, compute_dtype: str = "float32"):
    """The context in which a config's train step, evaluation and
    prediction run (``train/config.py`` states the mapping and why).  For
    f32 compute, ``"float32"`` and ``"bfloat16"`` both mean
    :func:`ieee_f32`, TF32 off in cuBLAS and cuDNN; for bf16 compute, both
    mean :func:`bf16_products`.  The entry points hold it around the whole
    model, the CNN branch's convolutions included."""
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"unknown matmul_precision {precision!r}: "
                         "'float32' or 'bfloat16'")
    if compute_dtype == "bfloat16":
        return bf16_products()
    if compute_dtype != "float32":
        raise ValueError(f"unknown compute dtype {compute_dtype!r}: "
                         "'float32' or 'bfloat16'")
    return ieee_f32()


class CNNNet(nn.Module):
    """Fingerprint 1D-CNN branch (reference ``train.py:127-146``):
    Conv1d 1->32->64->128 (k=3, SAME, ReLU) over the bit axis, flatten,
    FC(128*nbits -> fc_hidden) -> ReLU -> dropout -> FC(-> out).

    The flatten is POS-major (``[B, W, C] -> [B, W*C]``, column ``w*128 +
    c``), like the reference package's ``CNNNet``, so ``fc1.weight`` is the
    flax kernel transposed with no permutation.

    ``pallas_bwd=True`` (``TrainConfig.cnn_pallas_bwd``) routes conv1 ->
    fc1 through :func:`~..ops.cnn.cnn_tail`: the same parameters and
    forward math, with the backward through the kernels
    ``csrc/cnn_dy3.cu`` and ``csrc/cnn_chain_bwd.cu``.  They take any
    batch and width, so there is no shape gate; the fingerprint must not
    require a gradient there.

    Under a mesh's model axis ``fc1`` (and ``fc2`` where the reference's
    rule splits it) runs column-split (:class:`TorchLinear`'s
    ``column_split``).  The kernels' backward does not take a split fc1.
    """

    def __init__(self, input_dim: int, output_dim: int, fc_hidden: int = 256,
                 dropout: float = 0.3, pallas_bwd: bool = False):
        super().__init__()
        self.pallas_bwd = pallas_bwd
        self.conv1 = TorchConv1d(1, 32)
        self.conv2 = TorchConv1d(32, 64)
        self.conv3 = TorchConv1d(64, 128)
        self.fc1 = TorchLinear(input_dim * 128, fc_hidden)
        self.dropout = Dropout(dropout)
        self.fc2 = TorchLinear(fc_hidden, output_dim)

    def forward(self, fp: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.pallas_bwd and self.fc1.column_split is not None:
            raise RuntimeError("the CNN kernels' backward does not take a "
                               "column-split fc1 (cnn_pallas_bwd=False)")
        if self.pallas_bwd:
            x = cnn_tail(fp, self.conv1.weight, self.conv1.bias,
                         self.conv2.weight, self.conv2.bias,
                         self.conv3.weight, self.conv3.bias,
                         self.fc1.weight, self.fc1.bias)
        else:
            x = fp.unsqueeze(1)                          # [B, 1, W]
            for conv in (self.conv1, self.conv2, self.conv3):
                x = F.relu(conv(x))                      # [B, C, W]
            x = self.fc1(x.transpose(1, 2).reshape(x.shape[0], -1))
        x = self.dropout(F.relu(x), generator)
        return self.fc2(x)


def keep_mask(shape, p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A bool dropout keep-mask of ``shape``, each element kept with
    probability ``1 - p``: drawn as :class:`Dropout` draws its masks
    (``bernoulli_`` on the ``generator``), on an f32 tensor.  Inside
    ``parallel.batch_shard`` it is the global batch's mask, this rank's
    rows."""
    shard = current_batch_shard()
    rows = shape[0] if shard is None else shard.rows
    keep = torch.empty((rows,) + tuple(shape[1:]), dtype=torch.float32,
                       device=device).bernoulli_(1.0 - p, generator=generator)
    if shard is not None:
        keep = keep[shard.offset:shard.offset + shape[0]]
    return keep > 0


class Table(nn.Module):
    """A learned table ``weight [*shape]`` (an embedding, or the edge
    encoder's per-hop matrices), drawn N(0, 0.02), the public Graphormer's
    embedding init.  ``forward(idx)`` gathers rows in f32 (so the
    backward sums each row's gradient in f32) and returns them in the
    table's dtype."""

    def __init__(self, *shape: int, std: float = 0.02):
        super().__init__()
        self.std = float(std)
        self.weight = nn.Parameter(torch.empty(*shape))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight.float()).to(self.weight.dtype)


class StructuralBias(nn.Module):
    """The Graphormer's attention bias (Ying et al. 2021, Eq. 6-7; the
    public code's ``GraphAttnBias``), ``[B, H, n + 1, n + 1]`` in f32 from
    ``spd [B, n, n]`` and ``path_types [B, n, n, hops]``:

    - ``spatial[spd]``, one value per head for each distance (a table of
      ``num_spatial``; -1, unreachable or padding, takes the last row);
    - plus the edge encoding ``c = (1/L) sum_{m<L} edge_type[t_m] @
      edge_hop[m]`` over the first ``L = min(spd, hops)`` bond types ``t_m``
      of the pair's path (type 0 is padding and embeds to zero);
    - the graph token's row and column take ``virtual_distance``.

    ``edge_type[t] @ edge_hop[m]`` depends on ``(m, t)`` alone, so it is
    formed once as a ``[hops, 5, H]`` table and gathered per hop."""

    def __init__(self, heads: int, hops: int = MAX_HOPS,
                 num_spatial: int = 512,
                 bond_types: int = 4):
        super().__init__()
        self.heads, self.hops = heads, hops
        self.spatial = Table(num_spatial, heads)
        self.virtual_distance = Table(1, heads)
        self.edge_type = Table(bond_types, heads)
        self.edge_hop = Table(hops, heads, heads)

    def forward(self, spd: torch.Tensor,
                path_types: torch.Tensor) -> torch.Tensor:
        b, n = spd.shape[0], spd.shape[1]
        h = self.heads
        spatial = self.spatial.weight.float()
        d = spd.long()
        idx = torch.where(d < 0, spatial.shape[0] - 1,
                          d.clamp_max(spatial.shape[0] - 2))
        inner = F.embedding(idx, spatial)                       # [B,n,n,H]
        emb = torch.cat([spatial.new_zeros(1, h),
                         self.edge_type.weight.float()])        # [5, H]
        table = torch.einsum("th,mhk->mtk", emb,
                             self.edge_hop.weight.float())      # [hops,5,H]
        types = path_types.long()
        edge = F.embedding(types[..., 0], table[0])
        for m in range(1, self.hops):
            edge = edge + F.embedding(types[..., m], table[m])
        hops = d.clamp(1, self.hops).unsqueeze(-1).to(edge.dtype)
        inner = inner + edge / hops
        t = self.virtual_distance.weight.float().reshape(1, 1, 1, h)
        body = torch.cat([t.expand(b, n, 1, h), inner], dim=2)
        full = torch.cat([t.expand(b, 1, n + 1, h), body], dim=1)
        return full.permute(0, 3, 1, 2).contiguous()


class GraphormerLayer(nn.Module):
    """One pre-LN Graphormer layer (Ying et al. 2021, Eq. 8-9)::

        x' = MHA(LN(x), bias) + x
        x  = fc2(dropout(GELU(fc1(LN(x'))))) + x'

    ``MHA``: per-head ``q k^T / sqrt(d) + bias``, keys outside
    ``key_mask`` at -inf, dropout ``attention_dropout`` on the
    probabilities (``ops/biased_attention.py``), then ``out_proj``.  In
    training the attention's keep-mask is drawn before the FFN's."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 attention_dropout: float = 0.1, dropout: float = 0.1):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} is not a multiple of {heads} "
                             "heads")
        self.heads = heads
        self.attention_dropout = float(attention_dropout)
        self.dropout = float(dropout)
        self.attn_norm = nn.LayerNorm(dim)
        self.q_proj = TorchLinear(dim, dim)
        self.k_proj = TorchLinear(dim, dim)
        self.v_proj = TorchLinear(dim, dim)
        self.out_proj = TorchLinear(dim, dim)
        self.ffn_norm = nn.LayerNorm(dim)
        self.fc1 = TorchLinear(dim, ffn_dim)
        self.fc2 = TorchLinear(ffn_dim, dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                key_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        y = self.attn_norm(x)
        q, k, v = (proj(y).view(b, n, h, d // h).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        keep, p = None, self.attention_dropout
        if self.training and p > 0.0:
            keep = keep_mask((b, h, n, n), p, generator, x.device)
        o = biased_attention(q, k, v, bias, key_mask, keep, p)
        x = x + self.out_proj(o.transpose(1, 2).reshape(b, n, d))
        y = F.gelu(self.fc1(self.ffn_norm(x)))
        if self.training and self.dropout > 0.0:
            keep = keep_mask(y.shape, self.dropout, generator, x.device)
            y = y * keep.to(y.dtype) / (1.0 - self.dropout)
        return x + self.fc2(y)


class CombinedNet(nn.Module):
    """Fusion head (reference ``train.py:149-160``): FC -> ReLU ->
    dropout(0.3) -> FC."""

    def __init__(self, in_features: int, hidden_dim: int,
                 output_dim: int = 1, dropout: float = 0.3):
        super().__init__()
        self.fc1 = TorchLinear(in_features, hidden_dim)
        self.dropout = Dropout(dropout)
        self.fc2 = TorchLinear(hidden_dim, output_dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc2(self.dropout(F.relu(self.fc1(x)), generator))


_OWN_PARAMETERS = (TorchLinear, TorchConv1d, CenterTapConv1d, GlorotLinear,
                   GCNConv, GATConv, MaskedBatchNorm, Table)


def reset_parameters(model: nn.Module,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw every parameter of ``model`` from ``generator``, in module
    order (the seed fixes the weights), and reset the batch norms' running
    statistics.  Each layer's ``reset_parameters`` sets the parameters it
    holds itself, not those of its submodules."""
    for m in model.modules():
        if isinstance(m, _OWN_PARAMETERS):
            m.reset_parameters(generator)
    return model
