"""Plain-PyTorch oracles for the six baseline GNNs (the port's copy of
``mgat_graphsage_tpu/compare/torch_ref_gnn.py``).

Extends ``torch_ref.py`` (the flagship-hybrid oracle) to the baseline zoo:
weight-for-weight reimplementations of the reference's exact math in the
reference's exact flat data layout —

- ``SAGENet``   (reference ``gnn/graphsage.py:50-75``)
- ``GATNet``    (reference ``gnn/gat.py:51-71``)
- ``GCNNet``    (reference ``gnn/gcn.py:42-66``)
- ``GAT_GCN``   (reference ``gnn/gat-gcn.py:53-76``)
- ``GINConvNet``(reference ``gnn/gin.py:56-106``)
- ``ChebNet``   (reference ``gnn/chebnet.py:50-96``)

The PyG convs the reference imports (``GCNConv``/``GATConv``/``GINConv``/
``global_*_pool``) are reproduced with plain torch index_add/scatter ops
following PyG's documented semantics (self-loop handling, symmetric
normalization, edge-softmax attention, post-aggregation bias).  Their
``state_dict``s are the reference's bare baseline checkpoints
(``compat.py::import_baseline_checkpoint``).  Every tensor they make lives
on their input's device.  Weights come from the port through the
flax-shaped numpy trees of ``models/convert.py`` (``params_to_jax``,
``batch_stats_to_jax``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from .torch_ref import TorchSAGEConv, global_max_pool

__all__ = [
    "TorchGCNConv", "TorchGATConv", "TorchGINConv", "TorchChebConvRef",
    "TorchSAGENet", "TorchGATNet", "TorchGCNNet", "TorchGATGCN",
    "TorchGINNet", "TorchChebNet", "load_baseline_params",
    "BASELINE_ORACLES",
]


def global_mean_pool(x: torch.Tensor, batch: torch.Tensor,
                     num_graphs: int) -> torch.Tensor:
    s = torch.zeros((num_graphs, x.size(1)), dtype=x.dtype,
                    device=x.device).index_add_(0, batch, x)
    cnt = torch.zeros(num_graphs, dtype=x.dtype, device=x.device).index_add_(
        0, batch, torch.ones_like(batch, dtype=x.dtype))
    return s / cnt.clamp(min=1.0).unsqueeze(-1)


def global_add_pool(x: torch.Tensor, batch: torch.Tensor,
                    num_graphs: int) -> torch.Tensor:
    return torch.zeros((num_graphs, x.size(1)), dtype=x.dtype,
                       device=x.device).index_add_(0, batch, x)


def _add_self_loops(edge_index: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    loops = torch.arange(num_nodes, dtype=edge_index.dtype,
                         device=edge_index.device)
    return torch.cat([edge_index, torch.stack([loops, loops])], dim=1)


class TorchGCNConv(nn.Module):
    """PyG ``GCNConv`` semantics: D^-1/2 (A+I) D^-1/2 (x W) + b, with the
    bias added AFTER aggregation (as PyG does)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.lin = nn.Linear(in_features, out_features, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
        n = x.size(0)
        ei = _add_self_loops(edge_index, n)
        src, dst = ei[0], ei[1]
        deg = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
            0, dst, torch.ones_like(dst, dtype=x.dtype))
        dinv = deg.clamp(min=1e-12).rsqrt()
        norm = dinv[dst] * dinv[src]
        h = self.lin(x)
        out = torch.zeros_like(h).index_add_(0, dst,
                                             h[src] * norm.unsqueeze(-1))
        return out + self.bias


class TorchGATConv(nn.Module):
    """PyG ``GATConv`` semantics: multi-head edge-softmax attention with
    self-loops; out_i = concat_h sum_{j in N(i)+{i}} alpha_ij (W x_j) + b."""

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 negative_slope: float = 0.2):
        super().__init__()
        self.heads = heads
        self.out_features = out_features
        self.lin = nn.Linear(in_features, heads * out_features, bias=False)
        self.att_src = nn.Parameter(torch.zeros(1, heads, out_features))
        self.att_dst = nn.Parameter(torch.zeros(1, heads, out_features))
        self.bias = nn.Parameter(torch.zeros(heads * out_features))
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
        n, h, c = x.size(0), self.heads, self.out_features
        wx = self.lin(x).view(n, h, c)
        a_src = (wx * self.att_src).sum(-1)          # [N, H]
        a_dst = (wx * self.att_dst).sum(-1)
        ei = _add_self_loops(edge_index, n)
        src, dst = ei[0], ei[1]
        logits = F.leaky_relu(a_dst[dst] + a_src[src],
                              self.negative_slope)   # [E, H]
        # numerically-stable per-destination softmax over incoming edges
        lmax = torch.full((n, h), float("-inf"),
                          device=x.device).scatter_reduce(
            0, dst.unsqueeze(-1).expand_as(logits), logits,
            reduce="amax", include_self=True)
        expd = torch.exp(logits - lmax[dst])
        denom = torch.zeros(n, h, dtype=x.dtype,
                            device=x.device).index_add_(0, dst, expd)
        alpha = expd / denom.clamp(min=1e-16)[dst]   # [E, H]
        msg = wx[src] * alpha.unsqueeze(-1)          # [E, H, C]
        out = torch.zeros(n, h, c, dtype=x.dtype,
                          device=x.device).index_add_(0, dst, msg)
        return out.reshape(n, h * c) + self.bias


class TorchGINConv(nn.Module):
    """PyG ``GINConv`` semantics with eps=0 fixed:
    mlp((1+eps) x + sum_{j in N(i)} x_j)."""

    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(in_features, dim), nn.ReLU(),
                                 nn.Linear(dim, dim))

    def forward(self, x: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
        src, dst = edge_index[0], edge_index[1]
        agg = torch.zeros_like(x).index_add_(0, dst, x[src])
        return self.mlp(x + agg)


class TorchChebConvRef(nn.Module):
    """The reference's hand-rolled "Chebyshev" conv with its nonstandard
    pseudo-Laplacian L = -(A + D) (``gnn/chebnet.py:50-73``)."""

    def __init__(self, in_features: int, out_features: int, k: int = 3):
        super().__init__()
        self.k = k
        self.lin = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
        n = x.size(0)
        lap = torch.zeros(n, n, dtype=x.dtype, device=x.device)
        lap[edge_index[0], edge_index[1]] = -1.0
        lap = lap + torch.diag(lap.sum(1))
        t_k = [torch.eye(n, dtype=x.dtype, device=x.device), lap]
        for k in range(2, self.k):
            t_k.append(2 * lap @ t_k[k - 1] - t_k[k - 2])
        out = t_k[0] @ x
        for k in range(1, self.k):
            out = out + t_k[k] @ x
        return self.lin(out)


# ---------------------------------------------------------------------------
# Assembled baseline models (flat layout, eval-mode parity targets)
# ---------------------------------------------------------------------------


class TorchSAGENet(nn.Module):
    """Reference ``gnn/graphsage.py:50-75``."""

    def __init__(self, features: int = 35, output_dim: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.sage1 = TorchSAGEConv(features, features)
        self.sage2 = TorchSAGEConv(features, output_dim)
        self.fc_g1 = nn.Linear(output_dim, output_dim)
        self.fc_g2 = nn.Linear(output_dim, output_dim)
        self.out = nn.Linear(output_dim, 1)
        self.p = dropout

    def forward(self, x, edge_index, batch, num_graphs):
        x = F.dropout(x, p=self.p, training=self.training)
        x = F.relu(self.sage1(x, edge_index))
        x = F.dropout(x, p=self.p, training=self.training)
        x = self.sage2(x, edge_index)          # NO relu before pool
        x = global_max_pool(x, batch, num_graphs)
        x = F.relu(self.fc_g1(x))
        x = F.dropout(x, p=self.p, training=self.training)
        x = F.relu(self.fc_g2(x))
        return self.out(x)


class TorchGATNet(nn.Module):
    """Reference ``gnn/gat.py:51-71``."""

    def __init__(self, features: int = 35, output_dim: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.gcn1 = TorchGATConv(features, features, heads=10)
        self.gcn2 = TorchGATConv(features * 10, output_dim, heads=1)
        self.fc_g1 = nn.Linear(output_dim, output_dim)
        self.out = nn.Linear(output_dim, 1)
        self.p = dropout

    def forward(self, x, edge_index, batch, num_graphs):
        x = F.dropout(x, p=self.p, training=self.training)
        x = F.elu(self.gcn1(x, edge_index))
        x = F.dropout(x, p=self.p, training=self.training)
        x = F.relu(self.gcn2(x, edge_index))
        x = global_max_pool(x, batch, num_graphs)
        x = F.relu(self.fc_g1(x))
        return self.out(x)


class TorchGCNNet(nn.Module):
    """Reference ``gnn/gcn.py:42-66``."""

    def __init__(self, features: int = 5, dropout: float = 0.1):
        super().__init__()
        self.conv1 = TorchGCNConv(features, features)
        self.conv2 = TorchGCNConv(features, features * 2)
        self.conv3 = TorchGCNConv(features * 2, features * 4)
        self.fc_g1 = nn.Linear(features * 4, 1024)
        self.fc_g2 = nn.Linear(1024, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, edge_index, batch, num_graphs):
        x = F.relu(self.conv1(x, edge_index))
        x = F.relu(self.conv2(x, edge_index))
        x = F.relu(self.conv3(x, edge_index))
        x = global_max_pool(x, batch, num_graphs)
        x = F.relu(self.fc_g1(x))
        x = self.dropout(x)
        return self.fc_g2(x)


class TorchGATGCN(nn.Module):
    """Reference ``gnn/gat-gcn.py:53-76``."""

    def __init__(self, features: int = 35, output_dim: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.conv1 = TorchGATConv(features, features, heads=10)
        self.conv2 = TorchGCNConv(features * 10, features * 10)
        self.fc_g1 = nn.Linear(features * 10 * 2, 1500)
        self.fc_g2 = nn.Linear(1500, output_dim)
        self.out = nn.Linear(output_dim, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, edge_index, batch, num_graphs):
        x = F.relu(self.conv1(x, edge_index))
        x = F.relu(self.conv2(x, edge_index))
        x = torch.cat([global_max_pool(x, batch, num_graphs),
                       global_mean_pool(x, batch, num_graphs)], dim=1)
        x = F.relu(self.fc_g1(x))
        x = self.dropout(x)
        x = self.fc_g2(x)
        return self.out(x)


class TorchGINNet(nn.Module):
    """Reference ``gnn/gin.py:56-106``: 5x (GINConv -> ReLU -> BatchNorm),
    add-pool, FC 32->128->1024->256->1."""

    def __init__(self, features: int = 35, dim: int = 32,
                 dropout: float = 0.2):
        super().__init__()
        self.convs = nn.ModuleList(
            [TorchGINConv(features if i == 0 else dim, dim)
             for i in range(5)])
        self.bns = nn.ModuleList([nn.BatchNorm1d(dim) for _ in range(5)])
        self.fc1_xd = nn.Linear(dim, 128)
        self.fc1 = nn.Linear(128, 1024)
        self.fc2 = nn.Linear(1024, 256)
        self.out = nn.Linear(256, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, edge_index, batch, num_graphs):
        for conv, bn in zip(self.convs, self.bns):
            x = bn(F.relu(conv(x, edge_index)))
        x = global_add_pool(x, batch, num_graphs)
        x = self.dropout(F.relu(self.fc1_xd(x)))
        x = self.dropout(F.relu(self.fc1(x)))
        x = F.relu(self.fc2(x))
        return self.out(x)


class TorchChebNet(nn.Module):
    """Reference ``gnn/chebnet.py:75-96``."""

    def __init__(self, features: int = 35, output_dim: int = 128,
                 k: int = 3, dropout: float = 0.2):
        super().__init__()
        self.conv1 = TorchChebConvRef(features, 16, k)
        self.conv2 = TorchChebConvRef(16, output_dim, k)
        self.fc_g1 = nn.Linear(output_dim, output_dim)
        self.out = nn.Linear(output_dim, 1)
        self.p = dropout

    def forward(self, x, edge_index, batch, num_graphs):
        x = F.dropout(x, p=self.p, training=self.training)
        x = F.elu(self.conv1(x, edge_index))
        x = F.dropout(x, p=self.p, training=self.training)
        x = F.relu(self.conv2(x, edge_index))
        x = global_max_pool(x, batch, num_graphs)
        x = F.relu(self.fc_g1(x))
        return self.out(x)


# ---------------------------------------------------------------------------
# port -> oracle weight transfer
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _copy_linear(dst: nn.Linear, p: Dict) -> None:
    with torch.no_grad():
        dst.weight.copy_(_t(p["kernel"]).T)
        if dst.bias is not None and "bias" in p:
            dst.bias.copy_(_t(p["bias"]))


def _copy_sage(dst: TorchSAGEConv, p: Dict) -> None:
    _copy_linear(dst.lin_l, p["lin_l"])
    _copy_linear(dst.lin_r, p["lin_r"])


def _copy_gcn(dst: TorchGCNConv, p: Dict) -> None:
    _copy_linear(dst.lin, p["lin"])
    with torch.no_grad():
        dst.bias.copy_(_t(p["bias"]))


def _copy_gat(dst: TorchGATConv, p: Dict) -> None:
    _copy_linear(dst.lin, p["lin"])
    with torch.no_grad():
        dst.att_src.copy_(_t(p["att_src"]))
        dst.att_dst.copy_(_t(p["att_dst"]))
        dst.bias.copy_(_t(p["bias"]))


def _copy_gin(dst: TorchGINConv, p: Dict) -> None:
    _copy_linear(dst.mlp[0], p["mlp_0"])
    _copy_linear(dst.mlp[2], p["mlp_1"])


def _copy_cheb(dst: TorchChebConvRef, p: Dict) -> None:
    _copy_linear(dst.lin, p["lin"])


def load_baseline_params(name: str, params: Dict, batch_stats: Dict,
                         model: nn.Module) -> None:
    """Copy a baseline's flax-shaped numpy trees (``models/convert.py::
    params_to_jax`` and ``batch_stats_to_jax`` of the port's model) into
    the torch oracle."""
    if name == "sage":
        _copy_sage(model.sage1, params["sage1"])
        _copy_sage(model.sage2, params["sage2"])
        _copy_linear(model.fc_g1, params["fc_g1"])
        _copy_linear(model.fc_g2, params["fc_g2"])
        _copy_linear(model.out, params["out"])
    elif name == "gat":
        _copy_gat(model.gcn1, params["gcn1"])
        _copy_gat(model.gcn2, params["gcn2"])
        _copy_linear(model.fc_g1, params["fc_g1"])
        _copy_linear(model.out, params["out"])
    elif name == "gcn":
        _copy_gcn(model.conv1, params["conv1"])
        _copy_gcn(model.conv2, params["conv2"])
        _copy_gcn(model.conv3, params["conv3"])
        _copy_linear(model.fc_g1, params["fc_g1"])
        _copy_linear(model.fc_g2, params["fc_g2"])
    elif name == "gat_gcn":
        _copy_gat(model.conv1, params["conv1"])
        _copy_gcn(model.conv2, params["conv2"])
        _copy_linear(model.fc_g1, params["fc_g1"])
        _copy_linear(model.fc_g2, params["fc_g2"])
        _copy_linear(model.out, params["out"])
    elif name == "gin":
        with torch.no_grad():
            for i in range(5):
                _copy_gin(model.convs[i], params[f"conv{i + 1}"])
                bn, p = model.bns[i], params[f"bn{i + 1}"]
                bn.weight.copy_(_t(p["scale"]))
                bn.bias.copy_(_t(p["bias"]))
                bs = batch_stats[f"bn{i + 1}"]
                bn.running_mean.copy_(_t(bs["mean"]))
                bn.running_var.copy_(_t(bs["var"]))
        _copy_linear(model.fc1_xd, params["fc1_xd"])
        _copy_linear(model.fc1, params["fc1"])
        _copy_linear(model.fc2, params["fc2"])
        _copy_linear(model.out, params["out"])
    elif name == "cheb":
        _copy_cheb(model.conv1, params["conv1"])
        _copy_cheb(model.conv2, params["conv2"])
        _copy_linear(model.fc_g1, params["fc_g1"])
        _copy_linear(model.out, params["out"])
    else:
        raise ValueError(name)


# model key (TrainConfig.model) -> oracle constructor
BASELINE_ORACLES = {
    "sage": TorchSAGENet,
    "gat": TorchGATNet,
    "gcn": TorchGCNNet,
    "gat_gcn": TorchGATGCN,
    "gin": TorchGINNet,
    "cheb": TorchChebNet,
}
