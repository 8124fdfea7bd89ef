"""Plain-PyTorch reimplementation of the reference flagship model (the
port's copy of ``mgat_graphsage_tpu/compare/torch_ref.py``).

The reference's exact math (``train.py:77-160``) in the reference's exact
*flat* data layout (concatenated nodes + batch segment vector, PyG-style),
written with plain torch ops (torch_geometric's SAGEConv and
global_max_pool semantics are reproduced with index_add and segment
reductions).  It is the numeric oracle that the port's padded-dense path
is held to, and the twin whose ``state_dict``s are the reference's
checkpoint format (``compat.py``).  Unlike the reference package's copy it
runs on any device: every tensor it makes lives on its input's device.

Weights come from the port through the flax-shaped numpy tree of
``models/convert.py::params_to_jax`` (:func:`load_params_into_torch`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import cnn_fc1_pos_major_to_torch

__all__ = [
    "TorchModifiedGATLayer", "TorchSAGEConv", "TorchGraphBranch",
    "TorchCNNNet", "TorchCombinedNet", "TorchHybrid", "flat_batch",
    "load_params_into_torch",
]


class TorchModifiedGATLayer(nn.Module):
    """Reference ``train.py:77-99`` math on a flat [N, F] node matrix."""

    def __init__(self, features: int, residual: bool = True):
        super().__init__()
        self.query_transform = nn.Linear(features, features)
        self.key_transform = nn.Linear(features, features)
        self.value_transform = nn.Linear(features, features)
        self.conv3 = nn.Conv1d(features, features, 3, padding=1)
        self.conv5 = nn.Conv1d(features, features, 5, padding=2)
        self.linear_transform = nn.Linear(features * 3, features)
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.query_transform(x)
        k = self.key_transform(x)
        v = self.value_transform(x)
        ku = k.unsqueeze(2)                       # [N, F, 1]
        k3 = self.conv3(ku)
        k5 = self.conv5(ku)
        kc = torch.cat((k3, k5, ku), dim=1)       # [N, 3F, 1]
        k_new = self.linear_transform(kc.transpose(1, 2))  # [N, 1, F]
        scores = torch.matmul(q, k_new.transpose(1, 2)) / math.sqrt(
            k_new.size(-1))
        attn = F.softmax(scores.squeeze(-1), dim=-1)       # [N, N]
        out = torch.matmul(attn, v)
        if self.residual:
            out = out + v
        return out


class TorchSAGEConv(nn.Module):
    """PyG ``SAGEConv`` semantics (mean aggregation) with plain torch:
    out = lin_l(mean_{j in N(i)} x_j) + lin_r(x_i)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.lin_l = nn.Linear(in_features, out_features)
        self.lin_r = nn.Linear(in_features, out_features, bias=False)

    def forward(self, x: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
        src, dst = edge_index[0], edge_index[1]
        agg = torch.zeros_like(x).index_add_(0, dst, x[src])
        deg = torch.zeros(x.size(0), dtype=x.dtype,
                          device=x.device).index_add_(
            0, dst, torch.ones_like(src, dtype=x.dtype))
        agg = agg / deg.clamp(min=1.0).unsqueeze(-1)
        return self.lin_l(agg) + self.lin_r(x)


def global_max_pool(x: torch.Tensor, batch: torch.Tensor,
                    num_graphs: int) -> torch.Tensor:
    out = torch.full((num_graphs, x.size(1)), float("-inf"), dtype=x.dtype,
                     device=x.device)
    out = out.scatter_reduce(0, batch.unsqueeze(-1).expand_as(x), x,
                             reduce="amax", include_self=True)
    return torch.where(torch.isinf(out), torch.zeros_like(out), out)


class TorchGraphBranch(nn.Module):
    """Reference ``GAT_GraphSAGE`` (``train.py:102-124``)."""

    def __init__(self, features: int = 35, output_dim: int = 128,
                 dropout: float = 0.3):
        super().__init__()
        self.conv1 = TorchModifiedGATLayer(features)
        self.conv2 = TorchSAGEConv(features, features)
        self.fc_g1 = nn.Linear(features, 1500)
        self.fc_g2 = nn.Linear(1500, output_dim)
        self.out = nn.Linear(output_dim, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, edge_index, batch, num_graphs):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x, edge_index))
        x = global_max_pool(x, batch, num_graphs)
        x = F.relu(self.fc_g1(x))
        x = self.dropout(x)
        x = self.fc_g2(x)
        return self.out(x)


class TorchCNNNet(nn.Module):
    """Reference ``CNNNet`` (``train.py:127-146``)."""

    def __init__(self, input_dim: int = 1024, output_dim: int = 1024,
                 fc_hidden: int = 256, dropout: float = 0.3):
        super().__init__()
        self.conv1 = nn.Conv1d(1, 32, 3, padding="same")
        self.conv2 = nn.Conv1d(32, 64, 3, padding="same")
        self.conv3 = nn.Conv1d(64, 128, 3, padding="same")
        self.fc1 = nn.Linear(128 * input_dim, fc_hidden)
        self.fc2 = nn.Linear(fc_hidden, output_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, fp):
        x = fp.unsqueeze(1)                       # [B, 1, nbits]
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = x.view(x.size(0), -1)
        x = self.dropout(F.relu(self.fc1(x)))
        return self.fc2(x)


class TorchCombinedNet(nn.Module):
    """Reference ``CombinedNet`` (``train.py:149-160``)."""

    def __init__(self, input_dim: int = 1025, hidden: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, hidden)
        self.fc2 = nn.Linear(hidden, 1)
        self.dropout = nn.Dropout(0.3)

    def forward(self, x):
        return self.fc2(self.dropout(F.relu(self.fc1(x))))


class TorchHybrid(nn.Module):
    """The three reference models jointly, flat layout."""

    def __init__(self, features: int = 35, fp_dim: int = 1024,
                 cnn_fc_hidden: int = 256, cnn_out: int = 0):
        # cnn_fc_hidden/cnn_out cover the fingerprint-suite width variants
        # (ecfp=2024.py:125-126 widens fc1 to 512); 0 means output == input
        super().__init__()
        cnn_out = cnn_out or fp_dim
        self.graph = TorchGraphBranch(features)
        self.cnn = TorchCNNNet(fp_dim, cnn_out, fc_hidden=cnn_fc_hidden)
        self.combined = TorchCombinedNet(1 + cnn_out)

    def forward(self, x, edge_index, batch, num_graphs, fp):
        g = self.graph(x, edge_index, batch, num_graphs)
        c = self.cnn(fp)
        latent = torch.cat((g, c), dim=1)
        return self.combined(latent), latent


def flat_batch(graphs: List[Tuple[np.ndarray, np.ndarray]],
               fps: List[np.ndarray]):
    """Concatenate per-molecule (features, edge_index) into the reference's
    flat layout: x [N_total, F], edge_index [2, E_total] (offset), batch
    segment vector, fp [B, nbits]."""
    xs, eis, batch = [], [], []
    offset = 0
    for i, (feats, ei) in enumerate(graphs):
        xs.append(torch.tensor(feats))
        eis.append(torch.tensor(ei.astype(np.int64)) + offset)
        batch.append(torch.full((feats.shape[0],), i, dtype=torch.long))
        offset += feats.shape[0]
    x = torch.cat(xs)
    edge_index = torch.cat(eis, dim=1)
    batch_vec = torch.cat(batch)
    fp = torch.tensor(np.concatenate(fps, axis=0))
    return x, edge_index, batch_vec, len(graphs), fp


# ---------------------------------------------------------------------------
# port -> oracle weight transfer
# ---------------------------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def load_params_into_torch(params: Dict, model: TorchHybrid) -> None:
    """Copy a hybrid's flax-shaped numpy tree (``models/convert.py::
    params_to_jax`` of the port's model) into the torch reference
    model."""
    g = params["gat_graphsage"]
    mg = g["conv1"]
    tl = model.graph.conv1
    with torch.no_grad():
        for name in ("query_transform", "key_transform", "value_transform",
                     "linear_transform"):
            getattr(tl, name).weight.copy_(_t(mg[name]["kernel"]).T)
            getattr(tl, name).bias.copy_(_t(mg[name]["bias"]))
        for cname in ("conv3", "conv5"):
            getattr(tl, cname).weight.copy_(_t(mg[cname]["weight"]))
            getattr(tl, cname).bias.copy_(_t(mg[cname]["bias"]))
        model.graph.conv2.lin_l.weight.copy_(_t(g["conv2"]["lin_l"]["kernel"]).T)
        model.graph.conv2.lin_l.bias.copy_(_t(g["conv2"]["lin_l"]["bias"]))
        model.graph.conv2.lin_r.weight.copy_(_t(g["conv2"]["lin_r"]["kernel"]).T)
        for src, dst in (("fc_g1", model.graph.fc_g1),
                         ("fc_g2", model.graph.fc_g2),
                         ("out", model.graph.out)):
            dst.weight.copy_(_t(g[src]["kernel"]).T)
            dst.bias.copy_(_t(g[src]["bias"]))
        cnn = params["cnn"]
        for i in (1, 2, 3):
            # flax nn.Conv kernel [k, in, out] -> torch [out, in, k]
            k = _t(cnn[f"conv{i}"]["kernel"]).permute(2, 1, 0)
            getattr(model.cnn, f"conv{i}").weight.copy_(k)
            getattr(model.cnn, f"conv{i}").bias.copy_(_t(cnn[f"conv{i}"]["bias"]))
        # CNNNet stores fc1 rows pos-major (w*128 + c); torch's flatten
        # is channel-major (c*W + w) — permute back for the torch twin
        # (models/layers.py cnn_fc1_pos_major_to_torch).
        k1 = np.asarray(cnn_fc1_pos_major_to_torch(
            np.asarray(cnn["fc1"]["kernel"])))
        model.cnn.fc1.weight.copy_(_t(k1).T)
        model.cnn.fc1.bias.copy_(_t(cnn["fc1"]["bias"]))
        model.cnn.fc2.weight.copy_(_t(cnn["fc2"]["kernel"]).T)
        model.cnn.fc2.bias.copy_(_t(cnn["fc2"]["bias"]))
        comb = params["combined"]
        model.combined.fc1.weight.copy_(_t(comb["fc1"]["kernel"]).T)
        model.combined.fc1.bias.copy_(_t(comb["fc1"]["bias"]))
        model.combined.fc2.weight.copy_(_t(comb["fc2"]["kernel"]).T)
        model.combined.fc2.bias.copy_(_t(comb["fc2"]["bias"]))
