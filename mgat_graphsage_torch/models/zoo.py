"""The model zoo: the flagship hybrid, its graph branch with the ablation
ladder, and the six baselines GCN, GraphSAGE, GAT, GAT-GCN, GIN and
ChebNet (port of ``mgat_graphsage_tpu/models/zoo.py``).

Input convention: ``(nodes [B, N, F], adj [B, N, N], node_mask [B, N])``,
plus ``fp [B, nbits]`` for the hybrid, and ``generator`` (the dropout
masks' source in training) last.  Every model returns ``[B, 1]``
predictions; the hybrid its latent too.  Module names mirror the flax
parameter tree, so ``state_dict`` keys read like its paths
(``gat_graphsage.conv1.query_transform.weight`` for
``gat_graphsage/conv1/query_transform/kernel``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment_max_pool, segment_mean_pool, segment_sum_pool
from ..parallel.distributed import batch_sum, current_batch_shard
from .layers import (
    CNNNet,
    ChebConvRef,
    CombinedNet,
    Dropout,
    GATConv,
    GCNConv,
    GINConv,
    MaskedBatchNorm,
    ModifiedGATLayer,
    SAGEConv,
    TorchLinear,
)

__all__ = ["GATGraphSAGE", "HybridModel", "GCNNet", "SAGENet", "GATNet",
           "GATGCN", "GINConvNet", "ChebNet", "kl_loss", "build_model"]


def kl_loss(latent: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(N(mu, sigma^2) || N(0, 1)) over the batch-latent distribution
    (reference ``train.py:70-74``): mean/var per latent dim across the
    batch, summed over dims; var is the unbiased variance.  Inside
    ``parallel.batch_shard`` the masked sums are summed over the data
    axis: the mean and variance are the global batch's, on every rank."""
    shard = current_batch_shard()
    if shard is not None and sample_mask is None:
        sample_mask = latent.new_ones(latent.shape[0])
    if sample_mask is not None:
        w = sample_mask.unsqueeze(1)
        cnt = torch.clamp_min(batch_sum(w.sum(), shard), 1.0)
        mean = batch_sum((latent * w).sum(0), shard) / cnt
        var = batch_sum((((latent - mean) ** 2) * w).sum(0), shard) \
            / torch.clamp_min(cnt - 1.0, 1.0)
    else:
        mean = latent.mean(0)
        var = latent.var(0, unbiased=True)
    return -0.5 * torch.sum(1.0 + torch.log(var + 1e-10) - mean ** 2 - var)


def _dual_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    return torch.cat([segment_max_pool(x, node_mask),
                      segment_mean_pool(x, node_mask)], dim=-1)


class GATGraphSAGE(nn.Module):
    """Graph branch: attention -> ReLU -> SAGEConv -> ReLU -> masked max
    pool (or cat(max, mean)) -> FC -> ReLU -> dropout -> FC -> FC.

    ``attention="modified"`` is the M-GAT layer (the flagship and
    ``model2``-``model5``); ``"gat10"`` is a 10-head :class:`GATConv`
    concatenated to ``10 F`` (``model1``, reference ``ablation/model1.py``).
    """

    def __init__(self, in_features: int = 35, attention: str = "modified",
                 residual: bool = True, flat_attention: bool = False,
                 dual_pool: bool = False, sage_features: int = 35,
                 fc_hidden: int = 1500, output_dim: int = 128,
                 n_output: int = 1, dropout: float = 0.3):
        super().__init__()
        self.attention = attention
        self.dual_pool = dual_pool
        if attention == "modified":
            self.conv1 = ModifiedGATLayer(in_features, in_features,
                                          residual=residual,
                                          flat=flat_attention)
            conv1_out = in_features
        elif attention == "gat10":
            self.conv1 = GATConv(in_features, in_features, heads=10)
            conv1_out = 10 * in_features
        else:
            raise ValueError(f"unknown attention {attention!r}")
        self.conv2 = SAGEConv(conv1_out, sage_features)
        pooled = sage_features * (2 if dual_pool else 1)
        self.fc_g1 = TorchLinear(pooled, fc_hidden)
        self.dropout = Dropout(dropout)
        self.fc_g2 = TorchLinear(fc_hidden, output_dim)
        self.out = TorchLinear(output_dim, n_output)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.attention == "gat10":
            x = self.conv1(nodes, adj, node_mask, generator)
        else:
            x = self.conv1(nodes, node_mask)
        x = F.relu(self.conv2(F.relu(x), adj, node_mask))
        pooled = _dual_pool(x, node_mask) if self.dual_pool \
            else segment_max_pool(x, node_mask)
        h = self.dropout(F.relu(self.fc_g1(pooled)), generator)
        return self.out(self.fc_g2(h))


class HybridModel(nn.Module):
    """The flagship M-GAT-GraphSAGE hybrid (reference ``train.py:212-246``):
    graph branch + fingerprint CNN branch fused by CombinedNet.  Returns
    ``(prediction [B, 1], latent [B, 1 + fp_dim])``; the latent feeds the
    KL regulariser.  ``generator`` draws the dropout masks in training;
    ``cnn_pallas_bwd`` routes the CNN branch's backward through its
    kernels (:class:`CNNNet`)."""

    def __init__(self, in_features: int = 35, fp_dim: int = 1024,
                 cnn_fc_hidden: int = 256, combined_hidden: int = 512,
                 graph_dropout: float = 0.3, attention: str = "modified",
                 residual: bool = True, flat_attention: bool = False,
                 dual_pool: bool = False, cnn_pallas_bwd: bool = False):
        super().__init__()
        self.gat_graphsage = GATGraphSAGE(
            in_features, attention=attention, residual=residual,
            flat_attention=flat_attention, dual_pool=dual_pool,
            dropout=graph_dropout)
        self.cnn = CNNNet(input_dim=fp_dim, output_dim=fp_dim,
                          fc_hidden=cnn_fc_hidden, pallas_bwd=cnn_pallas_bwd)
        self.combined = CombinedNet(1 + fp_dim, combined_hidden, 1)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor, fp: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        graph_out = self.gat_graphsage(nodes, adj, node_mask, generator)
        latent = torch.cat([graph_out, self.cnn(fp, generator)], dim=-1)
        return self.combined(latent, generator), latent


class GCNNet(nn.Module):
    """GCN baseline (reference ``gnn/gcn.py:42-66``): GCNConv x3 (xd -> xd ->
    2 xd -> 4 xd), max pool, FC 4 xd -> 1024 -> 1, dropout 0.1.  Trained on
    the 5-dim featuriser (xd = 5)."""

    def __init__(self, num_features_xd: int = 5, dropout: float = 0.1):
        super().__init__()
        xd = num_features_xd
        self.conv1 = GCNConv(xd, xd)
        self.conv2 = GCNConv(xd, 2 * xd)
        self.conv3 = GCNConv(2 * xd, 4 * xd)
        self.fc_g1 = TorchLinear(4 * xd, 1024)
        self.dropout = Dropout(dropout)
        self.fc_g2 = TorchLinear(1024, 1)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = nodes
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x, adj, node_mask))
        x = F.relu(self.fc_g1(segment_max_pool(x, node_mask)))
        return self.fc_g2(self.dropout(x, generator))


class SAGENet(nn.Module):
    """GraphSAGE baseline (reference ``gnn/graphsage.py:50-75``): SAGEConv
    F -> F -> 128, max pool, FC 128 -> 128 -> 128 -> 1, dropout 0.2 on the
    input, between the convs and after the first FC."""

    def __init__(self, in_features: int = 35, dropout: float = 0.2):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.sage1 = SAGEConv(in_features, in_features)
        self.sage2 = SAGEConv(in_features, 128)
        self.fc_g1 = TorchLinear(128, 128)
        self.fc_g2 = TorchLinear(128, 128)
        self.out = TorchLinear(128, 1)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(nodes, generator)
        x = F.relu(self.sage1(x, adj, node_mask))
        x = self.sage2(self.dropout(x, generator), adj, node_mask)
        x = F.relu(self.fc_g1(segment_max_pool(x, node_mask)))
        x = F.relu(self.fc_g2(self.dropout(x, generator)))
        return self.out(x)


class GATNet(nn.Module):
    """Multi-head GAT baseline (reference ``gnn/gat.py:51-71``): GATConv
    F x 10 heads (concatenated) -> ELU -> GATConv 128 x 1 head -> ReLU, max
    pool, FC 128 -> 128 -> 1; dropout 0.2 on the input, between the convs
    and on both convs' attention coefficients."""

    def __init__(self, in_features: int = 35, dropout: float = 0.2):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.gcn1 = GATConv(in_features, in_features, heads=10,
                            dropout=dropout)
        self.gcn2 = GATConv(10 * in_features, 128, heads=1, dropout=dropout)
        self.fc_g1 = TorchLinear(128, 128)
        self.out = TorchLinear(128, 1)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(nodes, generator)
        x = F.elu(self.gcn1(x, adj, node_mask, generator))
        x = self.dropout(x, generator)
        x = F.relu(self.gcn2(x, adj, node_mask, generator))
        x = F.relu(self.fc_g1(segment_max_pool(x, node_mask)))
        return self.out(x)


class GATGCN(nn.Module):
    """GAT + GCN baseline (reference ``gnn/gat-gcn.py:53-76``): GATConv F x
    10 heads -> ReLU -> GCNConv 10 F -> 10 F -> ReLU, cat(max, mean) pool,
    FC 20 F -> 1500 -> dropout -> 128 -> 1."""

    def __init__(self, in_features: int = 35, dropout: float = 0.2):
        super().__init__()
        self.conv1 = GATConv(in_features, in_features, heads=10)
        self.conv2 = GCNConv(10 * in_features, 10 * in_features)
        self.fc_g1 = TorchLinear(20 * in_features, 1500)
        self.dropout = Dropout(dropout)
        self.fc_g2 = TorchLinear(1500, 128)
        self.out = TorchLinear(128, 1)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.conv1(nodes, adj, node_mask, generator))
        x = F.relu(self.conv2(x, adj, node_mask))
        h = F.relu(self.fc_g1(_dual_pool(x, node_mask)))
        return self.out(self.fc_g2(self.dropout(h, generator)))


class GINConvNet(nn.Module):
    """GIN baseline (reference ``gnn/gin.py:56-106``): 5 x (GINConv ->
    ReLU -> MaskedBatchNorm) at width 32, add pool, FC 32 -> 128 -> 1024 ->
    256 -> 1 with dropout 0.2 after the first two.  The batch norms leave
    padded nodes nonzero and the next conv's ``(1 + eps) x`` carries them;
    only the add pool masks them, as in the reference."""

    def __init__(self, in_features: int = 35, dropout: float = 0.2):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    GINConv(in_features if i == 0 else 32, 32))
            setattr(self, f"bn{i + 1}", MaskedBatchNorm(32))
        self.fc1_xd = TorchLinear(32, 128)
        self.dropout = Dropout(dropout)
        self.fc1 = TorchLinear(128, 1024)
        self.fc2 = TorchLinear(1024, 256)
        self.out = TorchLinear(256, 1)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = nodes
        for i in range(1, 6):
            x = F.relu(getattr(self, f"conv{i}")(x, adj, node_mask))
            x = getattr(self, f"bn{i}")(x, node_mask)
        x = F.relu(self.fc1_xd(segment_sum_pool(x, node_mask)))
        x = F.relu(self.fc1(self.dropout(x, generator)))
        x = F.relu(self.fc2(self.dropout(x, generator)))
        return self.out(x)


class ChebNet(nn.Module):
    """ChebNet baseline (reference ``gnn/chebnet.py:75-96``): ChebConvRef
    F -> 16 -> ELU -> 128 -> ReLU (K = 3, the reference's pseudo-Laplacian),
    max pool, FC 128 -> 128 -> 1; dropout 0.2 on the input and between the
    convs."""

    def __init__(self, in_features: int = 35, dropout: float = 0.2):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.conv1 = ChebConvRef(in_features, 16)
        self.conv2 = ChebConvRef(16, 128)
        self.fc_g1 = TorchLinear(128, 128)
        self.out = TorchLinear(128, 1)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(nodes, generator)
        x = F.elu(self.conv1(x, adj, node_mask))
        x = F.relu(self.conv2(self.dropout(x, generator), adj, node_mask))
        x = F.relu(self.fc_g1(segment_max_pool(x, node_mask)))
        return self.out(x)


def build_model(cfg) -> nn.Module:
    """``TrainConfig`` -> module, for every ``cfg.model`` of the reference
    package's registry (``mgat_graphsage_tpu/train/trainer.py::
    build_model``).  The node features are 5-dim under ``featurizer="5"``,
    else 35-dim."""
    from ..chem.fingerprints import FINGERPRINT_DIMS

    feat = 5 if cfg.featurizer == "5" else 35
    if cfg.model == "hybrid":
        return HybridModel(
            in_features=feat, fp_dim=FINGERPRINT_DIMS[cfg.fingerprint],
            cnn_fc_hidden=cfg.cnn_fc_hidden, attention=cfg.attention,
            residual=cfg.residual, flat_attention=cfg.flat_attention,
            dual_pool=cfg.dual_pool, graph_dropout=cfg.graph_dropout,
            cnn_pallas_bwd=cfg.cnn_pallas_bwd)
    if cfg.model == "gat_graphsage":
        return GATGraphSAGE(
            feat, attention=cfg.attention, residual=cfg.residual,
            flat_attention=cfg.flat_attention, dual_pool=cfg.dual_pool,
            sage_features=cfg.sage_features, dropout=cfg.graph_dropout)
    if cfg.model == "gcn":
        return GCNNet(num_features_xd=feat, dropout=cfg.graph_dropout)
    baselines = {"sage": SAGENet, "gat": GATNet, "gat_gcn": GATGCN,
                 "gin": GINConvNet, "cheb": ChebNet}
    if cfg.model not in baselines:
        raise ValueError(f"unknown model {cfg.model!r}")
    return baselines[cfg.model](feat, dropout=cfg.graph_dropout)
