"""The flagship hybrid and its graph branch (port of
``mgat_graphsage_tpu/models/zoo.py:38-145``).

Input convention: ``(nodes [B, N, F], adj [B, N, N], node_mask [B, N])``,
plus ``fp [B, nbits]`` for the hybrid.  Module names mirror the flax
parameter tree, so ``state_dict`` keys read like its paths
(``gat_graphsage.conv1.query_transform.weight`` for
``gat_graphsage/conv1/query_transform/kernel``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment_max_pool, segment_mean_pool
from .layers import (
    CNNNet,
    CombinedNet,
    Dropout,
    ModifiedGATLayer,
    SAGEConv,
    TorchLinear,
)

__all__ = ["GATGraphSAGE", "HybridModel", "kl_loss", "build_model"]


def kl_loss(latent: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(N(mu, sigma^2) || N(0, 1)) over the batch-latent distribution
    (reference ``train.py:70-74``): mean/var per latent dim across the
    batch, summed over dims; var is the unbiased variance."""
    if sample_mask is not None:
        w = sample_mask.unsqueeze(1)
        cnt = torch.clamp_min(w.sum(), 1.0)
        mean = (latent * w).sum(0) / cnt
        var = (((latent - mean) ** 2) * w).sum(0) / torch.clamp_min(
            cnt - 1.0, 1.0)
    else:
        mean = latent.mean(0)
        var = latent.var(0, unbiased=True)
    return -0.5 * torch.sum(1.0 + torch.log(var + 1e-10) - mean ** 2 - var)


class GATGraphSAGE(nn.Module):
    """Graph branch: ModifiedGAT -> ReLU -> SAGEConv -> ReLU -> masked max
    pool (or cat(max, mean)) -> FC -> ReLU -> dropout -> FC -> FC.

    Only ``attention="modified"`` is ported; ``"gat10"`` (the model1
    ablation) raises ``NotImplementedError``.
    """

    def __init__(self, in_features: int = 35, attention: str = "modified",
                 residual: bool = True, flat_attention: bool = False,
                 dual_pool: bool = False, sage_features: int = 35,
                 fc_hidden: int = 1500, output_dim: int = 128,
                 n_output: int = 1, dropout: float = 0.3):
        super().__init__()
        if attention == "gat10":
            raise NotImplementedError(
                "attention='gat10' (GATConv) is not ported yet")
        if attention != "modified":
            raise ValueError(attention)
        self.dual_pool = dual_pool
        self.conv1 = ModifiedGATLayer(in_features, in_features,
                                      residual=residual, flat=flat_attention)
        self.conv2 = SAGEConv(in_features, sage_features)
        pooled = sage_features * (2 if dual_pool else 1)
        self.fc_g1 = TorchLinear(pooled, fc_hidden)
        self.dropout = Dropout(dropout)
        self.fc_g2 = TorchLinear(fc_hidden, output_dim)
        self.out = TorchLinear(output_dim, n_output)

    def forward(self, nodes: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.conv1(nodes, node_mask))
        x = F.relu(self.conv2(x, adj, node_mask))
        if self.dual_pool:
            pooled = torch.cat([segment_max_pool(x, node_mask),
                                segment_mean_pool(x, node_mask)], dim=-1)
        else:
            pooled = segment_max_pool(x, node_mask)
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


def build_model(cfg) -> nn.Module:
    """``TrainConfig`` -> module, for the configurations ported so far
    (``hybrid`` and ``gat_graphsage`` with modified attention)."""
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
    raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
