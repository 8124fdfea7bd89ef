"""The model zoo: the flagship hybrid, its graph branch with the ablation
ladder, and the six baselines GCN, GraphSAGE, GAT, GAT-GCN, GIN and
ChebNet (port of ``mgat_graphsage_tpu/models/zoo.py``).

Input convention: ``(nodes [B, N, F], adj [B, N, N], node_mask [B, N])``,
plus ``fp [B, nbits]`` for the hybrid, and ``generator`` (the dropout
masks' source in training) last.  The graph transformers take others in
their place: :class:`GraphormerNet` ``(nodes, node_mask, degree, spd,
path_types)``, :class:`GPSNet` ``(nodes, node_mask, edges, edge_mask,
edge_types, rwse)``, :class:`EGTNet` ``(nodes, node_mask, spd,
path_types, svd)``.  Every model returns ``[B, 1]`` predictions; the
hybrid its latent too.  :func:`model_fields`,
:func:`model_inputs` and :func:`model_outputs` hold this convention for
the trainer and the predictor alike.  Module names mirror the flax
parameter tree, so ``state_dict`` keys read like its paths
(``gat_graphsage.conv1.query_transform.weight`` for
``gat_graphsage/conv1/query_transform/kernel``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..chem.featurize import RWSE_STEPS, SVD_RANK
from ..ops import (
    dense_adjacency,
    segment_max_pool,
    segment_mean_pool,
    segment_sum_pool,
)
from ..parallel.distributed import batch_sum, current_batch_shard
from ..utils import telemetry
from .layers import (
    CNNNet,
    ChebConvRef,
    CombinedNet,
    Dropout,
    EGTLayer,
    GATConv,
    GCNConv,
    GINConv,
    GPSLayer,
    GraphormerLayer,
    MaskedBatchNorm,
    ModifiedGATLayer,
    SAGEConv,
    StructuralBias,
    Table,
    TorchLinear,
    keep_mask,
)

__all__ = ["GATGraphSAGE", "HybridModel", "GCNNet", "SAGENet", "GATNet",
           "GATGCN", "GINConvNet", "ChebNet", "GraphormerNet", "GPSNet",
           "EGTNet", "kl_loss",
           "build_model", "model_fields", "model_inputs", "model_outputs"]


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


class GraphormerNet(nn.Module):
    """Graphormer (Ying et al., NeurIPS 2021; github.com/microsoft/
    Graphormer): ``layers`` pre-LN :class:`GraphormerLayer` over the atoms
    and a graph token, with the structural bias of
    :class:`StructuralBias` shared by every layer.

    Input: ``h0_i = nodes_i @ atom_encoder + in_degree[deg_i] +
    out_degree[deg_i]`` (the port's 35 one-hot features through a bias-free
    linear map, which is the sum of per-group embeddings), with the learned
    ``graph_token`` first.  Readout: the graph token's last state through
    ``head_transform -> GELU -> head_norm -> head_out`` to ``[B, 1]``.  The
    structural bias's build is the ``graphormer.bias`` device span
    (``utils/telemetry.py``)."""

    def __init__(self, in_features: int = 35, dim: int = 768,
                 layers: int = 12, heads: int = 32, ffn_dim: int = 768,
                 attention_dropout: float = 0.1, dropout: float = 0.1,
                 num_degree: int = 512, num_spatial: int = 512):
        super().__init__()
        self.atom_encoder = TorchLinear(in_features, dim, bias=False)
        self.in_degree = Table(num_degree, dim)
        self.out_degree = Table(num_degree, dim)
        self.graph_token = Table(1, dim)
        self.bias = StructuralBias(heads, num_spatial=num_spatial)
        self.layers = nn.ModuleList(
            GraphormerLayer(dim, heads, ffn_dim, attention_dropout, dropout)
            for _ in range(layers))
        self.head_transform = TorchLinear(dim, dim)
        self.head_norm = nn.LayerNorm(dim)
        self.head_out = TorchLinear(dim, 1)

    def forward(self, nodes: torch.Tensor, node_mask: torch.Tensor,
                degree: torch.Tensor, spd: torch.Tensor,
                path_types: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = nodes.shape[0]
        deg = degree.long().clamp_max(self.in_degree.weight.shape[0] - 1)
        x = self.atom_encoder(nodes) + self.in_degree(deg) \
            + self.out_degree(deg)
        token = self.graph_token.weight.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([token, x], dim=1)
        key_mask = torch.cat([node_mask.new_ones(b, 1, dtype=torch.bool),
                              node_mask > 0], dim=1)
        with telemetry.device_span("graphormer.bias", nodes.device):
            bias = self.bias(spd, path_types)
        for layer in self.layers:
            x = layer(x, bias, key_mask, generator)
        h = self.head_norm(F.gelu(self.head_transform(x[:, 0])))
        return self.head_out(h)


class GPSNet(nn.Module):
    """GraphGPS (Rampasek et al., NeurIPS 2022, arXiv:2205.12454;
    github.com/rampasek/GraphGPS), its PCQM4Mv2 GPS-medium: ``layers``
    :class:`GPSLayer`, each a GatedGCN with an edge stream beside
    attention without a bias.

    Input: ``h0 = cat(nodes @ atom_encoder, rwse_encoder(BN(rwse)))``, the
    port's 35 one-hot features through a bias-free linear map to ``dim -
    20``, and the atoms' 16 random-walk return probabilities
    (``data/dataset.py``) through a batch norm over the real atoms and
    ``Linear(16, 20)``; ``e0 = bond_encoder[edge_types]`` (type 0, the
    padding, embeds to zero).  Readout: the mean of the last node states
    over the real atoms, then ``dim -> dim/2 -> dim/4 -> 1`` with ReLU
    between (the public ``san_graph`` head of two hidden layers).  The
    walk's length and the encoding's width are the published ones."""

    PE_DIM = 20

    def __init__(self, in_features: int = 35, dim: int = 384,
                 layers: int = 10, heads: int = 16, ffn_dim: int = 768,
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 bond_types: int = 4):
        super().__init__()
        self.atom_encoder = TorchLinear(in_features, dim - self.PE_DIM,
                                        bias=False)
        self.rwse_norm = MaskedBatchNorm(RWSE_STEPS)
        self.rwse_encoder = TorchLinear(RWSE_STEPS, self.PE_DIM)
        self.bond_encoder = Table(bond_types, dim)
        self.layers = nn.ModuleList(
            GPSLayer(dim, heads, ffn_dim, dropout, attention_dropout)
            for _ in range(layers))
        self.head_fc1 = TorchLinear(dim, dim // 2)
        self.head_fc2 = TorchLinear(dim // 2, dim // 4)
        self.head_out = TorchLinear(dim // 4, 1)

    def forward(self, nodes: torch.Tensor, node_mask: torch.Tensor,
                edges: torch.Tensor, edge_mask: torch.Tensor,
                edge_types: torch.Tensor, rwse: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.atom_encoder(nodes)
        # the walk's probabilities reach their norm in f32 (a bf16 input
        # would round them by more than their spread)
        pe = self.rwse_encoder(self.rwse_norm(rwse.float(), node_mask)
                               .to(x.dtype))
        h = torch.cat([x, pe], dim=-1)
        table = self.bond_encoder.weight.float()
        table = torch.cat([table.new_zeros(1, table.shape[1]), table])
        e = F.embedding(edge_types.long(), table).to(h.dtype)
        for layer in self.layers:
            h, e = layer(h, e, edges, node_mask, edge_mask, generator)
        m = node_mask.float().unsqueeze(-1)
        pooled = (h.float() * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
        x = F.relu(self.head_fc1(pooled.to(h.dtype)))
        return self.head_out(F.relu(self.head_fc2(x)))


class EGTNet(nn.Module):
    """EGT, the Edge-augmented Graph Transformer (Hussain, Zaki and
    Subramanian, KDD 2022, arXiv:2108.03348; github.com/shamim-hussain/
    egt_pytorch), its PCQM4Mv2 ``egt_110m``: ``layers`` :class:`EGTLayer`
    over node states of width ``dim`` and dense pair states of width
    ``pair_dim``, the last layer without a pair update; the published
    model's virtual nodes, distances and clip are its constants.

    Input, with :attr:`VIRTUAL_NODES` virtual nodes first: ``h0 = nodes @
    atom_encoder + svd_encoder(svd)``, the port's 35 one-hot features
    through a bias-free linear map and the atoms' SVD encodings
    (``data/dataset.py``; in training each molecule's singular vectors
    flip their signs at random, one draw of the generator per triplet,
    before any dropout), the virtual nodes' own rows; ``e0 = distance[d] +
    bond[t]`` per pair of atoms, ``d`` the shortest-path distance up to
    :attr:`MAX_DISTANCE` and one row past it for further and unreachable
    pairs, ``t`` the bond type of a bonded pair (0, no bond, embeds to
    zero), and for a virtual node's row or column its own pair row (the
    mean of two between virtual nodes).  Readout: the final layer norm of
    the virtual nodes' last states, concatenated, then ``Linear -> ELU ->
    Linear -> ELU -> Linear`` to ``[B, 1]``."""

    VIRTUAL_NODES = 4
    MAX_DISTANCE = 16   # the public upto_hop
    CLIP = 5.0          # the public clip_logits_value

    def __init__(self, in_features: int = 35, dim: int = 768,
                 pair_dim: int = 64, layers: int = 30, heads: int = 32,
                 ffn_dim: int = 768, attention_dropout: float = 0.3,
                 dropout: float = 0.0, bond_types: int = 4):
        super().__init__()
        v = self.VIRTUAL_NODES
        self.atom_encoder = TorchLinear(in_features, dim, bias=False)
        self.svd_encoder = TorchLinear(2 * SVD_RANK, dim)
        self.distance = Table(self.MAX_DISTANCE + 2, pair_dim, std=1.0)
        self.bond = Table(bond_types, pair_dim, std=1.0)
        self.virtual_node = Table(v, dim, std=1.0)
        self.virtual_pair = Table(v, pair_dim, std=1.0)
        self.layers = nn.ModuleList(
            EGTLayer(dim, pair_dim, heads, ffn_dim, attention_dropout,
                     dropout, self.CLIP, v, pair_update=i < layers - 1)
            for i in range(layers))
        self.final_norm = nn.LayerNorm(dim)
        self.head_fc1 = TorchLinear(v * dim, dim)
        self.head_fc2 = TorchLinear(dim, dim)
        self.head_out = TorchLinear(dim, 1)

    def _pairs(self, spd: torch.Tensor,
               path_types: torch.Tensor) -> torch.Tensor:
        """``e0 [B, V + n, V + n, C]`` in f32."""
        (b, n), v = spd.shape[:2], self.VIRTUAL_NODES
        dist = spd.long()
        far = (dist < 0) | (dist > self.MAX_DISTANCE)
        dist = torch.where(far, self.MAX_DISTANCE + 1, dist)
        bond = torch.where(dist == 1, path_types[..., 0].long(), 0)
        table = self.bond.weight.float()
        table = torch.cat([table.new_zeros(1, table.shape[1]), table])
        e = F.embedding(dist, self.distance.weight.float()) \
            + F.embedding(bond, table)
        vp = self.virtual_pair.weight.float()
        c = vp.shape[1]
        top = torch.cat([0.5 * (vp[:, None] + vp[None, :]),
                         vp[:, None].expand(v, n, c)], 1)
        left = vp[None].expand(n, v, c)
        return torch.cat([top.expand(b, v, v + n, c),
                          torch.cat([left.expand(b, n, v, c), e], 2)], 1)

    def forward(self, nodes: torch.Tensor, node_mask: torch.Tensor,
                spd: torch.Tensor, path_types: torch.Tensor,
                svd: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, v = nodes.shape[0], self.VIRTUAL_NODES
        if self.training:
            flip = keep_mask((b, SVD_RANK), 0.5, generator, nodes.device)
            sign = torch.where(flip, 1.0, -1.0).repeat(1, 2)
            svd = svd * sign[:, None, :]
        x = self.atom_encoder(nodes) + self.svd_encoder(svd.to(nodes.dtype))
        h = torch.cat([self.virtual_node.weight.to(x.dtype).expand(b, v, -1),
                       x], 1)
        e = self._pairs(spd, path_types).to(x.dtype)
        key_mask = torch.cat([node_mask.new_ones(b, v, dtype=torch.bool),
                              node_mask > 0], 1)
        for layer in self.layers:
            h, e = layer(h, e, key_mask, generator)
        h = self.final_norm(h)[:, :v].reshape(b, -1)
        h = F.elu(self.head_fc2(F.elu(self.head_fc1(h))))
        return self.head_out(h)


def model_fields(cfg) -> Tuple[str, ...]:
    """The dataset fields that ``cfg``'s model reads."""
    if cfg.model == "graphormer":
        return ("nodes", "node_mask", "degree", "spd", "path_types")
    if cfg.model == "gps":
        return ("nodes", "node_mask", "edges", "edge_mask", "edge_types",
                "rwse")
    if cfg.model == "egt":
        return ("nodes", "node_mask", "spd", "path_types", "svd")
    return ("nodes", "edges", "node_mask", "edge_mask") + (
        ("fp",) if cfg.is_hybrid else ())


def model_inputs(cfg, batch, dtype: Optional[torch.dtype] = None) -> tuple:
    """``cfg``'s model's positional inputs (``generator`` aside) from a
    batch with its ``sample_mask``, padding rows masked out (GraphGPS's
    edges too).  The float inputs are cast to ``dtype`` when given, the
    adjacency after its f32 build; the structure and the edge lists stay
    integers, GraphGPS's random-walk encoding and EGT's SVD encoding
    f32."""
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    smask = batch["sample_mask"].unsqueeze(1)
    node_mask = batch["node_mask"] * smask
    if cfg.model == "gps":
        return (cast(batch["nodes"]), cast(node_mask), batch["edges"],
                cast(batch["edge_mask"] * smask), batch["edge_types"],
                batch["rwse"])
    if cfg.model == "egt":
        return (cast(batch["nodes"]), cast(node_mask), batch["spd"],
                batch["path_types"], batch["svd"])
    if cfg.model == "graphormer":
        args = (batch["nodes"], node_mask)
        rest = (batch["degree"], batch["spd"], batch["path_types"])
    else:
        adj = dense_adjacency(batch["edges"], batch["edge_mask"],
                              batch["nodes"].shape[1])
        args = (batch["nodes"], adj, node_mask) + (
            (batch["fp"],) if cfg.is_hybrid else ())
        rest = ()
    return tuple(cast(a) for a in args) + rest


def model_outputs(cfg, out, latent: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(pred, latent)`` of a call of ``cfg``'s model, in f32; the latent
    is the hybrid's (for the KL term), else or with ``latent=False`` None."""
    pred, lat = out if cfg.is_hybrid else (out, None)
    return pred.float(), lat.float() if latent and lat is not None else None


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
    if cfg.model == "graphormer":
        return GraphormerNet(
            feat, dim=cfg.hidden_dim, layers=cfg.n_layers,
            heads=cfg.n_heads, ffn_dim=cfg.ffn_dim,
            attention_dropout=cfg.attention_dropout,
            dropout=cfg.graph_dropout)
    if cfg.model == "gps":
        return GPSNet(feat, dim=cfg.hidden_dim, layers=cfg.n_layers,
                      heads=cfg.n_heads, ffn_dim=cfg.ffn_dim,
                      dropout=cfg.graph_dropout,
                      attention_dropout=cfg.attention_dropout)
    if cfg.model == "egt":
        return EGTNet(feat, dim=cfg.hidden_dim, pair_dim=cfg.pair_dim,
                      layers=cfg.n_layers, heads=cfg.n_heads,
                      ffn_dim=cfg.ffn_dim,
                      attention_dropout=cfg.attention_dropout,
                      dropout=cfg.graph_dropout)
    baselines = {"sage": SAGENet, "gat": GATNet, "gat_gcn": GATGCN,
                 "gin": GINConvNet, "cheb": ChebNet}
    if cfg.model not in baselines:
        raise ValueError(f"unknown model {cfg.model!r}")
    return baselines[cfg.model](feat, dropout=cfg.graph_dropout)
