"""Layers, the model zoo (the hybrid, its ablations and the six
baselines), and the flax-tree converter."""

from .convert import (
    adam_state_from_jax,
    adam_state_to_jax,
    batch_stats_to_jax,
    params_from_jax,
    params_to_jax,
)
from .layers import (
    CNNNet,
    CenterTapConv1d,
    ChebConvRef,
    CombinedNet,
    Dropout,
    GATConv,
    GCNConv,
    GINConv,
    GlorotLinear,
    MaskedBatchNorm,
    ModifiedGATLayer,
    SAGEConv,
    TorchConv1d,
    TorchLinear,
    bf16_products,
    cnn_fc1_pos_major_to_torch,
    cnn_fc1_torch_to_pos_major,
    frozen_running_stats,
    ieee_f32,
    matmul_precision,
    reset_parameters,
)
from .zoo import (
    GATGCN,
    ChebNet,
    GATGraphSAGE,
    GATNet,
    GCNNet,
    GINConvNet,
    HybridModel,
    SAGENet,
    build_model,
    kl_loss,
)

__all__ = [
    "build_model",
    "TorchLinear", "TorchConv1d", "CenterTapConv1d", "ModifiedGATLayer",
    "SAGEConv", "GlorotLinear", "GCNConv", "GATConv", "GINConv",
    "ChebConvRef", "MaskedBatchNorm", "frozen_running_stats", "CNNNet",
    "CombinedNet", "Dropout", "ieee_f32",
    "bf16_products", "matmul_precision", "cnn_fc1_torch_to_pos_major",
    "cnn_fc1_pos_major_to_torch",
    "reset_parameters", "GATGraphSAGE", "HybridModel", "GCNNet", "SAGENet",
    "GATNet", "GATGCN", "GINConvNet", "ChebNet", "kl_loss",
    "params_from_jax", "params_to_jax", "batch_stats_to_jax",
    "adam_state_from_jax", "adam_state_to_jax",
]
