"""Config dataclass + preset registry (copy of
``mgat_graphsage_tpu/train/config.py``).

The fields and presets are the reference package's, unchanged, so that a
checkpoint sidecar's ``config`` dict loads here as it is; the port adds
the graph transformer (``model="graphormer"``): its widths, read by no
other model, and the preset ``graphormer_base``.  The comments
on each knob's measured effect live in the reference package; the
port's own measurements are in ``PERF.md``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["TrainConfig", "PRESETS", "get_config"]


@dataclasses.dataclass
class TrainConfig:
    name: str = "flagship"
    model: str = "hybrid"          # hybrid | gat_graphsage | gcn | sage |
                                   # gat | gat_gcn | gin | cheb | graphormer
    # graph-branch knobs (GATGraphSAGE axes)
    attention: str = "modified"    # modified | gat10
    residual: bool = True
    flat_attention: bool = False
    dual_pool: bool = False
    graph_dropout: float = 0.3
    sage_features: int = 35
    # data
    fingerprint: Optional[str] = "ecfp1024"
    featurizer: str = "35"         # "35" | "5"
    scale_targets: bool = True
    # CNN fc1 width: 256 in every reference script except
    # fingerprint/ecfp=2024.py:125 (512)
    cnn_fc_hidden: int = 256
    # optimization (reference torch.optim.Adam semantics: L2-coupled wd)
    lr: float = 1e-3
    lr_schedule: str = "constant"  # "constant" | "warmup_cosine"
    warmup_steps: int = 0
    lr_final_ratio: float = 0.1
    weight_decay: float = 1e-4
    kl_lambda: float = 0.001
    epochs: int = 1000
    batch_size: int = 128
    eval_batch_size: int = 64
    seed: int = 42
    # selection: 'original_mse' (train.py:284) or 'val_mse' (baselines)
    select_metric: str = "original_mse"
    # precision and storage knobs of the reference package's trainer;
    # carried so that sidecars round-trip.  matmul_precision on the H100
    # (models/layers.py::matmul_precision), in the train step, evaluation
    # and prediction alike, chosen by the compute dtype:
    # - compute_dtype="float32": both values run IEEE f32, TF32 off in
    #   cuBLAS and cuDNN (the reference-numerics mode keeps no tensor-core
    #   f32);
    # - compute_dtype="bfloat16": both values run bf16 products with f32
    #   accumulation, cuBLAS's bf16 split-K reduction off, as the
    #   reference's preferred_element_type=f32 gives it in every layer.
    matmul_precision: str = "bfloat16"
    adam_moment_dtype: str = "float32"
    compute_dtype: str = "float32"
    master_dtype: str = "float32"
    adam_factored_v: bool = False
    remat: bool = False
    cnn_pallas_bwd: bool = False
    dataset_storage: str = "float32"
    # the graph transformer's widths (model="graphormer"; the port's own):
    # graph_dropout is the FFN's dropout there
    n_layers: int = 12
    hidden_dim: int = 768
    ffn_dim: int = 768
    n_heads: int = 32
    attention_dropout: float = 0.1

    @property
    def is_hybrid(self) -> bool:
        return self.model == "hybrid"

    @property
    def needs_structure(self) -> bool:
        """The model reads the graph structure (``data/dataset.py``'s
        ``structure=True``) in place of the adjacency."""
        return self.model == "graphormer"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def _p(**kw) -> TrainConfig:
    return TrainConfig(**kw)


PRESETS: Dict[str, TrainConfig] = {
    # --- flagship hybrid (reference train.py; == ablation model 6) ---
    "flagship": _p(name="flagship"),
    # batch-global attention crossing molecule boundaries (train.py:96-98)
    "flagship_flat": _p(name="flagship_flat", flat_attention=True),
    "model6": _p(name="model6"),
    "flagship_bf16": _p(name="flagship_bf16", compute_dtype="bfloat16",
                        adam_moment_dtype="bfloat16"),
    "flagship_bf16sr": _p(name="flagship_bf16sr",
                          compute_dtype="bfloat16",
                          adam_moment_dtype="bfloat16",
                          master_dtype="bfloat16"),
    "flagship_bf16_bs256": _p(name="flagship_bf16_bs256",
                              compute_dtype="bfloat16",
                              adam_moment_dtype="bfloat16",
                              batch_size=256),
    "flagship_bf16_bs512_wc": _p(name="flagship_bf16_bs512_wc",
                                 compute_dtype="bfloat16",
                                 adam_moment_dtype="bfloat16",
                                 batch_size=512, lr=2e-3,
                                 lr_schedule="warmup_cosine",
                                 warmup_steps=300),
    "flagship_bf16_bs1024_wc": _p(name="flagship_bf16_bs1024_wc",
                                  compute_dtype="bfloat16",
                                  adam_moment_dtype="bfloat16",
                                  batch_size=1024, lr=3.2e-3,
                                  lr_schedule="warmup_cosine",
                                  warmup_steps=300),
    # --- ablation ladder (reference ablation/model*.py) ---
    "model1": _p(name="model1", model="gat_graphsage", attention="gat10",
                 dual_pool=True, sage_features=350, graph_dropout=0.2,
                 fingerprint=None, scale_targets=False, lr=1e-4,
                 weight_decay=0.0, kl_lambda=0.0, batch_size=64,
                 eval_batch_size=32, select_metric="val_mse"),
    "model2": _p(name="model2", model="gat_graphsage", residual=False,
                 dual_pool=True, graph_dropout=0.2, fingerprint=None,
                 scale_targets=False, lr=5e-3, weight_decay=0.0,
                 kl_lambda=0.0, select_metric="val_mse"),
    "model3": _p(name="model3", model="gat_graphsage", residual=True,
                 dual_pool=True, graph_dropout=0.2, fingerprint=None,
                 scale_targets=False, lr=5e-3, weight_decay=0.0,
                 kl_lambda=0.0, select_metric="val_mse"),
    "model4": _p(name="model4", scale_targets=False, lr=5e-3,
                 weight_decay=0.0, kl_lambda=0.0, select_metric="val_mse"),
    "model5": _p(name="model5", scale_targets=False, lr=5e-3,
                 weight_decay=0.0, kl_lambda=0.001,
                 select_metric="val_mse"),
    # --- baselines (reference gnn/*.py) ---
    "gcn": _p(name="gcn", model="gcn", fingerprint=None, featurizer="5",
              scale_targets=False, lr=5.9e-4, weight_decay=0.0,
              kl_lambda=0.0, epochs=10, batch_size=32, eval_batch_size=32,
              graph_dropout=0.1, select_metric="val_mse"),
    "graphsage": _p(name="graphsage", model="sage", fingerprint=None,
                    scale_targets=False, lr=5e-3, weight_decay=0.0,
                    kl_lambda=0.0, graph_dropout=0.2,
                    select_metric="val_mse"),
    "gat": _p(name="gat", model="gat", fingerprint=None,
              scale_targets=False, lr=5e-3, weight_decay=0.0, kl_lambda=0.0,
              graph_dropout=0.2, select_metric="val_mse"),
    "gat_gcn": _p(name="gat_gcn", model="gat_gcn", fingerprint=None,
                  scale_targets=False, lr=1e-4, weight_decay=0.0,
                  kl_lambda=0.0, batch_size=64, eval_batch_size=32,
                  graph_dropout=0.2, select_metric="val_mse"),
    "gin": _p(name="gin", model="gin", fingerprint=None,
              scale_targets=False, lr=5e-3, weight_decay=0.0, kl_lambda=0.0,
              graph_dropout=0.2, select_metric="val_mse"),
    "chebnet": _p(name="chebnet", model="cheb", fingerprint=None,
                  scale_targets=False, lr=5e-3, weight_decay=0.0,
                  kl_lambda=0.0, graph_dropout=0.2,
                  select_metric="val_mse"),
    # --- fingerprint suite (reference fingerprint/*.py) ---
    "morgan1024": _p(name="morgan1024", fingerprint="morgan1024"),
    "morgan2048": _p(name="morgan2048", fingerprint="morgan2048"),
    "ecfp2048": _p(name="ecfp2048", fingerprint="ecfp2048",
                   cnn_fc_hidden=512),
    "fcfp": _p(name="fcfp", fingerprint="fcfp1024"),
    "maccs": _p(name="maccs", fingerprint="maccs"),
    "smifp": _p(name="smifp", fingerprint="smifp"),
    "bci": _p(name="bci", fingerprint="bci"),
    # --- graph transformer (Ying et al., NeurIPS 2021, arXiv:2106.05234;
    # github.com/microsoft/Graphormer, arch graphormer_base): 12 pre-LN
    # layers, width 768, FFN 768, 32 heads of 24, attention and FFN dropout
    # 0.1; MSE on standardised targets, bf16 compute with f32 master
    # weights and f32 Adam moments, lr 2e-4 after 60,000 warm-up steps ---
    "graphormer_base": _p(name="graphormer_base", model="graphormer",
                          fingerprint=None, graph_dropout=0.1,
                          compute_dtype="bfloat16",
                          adam_moment_dtype="float32", lr=2e-4,
                          lr_schedule="warmup_cosine", warmup_steps=60000,
                          weight_decay=0.0, kl_lambda=0.0, batch_size=1024,
                          eval_batch_size=1024),
}


def get_config(name: str, **overrides) -> TrainConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
