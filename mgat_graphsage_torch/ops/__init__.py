"""Graph primitives (dense and segment-ID layouts) and the port's
hand-written CUDA kernels, each beside its plain PyTorch version: the
dense adjacency (``csrc/adjacency.cu``), the fused masked attention
forward and backward (``csrc/attention.cu``, ``csrc/attention_bwd.cu``)
and the fingerprint CNN's fused backward (``csrc/cnn_dy3.cu``,
``csrc/cnn_chain_bwd.cu``).  Importing this package builds nothing."""

from .adjacency import dense_adjacency_cuda, dense_adjacency_plain
from .attention import (
    attention_bwd_cuda,
    attention_bwd_plain,
    attention_plain,
    fused_masked_attention,
    fused_masked_attention_cuda,
)
from .cnn import (
    cnn_chain_bwd_cuda,
    cnn_chain_bwd_plain,
    cnn_tail,
    dy3_cuda,
    dy3_plain,
)
from .graph import (
    add_self_loops,
    degree,
    dense_adjacency,
    dense_adjacency_einsum,
    gcn_norm_adjacency,
    masked_softmax,
    segment_max_pool,
    segment_mean_pool,
    segment_sum_pool,
)
from .segment import (
    gather,
    scatter_sum,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)

__all__ = [
    "dense_adjacency", "dense_adjacency_cuda", "dense_adjacency_plain",
    "fused_masked_attention", "fused_masked_attention_cuda",
    "attention_bwd_cuda", "attention_plain", "attention_bwd_plain",
    "cnn_tail", "dy3_cuda", "dy3_plain", "cnn_chain_bwd_cuda",
    "cnn_chain_bwd_plain", "add_self_loops", "degree",
    "dense_adjacency_einsum", "gcn_norm_adjacency", "masked_softmax",
    "segment_max_pool", "segment_mean_pool", "segment_sum_pool", "gather",
    "scatter_sum", "segment_max", "segment_mean", "segment_softmax",
    "segment_sum",
]
