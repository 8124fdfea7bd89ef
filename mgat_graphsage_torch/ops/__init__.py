"""Graph primitives and the two hand-written CUDA kernels of the serving
path (``csrc/adjacency.cu``, ``csrc/attention.cu``), each beside its plain
PyTorch version.  Importing this package builds nothing."""

from .adjacency import dense_adjacency_cuda, dense_adjacency_plain
from .attention import attention_plain, fused_masked_attention_cuda
from .graph import (
    add_self_loops,
    dense_adjacency,
    masked_softmax,
    segment_max_pool,
    segment_mean_pool,
    segment_sum_pool,
)

__all__ = [
    "dense_adjacency", "dense_adjacency_cuda", "dense_adjacency_plain",
    "fused_masked_attention_cuda", "attention_plain", "add_self_loops",
    "masked_softmax", "segment_max_pool", "segment_mean_pool",
    "segment_sum_pool",
]
