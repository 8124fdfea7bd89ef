"""Graph primitives (dense and segment-ID layouts) and the port's
hand-written CUDA kernels, each beside its plain PyTorch version: the
dense adjacency (``csrc/adjacency.cu``), the fused masked attention
forward and backward (``csrc/attention.cu``, ``csrc/attention_bwd.cu``),
the fingerprint CNN's fused backward (``csrc/cnn_dy3.cu``,
``csrc/cnn_chain_bwd.cu``) and the graph transformer's biased attention
and structural bias, forward and backward (``csrc/biased_attention.cu``,
``csrc/structural_bias.cu``).  The names ``biased_attention`` and
``structural_bias`` stay the modules' (``utils/telemetry.py`` reads their
counters): their functions of those names are not re-exported here.
Importing this package builds nothing."""

from .adjacency import dense_adjacency_cuda, dense_adjacency_plain
from .attention import (
    attention_bwd_cuda,
    attention_bwd_plain,
    attention_plain,
    fused_masked_attention,
    fused_masked_attention_cuda,
)
from .biased_attention import (
    biased_attention_bwd_cuda,
    biased_attention_bwd_plain,
    biased_attention_cuda,
    biased_attention_fwd_plain,
)
from .cnn import (
    cnn_chain_bwd_cuda,
    cnn_chain_bwd_plain,
    cnn_tail,
    dy3_cuda,
    dy3_plain,
)
from .structural_bias import (
    structural_bias_bwd_cuda,
    structural_bias_bwd_plain,
    structural_bias_cuda,
    structural_bias_fwd_plain,
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
    "cnn_chain_bwd_plain", "biased_attention_cuda",
    "biased_attention_bwd_cuda", "biased_attention_fwd_plain",
    "biased_attention_bwd_plain", "structural_bias_cuda",
    "structural_bias_bwd_cuda", "structural_bias_fwd_plain",
    "structural_bias_bwd_plain", "add_self_loops", "degree",
    "dense_adjacency_einsum", "gcn_norm_adjacency", "masked_softmax",
    "segment_max_pool", "segment_mean_pool", "segment_sum_pool", "gather",
    "scatter_sum", "segment_max", "segment_mean", "segment_softmax",
    "segment_sum",
]
