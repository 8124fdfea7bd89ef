"""The yardstick's arithmetic for the graph transformer (Graphormer) of
``graphormer_base.train``: the FLOPs of a molecule's forward pass, and
the operations and bytes of its attention, from the configuration's
shapes.  The peaks are ``flops.py``'s (the H100's data sheet).

FLOPs count the work the model needs, whatever kernel does it: ``2 m n
k`` for every product (the Q, K, V and output projections, the FFN, the
attention's two products, the atom encoder and the head), nothing for
elementwise work or for gathers, at the padded shape: ``N = n_nodes + 1``
rows a molecule (the graph token first).  A training step counts three
forward passes a row.

The attention's least work is that of one fused kernel a layer, as a
hand-written one would do it: forward, read ``q``, ``k``, ``v`` and the
bias ``[H, N, N]`` and write the output; backward, read ``q``, ``k``,
``v``, the output, its gradient and the bias, and write the gradients of
``q``, ``k``, ``v`` and of the bias; every element at the compute
dtype's width (2 bytes for bf16), the dropout mask drawn in the kernel.
Operations: ``4 N^2 D`` forward (``q k^T`` and ``A v``), ``8 N^2 D``
backward (``dA``, ``dv``, ``dq``, ``dk``).
"""

from __future__ import annotations

from typing import Dict

from .flops import HBM_BYTES_PER_S, PEAK_FLOPS

WIDTH = {"bf16": 2, "f32": 4}


def forward_flops_per_row(model: Dict, n_nodes: int) -> int:
    """FLOPs of one molecule's forward pass."""
    n, d = n_nodes + 1, model["hidden_size"]
    ffn, f = model["ffn_hidden_size"], model["in_features"]
    layer = (4 * 2 * n * d * d          # q, k, v, out projections
             + 2 * 2 * n * d * ffn      # fc1, fc2
             + 2 * 2 * n * n * d)       # q k^T, A v over the heads
    return (model["num_hidden_layers"] * layer + 2 * n_nodes * f * d
            + 2 * d * d + 2 * d)


def attention_work_per_row(model: Dict, n_nodes: int, numerics: str,
                           backward: bool):
    """(bytes, operations) of one layer's attention for one molecule."""
    n, d = n_nodes + 1, model["hidden_size"]
    h, e = model["num_attention_heads"], WIDTH[numerics]
    if not backward:
        return (3 * n * d + h * n * n + n * d) * e, 4 * n * n * d
    return (5 * n * d + h * n * n + 3 * n * d + h * n * n) * e, \
        8 * n * n * d


def attention_least_s(model: Dict, n_nodes: int, numerics: str,
                      train_rows: int, eval_rows: int) -> float:
    """Least seconds of the attention of ``train_rows`` training rows
    (forward and backward) and ``eval_rows`` evaluated rows (forward), in
    every layer: each piece at the larger of its bytes at the HBM's rate
    and its operations at the compute dtype's peak."""
    peak = PEAK_FLOPS["bfloat16" if numerics == "bf16" else "float32"]

    def least(backward):
        nbytes, ops = attention_work_per_row(model, n_nodes, numerics,
                                             backward)
        return max(nbytes / HBM_BYTES_PER_S, ops / peak)

    per_layer = train_rows * (least(False) + least(True)) \
        + eval_rows * least(False)
    return model["num_hidden_layers"] * per_layer
