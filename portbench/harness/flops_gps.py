"""The yardstick's arithmetic for GraphGPS (GPS-medium) of
``graphgps_medium.train``: the FLOPs of a molecule's forward pass, and the
operations and bytes of its attention, from the configuration's shapes.
The peaks are ``flops.py``'s (the H100's data sheet).

FLOPs count the work the model needs, whatever kernel does it: ``2 m n
k`` for every product, at the padded shape ``N = n_nodes`` atoms and ``E
= n_edges`` directed edges a molecule: per layer the GatedGCN's four node
projections (A, B, D, E) and its edge projection C, the attention's Q, K,
V and output projections and its two products, the FFN; then the atom
and RWSE encoders and the head.  Gathers, the gated sums, the batch
norms and other elementwise work count nothing.  A training step counts
three forward passes a row.

The attention's least work is that of one fused kernel a layer without a
bias: forward, read ``q``, ``k``, ``v`` and write the output; backward,
read ``q``, ``k``, ``v``, the output and its gradient, and write the
gradients of ``q``, ``k`` and ``v``; every element at the compute dtype's
width (2 bytes for bf16), and in training the dropout's keep-mask ``[H, N,
N]`` at 1 byte, read once each way.  No bias is read and no bias gradient
written.  Operations: ``4 N^2 D`` forward (``q k^T`` and ``A v``), ``8 N^2
D`` backward (``dA``, ``dv``, ``dq``, ``dk``).
"""

from __future__ import annotations

from typing import Dict

from .flops import HBM_BYTES_PER_S, PEAK_FLOPS

WIDTH = {"bf16": 2, "f32": 4}


def forward_flops_per_row(model: Dict, n_nodes: int, n_edges: int) -> int:
    """FLOPs of one molecule's forward pass."""
    n, e, d = n_nodes, n_edges, model["hidden_size"]
    ffn, f = model["ffn_hidden_size"], model["in_features"]
    pe, steps = model["pe_dim"], model["rwse_steps"]
    layer = (4 * 2 * n * d * d          # A, B, D, E
             + 2 * e * d * d            # C, over the edge slots
             + 4 * 2 * n * d * d        # q, k, v, out projections
             + 2 * 2 * n * n * d        # q k^T, A v over the heads
             + 2 * 2 * n * d * ffn)     # the FFN's two products
    head = 2 * (d * (d // 2) + (d // 2) * (d // 4) + d // 4)
    return (model["num_hidden_layers"] * layer + 2 * n * f * (d - pe)
            + 2 * n * steps * pe + head)


def attention_work_per_row(model: Dict, n_nodes: int, numerics: str,
                           backward: bool, dropout: bool = True):
    """(bytes, operations) of one layer's attention for one molecule,
    without a bias; ``dropout``: the keep-mask is read (training)."""
    n, d = n_nodes, model["hidden_size"]
    h, e = model["num_attention_heads"], WIDTH[numerics]
    keep = h * n * n if dropout else 0
    if not backward:
        return 4 * n * d * e + keep, 4 * n * n * d
    return 8 * n * d * e + keep, 8 * n * n * d


def attention_least_s(model: Dict, n_nodes: int, numerics: str,
                      train_rows: int, eval_rows: int) -> float:
    """Least seconds of the attention of ``train_rows`` training rows
    (forward and backward, with the keep-mask) and ``eval_rows`` evaluated
    rows (forward, no keep-mask), in every layer: each piece at the larger
    of its bytes at the HBM's rate and its operations at the compute
    dtype's peak."""
    peak = PEAK_FLOPS["bfloat16" if numerics == "bf16" else "float32"]

    def least(backward, dropout):
        nbytes, ops = attention_work_per_row(model, n_nodes, numerics,
                                             backward, dropout)
        return max(nbytes / HBM_BYTES_PER_S, ops / peak)

    per_layer = train_rows * (least(False, True) + least(True, True)) \
        + eval_rows * least(False, False)
    return model["num_hidden_layers"] * per_layer
