"""The yardstick's arithmetic for EGT (EGT-110M) of ``egt_110m.train``:
the FLOPs of a molecule's forward pass, and the bytes and operations of
its gated attention, from the configuration's shapes.  The peaks are
``flops.py``'s (the H100's data sheet).

FLOPs count the work the model needs, whatever kernel does it: ``2 m n
k`` for every product, at the padded shape, ``N = n_nodes + V`` nodes a
molecule (the atoms' slots and the virtual nodes) and all ``N^2`` pair
slots: per layer the node stream's Q, K, V and output projections and its
FFN, the attention's two products, and the pair stream's ``E`` and ``G``
projections, and but in the last layer its output projection and FFN;
then the atom and SVD encoders and the head.  Layer norms, the softmax,
the gates and other elementwise work count nothing.  A training step
counts three forward passes a row.

The gated attention's least work is that of one fused op a layer, each
tensor moved once at the compute dtype's width (2 bytes for bf16): read
``q``, ``k``, ``v``, ``E`` and ``G`` and write the output and ``H^``; in
training also read the gradients of the output and of ``H^`` and write
those of ``q``, ``k``, ``v``, ``E`` and ``G``, and read the dropout's
keep-mask ``[H, N, N]`` at 1 byte.  The last layer's ``H^`` feeds no pair
update, so there it is neither written nor its gradient read.
Operations: ``4 N^2 D`` forward (``q k^T`` and ``A v``), ``8 N^2 D``
backward.  A row's least time is the larger of its bytes at the HBM's
rate and its operations at the compute dtype's peak.
"""

from __future__ import annotations

from typing import Dict

from .flops import HBM_BYTES_PER_S, PEAK_FLOPS

WIDTH = {"bf16": 2, "f32": 4}


def forward_flops_per_row(model: Dict, n_nodes: int) -> int:
    """FLOPs of one molecule's forward pass."""
    d, c, h = model["hidden_size"], model["pair_size"], \
        model["num_attention_heads"]
    ffn, pffn, v = model["ffn_hidden_size"], model["pair_ffn_size"], \
        model["virtual_nodes"]
    n = n_nodes + v
    pairs = n * n
    layer = (4 * 2 * n * d * d          # q, k, v, out projections
             + 2 * 2 * n * d * ffn      # the node FFN's two products
             + 2 * 2 * pairs * d        # q k^T, A v over the heads
             + 2 * 2 * pairs * c * h)   # E, G over the pair slots
    update = (2 * pairs * h * c         # the pair stream's output, H^ W_OE
              + 2 * 2 * pairs * c * pffn)  # the pair FFN's two products
    layers = model["num_hidden_layers"]
    head = 2 * (v * d * d + d * d + d)
    return (layers * layer + (layers - 1) * update
            + 2 * n_nodes * (model["in_features"] + 2 * model["svd_rank"])
            * d + head)


def attention_work_per_row(model: Dict, n_nodes: int, numerics: str,
                           training: bool, pair_update: bool = True):
    """(bytes, operations) of one layer's gated attention for one
    molecule: forward and backward with the keep-mask in ``training``,
    else the forward; ``pair_update``: its ``H^`` is used."""
    n = n_nodes + model["virtual_nodes"]
    d, h, e = model["hidden_size"], model["num_attention_heads"], \
        WIDTH[numerics]
    tensors = 3 * n * d + 2 * h * n * n + n * d \
        + (h * n * n if pair_update else 0)
    if not training:
        return tensors * e, 4 * n * n * d
    return 2 * tensors * e + h * n * n, 12 * n * n * d


def attention_least_s(model: Dict, n_nodes: int, numerics: str,
                      train_rows: int, eval_rows: int) -> float:
    """Least seconds of the gated attention of ``train_rows`` training
    rows and ``eval_rows`` evaluated rows, every layer."""
    peak = PEAK_FLOPS["bfloat16" if numerics == "bf16" else "float32"]

    def least(training, pair_update):
        nbytes, ops = attention_work_per_row(model, n_nodes, numerics,
                                             training, pair_update)
        return max(nbytes / HBM_BYTES_PER_S, ops / peak)

    layers = model["num_hidden_layers"]
    return sum(train_rows * least(True, i < layers - 1)
               + eval_rows * least(False, i < layers - 1)
               for i in range(layers))
