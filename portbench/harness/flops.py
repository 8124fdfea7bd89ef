"""The yardstick's arithmetic: the H100's published peaks, the least time
of a piece of work (a copy of ``chip_smoke.py::bound`` at commit 157b929),
the operations and bytes of kernels 1-3 for their inputs (the counts
beside ``bound`` in ``chip_smoke.py``), and the FLOPs of the hybrid's
forward pass from its layer shapes.

The FLOP count is of the work the model needs, whatever kernel does it:
``2 m n k`` for every product (linear layers, convolutions, the
attention's two products, the SAGE aggregation), nothing for elementwise
work, at the padded shapes the model runs (``n_nodes`` rows a graph).
A training step counts three forward passes (forward, and the backward's
two products per forward product).
"""

from __future__ import annotations

from typing import Dict, Tuple

# H100 SXM, NVIDIA's data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,     # f32 outside the tensor cores
              "bfloat16": 989e12}   # bf16 on the tensor cores


def bound(nbytes: float, flops: float, flops_per_s: float = PEAK_FLOPS[
        "float32"]) -> Tuple[float, str]:
    """Least time in ms for ``nbytes`` and ``flops``, and which of the two
    sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def adjacency_work(b: int, n: int, e: int) -> Tuple[int, int]:
    """(bytes, operations) of kernel 1: read edges and masks, write
    ``[B, N, N]`` f32."""
    return b * 3 * e * 4 + b * n * n * 4, b * e


def attention_fwd_work(b: int, n: int, f: int) -> Tuple[int, int]:
    """(bytes, operations) of kernel 2: read q, k, v, the mask, write out."""
    return (3 * b * n * f * 4 + b * n * 4 + b * n * f * 4,
            4 * b * n * n * f + 5 * b * n * n)


def attention_bwd_work(b: int, n: int, f: int) -> Tuple[int, int]:
    """(bytes, operations) of kernel 3."""
    return (4 * (4 * b * n * f + b * n + 3 * b * n * f),
            10 * b * n * n * f)


def forward_flops_per_row(model: Dict, n_nodes: int) -> int:
    """FLOPs of one molecule's forward pass through the hybrid."""
    f, n = model["in_features"], n_nodes
    fc, go = model["graph_fc_hidden"], model["graph_out"]
    bits, ch = model["fp_bits"], list(model["cnn_channels"])
    h, hc = model["cnn_fc_hidden"], model["combined_hidden"]
    graph = (3 * 2 * n * f * f           # Q, K, V
             + 2 * 2 * n * f * f          # centre taps of conv3, conv5
             + 2 * n * 3 * f * f          # linear_transform
             + 2 * 2 * n * n * f          # scores, attn @ v
             + 2 * n * n * f              # adj @ x
             + 2 * 2 * n * f * f          # lin_l, lin_r
             + 2 * f * fc + 2 * fc * go + 2 * go)
    widths = [1] + ch
    cnn = sum(2 * bits * widths[i] * widths[i + 1] * 3
              for i in range(len(ch)))
    cnn += 2 * bits * ch[-1] * h + 2 * h * bits
    head = 2 * (1 + bits) * hc + 2 * hc
    return graph + cnn + head


def kernel_bound_s(kind: str, batches: Dict[int, int], n: int, e: int,
                   f: int) -> float:
    """Least seconds for ``batches`` (batch size -> count) of one kernel's
    work at ``N = n``, ``E = e``, ``F = f`` (its f32 peak: kernels 1-3
    take f32 in every configuration)."""
    total = 0.0
    for b, count in batches.items():
        if kind == "adjacency":
            nbytes, ops = adjacency_work(b, n, e)
        elif kind == "attention_fwd":
            nbytes, ops = attention_fwd_work(b, n, f)
        elif kind == "attention_bwd":
            nbytes, ops = attention_bwd_work(b, n, f)
        else:
            raise ValueError(f"unknown kernel {kind!r}")
        total += count * bound(nbytes, ops)[0] / 1e3
    return total
