"""Seeded weights of the graph transformer (Graphormer) that the cell
``graphormer_base.train`` runs, made on the device by the benchmark and
handed to the program and the reference alike, as ``weights.py`` makes
the hybrid's.

The names and shapes are the program's ``state_dict``'s
(``reference/graphormer.py`` reads the same names).  A linear layer's
weight and bias are drawn U(+-1/sqrt(fan_in)), PyTorch's default; a
table (the degree, token and distance embeddings, the edge encoder) is
drawn U(+-0.02 sqrt(3)), the public code's embedding spread (std 0.02);
a layer norm's weight is 1 and its bias 0.  All come from one
``torch.rand`` call on a ``torch.Generator`` of the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

TABLE_BOUND = 0.02 * math.sqrt(3.0)


def param_table(model: Dict) -> List[Tuple[str, Tuple[int, ...], str,
                                           float]]:
    """``(name, shape, kind, bound)`` of every parameter in the program's
    ``state_dict`` order; ``kind`` is ``uniform``, ``ones`` or ``zeros``.
    ``model`` is a configuration's ``"model"`` group."""
    f, d = model["in_features"], model["hidden_size"]
    ffn, h = model["ffn_hidden_size"], model["num_attention_heads"]
    hops = model["multi_hop_max_dist"]
    rows: List[Tuple[str, Tuple[int, ...], str, float]] = []

    def linear(name, n_in, n_out, bias=True):
        b = 1.0 / math.sqrt(n_in)
        rows.append((name + ".weight", (n_out, n_in), "uniform", b))
        if bias:
            rows.append((name + ".bias", (n_out,), "uniform", b))

    def table(name, *shape):
        rows.append((name + ".weight", tuple(shape), "uniform", TABLE_BOUND))

    def norm(name):
        rows.append((name + ".weight", (d,), "ones", 0.0))
        rows.append((name + ".bias", (d,), "zeros", 0.0))

    linear("atom_encoder", f, d, bias=False)
    table("in_degree", model["num_in_degree"], d)
    table("out_degree", model["num_out_degree"], d)
    table("graph_token", 1, d)
    table("bias.spatial", model["num_spatial"], h)
    table("bias.virtual_distance", 1, h)
    table("bias.edge_type", model["num_bond_types"], h)
    table("bias.edge_hop", hops, h, h)
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        norm(p + "attn_norm")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(p + proj, d, d)
        norm(p + "ffn_norm")
        linear(p + "fc1", d, ffn)
        linear(p + "fc2", ffn, d)
    linear("head_transform", d, d)
    norm("head_norm")
    linear("head_out", d, 1)
    return rows


def num_params(model: Dict) -> int:
    return sum(int(torch.Size(s).numel()) for _, s, _, _ in
               param_table(model))


def make_weights(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device``, from ``seed`` alone."""
    table = param_table(model)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in table]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, kind, bound), n in zip(table, sizes):
        t = flat[off:off + n].view(shape)
        if kind == "uniform":
            out[name] = t.mul_(2.0 * bound).sub_(bound)
        else:
            out[name] = t.fill_(1.0 if kind == "ones" else 0.0)
        off += n
    return out
