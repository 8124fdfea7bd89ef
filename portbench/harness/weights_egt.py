"""Seeded weights of EGT (EGT-110M) that the cell ``egt_110m.train`` runs,
made on the device by the benchmark and handed to the program and the
reference alike, as ``weights_gps.py`` makes GraphGPS's.

The names and shapes are the program's ``state_dict``'s
(``reference/egt.py`` reads the same names).  A linear layer's weight and
bias are drawn U(+-1/sqrt(fan_in)), PyTorch's default; a table (the
distance and bond embeddings, the virtual nodes' node and pair rows) U(+-
sqrt(3)), the spread of the public code's embeddings (std 1, torch's
``nn.Embedding`` and ``normal_`` defaults); a layer norm's weight is 1 and
its bias 0.  All come from one ``torch.rand`` call on a
``torch.Generator`` of the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

TABLE_BOUND = math.sqrt(3.0)


def param_table(model: Dict) -> List[Tuple[str, Tuple[int, ...], str,
                                           float]]:
    """``(name, shape, kind, bound)`` of every parameter in the program's
    ``state_dict`` order; ``kind`` is ``uniform``, ``ones`` or ``zeros``.
    ``model`` is a configuration's ``"model"`` group."""
    f, d, c = model["in_features"], model["hidden_size"], model["pair_size"]
    h, v = model["num_attention_heads"], model["virtual_nodes"]
    ffn, pffn = model["ffn_hidden_size"], model["pair_ffn_size"]
    layers = model["num_hidden_layers"]
    rows: List[Tuple[str, Tuple[int, ...], str, float]] = []

    def linear(name, n_in, n_out, bias=True):
        b = 1.0 / math.sqrt(n_in)
        rows.append((name + ".weight", (n_out, n_in), "uniform", b))
        if bias:
            rows.append((name + ".bias", (n_out,), "uniform", b))

    def table(name, *shape):
        rows.append((name + ".weight", shape, "uniform", TABLE_BOUND))

    def norm(name, width):
        rows.extend([(name + ".weight", (width,), "ones", 0.0),
                     (name + ".bias", (width,), "zeros", 0.0)])

    linear("atom_encoder", f, d, bias=False)
    linear("svd_encoder", 2 * model["svd_rank"], d)
    table("distance", model["max_distance"] + 2, c)
    table("bond", model["num_bond_types"], c)
    table("virtual_node", v, d)
    table("virtual_pair", v, c)
    for i in range(layers):
        p = f"layers.{i}."
        norm(p + "node_norm", d)
        norm(p + "pair_norm", c)
        for proj in ("q_proj", "k_proj", "v_proj"):
            linear(p + proj, d, d)
        linear(p + "E", c, h)
        linear(p + "G", c, h)
        linear(p + "out_proj", d, d)
        norm(p + "ffn_norm", d)
        linear(p + "fc1", d, ffn)
        linear(p + "fc2", ffn, d)
        if i < layers - 1:
            linear(p + "pair_out", h, c)
            norm(p + "pair_ffn_norm", c)
            linear(p + "pair_fc1", c, pffn)
            linear(p + "pair_fc2", pffn, c)
    norm("final_norm", d)
    linear("head_fc1", v * d, d)
    linear("head_fc2", d, d)
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
