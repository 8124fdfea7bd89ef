"""Seeded weights of GraphGPS (GPS-medium) that the cell
``graphgps_medium.train`` runs, made on the device by the benchmark and
handed to the program and the reference alike, as
``weights_graphormer.py`` makes Graphormer's.

The names and shapes are the program's ``state_dict``'s, the batch norms'
running statistics included (``reference/gps.py`` reads the same names).
A linear layer's weight and bias are drawn U(+-1/sqrt(fan_in)), PyTorch's
default; the bond table U(+-0.02 sqrt(3)) (std 0.02, as
``weights_graphormer.py`` draws its tables); a batch norm's scale is 1 and
its bias 0, its running mean 0 and variance 1.  All come from one
``torch.rand`` call on a ``torch.Generator`` of the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .weights_graphormer import TABLE_BOUND

BUFFERS = (".mean", ".var")


def param_table(model: Dict) -> List[Tuple[str, Tuple[int, ...], str,
                                           float]]:
    """``(name, shape, kind, bound)`` of every tensor of the program's
    ``state_dict``, in its order; ``kind`` is ``uniform``, ``ones`` or
    ``zeros``.  ``model`` is a configuration's ``"model"`` group."""
    f, d = model["in_features"], model["hidden_size"]
    ffn, pe, steps = model["ffn_hidden_size"], model["pe_dim"], \
        model["rwse_steps"]
    rows: List[Tuple[str, Tuple[int, ...], str, float]] = []

    def linear(name, n_in, n_out, bias=True):
        b = 1.0 / math.sqrt(n_in)
        rows.append((name + ".weight", (n_out, n_in), "uniform", b))
        if bias:
            rows.append((name + ".bias", (n_out,), "uniform", b))

    def norm(name, width=d):
        rows.extend([(name + ".scale", (width,), "ones", 0.0),
                     (name + ".bias", (width,), "zeros", 0.0),
                     (name + ".mean", (width,), "zeros", 0.0),
                     (name + ".var", (width,), "ones", 0.0)])

    linear("atom_encoder", f, d - pe, bias=False)
    norm("rwse_norm", steps)
    linear("rwse_encoder", steps, pe)
    rows.append(("bond_encoder.weight", (model["num_bond_types"], d),
                 "uniform", TABLE_BOUND))
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        for name in "ABCDE":
            linear(p + "local_model." + name, d, d)
        norm(p + "local_model.bn_node_x")
        norm(p + "local_model.bn_edge_e")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(p + proj, d, d)
        norm(p + "norm1_local")
        norm(p + "norm1_attn")
        linear(p + "ff_linear1", d, ffn)
        linear(p + "ff_linear2", ffn, d)
        norm(p + "norm2")
    linear("head_fc1", d, d // 2)
    linear("head_fc2", d // 2, d // 4)
    linear("head_out", d // 4, 1)
    return rows


def is_buffer(name: str) -> bool:
    """A batch norm's running statistic, not a parameter."""
    return name.endswith(BUFFERS)


def num_params(model: Dict) -> int:
    """Parameters, the running statistics left out."""
    return sum(int(torch.Size(s).numel()) for n, s, _, _ in
               param_table(model) if not is_buffer(n))


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
