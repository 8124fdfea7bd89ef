"""Seeded weights of the hybrid, made on the device by the benchmark and
handed to the program and the reference alike.

The names and shapes are the architecture's (``reference/model.py`` reads
the same names); each tensor is drawn U(+-1/sqrt(fan_in)), PyTorch's
default initialisation, from one ``torch.rand`` call over all of them on a
``torch.Generator`` of the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def param_table(model: Dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """``(name, shape, fan_in)`` of every parameter, in the program's
    ``state_dict`` order.  ``model`` is a configuration's ``"model"``
    group."""
    f = model["in_features"]
    fc = model["graph_fc_hidden"]
    go = model["graph_out"]
    bits = model["fp_bits"]
    ch = model["cnn_channels"]
    h = model["cnn_fc_hidden"]
    ch_hidden = model["combined_hidden"]
    rows: List[Tuple[str, Tuple[int, ...], int]] = []

    def linear(name, n_in, n_out, bias=True):
        rows.append((name + ".weight", (n_out, n_in), n_in))
        if bias:
            rows.append((name + ".bias", (n_out,), n_in))

    def conv(name, c_in, c_out, k):
        rows.append((name + ".weight", (c_out, c_in, k), c_in * k))
        rows.append((name + ".bias", (c_out,), c_in * k))

    g = "gat_graphsage."
    for t in ("query", "key", "value"):
        linear(f"{g}conv1.{t}_transform", f, f)
    conv(g + "conv1.conv3", f, f, 3)
    conv(g + "conv1.conv5", f, f, 5)
    linear(g + "conv1.linear_transform", 3 * f, f)
    linear(g + "conv2.lin_l", f, f)
    linear(g + "conv2.lin_r", f, f, bias=False)
    linear(g + "fc_g1", f, fc)
    linear(g + "fc_g2", fc, go)
    linear(g + "out", go, 1)
    widths = [1] + list(ch)
    for i in range(len(ch)):
        conv(f"cnn.conv{i + 1}", widths[i], widths[i + 1], 3)
    linear("cnn.fc1", bits * ch[-1], h)
    linear("cnn.fc2", h, bits)
    linear("combined.fc1", 1 + bits, ch_hidden)
    linear("combined.fc2", ch_hidden, 1)
    return rows


def num_params(model: Dict) -> int:
    n = 0
    for _, shape, _ in param_table(model):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def make_weights(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device``, from ``seed`` alone."""
    table = param_table(model)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in table]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, fan_in), n in zip(table, sizes):
        bound = 1.0 / fan_in ** 0.5
        out[name] = flat[off:off + n].view(shape).mul_(2.0 * bound) \
            .sub_(bound)
        off += n
    return out
