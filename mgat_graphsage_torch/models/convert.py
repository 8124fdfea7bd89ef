"""Carry parameters between the reference package's flax tree and the
port's ``state_dict``.

The flax tree of ``HybridModel`` is ``gat_graphsage/{conv1/{query,key,
value,linear}_transform, conv1/{conv3,conv5}, conv2/{lin_l,lin_r}, fc_g1,
fc_g2, out}``, ``cnn/{conv1..3, fc1, fc2}`` and ``combined/{fc1, fc2}``;
the port's modules carry the same names, so a path maps to a key by
joining it with dots.  Leaves:

- ``kernel [in, out]`` (dense) -> ``weight = kernel.T``;
- ``kernel [K, I, O]`` (conv)  -> ``weight = kernel.transpose(2, 1, 0)``;
- ``weight [out, in, k]`` (center-tap conv) and ``bias`` -> as they are.

The CNN fc1 rows are pos-major on both sides (``models/layers.py::
CNNNet``), so no permutation is needed.  The tree holds numpy arrays (the
JAX side converts with ``jax.device_get``); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .layers import CenterTapConv1d

__all__ = ["params_from_jax", "params_to_jax"]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax parameter tree of numpy arrays -> port ``state_dict``."""
    sd = {}
    for path, a in _flatten(tree):
        leaf = path[-1]
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 3:
                a = a.transpose(2, 1, 0)
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            leaf = "weight"
        elif leaf not in ("weight", "bias"):
            raise ValueError(f"unknown parameter leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (leaf,))
        sd[key] = torch.from_numpy(np.array(a, order="C"))  # owned copy
    return sd


def params_to_jax(model: nn.Module) -> Dict:
    """Port module -> flax parameter tree of numpy arrays (the inverse of
    :func:`params_from_jax`)."""
    tree: Dict = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            a = p.detach().cpu().numpy()
            if pname == "weight" and not isinstance(module, CenterTapConv1d):
                a = a.T if a.ndim == 2 else a.transpose(2, 1, 0)
                pname = "kernel"
            node = tree
            for part in (mname.split(".") if mname else []):
                node = node.setdefault(part, {})
            node[pname] = np.ascontiguousarray(a)
    return tree
