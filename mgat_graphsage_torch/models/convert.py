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

The Adam state crosses too: the reference's ``optax.ScaleByAdamState``
(``count``, and ``mu``, ``nu`` trees shaped like the parameters, f32) maps
to a ``torch.optim.Adam`` ``state_dict`` (per parameter ``step``,
``exp_avg``, ``exp_avg_sq``) by the same leaf rules, so a run trained in
JAX resumes in the port and back.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from .layers import CenterTapConv1d

__all__ = ["params_from_jax", "params_to_jax", "adam_state_from_jax",
           "adam_state_to_jax"]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax parameter tree of numpy arrays -> port ``state_dict``."""
    sd = {}
    for path, a in _flatten(tree):
        a = np.asarray(a)
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


def _tree(model: nn.Module, leaf: Callable[[torch.Tensor], torch.Tensor]
          ) -> Dict:
    """flax-shaped tree of ``leaf(param)`` for every parameter."""
    tree: Dict = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            a = leaf(p).detach().cpu().numpy()
            if pname == "weight" and not isinstance(module, CenterTapConv1d):
                a = a.T if a.ndim == 2 else a.transpose(2, 1, 0)
                pname = "kernel"
            node = tree
            for part in (mname.split(".") if mname else []):
                node = node.setdefault(part, {})
            node[pname] = np.ascontiguousarray(a)
    return tree


def params_to_jax(model: nn.Module) -> Dict:
    """Port module -> flax parameter tree of numpy arrays (the inverse of
    :func:`params_from_jax`)."""
    return _tree(model, lambda p: p)


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def adam_state_from_jax(opt_state, model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> Dict:
    """The reference's Adam state (``count``, ``mu``, ``nu`` as numpy
    trees: an ``optax.ScaleByAdamState`` after ``jax.device_get``, or a
    dict) -> a ``state_dict`` for ``optimizer`` (a ``torch.optim.Adam``
    over ``model.parameters()``)."""
    if any(isinstance(v, tuple) for _, v in _flatten(_field(opt_state,
                                                            "nu"))):
        raise NotImplementedError("a factored second moment "
                                  "(adam_factored_v) is not ported yet")
    count = int(np.asarray(_field(opt_state, "count")))
    mu = params_from_jax(_field(opt_state, "mu"))
    nu = params_from_jax(_field(opt_state, "nu"))
    sd = optimizer.state_dict()
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, p in enumerate(params):
        n = names[id(p)]
        state[i] = {"step": torch.tensor(float(count)),
                    "exp_avg": mu[n].to(p.device),
                    "exp_avg_sq": nu[n].to(p.device)}
    return {"state": state, "param_groups": sd["param_groups"]}


def adam_state_to_jax(model: nn.Module,
                      optimizer: torch.optim.Optimizer) -> Dict:
    """The inverse of :func:`adam_state_from_jax`: ``{"count": int32,
    "mu": tree, "nu": tree}`` of numpy arrays (zeros before the first
    step)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    state = optimizer.state_dict()["state"]

    def moment(key):
        def leaf(p):
            s = state.get(index[id(p)])
            return s[key] if s else torch.zeros_like(p)
        return _tree(model, leaf)

    steps = {int(s["step"]) for s in state.values()} or {0}
    if len(steps) != 1:
        raise ValueError(f"parameters were stepped unevenly: {steps}")
    return {"count": np.int32(steps.pop()), "mu": moment("exp_avg"),
            "nu": moment("exp_avg_sq")}

