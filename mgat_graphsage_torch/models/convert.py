"""Carry parameters between the reference package's flax tree and the
port's ``state_dict``.

The flax tree of ``HybridModel`` is ``gat_graphsage/{conv1/{query,key,
value,linear}_transform, conv1/{conv3,conv5}, conv2/{lin_l,lin_r}, fc_g1,
fc_g2, out}``, ``cnn/{conv1..3, fc1, fc2}`` and ``combined/{fc1, fc2}``;
the baselines' are their layers' names (``conv1/lin``, ``gcn1/att_src``,
``bn1/scale``, ...).  The port's modules carry the same names, so a path
maps to a key by joining it with dots.  Leaves:

- ``kernel [in, out]`` (dense) -> ``weight = kernel.T``;
- ``kernel [K, I, O]`` (conv)  -> ``weight = kernel.transpose(2, 1, 0)``;
- ``weight [out, in, k]`` (center-tap conv), ``bias``, GAT's ``att_src``
  and ``att_dst [1, H, C]`` and batch norm's ``scale`` -> as they are.

The ``batch_stats`` collection (``MaskedBatchNorm``'s running ``mean`` and
``var``) maps to the modules' buffers of the same names, f32 both sides.

The CNN fc1 rows are pos-major on both sides (``models/layers.py::
CNNNet``), so no permutation is needed.  The tree holds numpy arrays (the
JAX side converts with ``jax.device_get``); nothing here imports JAX.

The Adam state crosses too: the reference's ``optax.ScaleByAdamState``
(``count``, and ``mu``, ``nu`` trees shaped like the parameters, f32 or
bf16, with ``(r, c)`` pairs for factored second moments) maps to the
``state_dict`` of ``torch.optim.Adam`` or of the port's
``train/optim.py::TorchAdam`` (per parameter ``step``, ``exp_avg``,
``exp_avg_sq``, or ``exp_avg_sq_row`` and ``exp_avg_sq_col``) by the same
leaf rules, so a run trained in JAX resumes in the port and back.  numpy
has no bfloat16 of its own: a bf16 array is recognised by its dtype's
name and crosses through a 16-bit integer view, so nothing here imports
``ml_dtypes``.  A tree's leaf may also be a tensor already (the bf16
leaves that ``train/checkpoint.py`` decodes from a msgpack checkpoint
without ``ml_dtypes``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .layers import CenterTapConv1d

__all__ = ["params_from_jax", "params_to_jax", "batch_stats_to_jax",
           "adam_state_from_jax", "adam_state_to_jax"]

# leaves that cross as they are (no transpose)
_AS_IS = ("weight", "bias", "att_src", "att_dst", "scale")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _from_numpy(a) -> torch.Tensor:
    """An owned tensor of ``a`` (a numpy array or a tensor).  A bf16 array
    (``ml_dtypes.bfloat16``, which numpy knows only by name) crosses
    through its 16-bit view."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().clone()
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``.  A bf16 tensor comes out as numpy's
    ``bfloat16`` where a library has registered it (JAX does), else
    widened to f32, which holds every bf16 value exactly."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    except TypeError:
        return t.float().numpy()


def params_from_jax(tree, batch_stats=None) -> Dict[str, torch.Tensor]:
    """flax parameter tree of numpy arrays (and its ``batch_stats`` tree,
    where the model has batch norms) -> port ``state_dict``."""
    sd = {}
    for path, a in _flatten(batch_stats or {}):
        if path[-1] not in ("mean", "var"):
            raise ValueError(f"unknown batch_stats leaf {'/'.join(path)}")
        sd[".".join(path)] = _from_numpy(a)
    for path, a in _flatten(tree):
        tensor = isinstance(a, torch.Tensor)
        a = a if tensor else np.asarray(a)
        leaf = path[-1]
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 3:
                a = a.permute(2, 1, 0) if tensor else a.transpose(2, 1, 0)
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            leaf = "weight"
        elif leaf not in _AS_IS:
            raise ValueError(f"unknown parameter leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (leaf,))
        sd[key] = _from_numpy(a)
    return sd


def _tree(model: nn.Module, leaf: Callable[[torch.Tensor], object]) -> Dict:
    """flax-shaped tree of ``leaf(param)`` for every parameter: a tensor,
    or for a factored second moment the ``(row, col)`` factors of the
    ``[out, in]`` weight, which are the reference's ``(c, r)`` of its
    ``[in, out]`` kernel."""
    tree: Dict = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            a = leaf(p)
            kernel = pname == "weight" and \
                not isinstance(module, CenterTapConv1d)
            if isinstance(a, tuple):              # (row, col) -> (r, c)
                a = (_to_numpy(a[1]), _to_numpy(a[0]))
            else:
                a = _to_numpy(a)
                if kernel:
                    a = np.ascontiguousarray(
                        a.T if a.ndim == 2 else a.transpose(2, 1, 0))
            node = tree
            for part in (mname.split(".") if mname else []):
                node = node.setdefault(part, {})
            node["kernel" if kernel else pname] = a
    return tree


def params_to_jax(model: nn.Module) -> Dict:
    """Port module -> flax parameter tree of numpy arrays (the inverse of
    :func:`params_from_jax`)."""
    return _tree(model, lambda p: p)


def batch_stats_to_jax(model: nn.Module) -> Dict:
    """Port module -> flax ``batch_stats`` tree of numpy arrays (the
    buffers; empty for a model with no batch norm)."""
    tree: Dict = {}
    for name, b in model.named_buffers():
        *mods, leaf = name.split(".")
        node = tree
        for part in mods:
            node = node.setdefault(part, {})
        node[leaf] = _to_numpy(b)
    return tree


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _factored_from_jax(nu) -> Tuple[Dict, Dict]:
    """Split the reference's ``nu`` tree into the full second moments and
    the factored ones (``(r, c)`` tuples), keyed by ``state_dict`` name."""
    full, factored = {}, {}
    for path, v in _flatten(nu):
        if isinstance(v, tuple):
            name = ".".join(path[:-1] + ("weight",))
            r, c = (_from_numpy(x) for x in v)
            factored[name] = (c, r)       # (row, col) of the [out, in] weight
        else:
            full[path] = v
    tree: Dict = {}
    for path, v in full.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    return params_from_jax(tree), factored


def adam_state_from_jax(opt_state, model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> Dict:
    """The reference's Adam state (``count``, ``mu``, ``nu`` as numpy
    trees: an ``optax.ScaleByAdamState`` after ``jax.device_get``, or a
    dict) -> a ``state_dict`` for ``optimizer`` over
    ``model.parameters()``.  Moments keep their dtype (f32 or bf16); a
    factored second moment ``(r, c)`` becomes ``exp_avg_sq_row`` and
    ``exp_avg_sq_col`` (``train/optim.py::TorchAdam``)."""
    count = int(np.asarray(_field(opt_state, "count")))
    mu = params_from_jax(_field(opt_state, "mu"))
    nu, factored = _factored_from_jax(_field(opt_state, "nu"))
    sd = optimizer.state_dict()
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, p in enumerate(params):
        n = names[id(p)]
        state[i] = {"step": torch.tensor(float(count)),
                    "exp_avg": mu[n].to(p.device)}
        if n in factored:
            state[i]["exp_avg_sq_row"] = factored[n][0].to(p.device)
            state[i]["exp_avg_sq_col"] = factored[n][1].to(p.device)
        else:
            state[i]["exp_avg_sq"] = nu[n].to(p.device)
    return {"state": state, "param_groups": sd["param_groups"]}


def adam_state_to_jax(model: nn.Module,
                      optimizer: torch.optim.Optimizer) -> Dict:
    """The inverse of :func:`adam_state_from_jax`: ``{"count": int32,
    "mu": tree, "nu": tree}`` of numpy arrays (zeros before the first
    step), bf16 moments as bf16 (see :func:`_to_numpy`), a factored
    second moment as its ``(r, c)`` pair."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    state = optimizer.state_dict()["state"]
    mdt = getattr(optimizer, "moment_dtype", None)

    def moment(key):
        def leaf(p):
            s = state.get(index[id(p)])
            if s and key == "exp_avg_sq" and "exp_avg_sq_row" in s:
                return s["exp_avg_sq_row"], s["exp_avg_sq_col"]
            return s[key] if s else torch.zeros_like(p, dtype=mdt)
        return _tree(model, leaf)

    steps = {int(s["step"]) for s in state.values()} or {0}
    if len(steps) != 1:
        raise ValueError(f"parameters were stepped unevenly: {steps}")
    return {"count": np.int32(steps.pop()), "mu": moment("exp_avg"),
            "nu": moment("exp_avg_sq")}
