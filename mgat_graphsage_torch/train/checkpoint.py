"""Checkpoints of the port: ``torch.save`` of ``{"step", "state_dict"}``,
plus ``"optimizer"`` (the optimizer's ``state_dict``) in a full
checkpoint, and the reference package's JSON sidecar schema (``config``,
``scaler``, ``max_nodes``, ``max_edges``, ``light``) at ``<path>.json``.

A light checkpoint (no optimizer state) is enough to serve
(``eval/predict.py``) and to select the best model; a full one resumes
training.  Everything is written from the CPU, so a checkpoint loads on
any device.

:func:`load_checkpoint` also reads the reference package's checkpoints
(``<path>.msgpack``, ``flax.serialization.to_bytes`` of its train state,
with the same sidecar), so ``Predictor``, ``serve.py`` and
``Trainer.load`` take them as they are.  They are decoded with
``msgpack`` alone (:func:`read_msgpack_checkpoint`: flax's ndarray and
numpy-scalar extension types, and its chunked arrays; bf16 arrays become
bf16 tensors, so neither flax, JAX nor ``ml_dtypes`` is needed) and
mapped through ``models/convert.py``: the parameters and ``batch_stats``
to a ``state_dict`` here, the Adam state (``count``, ``mu``, ``nu``) by
``Trainer.load`` through ``adam_state_from_jax``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_is_light",
           "latest_checkpoint", "read_msgpack_checkpoint",
           "jax_adam_state"]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    metadata: Optional[Dict] = None, step: int = 0,
                    optimizer_state: Optional[Dict] = None) -> None:
    """Write ``state_dict`` (and ``optimizer_state`` for a full checkpoint;
    without it the checkpoint is light) and the JSON sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"step": int(step), "state_dict": _to_cpu(state_dict)}
    if optimizer_state is not None:
        blob["optimizer"] = _to_cpu(optimizer_state)
    torch.save(blob, path)
    meta = dict(metadata or {})
    meta["light"] = optimizer_state is None
    with open(path + ".json", "w") as f:
        json.dump(_jsonify(meta), f, indent=2)


def load_checkpoint(path: str, map_location="cpu",
                    with_optimizer: bool = False):
    """Return ``(state_dict, step, sidecar)``, and with
    ``with_optimizer=True`` also the optimizer state (None for a light
    checkpoint) as a fourth item.  For a reference package checkpoint
    (``.msgpack``) that fourth item is its Adam state as
    :func:`jax_adam_state` gives it, for ``adam_state_from_jax``."""
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    if path.endswith(".msgpack"):
        from ..models.convert import params_from_jax

        tree = read_msgpack_checkpoint(path)
        sd = {k: v.to(map_location) for k, v in params_from_jax(
            tree["params"], tree.get("batch_stats") or None).items()}
        out = (sd, int(np.asarray(tree["step"])), meta)
        return out + (jax_adam_state(tree.get("opt_state")),) \
            if with_optimizer else out
    blob = torch.load(path, map_location=map_location, weights_only=True)
    out = (blob["state_dict"], int(blob["step"]), meta)
    return out + (blob.get("optimizer"),) if with_optimizer else out


_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3    # flax.serialization's extension types


def _decode_array(data: bytes):
    """flax's ndarray encoding, a msgpack ``(shape, dtype name, bytes)``:
    a numpy array, or a bf16 tensor for ``bfloat16`` (which numpy has no
    type for)."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _decode_array(data)
    if code == _EXT_NPSCALAR:
        a = _decode_array(data)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack extension type {code} is not one a "
                     "checkpoint holds")


def _unchunk(tree):
    """flax's chunked form of an array above 1 GiB (``{"__msgpack_
    chunked_array__": True, "shape": {"0": ..}, "chunks": {"0": ..}}``)
    back to the array, throughout the tree."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = torch.cat(chunks) if isinstance(chunks[0], torch.Tensor) \
            else np.concatenate(chunks)
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack_checkpoint(path: str) -> Dict:
    """The reference package's checkpoint at ``path`` as a tree of dicts
    with numpy (or, for bf16, tensor) leaves: ``step``, ``params``,
    ``batch_stats`` and, in a full checkpoint, ``opt_state``."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def _tuples(tree):
    """A serialized tuple (``{"0": .., "1": ..}``, as a factored second
    moment ``(r, c)`` is stored) back to a tuple, throughout the tree."""
    if not isinstance(tree, dict):
        return tree
    if tree and set(tree) == {str(i) for i in range(len(tree))}:
        return tuple(_tuples(tree[str(i)]) for i in range(len(tree)))
    return {k: _tuples(v) for k, v in tree.items()}


def jax_adam_state(opt_state) -> Optional[Dict]:
    """The Adam state (``{"count", "mu", "nu"}``, factored second moments
    as ``(r, c)`` tuples) found in a decoded optax state, or None (a light
    checkpoint)."""
    if not isinstance(opt_state, dict):
        return None
    if {"count", "mu", "nu"} <= set(opt_state):
        return {"count": opt_state["count"], "mu": opt_state["mu"],
                "nu": _tuples(opt_state["nu"])}
    for v in opt_state.values():
        found = jax_adam_state(v)
        if found is not None:
            return found
    return None


def checkpoint_is_light(path: str) -> bool:
    """What the sidecar says (a checkpoint without one counts as full)."""
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            return bool(json.load(f).get("light", False))
    return False


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_") -> Optional[str]:
    """The ``<prefix><step>.pt`` in ``ckpt_dir`` with the largest step, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in os.listdir(ckpt_dir):
        stem = f[len(prefix):-len(".pt")]
        if f.startswith(prefix) and f.endswith(".pt") and stem.isdigit():
            steps.append((int(stem), f))
    return os.path.join(ckpt_dir, max(steps)[1]) if steps else None


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
