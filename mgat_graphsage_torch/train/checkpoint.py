"""Checkpoints of the port: ``torch.save`` of ``{"step", "state_dict"}``,
plus ``"optimizer"`` (the optimizer's ``state_dict``) in a full
checkpoint, and the reference package's JSON sidecar schema (``config``,
``scaler``, ``max_nodes``, ``max_edges``, ``light``) at ``<path>.json``.

A light checkpoint (no optimizer state) is enough to serve
(``eval/predict.py``) and to select the best model; a full one resumes
training.  Everything is written from the CPU, so a checkpoint loads on
any device.  Reading the reference package's flax-msgpack checkpoints is
not supported yet: carry weights and Adam state over with
``models/convert.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_is_light",
           "latest_checkpoint"]


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
    checkpoint) as a fourth item."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    out = (blob["state_dict"], int(blob["step"]), meta)
    return out + (blob.get("optimizer"),) if with_optimizer else out


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
