"""Checkpoints of the port: ``torch.save`` of ``{"step", "state_dict"}``
plus the reference package's JSON sidecar schema (``config``, ``scaler``,
``max_nodes``, ``max_edges``, ``light``) at ``<path>.json``.

The port writes light checkpoints only (no optimizer state) until its
trainer lands.  Reading the reference package's flax-msgpack checkpoints
is not supported yet: carry weights over with ``models/convert.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    metadata: Optional[Dict] = None, step: int = 0) -> None:
    """Write ``state_dict`` (moved to the CPU) and the JSON sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"step": int(step), "state_dict": cpu}, path)
    meta = dict(metadata or {})
    meta["light"] = True
    with open(path + ".json", "w") as f:
        json.dump(_jsonify(meta), f, indent=2)


def load_checkpoint(path: str, map_location="cpu"
                    ) -> Tuple[Dict[str, torch.Tensor], int, Dict]:
    """Return ``(state_dict, step, sidecar)``."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return blob["state_dict"], int(blob["step"]), meta


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
