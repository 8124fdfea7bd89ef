"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a quiet fall-back to the CPU.  Under a
process group the default is the rank's own card."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``, and under an initialised process group
    ``cuda:{LOCAL_RANK % device_count}`` (the rank where ``LOCAL_RANK`` is
    not set).  Raises if CUDA is asked for (or implied) and is not
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the port on the CPU")
    dist = torch.distributed
    if device is None and dist.is_available() and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev
