"""Bounded CUDA liveness probe (the port's copy of
``mgat_graphsage_tpu/utils/backend.py``).

A CUDA installation or card that has gone bad can make the first CUDA
call in a process block.  Probing in a subprocess with a timeout keeps
the CALLER's process hang-free.  There is no CPU fallback: a caller that needs the
card learns that it is not there and decides (a measurement aborts rather
than report CPU numbers).
"""

from __future__ import annotations

import subprocess
import sys

__all__ = ["probe_backend"]

_PROBE_SRC = (
    "import torch\n"
    "if not torch.cuda.is_available():\n"
    "    raise SystemExit('torch.cuda.is_available() is False')\n"
    "torch.zeros(1, device='cuda').add_(1).item()\n"
    "print('cuda')\n")


def probe_backend(timeout_s: int = 240) -> str:
    """Initialise CUDA and run one kernel in a bounded subprocess.

    Returns ``'cuda'`` on success; raises ``RuntimeError`` if there is no
    CUDA device, the probe fails, or it does not finish within
    ``timeout_s``."""
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        raise RuntimeError(
            f"CUDA did not initialise within {timeout_s}s; aborting "
            "instead of hanging")
    if r.returncode != 0:
        raise RuntimeError(
            f"CUDA probe failed (rc={r.returncode}): "
            f"{(r.stderr.strip() or r.stdout.strip())[-400:]}")
    return r.stdout.strip().splitlines()[-1]
