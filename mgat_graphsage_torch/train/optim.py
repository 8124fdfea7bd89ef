"""Optimizer and learning-rate schedule of the port's trainer (port of
``mgat_graphsage_tpu/train/trainer.py::make_optimizer`` and
``_lr_schedule``, with ``train/optim.py::torch_adam`` at f32 moments).

The reference's optimizer is torch's Adam: L2 weight decay added to the
gradient before the moments (not decoupled AdamW), f32 moments, bias
corrections on the 1-based step count.  ``torch.optim.Adam(lr,
weight_decay=...)`` has exactly these semantics, so the port uses it.  The
schedule is the reference formula evaluated in f32 on the host once per
step.  bf16 moments, the factored second moment and the bf16 master with
stochastic rounding are not ported yet: :func:`check_ported` refuses them.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch
from torch import nn

__all__ = ["lr_schedule", "make_optimizer", "set_lr", "check_ported"]

# what each knob that is not ported yet waits for (ROADMAP.md, Queue 1)
_NOT_PORTED = {
    "compute_dtype": ("float32", "bf16 compute is not ported yet (ROADMAP "
                      "Queue 1 item 3)"),
    "master_dtype": ("float32", "the bf16 master with stochastic rounding "
                     "is not ported yet (ROADMAP Queue 1 item 3)"),
    "adam_moment_dtype": ("float32", "bf16 Adam moments are not ported yet "
                          "(ROADMAP Queue 1 item 3)"),
    "adam_factored_v": (False, "the factored Adam second moment is not "
                        "ported yet (ROADMAP Queue 1 item 3)"),
    "remat": (False, "remat (recompute activations in the backward) is not "
              "ported yet (ROADMAP Queue 1 item 3)"),
    "dataset_storage": ("float32", "compact dataset storage is not ported "
                        "yet (ROADMAP Queue 1 item 6)"),
}


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config knob the port's trainer
    does not have yet, naming the ROADMAP item that brings it."""
    for field, (ported, msg) in _NOT_PORTED.items():
        if getattr(cfg, field) != ported:
            raise NotImplementedError(f"{field}={getattr(cfg, field)!r}: "
                                      f"{msg}")


def lr_schedule(cfg, total_steps: int) -> Union[float, Callable[[int], float]]:
    """cfg -> constant float lr, or a map from the 1-based step count to
    the lr.

    ``warmup_cosine``: linear warmup over ``cfg.warmup_steps`` steps, then
    cosine decay from ``cfg.lr`` to ``cfg.lr * cfg.lr_final_ratio`` over the
    remaining ``total_steps``: the reference formula, in f32 as the
    reference evaluates it."""
    if cfg.lr_schedule == "constant":
        return cfg.lr
    if cfg.lr_schedule != "warmup_cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                         "(expected 'constant' or 'warmup_cosine')")
    f32 = np.float32
    warm = max(int(cfg.warmup_steps), 1)
    floor = cfg.lr * cfg.lr_final_ratio
    span = max(int(total_steps) - warm, 1)

    def sched(count: int) -> float:
        c = f32(count)
        wlr = f32(cfg.lr) * np.minimum(c / f32(warm), f32(1.0))
        prog = np.clip((c - f32(warm)) / f32(span), f32(0.0), f32(1.0))
        clr = f32(floor) + f32(0.5 * (cfg.lr - floor)) * (
            f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(wlr if c <= f32(warm) else clr)

    return sched


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Adam:
    """torch Adam with L2 coupled into the gradient, f32 moments."""
    check_ported(cfg)
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
