"""Configs, the trainer, its optimizer and checkpoints."""

from .checkpoint import (
    checkpoint_is_light,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .config import PRESETS, TrainConfig, get_config
from .optim import check_ported, lr_schedule, make_optimizer
from .trainer import Trainer, TrainState

__all__ = ["TrainConfig", "PRESETS", "get_config", "save_checkpoint",
           "load_checkpoint", "checkpoint_is_light", "latest_checkpoint",
           "check_ported", "lr_schedule", "make_optimizer", "Trainer",
           "TrainState"]
