"""Configs and checkpoints (the trainer is not ported yet)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .config import PRESETS, TrainConfig, get_config

__all__ = ["TrainConfig", "PRESETS", "get_config", "save_checkpoint",
           "load_checkpoint"]
