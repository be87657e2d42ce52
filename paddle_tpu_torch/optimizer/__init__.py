"""Optimizers and LR schedulers (counterpart of paddle_tpu/optimizer)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["lr", "Optimizer", "Adam", "AdamW"]
