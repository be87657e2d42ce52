"""Incubating APIs (counterpart of paddle_tpu/incubate): the fused
functional ops and fused transformer layers under ``incubate.nn``."""
from . import nn

__all__ = ["nn"]
