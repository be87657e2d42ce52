"""Incubating APIs (counterpart of paddle_tpu/incubate): the fused
functionals and layers under ``incubate.nn``, LookAhead and
ModelAverage, identity_loss, the 2:4 sparsity of ``asp`` and
``autotune``'s switches."""
from . import nn
from .optimizer import LookAhead, ModelAverage
from .nn.loss import identity_loss
from . import asp, autotune

__all__ = ["nn", "LookAhead", "ModelAverage", "identity_loss", "asp",
           "autotune"]
