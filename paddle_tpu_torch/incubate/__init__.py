"""Incubating APIs (counterpart of paddle_tpu/incubate): the fused
functionals and layers under ``incubate.nn``, LookAhead and
ModelAverage, identity_loss and the 2:4 sparsity of ``asp``.
``autotune`` is not ported (it goes with the kernels' autotune cache,
ROADMAP Queue A item 23)."""
from . import nn
from .optimizer import LookAhead, ModelAverage
from .nn.loss import identity_loss
from . import asp

__all__ = ["nn", "LookAhead", "ModelAverage", "identity_loss", "asp"]
