"""Optimizers and LR schedulers (counterpart of paddle_tpu/optimizer)."""
from . import lbfgs, lr, optimizer, optimizers
from .lbfgs import LBFGS
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Momentum, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "RMSProp", "Lamb", "Adadelta", "LBFGS"]
