from . import functional, initializer, quant, utils
from .layer import Layer, Parameter
from .param_attr import ParamAttr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers

__all__ = ["functional", "initializer", "quant", "utils", "Layer",
           "Parameter", "ParamAttr", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_"] + _layers
