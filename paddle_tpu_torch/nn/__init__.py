from . import functional, initializer
from .layer import Layer, Parameter
from .param_attr import ParamAttr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layers import (GELU, AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                     AdaptiveAvgPool3D, AdaptiveMaxPool2D, AvgPool1D,
                     AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D,
                     BatchNorm2D, BatchNorm3D, Conv1D, Conv1DTranspose,
                     Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
                     CrossEntropyLoss, Dropout, Embedding, Flatten,
                     LayerDict, LayerList, LayerNorm, Linear, MaxPool1D,
                     MaxPool2D, MaxPool3D, MultiHeadAttention, ParameterList,
                     ReLU, RMSNorm, Sequential, SiLU, Silu, Swish, Tanh,
                     Transformer, TransformerDecoder,
                     TransformerDecoderLayer, TransformerEncoder,
                     TransformerEncoderLayer)
from .layers import __all__ as _layers

__all__ = ["functional", "initializer", "Layer", "Parameter", "ParamAttr",
           "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_"] + _layers
