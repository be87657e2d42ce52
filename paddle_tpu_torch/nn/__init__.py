from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layers import (Dropout, Embedding, LayerDict, LayerList, LayerNorm,
                     Linear, MultiHeadAttention, ParameterList, RMSNorm,
                     Sequential, Transformer, TransformerDecoder,
                     TransformerDecoderLayer, TransformerEncoder,
                     TransformerEncoderLayer)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_", "Dropout",
           "Embedding", "LayerDict", "LayerList", "LayerNorm", "Linear",
           "MultiHeadAttention", "ParameterList", "RMSNorm", "Sequential",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
