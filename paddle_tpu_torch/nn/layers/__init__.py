from .common import Dropout, Embedding, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "Linear", "LayerDict", "LayerList",
           "ParameterList", "Sequential", "LayerNorm", "RMSNorm",
           "MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
