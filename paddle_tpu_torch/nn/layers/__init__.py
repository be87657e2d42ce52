from .activation import GELU, ReLU, SiLU, Silu, Swish, Tanh
from .common import Dropout, Embedding, Flatten, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, AvgPool3D,
                      MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["GELU", "ReLU", "SiLU", "Silu", "Swish", "Tanh", "Dropout",
           "Embedding", "Flatten", "Linear", "LayerDict", "LayerList",
           "ParameterList", "Sequential", "Conv1D", "Conv1DTranspose",
           "Conv2D", "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "CrossEntropyLoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "LayerNorm", "RMSNorm", "AdaptiveAvgPool1D",
           "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool2D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
