from .common import Dropout, Embedding, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["Dropout", "Embedding", "Linear", "LayerList", "LayerNorm"]
