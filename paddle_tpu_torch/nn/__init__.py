from . import functional
from .layers import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["functional", "Dropout", "Embedding", "LayerList", "LayerNorm",
           "Linear"]
