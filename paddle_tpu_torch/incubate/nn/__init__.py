from . import functional
from .layer import (FusedFeedForward, FusedMultiHeadAttention,
                    FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedFeedForward", "FusedMultiHeadAttention",
           "FusedTransformerEncoderLayer"]
