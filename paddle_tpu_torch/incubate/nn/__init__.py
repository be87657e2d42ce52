"""incubate.nn (counterpart of paddle_tpu/incubate/nn): the fused
functionals, the fused layers, identity_loss, the attention-bias classes
and memory_efficient_attention."""
from . import functional
from .layer import (FusedDropoutAdd, FusedEcMoe, FusedFeedForward,
                    FusedLinear, FusedMultiHeadAttention,
                    FusedMultiTransformer, FusedTransformerEncoderLayer)
from .loss import identity_loss
from . import attn_bias
from .memory_efficient_attention import memory_efficient_attention

__all__ = ["functional", "FusedDropoutAdd", "FusedEcMoe",
           "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer",
           "identity_loss", "attn_bias", "memory_efficient_attention"]
