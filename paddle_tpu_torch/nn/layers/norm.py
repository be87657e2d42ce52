"""LayerNorm and RMSNorm (counterparts of paddle_tpu/nn/layers/norm.py:12,
:40). Both call the plain functional ops, as the reference's layers do
(norm.py:33, :52): the fused kernels B4/B5 are reached only through
``incubate.nn.functional``."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, epsilon=1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            (normalized_shape,), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            (normalized_shape,), device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with a weight initialised to 1."""

    def __init__(self, hidden_size: int, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            (hidden_size,), device=device, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
