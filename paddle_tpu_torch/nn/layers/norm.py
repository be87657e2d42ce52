"""LayerNorm (counterpart of paddle_tpu/nn/layers/norm.py:12)."""
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
