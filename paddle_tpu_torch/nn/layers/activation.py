"""Activation layers (counterpart of paddle_tpu/nn/layers/activation.py)
over the activations ``nn.functional`` has: ReLU, GELU, Silu (also
spelt SiLU, and Swish), Tanh."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer

__all__ = ["ReLU", "GELU", "Silu", "SiLU", "Swish", "Tanh"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


class Swish(Silu):
    pass


SiLU = Silu  # the reference exports both spellings
