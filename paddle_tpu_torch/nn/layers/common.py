"""Linear, Embedding and Dropout (counterparts of
paddle_tpu/nn/layers/common.py:12,44,79)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class Linear(nn.Module):
    """y = x @ W + b. ``weight`` keeps paddle_tpu's [in, out] layout, so
    a paddle_tpu state_dict loads name for name with no transpose."""

    def __init__(self, in_features, out_features, bias=True, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            (out_features,), device=device, dtype=dtype)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device, dtype=dtype))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return nn.functional.dropout(x, self.p, self.training)
