"""LayerNorm, RMSNorm and the batch norms (counterparts of
paddle_tpu/nn/layers/norm.py:12, :40, :56-127). LayerNorm and RMSNorm
call the plain functional ops, as the reference's layers do (norm.py:33,
:52): the fused kernels B4/B5 are reached only through
``incubate.nn.functional``."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant
from .common import _attr_initializer, _drawn, _factory

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D"]


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


class _BatchNormBase(nn.Module):
    """Batch norm over every axis but the channel's (axis 1, or the last
    for a data_format ending in "C" on an input of rank 3 or more).

    The weight (default 1) and bias (default 0) are drawn by
    `weight_attr` / `bias_attr` as the other layers take them, or left
    out with False. The buffers ``_mean`` (zeros) and ``_variance``
    (ones) are f32, as in the reference. In training mode (and unless
    ``use_global_stats`` is True) the layer normalises by the batch's
    statistics and writes the new running statistics into its buffers in
    place, as the reference's layer rebinds them (norm.py:81-91): an
    eager step moves them. ``jit.TrainStep`` puts them back after each
    step, as the reference's compiled step leaves them (its docstring
    says why)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__()
        fk = _factory(device, dtype)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else _drawn(
            _attr_initializer(weight_attr, Constant(1.0)), (num_features,),
            fk, init_generator)
        self.bias = None if bias_attr is False else _drawn(
            _attr_initializer(bias_attr, Constant(0.0)), (num_features,),
            fk, init_generator)
        self.register_buffer("_mean", torch.zeros(
            (num_features,), dtype=torch.float32, device=fk["device"]))
        self.register_buffer("_variance", torch.ones(
            (num_features,), dtype=torch.float32, device=fk["device"]))

    def forward(self, x):
        training = self.training and self.use_global_stats is not True
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self.momentum, epsilon=self.epsilon,
            data_format=self.data_format)
        if training:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out

    def extra_repr(self):
        return f"num_features={self.num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    """data_format "NCL" (channels at axis 1) or "NLC"."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, **fk):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL" else
                         data_format, use_global_stats, **fk)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **fk):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, **fk)
