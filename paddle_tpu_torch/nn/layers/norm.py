"""LayerNorm, RMSNorm and the batch norms (counterparts of
paddle_tpu/nn/layers/norm.py:12, :40, :56-127), as ``Layer``s on the
reference's constructors. LayerNorm and RMSNorm call the plain
functional ops, as the reference's layers do (norm.py:33, :52): the
fused kernels B4/B5 are reached only through
``incubate.nn.functional``.

Weights default to 1 and biases to 0 (``create_parameter``);
`weight_attr` / `bias_attr` take a ``ParamAttr`` or an initializer, or
drop the parameter with False. The port's keyword-only ``device``
(None: the default place), ``dtype`` and ``init_generator`` come after
the reference's arguments."""
from __future__ import annotations

import torch

from ...core.tensor import Tensor
from .. import functional as F
from ..initializer import Constant
from ..layer import Layer, layer_device

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D"]


def _affine(layer, shape, weight_attr, bias_attr, device, generator):
    """The weight (default 1) and bias (default 0) of a norm layer, each
    left out (None) when its attr is False."""
    kw = dict(device=device, generator=generator)
    if weight_attr is False:
        layer.add_parameter("weight", None)
    else:
        layer.weight = layer.create_parameter(
            shape, attr=weight_attr, default_initializer=Constant(1.0), **kw)
    if bias_attr is False:
        layer.add_parameter("bias", None)
    else:
        layer.bias = layer.create_parameter(shape, attr=bias_attr,
                                            is_bias=True, **kw)


class LayerNorm(Layer):
    """Normalises over the last ``len(normalized_shape)`` axes (an int
    is one axis)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        _affine(self, self.normalized_shape, weight_attr, bias_attr,
                device, init_generator)

    def forward(self, x):
        return F.layer_norm(x, self._parameters["weight"],
                            self._parameters["bias"], self.epsilon,
                            normalized_shape=self.normalized_shape)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    """RMSNorm over the last axis with a weight initialised to 1."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, *,
                 device=None, dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr,
            default_initializer=Constant(1.0), device=device,
            generator=init_generator)

    def forward(self, x):
        return F.rms_norm(x, self._parameters["weight"], self.epsilon)


def _torch(t):
    return t._data if isinstance(t, Tensor) else t


class _BatchNormBase(Layer):
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
        super().__init__(dtype=dtype)
        dev = layer_device(device)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        _affine(self, (num_features,), weight_attr, bias_attr, dev,
                init_generator)
        self.register_buffer("_mean", torch.zeros(
            (num_features,), dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            (num_features,), dtype=torch.float32, device=dev))

    def forward(self, x):
        training = self.training and self.use_global_stats is not True
        mean, var = self._buffers["_mean"], self._buffers["_variance"]
        out, new_mean, new_var = F.batch_norm(
            x, mean, var, self._parameters["weight"],
            self._parameters["bias"], training=training,
            momentum=self.momentum, epsilon=self.epsilon,
            data_format=self.data_format)
        if training:
            with torch.no_grad():
                mean.copy_(_torch(new_mean))
                var.copy_(_torch(new_var))
        return out

    def extra_repr(self):
        return f"num_features={self.num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    """data_format "NCL" (channels at axis 1) or "NLC"."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL" else
                         data_format, use_global_stats, device=device,
                         dtype=dtype, init_generator=init_generator)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype,
                         init_generator=init_generator)
