"""paddle_tpu_torch.quantization: QAT and PTQ (counterpart of
paddle_tpu/quantization/__init__.py).

Fake quantization rounds x / scale * qmax to an integer in [-qmax, qmax]
and scales it back, with a straight-through gradient (a
``torch.autograd.Function``): the gradient passes where |x| <= max(scale,
1e-9) and the scale gets none. It is registered as
``fake_quantize_dequantize_moving_average_abs_max``, so Tensor and torch
callers both get it.

``FakeQuanterWithAbsMaxObserverLayer`` keeps a bias-corrected moving
average of abs-max as its scale, updated in training mode by eager calls
only, as the reference updates it only outside a trace: never inside
``TrainStep``'s step (its eager first run and its capture included),
under a CUDA graph capture, or on the fake tensors of ``to_static``'s
probe and ``jit.save``'s export. Under ``TrainStep`` the scale therefore
stays where the eager calls left it.

A quanter's scale lies beside the parameters of the layer it quantizes
(else on `device`, None: the eager default place). ``QAT.quantize``
wraps each configured layer in a ``QuantedLayer`` by a
walk over the model's modules, which reaches the ``Layer`` children of
the port's torch-module models (MobileNetV2, the ResNets, GPT, BERT).
A ``QuantedLayer`` puts the fake-quantized weight (a tensor recorded from
the layer's torch parameter) in the inner layer's parameter slot for one
call, so backward reaches the parameter through the straight-through
gradient; ``convert`` writes the fake-quantized values into the weights
and unwraps the layers.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np
import torch

from ..core.device import default_torch_device
from ..core.tensor import Tensor
from ..nn.layer import Layer, _named_sublayers
from ..ops.registry import register_op

__all__ = ["quantize_linear", "dequantize_linear", "BaseQuanter",
           "FakeQuanterWithAbsMaxObserverLayer",
           "FakeQuanterWithAbsMaxObserver", "SingleLayerConfig",
           "QuantConfig", "QuantedLayer", "Quantization", "QAT", "PTQ"]


def _divisor(v, like):
    """v as a 0-d tensor beside `like` (filled on the device: a CUDA
    graph capture allows no host copy): CUDA divides by a Python number
    through its reciprocal, a rounding away from the CPU's quotient."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bit_length):
        qmax = float(2 ** (bit_length - 1) - 1)
        s = torch.clamp(scale, min=1e-9)
        # the reference's promotion: a bfloat16 x against a float32 scale
        # computes in float32
        xs = x.to(torch.promote_types(x.dtype, s.dtype))
        ctx.save_for_backward(x, s)
        q = torch.clamp(torch.round(xs / s * qmax), -qmax, qmax) * s
        return q / _divisor(qmax, q)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        inside = (torch.abs(x) <= s).to(g.dtype)
        return (g * inside).to(x.dtype), torch.zeros_like(s), None


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def _fake_quant_op(x, scale, bit_length=8):
    """Fake quant-dequant with the straight-through gradient."""
    return _FakeQuant.apply(x, scale, bit_length)


def _data(x, device=None):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=device or default_torch_device())


def quantize_linear(x, scale, zero_point=0, bit_length=8, axis=None):
    """round(x / scale * qmax) + zero_point, clipped to the signed range:
    int8, or int32 above 8 bits."""
    data = _data(x)
    qmax = 2 ** (bit_length - 1) - 1
    s = torch.clamp(_data(scale, data.device).to(data.device), min=1e-9)
    q = torch.clamp(torch.round(data / s * qmax) + zero_point, -qmax - 1,
                    qmax)
    return Tensor._wrap(q.to(torch.int8 if bit_length <= 8
                             else torch.int32))


def dequantize_linear(x, scale, zero_point=0, bit_length=8, axis=None):
    data = _data(x)
    qmax = 2 ** (bit_length - 1) - 1
    s = _data(scale, data.device).to(data.device)
    d = (data.to(torch.float32) - zero_point) * s
    return Tensor._wrap(d / _divisor(qmax, d))


class BaseQuanter(Layer):
    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        return None


def _observing(data: torch.Tensor) -> bool:
    """Whether an observer may update on this call: an eager call, not a
    TrainStep step, a CUDA graph capture or a trace's fake tensor."""
    from ..jit import in_train_step
    from ..kernels import tracing
    if tracing(data) or in_train_step():
        return False
    return not (data.is_cuda and torch.cuda.is_current_stream_capturing())


class FakeQuanterWithAbsMaxObserverLayer(BaseQuanter):
    """A moving-average abs-max scale and the fake quant with the
    straight-through gradient."""

    def __init__(self, layer=None, moving_rate=0.9, bit_length=8,
                 dtype="float32", name=None, *, device=None):
        super().__init__()
        self._moving_rate = moving_rate
        self._bit_length = bit_length
        from ..nn.initializer import Constant
        if device is None and layer is not None:
            # beside the parameters of the layer it quantizes
            p = next(torch.nn.Module.parameters(layer), None)
            device = None if p is None else p.device
        self.scale = self.create_parameter(
            [1], default_initializer=Constant(1e-3), is_bias=False,
            device=device)
        self.scale.stop_gradient = True
        # the bias-corrected average: the first observation sets the
        # scale to it exactly
        self._accum = 0.0

    def forward(self, x):
        data = x._data if isinstance(x, Tensor) else x
        scale = self._parameters["scale"]
        if self.training and _observing(data):
            with torch.no_grad():
                cur = torch.abs(data).max().reshape(1)
                r = self._moving_rate
                state = r * scale * self._accum + (1 - r) * cur
                self._accum = r * self._accum + 1 - r
                scale.copy_(state / _divisor(self._accum, state))
        return _fake_quant_op(x, scale.detach()[0],
                              bit_length=self._bit_length)

    def scales(self):
        return self.scale

    def bit_length(self):
        return self._bit_length


class FakeQuanterWithAbsMaxObserver:
    """The factory a QuantConfig takes: ``instance(layer)`` makes a
    quanter."""

    def __init__(self, moving_rate=0.9, bit_length=8, dtype="float32",
                 name=None):
        self._kwargs = dict(moving_rate=moving_rate,
                            bit_length=bit_length, dtype=dtype)

    def instance(self, layer=None):
        return FakeQuanterWithAbsMaxObserverLayer(layer, **self._kwargs)


class SingleLayerConfig:
    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight


class QuantConfig:
    """Quanter factories by layer (first), by type, then global (for
    every Linear and Conv2D)."""

    def __init__(self, activation=None, weight=None):
        self._global = SingleLayerConfig(activation, weight)
        self._layer_cfg: Dict[int, SingleLayerConfig] = {}
        self._type_cfg: Dict[Type, SingleLayerConfig] = {}

    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for lay in layers:
            self._layer_cfg[id(lay)] = SingleLayerConfig(activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._type_cfg[t] = SingleLayerConfig(activation, weight)

    def config_for(self, layer) -> Optional[SingleLayerConfig]:
        if id(layer) in self._layer_cfg:
            return self._layer_cfg[id(layer)]
        for t, cfg in self._type_cfg.items():
            if isinstance(layer, t):
                return cfg
        if self._global.activation or self._global.weight:
            from ..nn.layers.common import Linear
            from ..nn.layers.conv import Conv2D
            if isinstance(layer, (Linear, Conv2D)):
                return self._global
        return None


class QuantedLayer(Layer):
    """A layer with activation and weight fake quanters: the input is
    quantized, and the quantized weight stands in the layer's parameter
    slot for the call."""

    def __init__(self, layer, cfg: SingleLayerConfig):
        super().__init__()
        self._inner = layer
        self.activation_quanter = (cfg.activation.instance(layer)
                                   if cfg.activation else None)
        self.weight_quanter = (cfg.weight.instance(layer)
                               if cfg.weight else None)

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        params = self._inner._parameters
        if self.weight_quanter is not None and params.get("weight") \
                is not None:
            # the recorded quantized weight for this call: backward flows
            # through the quanter's straight-through gradient to the leaf
            orig = params["weight"]
            params["weight"] = self.weight_quanter(orig)
            try:
                return self._inner(x)
            finally:
                params["weight"] = orig
        return self._inner(x)


def _sublayers(model):
    """(dotted name, module) of every module under `model`, not itself:
    Layers and the torch modules of the port's models alike."""
    return [(n, m) for n, m in _named_sublayers(model, "") if m is not model]


class Quantization:
    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model: Layer, inplace=False):
        raise NotImplementedError

    def convert(self, model: Layer, inplace=False):
        """Unwrap the quanted layers, their weights set to their
        fake-quantized values."""
        for name, sub in _sublayers(model):
            if isinstance(sub, QuantedLayer):
                inner = sub._inner
                w = inner._parameters.get("weight")
                if sub.weight_quanter is not None and w is not None:
                    with torch.no_grad():
                        w.copy_(sub.weight_quanter(w))
                _set_sublayer(model, name, inner)
        return model


class QAT(Quantization):
    def quantize(self, model: Layer, inplace=False):
        for name, sub in _sublayers(model):
            if isinstance(sub, QuantedLayer):
                continue
            cfg = self._config.config_for(sub)
            if cfg is not None and (cfg.activation or cfg.weight):
                _set_sublayer(model, name, QuantedLayer(sub, cfg))
        return model


class PTQ(Quantization):
    """Post-training quantization: the QAT wrappers in training mode
    collect abs-max scales over calibration batches."""

    def quantize(self, model: Layer, inplace=False):
        model = QAT(self._config).quantize(model, inplace=inplace)
        model.train()
        return model


def _set_sublayer(root, dotted: str, new):
    parts = dotted.split(".")
    obj = root
    for p in parts[:-1]:
        obj = getattr(obj, p)
    obj.add_module(parts[-1], new)
