"""Conv layers (counterpart of paddle_tpu/nn/layers/conv.py).

The kernel keeps paddle's layout, [out, in/groups, *k] ([in,
out/groups, *k] for the transposes), in every data_format, so a
reference state_dict loads name for name. Weights are drawn by the
reference's defaults: KaimingUniform(fan_in, negative_slope=sqrt(5))
and a bias from Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in =
in/groups * prod(k) (the 1-D transpose: XavierUniform and a zero bias,
as the reference's ``create_parameter`` defaults give it). `weight_attr`
/ `bias_attr` take a ``ParamAttr`` or an initializer, as
``Layer.create_parameter`` reads them; ``bias_attr=False`` drops the
bias. The port's keyword-only ``device`` (None: the default place),
``dtype`` and ``init_generator`` (None: the port's default generator)
come after the reference's arguments.
"""
from __future__ import annotations

import numpy as np

from .. import functional as F
from ..cnn_ops import _conv_padding, _norm_tuple
from ..initializer import KaimingUniform, Uniform
from ..layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _conv_params(layer, shape, fan_in, out_channels, weight_attr,
                 bias_attr, device, generator, defaults=True):
    """The kernel and bias of a conv layer (no bias when `bias_attr` is
    False): with `defaults`, KaimingUniform(fan_in, sqrt(5)) and, when
    `bias_attr` is None, Uniform(+-1/sqrt(fan_in)); without,
    ``create_parameter``'s own (XavierUniform, 0)."""
    kw = dict(device=device, generator=generator)
    layer.weight = layer.create_parameter(
        shape, attr=weight_attr, default_initializer=KaimingUniform(
            fan_in=fan_in, negative_slope=np.sqrt(5.0)) if defaults
        else None, **kw)
    if bias_attr is False:
        layer.add_parameter("bias", None)
        return
    default = None
    if defaults and bias_attr is None:
        bound = 1.0 / np.sqrt(fan_in)
        default = Uniform(-bound, bound)
    layer.bias = layer.create_parameter(
        (out_channels,), attr=bias_attr, is_bias=True,
        default_initializer=default, **kw)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, ndim,
                 stride=1, padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _norm_tuple(kernel_size, ndim)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self.output_padding = output_padding
        if transpose:
            shape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = in_channels // groups * int(np.prod(self.kernel_size))
        _conv_params(self, shape, fan_in, out_channels, weight_attr,
                     bias_attr, device, init_generator)

    def _wb(self):
        return self._parameters["weight"], self._parameters["bias"]

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype="float32", init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype,
                         init_generator=init_generator)

    def forward(self, x):
        return F.conv1d(x, *self._wb(), self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 *, device=None, dtype="float32", init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype,
                         init_generator=init_generator)

    def forward(self, x):
        return F.conv2d(x, *self._wb(), self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 *, device=None, dtype="float32", init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype,
                         init_generator=init_generator)

    def forward(self, x):
        return F.conv3d(x, *self._wb(), self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 *, device=None, dtype="float32", init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype, init_generator=init_generator)

    def forward(self, x, output_size=None):
        outpad = (_outpad_from_size(x, output_size, self.kernel_size,
                                    self.stride, self.padding,
                                    self.dilation, 2)
                  if output_size is not None else self.output_padding)
        return F.conv2d_transpose(x, *self._wb(), self.stride,
                                  self.padding, outpad, self.dilation,
                                  self.groups, self.data_format)


class Conv1DTranspose(Layer):
    """The reference's 1-D transpose (conv.py:126): the input and weight
    take a unit axis at 2 and go through the 2-D transpose in NCHW
    (`data_format` is kept and not used, as in the reference); the
    weight defaults to XavierUniform and the bias to 0; `output_size` is
    taken and not used."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _norm_tuple(kernel_size, 1)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.output_padding = output_padding
        shape = (in_channels, out_channels // groups) + self.kernel_size
        _conv_params(self, shape, None, out_channels, weight_attr,
                     bias_attr, device, init_generator, defaults=False)

    def forward(self, x, output_size=None):
        weight, bias = self._parameters["weight"], self._parameters["bias"]
        out = F.conv2d_transpose(
            x.unsqueeze(2), weight.unsqueeze(2), bias,
            (1, self.stride) if isinstance(self.stride, int)
            else (1,) + tuple(self.stride),
            (0, self.padding) if isinstance(self.padding, int)
            else [0] + list(self.padding),
            (0, self.output_padding) if isinstance(self.output_padding, int)
            else self.output_padding,
            (1, self.dilation) if isinstance(self.dilation, int)
            else self.dilation,
            self.groups)
        return out.squeeze(2)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 *, device=None, dtype="float32", init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype, init_generator=init_generator)

    def forward(self, x, output_size=None):
        outpad = (_outpad_from_size(x, output_size, self.kernel_size,
                                    self.stride, self.padding,
                                    self.dilation, 3)
                  if output_size is not None else self.output_padding)
        return F.conv3d_transpose(x, *self._wb(), self.stride,
                                  self.padding, outpad, self.dilation,
                                  self.groups, self.data_format)


def _outpad_from_size(x, output_size, kernel, stride, padding, dilation, n):
    """The output_padding that lands a transpose on `output_size`
    (conv.py:199): the last n of its values, each at most
    stride + dilation - 1 above the size without it. The spatial sizes
    are read at axes 2.. in every layout, as the reference reads them."""
    output_size = _norm_tuple(output_size[-n:] if len(output_size) > n
                              else output_size, n)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    pad = _conv_padding(padding, n)
    kernel = _norm_tuple(kernel, n)
    spatial = x.shape[2:2 + n]
    outpad = []
    for i in range(n):
        base = ((spatial[i] - 1) * stride[i] - pad[i][0] - pad[i][1]
                + dilation[i] * (kernel[i] - 1) + 1)
        op_i = int(output_size[i]) - base
        if not 0 <= op_i < stride[i] + dilation[i]:
            raise ValueError(
                f"output_size {output_size} unreachable for input "
                f"{tuple(spatial)} with stride {stride}")
        outpad.append(op_i)
    return tuple(outpad)
