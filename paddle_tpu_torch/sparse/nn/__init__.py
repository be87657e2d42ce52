"""paddle.sparse.nn's layers over sparse/nn/functional (counterpart of
paddle_tpu/sparse/nn/__init__.py). A convolution's weight is [k...,
in / groups, out] drawn from Normal(0, 0.02), its bias zeros, on
`device` (None: the eager default place, the card unless
``set_device("cpu")``)."""
from __future__ import annotations

import torch

from . import functional  # noqa: F401
from ...nn.initializer import Normal
from ...nn.layer import Layer

__all__ = ["Conv3D", "SubmConv3D", "Conv2D", "SubmConv2D", "MaxPool3D",
           "ReLU", "LeakyReLU", "Softmax", "functional"]


class _SparseConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, subm=False, nd=3,
                 bias_attr=None, data_format=None, *, device=None,
                 init_generator=None):
        super().__init__()
        ks = ((kernel_size,) * nd if isinstance(kernel_size, int)
              else tuple(kernel_size))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.subm, self.nd = groups, subm, nd
        kw = dict(device=device, generator=init_generator)
        self.weight = self.create_parameter(
            ks + (in_channels // groups, out_channels),
            attr=Normal(std=0.02), **kw)
        if bias_attr is not False:
            self.bias = self.create_parameter((out_channels,), is_bias=True,
                                              **kw)
        else:
            self.add_parameter("bias", None)

    def forward(self, x):
        fn = {
            (3, False): functional.conv3d,
            (3, True): functional.subm_conv3d,
            (2, False): functional.conv2d,
            (2, True): functional.subm_conv2d,
        }[(self.nd, self.subm)]
        return fn(x, self._parameters["weight"], self._parameters["bias"],
                  self.stride, self.padding, self.dilation, self.groups)


class Conv3D(_SparseConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC", *,
                 device=None, init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, subm=False, nd=3,
                         bias_attr=bias_attr, device=device,
                         init_generator=init_generator)


class SubmConv3D(_SparseConvNd):
    """Submanifold: the output's sites are the input's."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 key=None, weight_attr=None, bias_attr=None,
                 data_format="NDHWC", *, device=None, init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, subm=True, nd=3,
                         bias_attr=bias_attr, device=device,
                         init_generator=init_generator)


class Conv2D(_SparseConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NHWC", *,
                 device=None, init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, subm=False, nd=2,
                         bias_attr=bias_attr, device=device,
                         init_generator=init_generator)


class SubmConv2D(_SparseConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 key=None, weight_attr=None, bias_attr=None,
                 data_format="NHWC", *, device=None, init_generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, subm=True, nd=2,
                         bias_attr=bias_attr, device=device,
                         init_generator=init_generator)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x):
        return functional.max_pool3d(x, self.kernel_size, self.stride,
                                     self.padding)


class ReLU(Layer):
    def forward(self, x):
        return functional.relu(x)

    def __repr__(self):
        return "sparse.nn.ReLU()"


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return x._map_values(lambda v: torch.nn.functional.leaky_relu(
            v, self.negative_slope))


class Softmax(Layer):
    """The softmax over the stored values of each row of a CSR (per
    batch), or over a COO's values along `axis`."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        from .. import SparseCsrTensor
        if not isinstance(x, SparseCsrTensor):
            return x._map_values(lambda v: torch.softmax(v, dim=self.axis))
        s = x._shape[-2]
        crows = x._crows.reshape(-1, s + 1)
        vals = x._vals.reshape(crows.shape[0], -1)
        nb, nnz = vals.shape
        pos = torch.arange(nnz, device=vals.device).expand(nb, nnz)
        # each stored value's row; padding past a batch's count lands on
        # a row of its own (s)
        row = torch.searchsorted(crows, pos.contiguous(), right=True) - 1
        seg = (torch.arange(nb, device=vals.device)[:, None] * (s + 1)
               + row.clamp(max=s)).reshape(-1)
        flat = vals.reshape(-1)
        top = flat.new_full((nb * (s + 1),), -torch.inf).scatter_reduce(
            0, seg, flat, "amax", include_self=True)
        e = torch.exp(flat - top[seg])
        den = e.new_zeros(nb * (s + 1)).index_add(0, seg, e)
        out = (e / den[seg]).reshape(x._vals.shape)
        return SparseCsrTensor(x._crows, x._cols, out, x._shape)
