"""Pooling layers (counterpart of paddle_tpu/nn/layers/pooling.py): the
max, average and adaptive pools in 1-D, 2-D and 3-D and MaxUnPool2D,
over ``nn.functional``'s pools. As in the reference, the plain pools
take ``return_mask`` and ``divisor_override`` and do not use them,
``ceil_mode`` is passed on and ignored there, and the 1-D pools take no
data_format; the 1-D and 3-D adaptive max pools return (out, indices)
with ``return_mask``."""
from __future__ import annotations

from ... import ops  # at call time: ops imports nn first
from .. import functional as F
from ..layer import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool2D", "AdaptiveMaxPool1D",
           "AdaptiveMaxPool3D", "MaxUnPool2D"]


class _Pool(Layer):
    def __init__(self, op, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format=None, **kw):
        super().__init__()
        self._op = op
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format
        self._kw = kw

    def forward(self, x):
        kwargs = dict(self._kw)
        if self.data_format is not None:
            kwargs["data_format"] = self.data_format
        return getattr(F, self._op)(x, self.kernel_size, self.stride,
                                    self.padding, ceil_mode=self.ceil_mode,
                                    **kwargs)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__("max_pool1d", kernel_size, stride, padding,
                         ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__("max_pool2d", kernel_size, stride, padding,
                         ceil_mode, data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__("max_pool3d", kernel_size, stride, padding,
                         ceil_mode, data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__("avg_pool1d", kernel_size, stride, padding,
                         ceil_mode, exclusive=exclusive)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__("avg_pool2d", kernel_size, stride, padding,
                         ceil_mode, data_format, exclusive=exclusive)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__("avg_pool3d", kernel_size, stride, padding,
                         ceil_mode, data_format, exclusive=exclusive)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(Layer):
    """NCHW, as the reference's layer takes it (no data_format)."""

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    """`return_mask`: (out, int32 argmax positions along L), the unpool
    contract."""

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size,
                                     return_mask=self.return_mask)


class AdaptiveMaxPool3D(Layer):
    """NCDHW; `return_mask`: (out, int32 argmax flat into D*H*W)."""

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size,
                                     return_mask=self.return_mask)


class MaxUnPool2D(Layer):
    """Each pooled value written back at its flat H*W index (per batch
    and channel, in either layout) of a zero image; NHWC runs the same
    scatter between transposes."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(
                f"MaxUnPool2D data_format must be NCHW or NHWC, got "
                f"{data_format!r}")
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format
        self.output_size = output_size

    def forward(self, x, indices):
        if self.data_format == "NHWC":
            out = F.unpool(ops.manipulation.transpose(x, [0, 3, 1, 2]),
                           ops.manipulation.transpose(indices, [0, 3, 1, 2]),
                           self.kernel_size, self.stride, self.padding,
                           self.output_size)
            return ops.manipulation.transpose(out, [0, 2, 3, 1])
        return F.unpool(x, indices, self.kernel_size, self.stride,
                        self.padding, self.output_size)
