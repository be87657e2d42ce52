"""The common layers (counterparts of paddle_tpu/nn/layers/common.py):
Linear, Embedding, the dropouts, Flatten, Identity, the upsampling,
padding, shuffle, fold / unfold and distance layers and Bilinear, as
``Layer``s on the reference's constructors.

Parameters are made by ``Layer.create_parameter`` with the reference's
defaults (Linear: XavierUniform and a zero bias; Embedding: Normal(0,
1)); `weight_attr` / `bias_attr` take a ``ParamAttr`` or an
initializer, and ``bias_attr=False`` drops the bias. The port's own
keyword-only arguments come after the reference's: ``device`` (None:
the default place), ``dtype`` and ``init_generator``, the
``torch.Generator`` the weights are drawn from (None: the port's
default generator). The dropouts take the port's keyword-only
``generator`` their masks are drawn from (None: the eager generator
for a Tensor input, torch's default generator for a torch one)."""
from __future__ import annotations

from torch import nn

from ...core.device import resolve_device
from ...core.dtype import to_dtype
from ... import ops  # at call time: ops imports nn first
from .. import functional as F
from ..initializer import Normal
from ..layer import Layer

__all__ = ["Linear", "Identity", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Embedding", "Flatten", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "Bilinear", "CosineSimilarity",
           "PairwiseDistance", "PixelShuffle", "PixelUnshuffle",
           "ChannelShuffle", "Unfold", "Fold"]


class Linear(Layer):
    """y = x @ W + b. ``weight`` keeps paddle_tpu's [in, out] layout, so
    a paddle_tpu state_dict loads name for name with no transpose."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, generator=init_generator)
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr, **kw)
        if bias_attr is False:
            self.add_parameter("bias", None)
        else:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self._parameters["weight"],
                        self._parameters["bias"])

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """Rows of ``weight`` [num_embeddings, embedding_dim] by id; the rows
    of ids equal to `padding_idx` read as zeros. `sparse` is taken and
    not used, as in the reference."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=Normal(0.0, 1.0)
            if weight_attr is None else None, device=device,
            generator=init_generator)

    def forward(self, x):
        return F.embedding(x, self._parameters["weight"],
                           padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """Dropout in training mode (nn/layers/common.py:44); `axis` is taken
    and not used, as in the reference. `generator`: a torch.Generator on
    the input's device that the masks are drawn from (None: the eager
    generator for a Tensor input, torch's default generator for a torch
    one)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode,
                         generator=self.generator)


class Flatten(Layer):
    """Axes start_axis..stop_axis merged into one (default: all but the
    batch axis)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout2D(Layer):
    """Whole channels dropped in training mode (NCHW or NHWC)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(Dropout2D):
    """The reference's Dropout3D is Dropout2D's code: one draw per (batch,
    channel) of an NCHW-shaped mask."""


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training,
                               generator=self.generator)


class Upsample(Layer):
    """``nn.functional.interpolate`` (jax.image.resize's conventions, not
    torch's: its docstring says where they differ)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    pass


class Bilinear(Layer):
    """out[b, o] = x1[b]^T W[o] x2[b] + bias: W [out, in1, in2]
    (XavierUniform), bias [1, out] (zeros, or none with False), through
    the einsum op as in the reference."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        kw = dict(device=device, generator=init_generator)
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            **kw)
        if bias_attr is False:
            self.add_parameter("bias", None)
        else:
            self.bias = self.create_parameter(
                (1, out_features), attr=bias_attr, is_bias=True, **kw)

    def forward(self, x1, x2):
        out = ops.linalg.einsum("bi,oij,bj->bo", x1,
                                self._parameters["weight"], x2)
        bias = self._parameters["bias"]
        return out if bias is None else out + bias


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    """The p-norm of x - y + epsilon over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return ops.linalg.norm(x - y + self.epsilon, p=self.p, axis=-1,
                    keepdim=self.keepdim)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        return F.channel_shuffle(x, self.groups)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold_im2col(x, *self.args)


class Fold(Layer):
    """col2im over ``nn.functional.fold``."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


def _factory(device, dtype):
    """The factory keywords of a model built on `device` (None: the CUDA
    card, raising without one) in `dtype` (a name or a torch dtype)."""
    return {"device": resolve_device(device), "dtype": to_dtype(dtype)}


def _drawn(init, shape, fk, generator):
    """A parameter of `shape` drawn by initializer `init` in
    ``fk["dtype"]`` on ``fk["device"]`` from `generator`."""
    return nn.Parameter(init(shape, fk["dtype"], device=fk["device"],
                             generator=generator))
