"""Linear, Embedding, Dropout and Flatten (counterparts of
paddle_tpu/nn/layers/common.py:12, 44, 79, 100), as ``Layer``s on the
reference's constructors.

Parameters are made by ``Layer.create_parameter`` with the reference's
defaults (Linear: XavierUniform and a zero bias; Embedding: Normal(0,
1)); `weight_attr` / `bias_attr` take a ``ParamAttr`` or an
initializer, and ``bias_attr=False`` drops the bias. The port's own
keyword-only arguments come after the reference's: ``device`` (None:
the default place), ``dtype`` and ``init_generator``, the
``torch.Generator`` the weights are drawn from (None: the port's
default generator)."""
from __future__ import annotations

from torch import nn

from ...core.device import resolve_device
from ...core.dtype import to_dtype
from .. import functional as F
from ..initializer import Normal
from ..layer import Layer


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


def _factory(device, dtype):
    """The factory keywords of a model built on `device` (None: the CUDA
    card, raising without one) in `dtype` (a name or a torch dtype)."""
    return {"device": resolve_device(device), "dtype": to_dtype(dtype)}


def _drawn(init, shape, fk, generator):
    """A parameter of `shape` drawn by initializer `init` in
    ``fk["dtype"]`` on ``fk["device"]`` from `generator`."""
    return nn.Parameter(init(shape, fk["dtype"], device=fk["device"],
                             generator=generator))
