"""Linear, Embedding, Dropout and Flatten (counterparts of
paddle_tpu/nn/layers/common.py:12, 44, 79, 100).

Linear and Embedding are built with uninitialised weights: a model
draws them (GPT's and LLaMA's ``_init_weights``), or a layer that
follows the reference's initializers builds them with ``_drawn`` and
``_drawn_linear``."""
from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.dtype import to_dtype
from .. import functional as F
from ..initializer import Constant, XavierUniform


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
    """Dropout in training mode (nn/layers/common.py:44). `generator`: a
    torch.Generator on the layer's device that the masks are drawn from
    (None: torch's default generator)."""

    def __init__(self, p=0.5, mode="upscale_in_train", *, generator=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode,
                         generator=self.generator)


class Flatten(nn.Module):
    """Axes start_axis..stop_axis merged into one (default: all but the
    batch axis)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


def _factory(device, dtype):
    """The factory keywords of a layer built on `device` (None: the CUDA
    card, raising without one) in `dtype` (a name or a torch dtype)."""
    return {"device": resolve_device(device), "dtype": to_dtype(dtype)}


def _drawn(init, shape, fk, generator):
    """A parameter of `shape` drawn by initializer `init` in
    ``fk["dtype"]`` on ``fk["device"]`` from `generator`."""
    return nn.Parameter(init(shape, fk["dtype"], device=fk["device"],
                             generator=generator))


def _attr_initializer(attr, default):
    """The initializer the reference's ``create_parameter`` takes for a
    ``weight_attr`` / ``bias_attr`` (nn/layer.py:143-158): a callable
    itself, anything else (None, True, ...) `default`. A ``ParamAttr``
    is not ported yet (ROADMAP item 14) and raises."""
    if type(attr).__name__ == "ParamAttr":
        raise NotImplementedError(
            "ParamAttr is not ported yet: pass an initializer as "
            "weight_attr / bias_attr")
    return attr if callable(attr) else default


def _drawn_linear(in_features, out_features, weight_attr, bias_attr, fk,
                  generator):
    """The reference's ``Linear(in, out, weight_attr, bias_attr)``: the
    weight drawn by `weight_attr`, the bias by `bias_attr`, each as
    ``_attr_initializer`` takes them (defaults XavierUniform and 0); no
    bias when `bias_attr` is False."""
    lin = Linear(in_features, out_features, bias=bias_attr is not False,
                 **fk)
    lin.weight = _drawn(_attr_initializer(weight_attr, XavierUniform()),
                        (in_features, out_features), fk, generator)
    if lin.bias is not None:
        lin.bias = _drawn(_attr_initializer(bias_attr, Constant(0.0)),
                          (out_features,), fk, generator)
    return lin
