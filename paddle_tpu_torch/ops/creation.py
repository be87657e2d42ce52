"""Creation ops (counterpart of paddle_tpu/ops/creation.py).

The ops with no tensor input make their output on the default place
(``core.device.get_place``: the card, or the CPU after
``set_device("cpu")``); the ``*_like`` ops and the rest follow their
input's device. Default dtypes are the reference's: float32, and int32
where it asks for int64 (it runs without x64)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import default_torch_device
from ..core.tensor import NARROW, Tensor
from ._util import dt, new_tensor as _new, shape_arg
from .registry import register_op

__all__ = ["zeros", "ones", "full", "empty", "eye", "arange", "linspace",
           "logspace", "zeros_like", "ones_like", "full_like", "empty_like",
           "assign", "tril", "triu", "diag", "diagflat", "meshgrid",
           "tril_indices", "triu_indices", "clone", "complex", "as_complex",
           "as_real"]


def _scalar(v):
    return v.item() if isinstance(v, Tensor) else v


# creation ops do not differentiate through inputs -> plain functions
def zeros(shape, dtype=None):
    return _new(torch.zeros(shape_arg(shape), dtype=dt(dtype),
                            device=default_torch_device()))


def ones(shape, dtype=None):
    return _new(torch.ones(shape_arg(shape), dtype=dt(dtype),
                           device=default_torch_device()))


def full(shape, fill_value, dtype=None):
    fill_value = _scalar(fill_value)
    if dtype is None:
        # jnp.full takes the fill value's type: float32, int32 or bool
        d = torch.bool if isinstance(fill_value, bool) else \
            torch.int32 if isinstance(fill_value, int) else torch.float32
    else:
        d = dt(dtype)
    return _new(torch.full(shape_arg(shape), fill_value, dtype=d,
                           device=default_torch_device()))


def empty(shape, dtype=None):
    return zeros(shape, dtype)


def eye(num_rows, num_columns=None, dtype=None):
    return _new(torch.eye(int(num_rows), int(num_columns or num_rows),
                          dtype=dt(dtype), device=default_torch_device()))


def arange(start=0, end=None, step=1, dtype=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        d = torch.float32 if any(isinstance(v, float)
                                 for v in (start, end, step)) \
            else torch.int32
    else:
        d = dt(dtype)
    return _new(torch.arange(start, end, step, dtype=d,
                             device=default_torch_device()))


def linspace(start, stop, num, dtype=None):
    return _new(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), dtype=dt(dtype),
                               device=default_torch_device()))


def logspace(start, stop, num, base=10.0, dtype=None):
    return _new(torch.logspace(start, stop, int(num), base=base,
                               dtype=dt(dtype),
                               device=default_torch_device()))


@register_op("zeros_like")
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=None if dtype is None else dt(dtype))


@register_op("ones_like")
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=None if dtype is None else dt(dtype))


@register_op("full_like")
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value,
                           dtype=None if dtype is None else dt(dtype))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


@register_op("assign")
def assign(x, output=None):
    if not isinstance(x, torch.Tensor):
        t = torch.as_tensor(np.asarray(x), device=default_torch_device())
        return t.to(NARROW.get(t.dtype, t.dtype))
    return x.clone()


@register_op("tril")
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@register_op("triu")
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@register_op("diag")
def diag(x, offset=0, padding_value=0):
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, torch.tensor(padding_value,
                                                  dtype=out.dtype,
                                                  device=out.device))
    return out


@register_op("diagflat")
def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


def meshgrid(*args):
    tensors = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    datas = [t._data if isinstance(t, Tensor) else torch.as_tensor(t)
             for t in tensors]
    return [Tensor._wrap(o) for o in torch.meshgrid(*datas, indexing="ij")]


def tril_indices(row, col, offset=0):
    r, c = np.tril_indices(row, offset, col)
    return _new(torch.as_tensor(np.stack([r, c]),
                                device=default_torch_device()))


def triu_indices(row, col=None, offset=0):
    col = col if col is not None else row
    r, c = np.triu_indices(row, offset, col)
    return _new(torch.as_tensor(np.stack([r, c]),
                                device=default_torch_device()))


def clone(x):
    return assign(x)


def complex(real, imag):
    return _complex(real, imag)


@register_op("complex")
def _complex(real, imag):
    return torch.complex(real, imag)


@register_op("as_complex")
def as_complex(x):
    return torch.view_as_complex(x.contiguous())


@register_op("as_real")
def as_real(x):
    return torch.view_as_real(x)
