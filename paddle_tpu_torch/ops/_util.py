"""Helpers the op modules share: dtype promotion as jnp promotes two
arrays, axis and shape arguments as the reference reads them."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import NARROW, Tensor


def promote(x, y):
    """(x, y) with two tensors of different dtypes cast to their common
    type, as jnp promotes two arrays whatever their ranks (torch lets a
    0-d tensor take the other's type instead). Python scalars stay as
    they are: both libraries treat them as weak."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
            and x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt), y.to(dt)
    return x, y


def promote_all(xs):
    """A list of tensors cast to their common type (jnp's rule, as
    ``promote``)."""
    d = xs[0].dtype
    for x in xs[1:]:
        d = torch.promote_types(d, x.dtype)
    return [x.to(d) for x in xs]


def pair(x, y):
    """Both operands of a binary op as tensors of one dtype; a Python
    scalar becomes a tensor of the other operand's type when it is of
    the same kind (weak, as jnp keeps it)."""
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, y)
    if not isinstance(y, torch.Tensor):
        y = as_tensor(y, x)
    return promote(x, y)


def new_tensor(t: torch.Tensor) -> Tensor:
    """A fresh, unrecorded Tensor of an op that takes no Tensor (a
    creation or random op), in the reference's dtype."""
    return Tensor._wrap(t.to(NARROW.get(t.dtype, t.dtype)),
                        stop_gradient=True)


def as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    """`x` as a torch tensor on `like`'s device (a Python scalar keeps
    its weak type by taking `like`'s when it is of the same kind)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x, device=like.device)
    if isinstance(x, int) and like.dtype == torch.bool:
        # a weak int takes a bool array to int32 in jnp
        return torch.tensor(x, dtype=torch.int32, device=like.device)
    if isinstance(x, int) and not like.is_floating_point():
        return torch.tensor(x, dtype=like.dtype, device=like.device)
    if isinstance(x, float) and (like.is_floating_point()
                                 or like.is_complex()):
        return torch.tensor(x, dtype=like.dtype, device=like.device)
    t = torch.as_tensor(np.asarray(x), device=like.device)
    return t.to(NARROW.get(t.dtype, t.dtype))


def ax(axis):
    """An axis argument: None, an int or a tuple of ints (a list or a
    Tensor taken as one)."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def shape_arg(shape):
    """A shape argument as a tuple of ints: an int, a list or tuple (of
    ints or 0-d tensors) or a tensor."""
    if isinstance(shape, Tensor):
        shape = shape._data
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, (torch.Tensor, Tensor))
                 else int(s) for s in shape)


def dt(dtype, default=torch.float32):
    """A dtype argument in the reference's types (64-bit as 32-bit)."""
    if dtype is None:
        return default
    d = dtypes.to_dtype(dtype)
    return NARROW.get(d, d)


def floatlike(x: torch.Tensor) -> torch.Tensor:
    """x, or x as float32 when it is an integer or bool tensor (jnp's
    float ops promote those to the default float)."""
    return x if x.is_floating_point() or x.is_complex() else x.float()
