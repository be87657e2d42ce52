"""Comparison, logical and bitwise ops (counterpart of
paddle_tpu/ops/logic.py)."""
from __future__ import annotations

import torch

from ._util import pair as _pair
from .registry import register_op

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "equal_all", "allclose", "isclose",
           "logical_and", "logical_or", "logical_xor", "logical_not",
           "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
           "bitwise_left_shift", "bitwise_right_shift", "is_empty",
           "is_tensor"]


@register_op("equal")
def equal(x, y):
    x, y = _pair(x, y)
    return torch.eq(x, y)


@register_op("not_equal")
def not_equal(x, y):
    x, y = _pair(x, y)
    return torch.ne(x, y)


@register_op("greater_than")
def greater_than(x, y):
    x, y = _pair(x, y)
    return torch.gt(x, y)


@register_op("greater_equal")
def greater_equal(x, y):
    x, y = _pair(x, y)
    return torch.ge(x, y)


@register_op("less_than")
def less_than(x, y):
    x, y = _pair(x, y)
    return torch.lt(x, y)


@register_op("less_equal")
def less_equal(x, y):
    x, y = _pair(x, y)
    return torch.le(x, y)


@register_op("equal_all")
def equal_all(x, y):
    x, y = _pair(x, y)
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return torch.all(x == y)


@register_op("allclose")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(isclose.raw_fn(x, y, rtol, atol, equal_nan))


@register_op("isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register_op("logical_and")
def logical_and(x, y):
    x, y = _pair(x, y)
    return torch.logical_and(x, y)


@register_op("logical_or")
def logical_or(x, y):
    x, y = _pair(x, y)
    return torch.logical_or(x, y)


@register_op("logical_xor")
def logical_xor(x, y):
    x, y = _pair(x, y)
    return torch.logical_xor(x, y)


@register_op("logical_not")
def logical_not(x):
    return torch.logical_not(x)


@register_op("bitwise_and")
def bitwise_and(x, y):
    x, y = _pair(x, y)
    return torch.bitwise_and(x, y)


@register_op("bitwise_or")
def bitwise_or(x, y):
    x, y = _pair(x, y)
    return torch.bitwise_or(x, y)


@register_op("bitwise_xor")
def bitwise_xor(x, y):
    x, y = _pair(x, y)
    return torch.bitwise_xor(x, y)


@register_op("bitwise_not")
def bitwise_not(x):
    return torch.bitwise_not(x)


@register_op("bitwise_left_shift")
def bitwise_left_shift(x, y):
    x, y = _pair(x, y)
    return torch.bitwise_left_shift(x, y)


@register_op("bitwise_right_shift")
def bitwise_right_shift(x, y):
    x, y = _pair(x, y)
    return torch.bitwise_right_shift(x, y)


@register_op("is_empty")
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    from ..core.tensor import Tensor
    return isinstance(x, Tensor)
