"""Reduction and statistics ops (counterpart of
paddle_tpu/ops/reduction.py). ``axis`` is None (all axes), an int or a
list; integer sums keep int32 and integer means compute in float32, as
the reference's do."""
from __future__ import annotations

import torch

from ._util import ax, dt, floatlike
from .registry import register_op

__all__ = ["sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
           "var", "std", "median", "nanmedian", "nansum", "nanmean",
           "quantile", "nanquantile", "all", "any", "count_nonzero",
           "cumsum", "cumprod", "cummax", "cummin", "cumulative_trapezoid"]


def _dims(x, axis):
    """The axes to reduce as torch takes them (a tuple; all of them for
    None)."""
    a = ax(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


def _no_axes(axis):
    """True for an empty axis list: the reference (jnp) reduces no axis
    there, where torch reduces every axis over an empty `dim`. (Paddle
    itself reduces every axis: ROADMAP Queue C, known gaps.)"""
    a = ax(axis)
    return isinstance(a, tuple) and not a


def _int_acc(x):
    """jnp sums bool and narrow ints in int32 (torch in int64)."""
    return torch.int32 if not (x.is_floating_point() or x.is_complex()) \
        else None


@register_op("sum")
def sum(x, axis=None, dtype=None, keepdim=False):
    d = dt(dtype) if dtype is not None else _int_acc(x)
    if _no_axes(axis):
        return x if d is None else x.to(d)
    if axis is None and not keepdim:
        # the whole-tensor reduction torch's own x.sum() runs
        return torch.sum(x, dtype=d)
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=d)


@register_op("mean")
def mean(x, axis=None, keepdim=False):
    if _no_axes(axis):
        return floatlike(x)
    if axis is None and not keepdim:
        return torch.mean(floatlike(x))
    return torch.mean(floatlike(x), dim=_dims(x, axis), keepdim=keepdim)


def _minmax(fn, x, axis, keepdim):
    if x.dim() == 0 or _no_axes(axis):
        return x
    return fn(x, dim=_dims(x, axis), keepdim=keepdim)


@register_op("max")
def max(x, axis=None, keepdim=False):
    return _minmax(torch.amax, x, axis, keepdim)


@register_op("min")
def min(x, axis=None, keepdim=False):
    return _minmax(torch.amin, x, axis, keepdim)


@register_op("amax")
def amax(x, axis=None, keepdim=False):
    return _minmax(torch.amax, x, axis, keepdim)


@register_op("amin")
def amin(x, axis=None, keepdim=False):
    return _minmax(torch.amin, x, axis, keepdim)


@register_op("prod")
def prod(x, axis=None, keepdim=False, dtype=None):
    d = dt(dtype) if dtype is not None else _int_acc(x)
    out = x if d is None else x.to(d)
    if x.dim() == 0:
        return out
    # torch.prod reduces one axis a call: the last first keeps the
    # others' indices
    for a in sorted({a % x.dim() for a in _dims(x, axis)}, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdim)
    return out


@register_op("logsumexp")
def logsumexp(x, axis=None, keepdim=False):
    if _no_axes(axis):
        return floatlike(x)
    return torch.logsumexp(floatlike(x), dim=_dims(x, axis), keepdim=keepdim)


@register_op("var")
def var(x, axis=None, unbiased=True, keepdim=False):
    if _no_axes(axis):
        return _var_of_one(x, unbiased)
    return torch.var(floatlike(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@register_op("std")
def std(x, axis=None, unbiased=True, keepdim=False):
    if _no_axes(axis):
        return torch.sqrt(_var_of_one(x, unbiased))
    return torch.std(floatlike(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _var_of_one(x, unbiased):
    """The variance of each element alone, as jnp.var over no axis gives
    it: 0 / (1 - ddof), so nan when unbiased."""
    xf = floatlike(x)
    return torch.square(xf - xf) / (0.0 if unbiased else 1.0)


def _moved(x, axis):
    """x with the reduced axes flattened into the last one, and the
    shape keepdim restores: (y, keep_shape)."""
    dims = tuple(a % x.dim() for a in _dims(x, axis)) if x.dim() else ()
    rest = [i for i in range(x.dim()) if i not in dims]
    y = x.permute(rest + list(dims)).reshape(
        [x.shape[i] for i in rest] + [-1])
    keep = [1 if i in dims else x.shape[i] for i in range(x.dim())]
    return y, keep


def _quantile(x, q, axis, keepdim, nan):
    """numpy's linear quantile (and nanquantile) over `axis`."""
    y, keep = _moved(floatlike(x), axis)
    qt = torch.as_tensor(q, dtype=y.dtype, device=y.device)
    fn = torch.nanquantile if nan else torch.quantile
    out = fn(y, qt.reshape(-1), dim=-1)                 # [nq, ...]
    if keepdim:
        out = out.reshape([out.shape[0]] + keep)
    return out if qt.dim() else out[0]


@register_op("median")
def median(x, axis=None, keepdim=False):
    """numpy's median: the mean of the two middles for an even count."""
    return _quantile(x, 0.5, axis, keepdim, nan=False)


@register_op("nanmedian")
def nanmedian(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim, nan=True)


@register_op("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False):
    if _no_axes(axis):
        if x.is_floating_point() or x.is_complex():
            return torch.nan_to_num(x, nan=0.0, posinf=float("inf"),
                                    neginf=float("-inf"))
        return x.to(torch.int32)
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim)


@register_op("nanmean")
def nanmean(x, axis=None, keepdim=False):
    if _no_axes(axis):
        return floatlike(x)
    return torch.nanmean(floatlike(x), dim=_dims(x, axis), keepdim=keepdim)


@register_op("quantile")
def quantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, axis, keepdim, nan=False)


@register_op("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, axis, keepdim, nan=True)


@register_op("all")
def all(x, axis=None, keepdim=False):
    if x.dim() == 0 or _no_axes(axis):
        return x.bool()
    return torch.all(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


@register_op("any")
def any(x, axis=None, keepdim=False):
    if x.dim() == 0 or _no_axes(axis):
        return x.bool()
    return torch.any(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


@register_op("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False):
    if _no_axes(axis):
        return (x != 0).to(torch.int32)
    return torch.sum(x != 0, dim=_dims(x, axis), keepdim=keepdim,
                     dtype=torch.int32)


@register_op("cumsum")
def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.cumsum(x, dim=axis, dtype=_int_acc(x))


@register_op("cumprod")
def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    return torch.cumprod(x, dim=dim, dtype=_int_acc(x))


@register_op("cummax")
def cummax(x, axis=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    vals, idx = torch.cummax(x, dim=axis)
    return vals, _last_match(x, vals, axis)


@register_op("cummin")
def cummin(x, axis=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    vals, idx = torch.cummin(x, dim=axis)
    return vals, _last_match(x, vals, axis)


def _last_match(x, vals, axis):
    """The index of the last element equal to the running extreme, as
    the reference picks it (reduction.py:153-160)."""
    n = x.shape[axis]
    shape = [n if i == axis % x.dim() else 1 for i in range(x.dim())]
    ar = torch.arange(n, device=x.device).reshape(shape)
    idx = torch.where(x == vals, ar, torch.full_like(ar, -1))
    return torch.cummax(idx.expand(x.shape).contiguous(), dim=axis)[0]


@register_op("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.cumulative_trapezoid(y, x, dim=axis)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else dx,
                                      dim=axis)

