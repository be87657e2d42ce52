"""Search and sort ops (counterpart of paddle_tpu/ops/search.py). Index
outputs are int32, as the reference gives them without x64."""
from __future__ import annotations

import torch

from ._util import dt
from .registry import register_op

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
           "nonzero", "searchsorted", "bucketize", "unique",
           "unique_consecutive", "masked_scatter"]


@register_op("argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    out = torch.argmax(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(dt(dtype))


@register_op("argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    out = torch.argmin(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(dt(dtype))


@register_op("argsort")
def argsort(x, axis=-1, descending=False, stable=False):
    return torch.argsort(x, dim=axis, descending=descending, stable=stable)


@register_op("sort")
def sort(x, axis=-1, descending=False, stable=False):
    return torch.sort(x, dim=axis, descending=descending, stable=stable)[0]


@register_op("topk")
def topk(x, k, axis=None, largest=True, sorted=True):
    vals, idx = torch.topk(x, int(k), dim=-1 if axis is None else axis,
                           largest=largest, sorted=True)
    return vals, idx


@register_op("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False):
    # the reference takes the k-th of a stable ascending sort
    s, si = torch.sort(x, dim=axis, stable=True)
    vals = torch.select(s, axis, int(k) - 1)
    idx = torch.select(si, axis, int(k) - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@register_op("mode")
def mode(x, axis=-1, keepdim=False):
    """The most frequent value along `axis` (the smallest of a tie) and
    the index of its first occurrence, as the reference computes them."""
    xm = torch.movedim(x, axis, -1)
    s = torch.sort(xm, dim=-1)[0]
    n = s.shape[-1]
    # run length of the run ending at each sorted position
    new = torch.ones_like(s, dtype=torch.bool)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    pos = torch.arange(n, device=x.device).expand(s.shape)
    first = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                         dim=-1)[0]
    best = torch.argmax(pos - first, dim=-1, keepdim=True)
    vals = torch.gather(s, -1, best)[..., 0]
    idx = torch.argmax((xm == vals[..., None]).to(torch.int32), dim=-1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@register_op("nonzero")
def nonzero(x, as_tuple=False):
    if as_tuple:
        return tuple(n[:, None] for n in torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


@register_op("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    out = torch.searchsorted(sorted_sequence, values, right=right)
    return out.to(torch.int32)


@register_op("bucketize")
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, right=right).to(torch.int32)


@register_op("unique_op")
def _unique(x, return_index=False, return_inverse=False, return_counts=False,
            axis=None):
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        # the first occurrence of each unique value (numpy's)
        flat = inv.reshape(-1)
        n = flat.numel()
        order = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0] if axis is not None
                            else vals.numel(),), n, device=x.device,
                           dtype=order.dtype)
        first = first.scatter_reduce(0, flat, order, "amin")
        outs.append(first)
    if return_inverse:
        outs.append(inv.reshape(-1) if axis is None else inv)
    if return_counts:
        outs.append(counts)
    return tuple(outs) if len(outs) > 1 else outs[0]


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    return _unique(x, return_index, return_inverse, return_counts, axis)


@register_op("unique_consecutive")
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    flat = x.reshape(-1) if axis is None else x
    out = torch.unique_consecutive(flat, return_inverse=return_inverse,
                                   return_counts=return_counts)
    return out


@register_op("masked_scatter")
def masked_scatter(x, mask, value):
    return torch.masked_scatter(x, torch.broadcast_to(mask.bool(), x.shape),
                                value.to(x.dtype))
