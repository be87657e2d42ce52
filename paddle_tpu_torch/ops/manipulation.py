"""Shape and layout ops (counterpart of paddle_tpu/ops/manipulation.py).

Scatters and index updates are out of place: each writes into a clone
(``index_put``, ``scatter``, ``index_add`` ...), so the input and any
tensor autograd saved stay as they were, as the reference's ``.at[]``
updates leave their input. ``flatten`` is the nn functional's registered
op."""
from __future__ import annotations

import builtins

import torch

from ..core.tensor import Tensor
from ..nn.functional import flatten
from ._util import as_tensor, dt, promote, promote_all, shape_arg
from .registry import register_op

__all__ = [
    "reshape", "transpose", "flatten", "squeeze", "unsqueeze", "concat",
    "stack", "split", "chunk", "unbind", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "roll", "flip", "rot90", "gather",
    "gather_nd", "take_along_axis", "put_along_axis", "scatter",
    "scatter_nd_add", "scatter_nd", "index_select", "index_sample",
    "index_add", "index_put", "index_fill", "masked_select", "masked_fill",
    "where", "slice", "strided_slice", "repeat_interleave", "moveaxis",
    "swapaxes", "as_strided", "unfold", "cast", "tensordot", "atleast_1d",
    "atleast_2d", "atleast_3d", "view", "crop", "shard_index", "unstack",
    "fill_diagonal"]


def _idx(index: torch.Tensor) -> torch.Tensor:
    """An index tensor as torch's gathers and scatters take it."""
    return index.long()


def _nd_index(index):
    """gather_nd's index [..., k] as a tuple of k index tensors."""
    return tuple(_idx(index).movedim(-1, 0))


@register_op("reshape")
def reshape(x, shape):
    return torch.reshape(x, shape_arg(shape))


@register_op("transpose")
def transpose(x, perm=None):
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return x.permute(*[int(p) for p in perm])


@register_op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axes = tuple(a % x.dim() for a in axis if x.shape[a % x.dim()] == 1)
        return torch.squeeze(x, axes) if axes else x
    axis = axis % x.dim()
    return torch.squeeze(x, axis) if x.shape[axis] == 1 else x


@register_op("unsqueeze")
def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, int(axis))


@register_op("concat")
def concat(x, axis=0):
    return torch.cat(promote_all(list(x)), dim=int(axis))


@register_op("stack")
def stack(x, axis=0):
    return torch.stack(promote_all(list(x)), dim=int(axis))


@register_op("split_op", tags=("multi_out",))
def _split(x, num_or_sections, axis=0):
    axis = int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: axis {axis} of size {total} does not "
                             f"divide into {num_or_sections} parts")
        return tuple(torch.split(x, total // num_or_sections, dim=axis))
    sections = [int(s) for s in num_or_sections]
    known = builtins.sum(s for s in sections if s != -1)
    sections = [total - known if s == -1 else s for s in sections]
    return tuple(torch.split(x, sections, dim=axis))


def split(x, num_or_sections, axis=0):
    return list(_split(x, num_or_sections, axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def unbind(x, axis=0):
    n = x.shape[axis]
    return [squeeze(p, axis) for p in split(x, n, axis)]


@register_op("tile")
def tile(x, repeat_times):
    return torch.tile(x, shape_arg(repeat_times))


@register_op("expand")
def expand(x, shape):
    shape = shape_arg(shape)
    cur = [1] * (len(shape) - x.dim()) + list(x.shape)
    tgt = [c if s == -1 else s for s, c in zip(shape, cur)]
    return x.reshape(cur).expand(tgt)


@register_op("expand_as")
def expand_as(x, y):
    return x.expand(y.shape)


@register_op("broadcast_to")
def broadcast_to(x, shape):
    return torch.broadcast_to(x, shape_arg(shape))


def broadcast_tensors(inputs):
    datas = [t._data if isinstance(t, Tensor) else torch.as_tensor(t)
             for t in inputs]
    return [Tensor._wrap(o) for o in torch.broadcast_tensors(*datas)]


@register_op("roll")
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, dims=axis)


@register_op("flip")
def flip(x, axis):
    axis = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(x, axis)


@register_op("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@register_op("gather")
def gather(x, index, axis=0):
    index = index.reshape(-1) if index.dim() > 1 else index
    return torch.index_select(x, int(axis), _idx(index).reshape(-1)) \
        if index.dim() else torch.select(x, int(axis), int(index))


@register_op("gather_nd")
def gather_nd(x, index):
    return x[_nd_index(index)]


@register_op("take_along_axis")
def take_along_axis(arr, indices, axis, broadcast=True):
    if broadcast:
        shape = list(arr.shape)
        shape[axis] = indices.shape[axis]
        indices = torch.broadcast_to(indices, shape)
    return torch.take_along_dim(arr, _idx(indices), dim=axis)


_REDUCE = {"add": "sum", "sum": "sum", "multiply": "prod", "mul": "prod",
           "amax": "amax", "amin": "amin"}


@register_op("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign"):
    values = torch.broadcast_to(as_tensor(values, arr).to(arr.dtype),
                                indices.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, _idx(indices), values)
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce}")
    return torch.scatter_reduce(arr, axis, _idx(indices), values,
                                _REDUCE[reduce], include_self=True)


@register_op("scatter")
def scatter(x, index, updates, overwrite=True):
    index = _idx(index.reshape(-1))
    if overwrite:
        out = x.clone()
        out[index] = updates.to(x.dtype)
        return out
    zeros = torch.zeros_like(x).index_add(0, index, updates.to(x.dtype))
    mask = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    mask[index] = True
    return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), zeros, x)


@register_op("scatter_nd_add")
def scatter_nd_add(x, index, updates):
    return torch.index_put(x, _nd_index(index), updates.to(x.dtype),
                           accumulate=True)


@register_op("scatter_nd")
def scatter_nd(index, updates, shape):
    zeros = torch.zeros(shape_arg(shape), dtype=updates.dtype,
                        device=updates.device)
    return torch.index_put(zeros, _nd_index(index), updates, accumulate=True)


@register_op("index_select")
def index_select(x, index, axis=0):
    return torch.index_select(x, int(axis), _idx(index.reshape(-1)))


@register_op("index_sample")
def index_sample(x, index):
    return torch.gather(x, 1, _idx(index))


@register_op("index_add")
def index_add(x, index, axis, value):
    return torch.index_add(x, int(axis), _idx(index.reshape(-1)),
                           value.to(x.dtype))


@register_op("index_put")
def index_put(x, indices, value, accumulate=False):
    idx = tuple(i if i.dtype == torch.bool else _idx(i) for i in indices)
    value = as_tensor(value, x).to(x.dtype)
    return torch.index_put(x, idx, value, accumulate=accumulate)


@register_op("index_fill")
def index_fill(x, index, axis, value):
    return torch.index_fill(x, int(axis), _idx(index.reshape(-1)), value)


@register_op("masked_select")
def masked_select(x, mask):
    return torch.masked_select(x, mask.bool())


@register_op("masked_fill")
def masked_fill(x, mask, value):
    return torch.where(mask.bool(), as_tensor(value, x).to(x.dtype), x)


@register_op("where")
def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.stack(torch.nonzero(condition, as_tuple=True), dim=1)
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, y)
    if not isinstance(y, torch.Tensor):
        y = as_tensor(y, x)
    x, y = promote(x, y)
    return torch.where(condition.bool(), x, y)


@register_op("slice_op")
def _slice(x, axes, starts, ends):
    sl = [builtins.slice(None)] * x.dim()
    for a, st, en in zip(axes, starts, ends):
        sl[a] = builtins.slice(int(st), int(en))
    return x[tuple(sl)]


def slice(x, axes, starts, ends):
    return _slice(x, axes, starts, ends)


@register_op("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    sl = [builtins.slice(None)] * x.dim()
    for a, st, en, sd in zip(axes, starts, ends, strides):
        if int(sd) < 0:
            raise NotImplementedError(
                "strided_slice: negative strides are not supported")
        sl[a] = builtins.slice(int(st), int(en), int(sd))
    return x[tuple(sl)]


@register_op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = _idx(repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op("moveaxis")
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@register_op("swapaxes")
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@register_op("as_strided")
def as_strided(x, shape, stride, offset=0):
    return torch.as_strided(x.contiguous(), shape_arg(shape),
                            shape_arg(stride), int(offset))


@register_op("unfold")
def unfold(x, axis, size, step):
    """Windows of `size` every `step` along `axis`, the window as the
    last axis (Tensor.unfold)."""
    return x.unfold(int(axis), int(size), int(step))


@register_op("cast")
def cast(x, dtype):
    return x.to(dt(dtype))


@register_op("tensordot")
def tensordot(x, y, axes=2):
    x, y = promote(x, y)
    return torch.tensordot(x, y, dims=axes)


@register_op("atleast_1d_op")
def _atleast_1d(x):
    return torch.atleast_1d(x)


def atleast_1d(*xs):
    outs = [_atleast_1d(x) for x in xs]
    return outs if len(outs) > 1 else outs[0]


@register_op("atleast_2d_op")
def _atleast_2d(x):
    return torch.atleast_2d(x)


def atleast_2d(*xs):
    outs = [_atleast_2d(x) for x in xs]
    return outs if len(outs) > 1 else outs[0]


@register_op("atleast_3d_op")
def _atleast_3d(x):
    return torch.atleast_3d(x)


def atleast_3d(*xs):
    outs = [_atleast_3d(x) for x in xs]
    return outs if len(outs) > 1 else outs[0]


@register_op("view")
def view(x, shape_or_dtype):
    if isinstance(shape_or_dtype, (list, tuple)):
        return torch.reshape(x, shape_arg(shape_or_dtype))
    return x.view(dt(shape_or_dtype))


@register_op("crop")
def crop(x, shape=None, offsets=None):
    shape = shape_arg(shape) if shape is not None else tuple(x.shape)
    offsets = list(offsets) if offsets is not None else [0] * x.dim()
    sl = tuple(builtins.slice(int(o), int(o) + (x.shape[i] if s == -1 else s))
               for i, (o, s) in enumerate(zip(offsets, shape)))
    return x[sl]


@register_op("shard_index")
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full_like(x, ignore_value))


@register_op("unstack")
def unstack(x, axis=0, num=None):
    """Single slices along axis, the axis squeezed."""
    return tuple(torch.unbind(x, dim=axis))


@register_op("fill_diagonal")
def fill_diagonal(x, value, offset=0, wrap=False):
    """The diagonal at `offset` of the last two axes set to value (out of
    place; wrap restarts it every n + 1 rows of a tall 2-D x)."""
    m, n = x.shape[-2:]
    rows = torch.arange(m, device=x.device)[:, None]
    cols = torch.arange(n, device=x.device)[None, :]
    hit = (cols - rows) == offset
    if wrap and x.dim() == 2 and m > n:
        if offset != 0:
            raise NotImplementedError(
                "fill_diagonal: wrap=True with a nonzero offset is not "
                "supported")
        hit = torch.remainder(rows - cols, n + 1) == 0
    return torch.where(hit, torch.tensor(value, dtype=x.dtype,
                                         device=x.device), x)

