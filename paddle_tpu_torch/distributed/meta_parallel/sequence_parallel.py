"""Sequence-parallel utilities (counterpart of
paddle_tpu/distributed/meta_parallel/sequence_parallel.py).

One controller: as in the reference, sequence parallelism is a
placement. Activations [b, s, ...] carry ``P(None, "mp", ...)`` in the
layer-norm and dropout region, and the boundary ops are reshards
(``dist_reshard``) that each note a ``comms.reshard`` marker with the
array's bytes and no duration, as the reference's do.

Process groups (mp > 1): each rank holds its chunk of axis 1, and the
boundary ops are the autograd Functions of ``mp_layers``: ``scatter``
keeps this rank's chunk (the gradient is gathered), ``all_gather``
gathers the chunks (the gradient is split back), ``reduce_scatter`` sums
the partial products and keeps this rank's chunk (the gradient is
gathered). The collectives record themselves (``communication``).
"""
from __future__ import annotations

import torch

from ...core.tensor import Tensor
from ...observability import comms as _comms
from ...observability import metrics as _om
from ...ops.registry import eager_method
from ..topology import NamedSharding
from ..topology import PartitionSpec as P
from .mp_layers import (
    ColumnParallelLinear, RowParallelLinear, _c_concat, _c_identity,
    _c_split, _dist_reshard, _mesh, _reduce_scatter, _split_group,
)

__all__ = ["scatter", "all_gather", "reduce_scatter", "ScatterOp",
           "GatherOp", "AllGatherOp", "ColumnSequenceParallelLinear",
           "RowSequenceParallelLinear",
           "register_sequence_parallel_allreduce_hooks",
           "mark_as_sequence_parallel_parameter"]


def _seq_spec(ndim, axis="mp"):
    # [b, s, ...] with the sequence axis split
    spec = [None] * ndim
    spec[1] = axis
    return P(*spec)


def _note(op, axis, t):
    # a reshard boundary: count, bytes and a zero-duration marker (the
    # reference's: its collective is asynchronous and may be fused or
    # elided by XLA, so no honest host timing exists)
    if _om._ENABLED:
        _comms.note_reshard(op, axis, int(t.size) * t._data.element_size())


def _boundary(op, x, axis, split_fn, spec):
    """One boundary op on `x` (a Tensor, a torch tensor, which gives a
    torch tensor back, or an array): `split_fn(data, group)` in
    process-group mode, else a noted reshard to `spec(ndim)`."""
    torch_in = isinstance(x, torch.Tensor)
    t = Tensor._wrap(x) if torch_in else (
        x if isinstance(x, Tensor) else Tensor(x))
    g = _split_group()
    if g is not None:
        out = Tensor._wrap(split_fn(t._data, g))
    else:
        _note(op, axis, t)
        out = _dist_reshard(t, dst_sharding=NamedSharding(
            _mesh(), spec(t.ndim)))
    return out._data if torch_in else out


def scatter(x, axis="mp"):
    """Split the sequence axis over the mp group (ScatterOp)."""
    return _boundary("scatter", x, axis, lambda d, g: _c_split(d, g, 1),
                     lambda n: _seq_spec(n, axis))


def all_gather(x, axis="mp"):
    """Gather the sequence axis (AllGatherOp)."""
    return _boundary("all_gather", x, axis,
                     lambda d, g: _c_concat(d, g, 1), lambda n: P())


GatherOp = all_gather
ScatterOp = scatter
AllGatherOp = all_gather


def reduce_scatter(x, axis="mp"):
    """Partial sums -> the sequence axis split (ReduceScatterOp). With
    one controller the same reshard as `scatter`, noted under its own
    op label."""
    return _boundary("reduce_scatter", x, axis,
                     lambda d, g: _reduce_scatter(d, g, 1),
                     lambda n: _seq_spec(n, axis))


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """The reference's sequence_parallel_utils.py:230: the input arrives
    split on the sequence axis and is gathered before the column
    product."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None):
        super().__init__(in_features, out_features,
                         weight_attr=weight_attr, has_bias=has_bias,
                         gather_output=gather_output, mp_group=mp_group,
                         name=name)

    def forward(self, x):
        x = all_gather(x)
        return super().forward(x)


class RowSequenceParallelLinear(RowParallelLinear):
    """The reference's sequence_parallel_utils.py:340: the output is
    reduce-scattered onto the sequence axis. Process-group mode: the
    partial products are reduce-scattered and the bias added after,
    through ``_c_identity`` (each rank's chunk adds to its gradient)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None):
        super().__init__(in_features, out_features,
                         weight_attr=weight_attr, has_bias=has_bias,
                         input_is_parallel=input_is_parallel,
                         mp_group=mp_group, name=name)

    def forward(self, x):
        if self._group is None:
            return reduce_scatter(super().forward(x))
        return self._sequence_forward(x)

    @eager_method
    def _sequence_forward(self, x):
        y = _reduce_scatter(self._partial(x), self._group, 1)
        b = self._parameters["bias"]
        return y if b is None else y + _c_identity(b, self._group).to(
            y.dtype)


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               use_mp=True):
    """The reference's sequence_parallel_utils.py:192: the parameters of
    the sequence-parallel region (marked by
    `mark_as_sequence_parallel_parameter`) see only their rank's chunk
    of the sequence, so their gradients are summed over the mp group.
    With one controller the gradient is already the whole one (a no-op,
    as in the reference); in process-group mode a hook on each marked
    parameter all-reduces its gradient. Returns None."""
    g = _split_group()
    if g is None or not use_mp:
        return None
    from .mp_layers import _all_reduce
    for p in model.parameters():
        if getattr(p._data, "_sequence_parallel", False) \
                and not p.stop_gradient:
            p.register_hook(lambda grad, _g=g: Tensor._wrap(
                _all_reduce(grad._data, _g)))
    return None


def mark_as_sequence_parallel_parameter(param):
    getattr(param, "_data", param)._sequence_parallel = True
    return param
