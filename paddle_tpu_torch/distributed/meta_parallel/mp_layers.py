"""Tensor-parallel (mpu) layers (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py).

Two modes, as `distributed.communication` has:

1. **One controller** (no ``torch.distributed`` group, or a model
   parallel degree of 1): as in the reference, each layer holds the
   FULL logical weight and the forward is the dense math. The
   reference commits the weight to the hybrid mesh with the
   tensor-parallel ``NamedSharding`` (column weights ``P(None, "mp")``,
   row weights ``P("mp", None)``, the vocab embedding ``P("mp", None)``)
   and XLA inserts the collectives; the port records the same placement
   on the parameter (`topology.place`) and computes the same function on
   one device.

2. **Process groups** (`fleet.init` over a ``torch.distributed`` default
   group with ``mp_degree`` > 1): each process holds ITS shard (rank r
   of the mp group: rows or columns r·n/mp ... (r+1)·n/mp) and the
   layers call the collectives through autograd Functions, Megatron's
   way: ``_c_identity`` (identity forward, all-reduce of the gradient),
   ``_mp_allreduce`` (the reverse), ``_c_concat`` / ``_c_split`` (gather
   along an axis and the split back). Each layer computes the dense
   function of mode 1.

The ``dist_reshard`` op moves nothing in either mode (one device holds
the whole array); it records its destination placement on the result.
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...nn.initializer import XavierUniform
from ...nn.layer import Layer
from ...ops.registry import eager_method, register_op
from ..topology import PartitionSpec as P
from ..topology import get_hybrid_communicate_group, place

__all__ = [
    "VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
    "ParallelCrossEntropy",
]


def _mesh():
    hcg = get_hybrid_communicate_group()
    assert hcg is not None, "fleet.init(...) must run before mpu layers"
    return hcg.mesh


def _commit(param, spec):
    return place(param, _mesh(), spec)


def _split_group():
    """The model-parallel group when this process holds a shard
    (process-group mode, mp > 1), else None (the dense single
    controller)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    g = hcg.get_model_parallel_group()
    return g if g._torch_group is not None and g.nranks > 1 else None


def _shard(n, group, what):
    if n % group.nranks:
        raise ValueError(f"{what} {n} is not divisible by the model "
                         f"parallel degree {group.nranks}")
    return n // group.nranks


# ---- the collectives of process-group mode, as autograd Functions ----
def _all_reduce(t, group):
    from .. import communication
    out = t.contiguous().clone()
    communication.all_reduce(out, group=group)
    return out


def _all_gather(t, group, dim):
    from .. import communication
    parts = []
    communication.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def _chunk(t, group, dim):
    return t.chunk(group.nranks, dim)[group.rank()].contiguous()


class _CIdentity(torch.autograd.Function):
    """Forward the identity, backward the all-reduce over `group`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _MpAllreduce(torch.autograd.Function):
    """Forward the all-reduce over `group`, backward the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CConcat(torch.autograd.Function):
    """Forward the all-gather along `dim`, backward this rank's chunk."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _CSplit(torch.autograd.Function):
    """Forward this rank's chunk along `dim`, backward the all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward the sum over `group` and this rank's chunk along `dim`,
    backward the all-gather (gloo has no reduce-scatter: an all-reduce
    and a slice)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(_all_reduce(x, group), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def _c_identity(x, group):
    return _CIdentity.apply(x, group)


def _mp_allreduce(x, group):
    return _MpAllreduce.apply(x, group)


def _c_concat(x, group, dim=-1):
    return _CConcat.apply(x, group, dim % x.dim())


def _c_split(x, group, dim=-1):
    return _CSplit.apply(x, group, dim % x.dim())


def _reduce_scatter(x, group, dim):
    return _ReduceScatter.apply(x, group, dim % x.dim())


@register_op("dist_reshard")
def _dist_reshard(x, dst_sharding=None):
    """The reference's differentiable reshard (a ``device_put``): here
    the identity, its result carrying `dst_sharding` (a topology
    `NamedSharding`, or None) as its recorded placement."""
    y = x.view_as(x)
    if dst_sharding is not None:
        place(y, dst_sharding.mesh, dst_sharding.spec)
    return y


class VocabParallelEmbedding(Layer):
    """The reference's mp_layers.py:47: the table split on the vocab
    axis. Process-group mode (``c_embedding``): ids outside this rank's
    rows read zeros, and the rows are summed over the group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._group = _split_group()
        rows = num_embeddings if self._group is None else _shard(
            num_embeddings, self._group, "num_embeddings")
        self._start = 0 if self._group is None \
            else self._group.rank() * rows
        self.weight = self.create_parameter(
            (rows, embedding_dim), attr=weight_attr,
            default_initializer=XavierUniform())
        _commit(self.weight, P("mp", None))

    @eager_method
    def forward(self, x):
        w = self._parameters["weight"]
        if self._group is None:
            return F.embedding(x, w)
        local = x - self._start
        outside = (local < 0) | (local >= w.shape[0])
        out = F.embedding(torch.where(outside, 0, local), w)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return _mp_allreduce(out, self._group)


class ColumnParallelLinear(Layer):
    """The reference's mp_layers.py:333: the weight split on the output
    axis. Process-group mode: the input enters through ``_c_identity``
    and, with `gather_output`, the columns are gathered."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self._group = _split_group()
        cols = out_features if self._group is None else _shard(
            out_features, self._group, "out_features")
        self.weight = self.create_parameter(
            (in_features, cols), attr=weight_attr,
            default_initializer=XavierUniform())
        _commit(self.weight, P(None, "mp"))
        if has_bias:
            self.bias = self.create_parameter((cols,), attr=None,
                                              is_bias=True)
            _commit(self.bias, P("mp"))
        else:
            self.bias = None

    @eager_method
    def forward(self, x):
        w, b = self._parameters["weight"], self._parameters["bias"]
        if self._group is not None:
            y = F.linear(_c_identity(x, self._group), w, b)
            return _c_concat(y, self._group) if self.gather_output else y
        y = F.linear(x, w, b)
        if self.gather_output:
            # the reference replicates the mp-split output (an
            # all-gather XLA inserts)
            from ..topology import NamedSharding
            y = _dist_reshard(y, dst_sharding=NamedSharding(_mesh(), P()))
        return y


class RowParallelLinear(Layer):
    """The reference's mp_layers.py:540: the weight split on the input
    axis, the output the sum of the partial products. Process-group
    mode: the input is split unless `input_is_parallel`, the partial
    products are all-reduced and the bias (whole on every rank) added
    after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self._group = _split_group()
        rows = in_features if self._group is None else _shard(
            in_features, self._group, "in_features")
        self.weight = self.create_parameter(
            (rows, out_features), attr=weight_attr,
            default_initializer=XavierUniform())
        _commit(self.weight, P("mp", None))
        if has_bias:
            self.bias = self.create_parameter((out_features,), attr=None,
                                              is_bias=True)
            _commit(self.bias, P())
        else:
            self.bias = None

    def _partial(self, x):
        """This rank's partial product (process-group mode), no bias."""
        if not self.input_is_parallel:
            x = _c_split(x, self._group)
        return F.linear(x, self._parameters["weight"])

    @eager_method
    def forward(self, x):
        b = self._parameters["bias"]
        if self._group is None:
            return F.linear(x, self._parameters["weight"], b)
        y = _mp_allreduce(self._partial(x), self._group)
        return y if b is None else y + b.to(y.dtype)


class ParallelCrossEntropy(Layer):
    """The reference's mp_layers.py:741: softmax cross-entropy over
    vocab-split logits, per token (reduction "none"), `ignore_index`
    kept. Process-group mode: the max, the sum of exponentials and the
    target logit are all-reduced over the group; a label outside this
    rank's columns contributes zero there."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group = _split_group()

    @eager_method
    def forward(self, input, label):
        if self._group is None:
            return F.cross_entropy(input, label,
                                   ignore_index=self.ignore_index,
                                   reduction="none")
        g = self._group
        logits = input.float()
        cols = logits.shape[-1]
        start = g.rank() * cols
        if label.dim() == logits.dim():
            label = label.squeeze(-1)
        with torch.no_grad():
            from .. import communication
            m = logits.amax(-1).contiguous()
            communication.all_reduce(m, op=communication.ReduceOp.MAX,
                                     group=g)
        shifted = logits - m.unsqueeze(-1)
        sum_exp = _mp_allreduce(shifted.exp().sum(-1), g)
        local = label.long() - start
        inside = (local >= 0) & (local < cols)
        picked = shifted.gather(-1, torch.where(inside, local, 0)
                                .unsqueeze(-1)).squeeze(-1)
        target = _mp_allreduce(torch.where(inside, picked, 0.0), g)
        loss = torch.log(sum_exp) - target
        return torch.where(label.long() == self.ignore_index, 0.0, loss)
