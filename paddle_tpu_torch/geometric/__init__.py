"""Graph message passing (counterpart of paddle_tpu/geometric).

Messages are row gathers along the edges (``index_select``), reductions
``index_add`` (sum, mean) and ``scatter_reduce`` (max, min) onto the
destination nodes, registered under the reference's op names; gradients
come from torch.autograd (a max or min splits its gradient evenly among
tied messages, as the reference's segment reductions do).

Out-of-range indices follow the reference's XLA semantics, with no host
read: a gather index wraps once when negative and is then clamped into
[0, n) (``x[idx]`` in jnp), and a message whose destination lies outside
[0, out_size) is dropped (``segment_sum``). An empty segment of a max or
min reduction is 0, and, as the reference tests the result for ±inf to
find the empty ones, so is a segment whose max or min is a genuine ±inf
(for integers: the type's min for max, its max for min).

Neighbour sampling and ``reindex_graph`` run on the host in numpy, as in
the reference; the sampler's numpy generator is seeded from the port's
default generator, so ``seed`` makes it reproducible. Their results go to
the device of the graph's input tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.generator import torch_generator
from ..core.tensor import NARROW, Tensor
from ..ops.registry import register_op

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_sum",
           "segment_mean", "segment_max", "segment_min", "segment_pool",
           "reindex_graph", "sample_neighbors",
           "weighted_sample_neighbors"]


def _gather(x, idx):
    """x[idx] along rows with jnp's index rules (wrap once, clamp)."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x.index_select(0, idx)


def _seg_reduce(msg, dst, num, reduce_op):
    """Reduce the rows of msg onto `num` segments by dst; messages with a
    destination outside [0, num) go to a dropped extra row."""
    dst = dst.long()
    dst = torch.where((dst < 0) | (dst >= num), torch.full_like(dst, num),
                      dst)
    tail = tuple(msg.shape[1:])
    if reduce_op in ("sum", "mean"):
        out = msg.new_zeros((num + 1,) + tail).index_add(0, dst, msg)[:num]
        if reduce_op == "sum":
            return out
        cnt = torch.zeros(num + 1, dtype=msg.dtype, device=msg.device)
        cnt = cnt.index_add(0, dst, torch.ones_like(dst, dtype=msg.dtype))
        return out / torch.clamp(cnt[:num], min=1.0).reshape(
            (-1,) + (1,) * len(tail))
    if reduce_op in ("max", "min"):
        index = dst.reshape((-1,) + (1,) * len(tail)).expand(msg.shape)
        out = msg.new_zeros((num + 1,) + tail).scatter_reduce(
            0, index, msg, "amax" if reduce_op == "max" else "amin",
            include_self=False)[:num]
        # an empty segment keeps its 0; a genuine +-inf (an integer type's
        # sentinel) is zeroed as the reference zeroes it
        if out.is_floating_point():
            bad = torch.isinf(out)
        else:
            info = torch.iinfo(out.dtype)
            bad = out == (info.min if reduce_op == "max" else info.max)
        return torch.where(bad, torch.zeros_like(out), out)
    raise ValueError(f"unknown reduce_op {reduce_op!r}")


@register_op("send_u_recv")
def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None):
    """Gather x's rows along the src edges and reduce them onto the dst
    nodes."""
    num = int(out_size) if out_size is not None else x.shape[0]
    return _seg_reduce(_gather(x, src_index), dst_index, num, reduce_op)


def _ecompute(u, e, compute_op):
    if compute_op == "add":
        return u + e
    if compute_op == "sub":
        return u - e
    if compute_op == "mul":
        return u * e
    if compute_op == "div":
        return u / e
    raise ValueError(f"unknown compute_op {compute_op!r}")


@register_op("send_ue_recv")
def send_ue_recv(x, y, src_index, dst_index, compute_op="add",
                 reduce_op="sum", out_size=None):
    """Message = compute(x[src], y[edge]), reduced onto the dst nodes."""
    num = int(out_size) if out_size is not None else x.shape[0]
    u = _gather(x, src_index)
    e = y
    if e.dim() < u.dim():
        e = e.reshape(tuple(e.shape) + (1,) * (u.dim() - e.dim()))
    return _seg_reduce(_ecompute(u, e, compute_op), dst_index, num,
                       reduce_op)


@register_op("send_uv")
def send_uv(x, y, src_index, dst_index, compute_op="add"):
    """Per-edge message from both endpoints: compute(x[src], y[dst])."""
    return _ecompute(_gather(x, src_index), _gather(y, dst_index),
                     compute_op)


@register_op("segment_pool", cacheable=False)
def segment_pool(x, segment_ids, pool_type="sum", out_size=None):
    """Pool x's rows by segment_ids (sorted ascending). Without out_size
    the segment count is the last id + 1, read from the device (a host
    sync): pass out_size where that matters, as under a CUDA graph."""
    if out_size is not None:
        num = int(out_size)
    else:
        num = int(segment_ids[-1]) + 1
    kind = pool_type.lower()
    return _seg_reduce(x, segment_ids, num,
                       "mean" if kind == "avg" else kind)


def segment_sum(x, segment_ids, out_size=None):
    return segment_pool(x, segment_ids, "sum", out_size=out_size)


def segment_mean(x, segment_ids, out_size=None):
    return segment_pool(x, segment_ids, "mean", out_size=out_size)


def segment_max(x, segment_ids, out_size=None):
    return segment_pool(x, segment_ids, "max", out_size=out_size)


def segment_min(x, segment_ids, out_size=None):
    return segment_pool(x, segment_ids, "min", out_size=out_size)


# ---- sampling and reindexing: host (numpy) work of the input pipeline,
# as in the reference; the device sees the fixed reindexed tensors


def _host(t):
    """(numpy array, torch device) of a Tensor, torch tensor or array."""
    d = t._data if isinstance(t, Tensor) else t
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy(), d.device
    return np.asarray(d), None


def _device_of(*ts):
    for t in ts:
        if t is not None:
            dev = _host(t)[1]
            if dev is not None:
                return dev
    from ..core.device import default_torch_device
    return default_torch_device()


def _tensor(a, device):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return Tensor._wrap(t.to(device, NARROW.get(t.dtype, t.dtype)))


def reindex_graph(x, neighbors, count, value_buffer=None,
                  index_buffer=None, name=None):
    """Node ids renumbered into [0, n): x first, in order, then each new
    neighbour as it first appears. Returns (reindex_src, reindex_dst,
    out_nodes)."""
    xv = _host(x)[0].reshape(-1)
    nb = _host(neighbors)[0].reshape(-1)
    ct = _host(count)[0].reshape(-1).astype(np.int64)
    seen = dict.fromkeys(xv.tolist())
    for v in nb.tolist():
        seen.setdefault(v, None)
    out_nodes = np.fromiter(seen.keys(), dtype=xv.dtype, count=len(seen))
    lut = {v: i for i, v in enumerate(out_nodes.tolist())}
    reindex_src = np.array([lut[v] for v in nb.tolist()], xv.dtype)
    reindex_dst = np.repeat(np.arange(len(xv), dtype=xv.dtype), ct)
    dev = _device_of(x, neighbors, count)
    return (_tensor(reindex_src, dev), _tensor(reindex_dst, dev),
            _tensor(out_nodes, dev))


def _host_rng():
    """A numpy generator seeded by a draw of the port's default
    generator (its CPU stream)."""
    seed = torch.randint(0, 2 ** 62, (2,), dtype=torch.int64,
                         generator=torch_generator(torch.device("cpu")))
    return np.random.default_rng(seed.tolist())


def _sample_neighbors_impl(row, colptr, input_nodes, sample_size, eids,
                           return_eids, weights):
    rowv = _host(row)[0].reshape(-1)
    cp = _host(colptr)[0].reshape(-1).astype(np.int64)
    nodes = _host(input_nodes)[0].reshape(-1)
    ev = _host(eids)[0].reshape(-1) if eids is not None else None
    wv = _host(weights)[0].reshape(-1) if weights is not None else None
    rng = _host_rng()
    outs, cnts, oeids = [], [], []
    for n in nodes.tolist():
        lo, hi = int(cp[n]), int(cp[n + 1])
        deg = hi - lo
        if sample_size < 0 or deg <= sample_size:
            pick = np.arange(lo, hi)
        elif wv is not None:
            w = wv[lo:hi].astype(np.float64)
            p = w / w.sum() if w.sum() > 0 else None
            pick = lo + rng.choice(deg, size=sample_size, replace=False,
                                   p=p)
        else:
            pick = lo + rng.choice(deg, size=sample_size, replace=False)
        outs.append(rowv[pick])
        cnts.append(len(pick))
        if return_eids:
            if ev is None:
                raise ValueError("return_eids=True requires eids")
            oeids.append(ev[pick])
    out = np.concatenate(outs) if outs else np.empty(0, rowv.dtype)
    dev = _device_of(row, colptr, input_nodes)
    res = (_tensor(out, dev), _tensor(np.asarray(cnts, np.int32), dev))
    if return_eids:
        oe = np.concatenate(oeids) if oeids else np.empty(0, rowv.dtype)
        res = res + (_tensor(oe, dev),)
    return res


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbour sampling without replacement over a CSC graph:
    (out_neighbors, out_count[, out_eids])."""
    return _sample_neighbors_impl(row, colptr, input_nodes, sample_size,
                                  eids, return_eids, None)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None,
                              return_eids=False, name=None):
    """Weight-proportional neighbour sampling without replacement over a
    CSC graph: (out_neighbors, out_count[, out_eids])."""
    return _sample_neighbors_impl(row, colptr, input_nodes, sample_size,
                                  eids, return_eids, edge_weight)
