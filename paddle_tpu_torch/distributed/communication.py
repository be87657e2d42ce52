"""Collective communication (counterpart of
paddle_tpu/distributed/communication.py).

The reference has two modes (its :1-42): inside ``shard_map`` each rank
holds its local tensor and the collectives are ``jax.lax`` primitives;
outside, a "distributed tensor" of a G-rank group is one array whose dim
0 is G, and the collectives are shape-preserving programs over dim 0
that write their result back in place. The port maps them so:

1. **Eager rank-major** (no ``torch.distributed`` process group): the
   same functions of dim 0, computed with torch ops on the tensor's own
   device and written back in place (a ``Tensor`` rebinds its data, as
   the reference's ``_finish`` does; a torch tensor of the same shape
   is overwritten, else a new one is returned). The world group has
   `parallel.get_world_size()` ranks: the card count on CUDA (1 on one
   card), and on the CPU the host-platform device count that JAX gives
   the reference in the same environment (parallel.py says how).

2. **Per-rank local tensors** (a ``torch.distributed`` default process
   group exists: `parallel.init_parallel_env` makes one from the
   launcher's environment, or the caller made one): each process holds
   its own tensor and the functions call ``torch.distributed`` on it,
   NCCL for CUDA tensors and gloo for CPU ones, in place. This is the
   reference's in-trace mode and its multi-process jobs.

``sync_op=False`` returns a `Work`; its ``wait()`` is the collective's
completion edge. Every call records through ``observability.comms``
(``start`` / ``finish`` with the per-rank payload bytes; one flag check
when observability is off), in both modes, as the reference's eager
calls do. send / recv in rank-major mode keep the reference's
single-controller matching (each send records its destination; a recv
takes the oldest send addressed to its receiver).

Departures: ``ppermute`` and ``axis_index`` (the reference's in-trace
helpers) run in either mode and record as eager collectives; gloo has no
reduce-scatter, so over gloo it is an all-reduce and a slice.
"""
from __future__ import annotations

import collections
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.tensor import Tensor
from ..observability import comms as _comms
from ..observability import metrics as _om

__all__ = ["ReduceOp", "Group", "Work", "new_group", "get_group",
           "is_initialized", "destroy_process_group", "all_reduce",
           "all_gather", "all_to_all", "alltoall", "reduce", "broadcast",
           "reduce_scatter", "scatter", "barrier", "send", "recv", "isend",
           "irecv", "P2POp", "batch_isend_irecv", "init_default_group",
           "ppermute", "axis_index"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def _reduce_dim0(x, op, keepdim=False):
    if op == ReduceOp.SUM:
        return x.sum(0, keepdim=keepdim)
    if op == ReduceOp.MAX:
        return x.amax(0, keepdim=keepdim)
    if op == ReduceOp.MIN:
        return x.amin(0, keepdim=keepdim)
    if op == ReduceOp.PROD:
        return x.prod(0, keepdim=keepdim)
    if op == ReduceOp.AVG:
        return x.mean(0, keepdim=keepdim)
    raise ValueError(f"unknown ReduceOp {op!r}")


def _dist():
    import torch.distributed as dist
    return dist


def _pg_active() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


class Group:
    """A communication group: an ordered list of global ranks (the
    reference's group.py ``Group``). In process-group mode
    ``process_group`` is its ``torch.distributed`` group, None for a
    group this process is not in; in rank-major mode it is the group
    itself, as in the reference."""

    def __init__(self, gid: int, ranks: List[int], devices=None,
                 axis_name: Optional[str] = None, mesh=None,
                 mesh_axis: Optional[str] = None):
        self.id = gid
        self.ranks = list(ranks)
        self.nranks = len(ranks)
        self.axis_name = axis_name or f"_pg{gid}"
        self.mesh = mesh
        self.mesh_axis = mesh_axis if mesh_axis is not None \
            else self.axis_name
        self._torch_group = None        # set by _new_group_obj
        self.process_group = self

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def rank(self):
        """This process's rank in the group (0 in rank-major mode, where
        one process is every rank; -1 when it is not a member)."""
        if self._torch_group is None:
            return 0
        return self.get_group_rank(_dist().get_rank())

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks}, ranks={self.ranks})"


_GROUP_COUNTER = [0]
_GROUP_MAP = {}
_GLOBAL_GROUP: Optional[Group] = None


def _new_group_obj(ranks, devices=None, axis_name=None, mesh=None,
                   mesh_axis=None, process_group=None) -> Group:
    gid = _GROUP_COUNTER[0]
    _GROUP_COUNTER[0] += 1
    g = Group(gid, ranks, devices=devices, axis_name=axis_name, mesh=mesh,
              mesh_axis=mesh_axis)
    if process_group is not None:
        g._torch_group = g.process_group = process_group
    _GROUP_MAP[gid] = g
    return g


def init_default_group() -> Group:
    """The world group: every process of the process group, or every
    rank of the rank-major world (`parallel.get_world_size`)."""
    global _GLOBAL_GROUP
    pg = _pg_active()
    if _GLOBAL_GROUP is not None and \
            (_GLOBAL_GROUP._torch_group is not None) != pg:
        _forget_groups()
    if _GLOBAL_GROUP is None:
        if pg:
            dist = _dist()
            _GLOBAL_GROUP = _new_group_obj(
                list(range(dist.get_world_size())), axis_name="world",
                process_group=dist.group.WORLD)
        else:
            from .parallel import _rank_major_world
            _GLOBAL_GROUP = _new_group_obj(
                list(range(_rank_major_world())), axis_name="world")
    return _GLOBAL_GROUP


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return init_default_group()
    return _GROUP_MAP[gid]


def new_group(ranks: Sequence[int] = None, backend=None,
              timeout=None) -> Group:
    """A group of `ranks` (None: the world group). In process-group mode
    every process must call it, in the same order (torch.distributed's
    rule)."""
    if ranks is None:
        return init_default_group()
    init_default_group()
    if _pg_active():
        pg = _dist().new_group(list(ranks), timeout=timeout)
        # a process outside `ranks` gets a non-member handle
        return _new_group_obj(list(ranks), process_group=pg)
    return _new_group_obj(list(ranks))


def _resolve_group(group) -> Group:
    if group is None:
        return init_default_group()
    return group


def is_initialized() -> bool:
    return _GLOBAL_GROUP is not None


def _forget_groups():
    global _GLOBAL_GROUP
    _GLOBAL_GROUP = None
    _GROUP_MAP.clear()
    _GROUP_COUNTER[0] = 0
    _P2P_BUF.clear()


def destroy_process_group(group=None):
    """Forget the world group and every group; in process-group mode
    also destroy torch.distributed's default group."""
    if group is None or group is _GLOBAL_GROUP:
        _forget_groups()
        if _pg_active():
            _dist().destroy_process_group()


class Work:
    """An async collective's handle. ``wait()`` waits for the collective
    (torch.distributed's work in process-group mode), applies what
    follows it (AVG's division) and closes the observability timing
    span, so a ``sync_op=False`` collective measures launch to
    completion. Idempotent: only the first ``wait()`` records."""

    def __init__(self, result=None, rec=None):
        self._result = result
        self._rec = rec
        self._work = None       # torch.distributed's, process-group mode
        self._then = None       # what follows it (AVG's division)

    def wait(self):
        work, self._work = self._work, None
        if work is not None:
            for w in (work if isinstance(work, list) else [work]):
                w.wait()
        then, self._then = self._then, None
        if then is not None:
            then()
        rec, self._rec = self._rec, None
        if rec is not None:
            _comms.finish(rec, _data_of(self._result))
        return True

    def is_completed(self):
        return self._work is None or all(
            w.is_completed() for w in (self._work if isinstance(
                self._work, list) else [self._work]))


_Task = Work        # the reference's legacy alias


def _pg_work(result, rec, work, then=None) -> Work:
    """A Work over torch.distributed's `work` (and what follows it)."""
    w = Work(result, rec)
    w._work, w._then = work, then
    return w


def _data_of(t):
    if isinstance(t, Tensor):
        return t._data
    if isinstance(t, (list, tuple)):
        return [_data_of(x) for x in t]
    return t


def _unwrap(t) -> torch.Tensor:
    if isinstance(t, Tensor):
        return t._data
    if isinstance(t, torch.Tensor):
        return t
    from ..core.device import default_torch_device
    return torch.as_tensor(np.asarray(t), device=default_torch_device())


def _nbytes(x) -> int:
    return int(x.numel()) * x.element_size()


def _start(op, group, nbytes):
    return _comms.start(op, group.axis_name, nbytes) \
        if _om._ENABLED else None


def _rankmajor(x, group: Group):
    if x.dim() == 0 or x.shape[0] != group.nranks:
        raise ValueError(
            f"eager collective expects rank-major dim0 == group size "
            f"({group.nranks}), got shape {tuple(x.shape)}")
    return x


def _rank_index(group, rank):
    return group.get_group_rank(rank) if rank in group.ranks else rank


def _finish(tensor, out, sync_op, rec=None, like=None):
    """Write `out` back into `tensor` in place (paddle's collectives
    mutate) and return it; `tensor` None returns `out` itself, a Tensor
    unless `like` (the argument it came from) is a torch tensor. `rec`
    is closed here for a sync call (its completion edge), by the Work's
    wait() otherwise."""
    if tensor is None and isinstance(like, torch.Tensor):
        result = out
    elif isinstance(tensor, Tensor):
        tensor._set_data(out)
        result = tensor
    elif isinstance(tensor, torch.Tensor):
        if tensor.shape == out.shape:
            with torch.no_grad():
                tensor.copy_(out)
            result = tensor
        else:
            result = out
    else:
        result = Tensor._wrap(out)
    if sync_op:
        _comms.finish(rec, out)
        return result
    return Work(result, rec)


def _wrap_like(src, out):
    """`out` as `src`'s kind: a Tensor for a Tensor (or array) call, the
    torch tensor for a torch-level one."""
    return out if isinstance(src, torch.Tensor) else Tensor._wrap(out)


# ---------------------------------------------------------------------------
# process-group mode
# ---------------------------------------------------------------------------
def _torch_op(op):
    d = _dist().ReduceOp
    return {ReduceOp.SUM: d.SUM, ReduceOp.MAX: d.MAX, ReduceOp.MIN: d.MIN,
            ReduceOp.PROD: d.PRODUCT, ReduceOp.AVG: d.SUM}[op]


def _nccl(group) -> bool:
    return "nccl" in str(_dist().get_backend(group._torch_group))


def _pg_call(tensor, group, sync_op, rec, fn):
    """Run `fn(t)` (a torch.distributed call with async_op=True over the
    contiguous local tensor `t`) and finish: a non-contiguous tensor is
    worked on through a copy written back after."""
    x = _unwrap(tensor)
    t = x if x.is_contiguous() else x.contiguous()
    work, then = fn(t)

    def done():
        if then is not None:
            then()
        if t is not x:
            with torch.no_grad():
                x.copy_(t)

    if sync_op:
        work.wait()
        done()
        _comms.finish(rec, x)
        return tensor if isinstance(tensor, (Tensor, torch.Tensor)) \
            else Tensor._wrap(x)
    return _pg_work(tensor, rec, work, done)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    group = _resolve_group(group)
    x = _unwrap(tensor)
    if group._torch_group is not None:
        rec = _start("all_reduce", group, _nbytes(x))

        def run(t):
            w = _dist().all_reduce(t, op=_torch_op(op),
                                   group=group._torch_group, async_op=True)
            return w, ((lambda: t.div_(group.nranks))
                       if op == ReduceOp.AVG else None)

        return _pg_call(tensor, group, sync_op, rec, run)
    rec = _start("all_reduce", group, _nbytes(x) // group.nranks)
    x = _rankmajor(x, group)
    out = _reduce_dim0(x, op, keepdim=True).expand(x.shape).contiguous()
    return _finish(tensor, out, sync_op, rec)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    group = _resolve_group(group)
    x = _unwrap(tensor)
    if group._torch_group is not None:
        rec = _start("reduce", group, _nbytes(x))
        dst_g = _global_rank(group, dst)

        def run(t):
            # torch.distributed leaves a non-destination's buffer
            # undefined; the reference keeps every other rank's tensor
            buf = t.clone()
            w = _dist().reduce(buf, dst_g, op=_torch_op(op),
                               group=group._torch_group, async_op=True)

            def then():
                if _dist().get_rank() == dst_g:
                    t.copy_(buf)
                    if op == ReduceOp.AVG:
                        t.div_(group.nranks)

            return w, then

        return _pg_call(tensor, group, sync_op, rec, run)
    rec = _start("reduce", group, _nbytes(x) // group.nranks)
    x = _rankmajor(x, group)
    out = x.clone()
    out[_rank_index(group, dst)] = _reduce_dim0(x, op)
    return _finish(tensor, out, sync_op, rec)


def broadcast(tensor, src=0, group=None, sync_op=True):
    group = _resolve_group(group)
    x = _unwrap(tensor)
    if group._torch_group is not None:
        rec = _start("broadcast", group, _nbytes(x))
        src_g = _global_rank(group, src)
        return _pg_call(tensor, group, sync_op, rec, lambda t: (
            _dist().broadcast(t, src_g, group=group._torch_group,
                              async_op=True), None))
    rec = _start("broadcast", group, _nbytes(x) // group.nranks)
    x = _rankmajor(x, group)
    i = _rank_index(group, src)
    out = x[i:i + 1].expand(x.shape).contiguous()
    return _finish(tensor, out, sync_op, rec)


def all_gather(tensor_list, tensor=None, group=None, sync_op=True):
    """Two call styles, as the reference's: all_gather(list, tensor)
    appends G tensors to `list`; all_gather(tensor) returns the
    concatenation along dim 0 (rank-major: [G, G * d0, ...])."""
    group = _resolve_group(group)
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    x = _unwrap(tensor)
    g = group.nranks
    if group._torch_group is not None:
        rec = _start("all_gather", group, _nbytes(x))
        t = x.contiguous()
        parts = [torch.empty_like(t) for _ in range(g)]
        work = _dist().all_gather(parts, t, group=group._torch_group,
                                  async_op=True)
        if tensor_list is not None:
            tensor_list.extend(_wrap_like(tensor, p) for p in parts)
            if sync_op:
                work.wait()
                _comms.finish(rec, parts)
                return None
            return _pg_work(parts, rec, work)
        work.wait()
        out = torch.cat(parts, 0)
        return _finish(None, out, sync_op, rec, like=tensor)
    rec = _start("all_gather", group, _nbytes(x) // g)
    x = _rankmajor(x, group)
    flat = x.reshape((1, g * x.shape[1]) + tuple(x.shape[2:])) \
        if x.dim() > 1 else x.reshape(1, g)
    out = flat.expand((g,) + tuple(flat.shape[1:])).contiguous()
    if tensor_list is not None:
        per = out[0].reshape((g,) + tuple(x.shape[1:]))
        tensor_list.extend(_wrap_like(tensor, per[i]) for i in range(g))
        if sync_op:
            _comms.finish(rec, per)
            return None
        return Work(per, rec)
    return _finish(None, out, sync_op, rec, like=tensor)


def reduce_scatter(tensor, tensor_or_tensor_list=None, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """reduce_scatter(src) returns rank r's chunk r of the reduction of
    `src` (dim 0 split in G); reduce_scatter(dst, src_or_list) writes it
    into `dst`."""
    group = _resolve_group(group)
    if tensor_or_tensor_list is None:
        src, dst = tensor, None
    else:
        dst, src = tensor, tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        x = torch.stack([_unwrap(t) for t in src])
        x = x.reshape((-1,) + tuple(x.shape[2:]))
        like = src[0]
    else:
        x = _unwrap(src)
        like = src
    g = group.nranks
    if group._torch_group is not None:
        rec = _start("reduce_scatter", group, _nbytes(x))
        t = x.contiguous()
        n = t.shape[0] // g
        me = group.rank()
        if _nccl(group):
            out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            work = _dist().reduce_scatter_tensor(
                out, t, op=_torch_op(op), group=group._torch_group,
                async_op=True)
            outs = [out]

            def then():
                if op == ReduceOp.AVG:
                    out.div_(g)
        else:
            # gloo has no reduce-scatter: all-reduce a copy, keep chunk r
            t = t.clone()
            work = _dist().all_reduce(t, op=_torch_op(op),
                                      group=group._torch_group,
                                      async_op=True)
            outs = [None]

            def then():
                outs[0] = t[me * n:(me + 1) * n]
                if op == ReduceOp.AVG:
                    outs[0].div_(g)

        def finish_dst():
            then()
            if dst is not None:
                _finish(dst, outs[0], True)

        if sync_op:
            work.wait()
            finish_dst()
            _comms.finish(rec, outs[0])
            return dst if dst is not None else _wrap_like(like, outs[0])
        return _pg_work(dst, rec, work, finish_dst)
    rec = _start("reduce_scatter", group, _nbytes(x) // g)
    x = _rankmajor(x, group)
    red = _reduce_dim0(x, op)
    out = red.reshape((g, red.shape[0] // g) + tuple(red.shape[1:]))
    if dst is not None:
        _finish(dst, out, True)
        if sync_op:
            _comms.finish(rec, out)
            return dst
        return Work(dst, rec)
    return _finish(None, out, sync_op, rec, like=like)


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op=True):
    """Tensor style, all_to_all(x): rank r's dim 0 split in G blocks,
    block c sent to rank c (rank-major: x[r] block c lands in out[c]
    block r). List style, all_to_all(out_list, in_list): in_list[c] is
    sent to rank c, out_list gains what each rank sent here."""
    group = _resolve_group(group)
    g = group.nranks
    if in_tensor_list is None:
        src = out_tensor_list
        x = _unwrap(src)
        if group._torch_group is not None:
            rec = _start("all_to_all", group, _nbytes(x))
            t = x.contiguous()
            out = torch.empty_like(t)
            work = _dist().all_to_all_single(out, t,
                                             group=group._torch_group,
                                             async_op=True)
            if sync_op:
                work.wait()
                _comms.finish(rec, out)
                return _wrap_like(src, out)
            return _pg_work(_wrap_like(src, out), rec, work)
        rec = _start("all_to_all", group, _nbytes(x) // g)
        x = _rankmajor(x, group)
        d = x.shape[1]
        blocks = x.reshape((g, g, d // g) + tuple(x.shape[2:]))
        out = blocks.transpose(0, 1).reshape(x.shape).contiguous()
        return _finish(None, out, sync_op, rec, like=src)
    ins = [_unwrap(t).contiguous() for t in in_tensor_list]
    if group._torch_group is not None:
        rec = _start("all_to_all", group, sum(_nbytes(t) for t in ins))
        outs = [torch.empty_like(t) for t in ins]
        if _nccl(group):
            work = _dist().all_to_all(outs, ins, group=group._torch_group,
                                      async_op=True)
        else:
            # gloo takes the single-tensor form only
            flat = torch.empty_like(torch.stack(ins))
            work = _dist().all_to_all_single(flat, torch.stack(ins),
                                             group=group._torch_group,
                                             async_op=True)
            outs = list(flat.unbind(0))
        out_tensor_list.extend(_wrap_like(in_tensor_list[0], o)
                               for o in outs)
        if sync_op:
            work.wait()
            _comms.finish(rec, outs)
            return None
        return _pg_work(outs, rec, work)
    x = torch.stack(ins)
    rec = _start("all_to_all", group, _nbytes(x))
    # the single-controller view: every "rank" is this process
    outs = [x[i] for i in range(g)]
    out_tensor_list.extend(_wrap_like(in_tensor_list[0], o) for o in outs)
    if sync_op:
        _comms.finish(rec, outs[-1] if outs else None)
        return None
    return Work(outs[-1] if outs else None, rec)


alltoall = all_to_all


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """scatter(tensor, list, src): rank r receives list[r] of `src`;
    rank-major, scatter(x, src=s) splits x[s] in G chunks."""
    group = _resolve_group(group)
    g = group.nranks
    if group._torch_group is not None:
        x = _unwrap(tensor)
        rec = _start("scatter", group, _nbytes(x))
        src_g = _global_rank(group, src)
        parts = None
        if _dist().get_rank() == src_g:
            parts = [_unwrap(t).contiguous() for t in tensor_list]
        return _pg_call(tensor, group, sync_op, rec, lambda t: (
            _dist().scatter(t, parts, src=src_g, group=group._torch_group,
                            async_op=True), None))
    if tensor_list is not None:
        parts = [_unwrap(t) for t in tensor_list]
        rec = _start("scatter", group, sum(_nbytes(p) for p in parts) // g)
        out = _rankmajor(torch.stack(parts), group)
        return _finish(tensor, out, sync_op, rec)
    x = _unwrap(tensor)
    rec = _start("scatter", group, _nbytes(x) // g)
    x = _rankmajor(x, group)
    chunks = x[_rank_index(group, src)].reshape(
        (g, x.shape[1] // g) + tuple(x.shape[2:])).contiguous()
    return _finish(tensor, chunks, sync_op, rec)


def barrier(group=None):
    group = _resolve_group(group)
    rec = _start("barrier", group, 0)
    if group._torch_group is not None:
        _dist().barrier(group=group._torch_group)
    elif torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _comms.finish(rec)
    return None


# ---- point to point ------------------------------------------------------
# Rank-major mode runs both sides of every pair in one process (the
# reference's single-controller rendering, its :440-520): each send
# records its destination; a recv takes the oldest send addressed to its
# receiver, known exactly when the group has two ranks (the peer of
# `src`); in larger groups recv takes FIFO order, and warns when sends to
# several destinations are outstanding.
_P2P_BUF = {}


def _global_rank(group, rank):
    """A rank argument as a global rank: members are taken as global
    ranks (paddle's convention), any other value as a group-local
    index."""
    if rank in group.ranks:
        return rank
    if 0 <= rank < group.nranks:
        return group.ranks[rank]
    raise ValueError(f"rank {rank} not in group {group.ranks}")


def send(tensor, dst=0, group=None, sync_op=True):
    group = _resolve_group(group)
    x = _unwrap(tensor)
    rec = _start("send", group, _nbytes(x))
    if group._torch_group is not None:
        t = x.contiguous()
        work = _dist().isend(t, _global_rank(group, dst),
                             group=group._torch_group)
        if sync_op:
            work.wait()
            _comms.finish(rec, t)
            return None
        return _pg_work(None, rec, work)
    _P2P_BUF.setdefault(group.id, collections.deque()).append(
        (_global_rank(group, dst), x))
    if sync_op:
        _comms.finish(rec, x)
        return None
    return Work(None, rec)


def recv(tensor, src=0, group=None, sync_op=True):
    group = _resolve_group(group)
    x = _unwrap(tensor)
    rec = _start("recv", group, _nbytes(x))
    if group._torch_group is not None:
        src_g = _global_rank(group, src)
        return _pg_call(tensor, group, sync_op, rec, lambda t: (
            _dist().irecv(t, src_g, group=group._torch_group), None))
    buf = _P2P_BUF.get(group.id)
    if not buf:
        raise RuntimeError(
            f"recv(src={src}) on group {group.id}: no outstanding send — "
            "a matching send() must be issued first in single-controller "
            "mode")
    me = None
    if group.nranks == 2:
        src_g = _global_rank(group, src)
        a, b = group.ranks
        me = b if src_g == a else a
    if me is not None:
        for i, (dst, v) in enumerate(buf):
            if dst == me:
                del buf[i]
                return _finish(tensor, v, sync_op, rec)
        raise RuntimeError(
            f"recv(src={src}) on group {group.id}: no outstanding send "
            f"addressed to rank {me}; pending destinations: "
            f"{[d for d, _ in buf]}")
    if len({d for d, _ in buf}) > 1:
        warnings.warn(
            f"recv(src={src}) on group {group.id}: sends to multiple "
            "destinations are outstanding and the receiver rank is "
            "ambiguous in single-controller mode — delivering FIFO order",
            RuntimeWarning, stacklevel=2)
    _, v = buf.popleft()
    return _finish(tensor, v, sync_op, rec)


isend = send
irecv = recv


class P2POp:
    """One point-to-point operation of `batch_isend_irecv` (the
    reference's batch_isend_irecv.py)."""

    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    if _om._ENABLED and p2p_op_list:
        # the sends and recvs count their own bytes; this counts the
        # batch itself
        _comms.count("batch_isend_irecv",
                     _resolve_group(p2p_op_list[0].group).axis_name, 0,
                     mode="eager")
    return [op.op(op.tensor, op.peer, group=op.group, sync_op=False)
            for op in p2p_op_list]


# ---- the reference's in-trace helpers ------------------------------------
def ppermute(x, group: Group, perm):
    """Collective permute: for each (src, dst) pair of `perm`, rank dst
    gets rank src's tensor; a rank no pair sends to gets zeros (jax's
    rule). Rank-major: rows of dim 0; process-group mode: paired sends
    and recvs."""
    t = _unwrap(x)
    rec = _start("ppermute", group, _nbytes(t) // (
        1 if group._torch_group is not None else group.nranks))
    if group._torch_group is not None:
        me = group.rank()
        out = torch.zeros_like(t)
        ops = []
        for s, d in perm:
            if s == me:
                ops.append(_dist().P2POp(_dist().isend, t.contiguous(),
                                         group.ranks[d], group._torch_group))
            if d == me:
                ops.append(_dist().P2POp(_dist().irecv, out,
                                         group.ranks[s], group._torch_group))
        for w in (_dist().batch_isend_irecv(ops) if ops else []):
            w.wait()
    else:
        t = _rankmajor(t, group)
        out = torch.zeros_like(t)
        for s, d in perm:
            out[d] = t[s]
    _comms.finish(rec, out)
    return _wrap_like(x, out)


def axis_index(group: Group):
    """This rank's index in `group` (process-group mode), or every
    rank's, rank-major ([G] int32)."""
    if group._torch_group is not None:
        return Tensor._wrap(torch.tensor(group.rank(), dtype=torch.int32))
    from ..core.device import default_torch_device
    return Tensor._wrap(torch.arange(group.nranks, dtype=torch.int32,
                                     device=default_torch_device()))
