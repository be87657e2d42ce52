"""paddle_tpu_torch.distributed (counterpart of paddle_tpu/distributed/).
Ported so far: the collectives (``communication``), the parallel
environment and ``DataParallel`` (``parallel``), the hybrid topology
(``topology``), ``meta_parallel``'s activation recompute and ``rpc``
(the fleet's HMAC call layer). ``fleet``, ``auto_parallel``,
``sharding``, ``checkpoint`` and ``ps`` are still to port (ROADMAP Queue
A items 26b-e)."""
from . import meta_parallel, rpc
from .communication import (
    ReduceOp, Group, Work, new_group, get_group, is_initialized,
    destroy_process_group, all_reduce, all_gather, all_to_all, alltoall,
    reduce, broadcast, reduce_scatter, scatter, barrier, send, recv,
    isend, irecv, P2POp, batch_isend_irecv,
)
from .meta_parallel import recompute, recompute_sequential
from .parallel import (
    init_parallel_env, get_rank, get_world_size, ParallelEnv,
    DataParallel, spawn,
)
from .topology import (
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group,
)

get_world_size_by_group = get_world_size

__all__ = ["meta_parallel", "recompute", "recompute_sequential", "rpc",
           "ReduceOp", "Group", "Work", "new_group", "get_group",
           "is_initialized", "destroy_process_group", "all_reduce",
           "all_gather", "all_to_all", "alltoall", "reduce", "broadcast",
           "reduce_scatter", "scatter", "barrier", "send", "recv", "isend",
           "irecv", "P2POp", "batch_isend_irecv", "init_parallel_env",
           "get_rank", "get_world_size", "ParallelEnv", "DataParallel",
           "spawn", "CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "get_world_size_by_group"]
