"""fleet: the hybrid-parallel facade (counterpart of
paddle_tpu/distributed/fleet/)."""
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .fleet import (
    DistributedStrategy, Fleet, distributed_model, distributed_optimizer,
    fleet, get_hybrid_communicate_group, init, worker_index, worker_num,
)

__all__ = ["init", "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "DistributedStrategy", "Fleet", "fleet",
           "worker_num", "worker_index", "CommunicateTopology",
           "HybridCommunicateGroup"]
