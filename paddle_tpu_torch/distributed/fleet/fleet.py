"""The fleet facade (counterpart of
paddle_tpu/distributed/fleet/fleet.py).

``fleet.init(strategy)`` builds the hybrid group
(`HybridCommunicateGroup`) over the world: the rank-major world of one
controller (`parallel.get_world_size()`, the card count on CUDA), or,
when a ``torch.distributed`` default group exists (the launcher's
environment, `parallel.init_parallel_env`), the processes of that group.
``distributed_model`` / ``distributed_optimizer`` wrap by the strategy's
degrees as the reference does.

Process-group mode ports tensor parallelism only. A pipeline, sharding
or sep degree above 1 raises ``NotImplementedError`` there: the
schedule's p2p activations, ZeRO and the ring across processes are
ROADMAP item 26b2 (ZeRO also 26c).
"""
from __future__ import annotations

from typing import Optional

from ...nn.layer import Layer
from ..topology import HybridCommunicateGroup
from ..topology import set_hybrid_communicate_group

__all__ = ["DistributedStrategy", "Fleet", "fleet", "init",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "worker_num", "worker_index"]

_NOT_IN_PROCESS_GROUPS = {
    "pp_degree": "the pipeline schedule's p2p activations across "
                 "processes",
    "sharding_degree": "ZeRO sharding across processes",
    "sep_degree": "the ring of ring attention across processes",
}


class DistributedStrategy:
    """distributed_strategy.proto's Python mirror (the reference's
    fleet/base/distributed_strategy.py:175). The knobs with a meaning
    here are modelled; the rest are kept so configurations round-trip."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.fuse_all_reduce_ops = True
        self.find_unused_parameters = False
        self._extra = {}

    def __setattr__(self, k, v):
        if k == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            # paddle's partial update of the dict
            merged = dict(self.hybrid_configs)
            merged.update(v)
            object.__setattr__(self, k, merged)
        else:
            object.__setattr__(self, k, v)

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


def _world() -> int:
    from ..parallel import get_world_size
    return get_world_size()


class Fleet:
    """The reference's fleet/fleet.py Fleet (the singleton `fleet`)."""

    def __init__(self):
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        from ..communication import _pg_active
        strategy = strategy or DistributedStrategy()
        self._strategy = strategy
        hc = strategy.hybrid_configs
        world = _world()
        degrees = {}
        for k in ("dp_degree", "mp_degree", "pp_degree",
                  "sharding_degree", "sep_degree"):
            v = hc.get(k, 1)
            degrees[k] = 1 if v in (None, -1) else max(1, int(v))
        # dp_degree -1 or unset takes the ranks left
        fixed = (degrees["mp_degree"] * degrees["pp_degree"] *
                 degrees["sharding_degree"] * degrees["sep_degree"])
        if hc.get("dp_degree") in (None, -1):
            degrees["dp_degree"] = max(1, world // fixed)
        if _pg_active():
            for k, what in _NOT_IN_PROCESS_GROUPS.items():
                if degrees[k] > 1:
                    raise NotImplementedError(
                        f"{k} > 1 with a torch.distributed process group "
                        f"({what}) is not ported: ROADMAP item 26b2")
            if degrees["dp_degree"] > 1 and degrees["mp_degree"] > 1:
                # TensorParallel averages no gradient over the dp group
                raise NotImplementedError(
                    "dp_degree > 1 beside mp_degree > 1 with a "
                    "torch.distributed process group (the dp replicas' "
                    "weight broadcast and gradient average) is not "
                    "ported: ROADMAP item 26b2")
        self._hcg = HybridCommunicateGroup(
            dp=degrees["dp_degree"], mp=degrees["mp_degree"],
            pp=degrees["pp_degree"], sharding=degrees["sharding_degree"],
            sep=degrees["sep_degree"])
        set_hybrid_communicate_group(self._hcg)
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def worker_num(self):
        return _world()

    def worker_index(self):
        from ..parallel import get_rank
        return get_rank()

    def is_first_worker(self):
        return self.worker_index() == 0

    def barrier_worker(self):
        return None

    def distributed_model(self, model: Layer):
        """The reference's fleet/model.py:32: wrap by the degrees."""
        assert self._hcg is not None, "call fleet.init first"
        from ..meta_parallel import (
            PipelineLayer, PipelineParallel, SegmentParallel,
            ShardingParallel, TensorParallel,
        )
        hcg = self._hcg
        if hcg.get_pipe_parallel_world_size() > 1:
            assert isinstance(model, PipelineLayer), (
                "pp_degree > 1 requires the model to be a PipelineLayer")
            return PipelineParallel(model, hcg, self._strategy)
        if hcg.get_sharding_parallel_world_size() > 1:
            model = ShardingParallel(model, hcg, self._strategy)
        if hcg.get_sep_parallel_world_size() > 1:
            model = SegmentParallel(model, hcg, self._strategy)
        if hcg.get_model_parallel_world_size() > 1:
            model = TensorParallel(model, hcg, self._strategy)
        if hcg.get_data_parallel_world_size() > 1 and not isinstance(
                model, (TensorParallel, SegmentParallel, ShardingParallel)):
            from ..parallel import DataParallel
            model = DataParallel(model, group=hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """The reference's fleet.py:1307: a HybridParallelOptimizer."""
        assert self._hcg is not None, "call fleet.init first"
        from ..meta_parallel.hybrid_optimizer import HybridParallelOptimizer
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       strategy or self._strategy)


fleet = Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group


def worker_num():
    return _world()


def worker_index():
    from ..parallel import get_rank
    return get_rank()
