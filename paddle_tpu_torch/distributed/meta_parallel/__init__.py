"""meta_parallel: the hybrid-parallel layers and model wrappers
(counterpart of paddle_tpu/distributed/meta_parallel/)."""
from .mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from .random import (
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .recompute import recompute, recompute_sequential
from .parallel_wrappers import (
    MetaParallelBase, SegmentParallel, ShardingParallel, TensorParallel,
)
from .pp_layers import (
    LayerDesc, PipelineLayer, SegmentLayers, SharedLayerDesc,
)
from .pipeline_parallel import PipelineParallel
from .hybrid_optimizer import (
    HybridParallelGradScaler, HybridParallelOptimizer,
)
from .moe_layer import MoELayer
from .sequence_parallel import (
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp,
    RowSequenceParallelLinear, ScatterOp, mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks,
)
from .ring_attention import RingAttention, ring_flash_attention

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "recompute", "recompute_sequential", "MetaParallelBase",
           "TensorParallel", "ShardingParallel", "SegmentParallel",
           "LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineParallel", "HybridParallelOptimizer",
           "HybridParallelGradScaler", "MoELayer", "ScatterOp", "GatherOp",
           "AllGatherOp", "ColumnSequenceParallelLinear",
           "RowSequenceParallelLinear",
           "register_sequence_parallel_allreduce_hooks",
           "mark_as_sequence_parallel_parameter", "ring_flash_attention",
           "RingAttention"]
