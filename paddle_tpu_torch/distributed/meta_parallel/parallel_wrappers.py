"""Hybrid-parallel model wrappers (counterpart of
paddle_tpu/distributed/meta_parallel/parallel_wrappers.py).

The reference's wrappers commit every parameter and buffer not yet
placed onto the hybrid mesh, replicated (the mpu layers placed theirs).
The port records that placement (`topology.place`). In process-group
mode, where each process made its own weights, the wrapper also
broadcasts every replicated parameter and buffer from the first rank of
the model-parallel group over it, as the reference's own reference
(Paddle's tensor_parallel.py:28) does, so the ranks agree.
"""
from __future__ import annotations

import torch

from ...nn.layer import Layer
from ..topology import PartitionSpec as P
from ..topology import place, placement

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "SegmentParallel"]


class MetaParallelBase(Layer):
    def __init__(self, layers: Layer, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        mesh = self._hcg.mesh
        fresh = []
        for t in list(self._layers.parameters()) + [
                b for b in self._layers.buffers()]:
            if placement(t) is None:
                place(t, mesh, P())
                fresh.append(t)
            elif placement(t).spec == P():
                fresh.append(t)
        g = self._hcg.get_model_parallel_group()
        if g._torch_group is not None and g.nranks > 1:
            from .. import communication
            with torch.no_grad():
                for t in fresh:
                    communication.broadcast(t._data, src=g.ranks[0],
                                            group=g)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    # the wrapped layer's API
    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._layers.set_state_dict(*a, **kw)

    def parameters(self, *a, **kw):
        return self._layers.parameters(*a, **kw)

    def named_parameters(self, *a, **kw):
        return self._layers.named_parameters(*a, **kw)


class TensorParallel(MetaParallelBase):
    """The reference's meta_parallel/tensor_parallel.py:28."""


class ShardingParallel(MetaParallelBase):
    """The reference's meta_parallel/sharding_parallel.py."""


class SegmentParallel(MetaParallelBase):
    """The reference's meta_parallel/segment_parallel.py:26: the model
    splits the sequence over the sep group itself; the wrapper places
    the parameters (and the hybrid optimizer syncs gradients over dp x
    sep)."""
