"""The hybrid-parallel topology and its per-axis groups (counterpart of
paddle_tpu/distributed/topology.py).

The reference builds one ``jax.sharding.Mesh`` over the hybrid axes
("dp", "pp", "sharding", "sep", "mp", outermost first) and a group per
axis backed by that mesh. The port's mesh is `RankMesh`: the global
ranks laid out in those axes (the first dp × pp × sharding × sep × mp
ranks of the world), with the reference mesh's ``shape`` and
``axis_names``. In rank-major mode, as in the reference's single
controller, each axis group holds that axis's degree of ranks and every
coordinate of this process is 0. In process-group mode each axis group
is the ``torch.distributed`` group of the ranks that share this
process's other coordinates (every process makes every such group, in
one order, as torch requires), and the coordinates are this rank's.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np

from .communication import Group, _new_group_obj, _pg_active

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group",
           "RankMesh"]

# the reference's axis order (outermost -> innermost)
_AXES = ("dp", "pp", "sharding", "sep", "mp")
_REF_NAMES = {"data": "dp", "pipe": "pp", "sharding": "sharding",
              "sep": "sep", "model": "mp"}


class CommunicateTopology:
    """The reference's fleet/base/topology.py:61."""

    def __init__(self, hybrid_group_names=None, dims=None):
        hybrid_group_names = hybrid_group_names or list(_AXES)
        self._names = [_REF_NAMES.get(n, n) for n in hybrid_group_names]
        self._dims = list(dims or [1] * len(self._names))
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        # reference names ("data") and the normalised ones ("dp") both
        return self._dims[self._names.index(
            _REF_NAMES.get(axis_name, axis_name))]

    def world_size(self):
        return self._world

    def get_rank(self, **kw):
        kw = {_REF_NAMES.get(k, k): v for k, v in kw.items()}
        coords = [kw[n] for n in self._names]
        return int(np.ravel_multi_index(coords, self._dims))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))


class RankMesh:
    """Global ranks laid out over named axes: the port's stand-in for
    the reference's ``jax.sharding.Mesh`` (``devices`` holds ranks)."""

    def __init__(self, ranks: np.ndarray, axis_names):
        self.devices = ranks
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"RankMesh({dict(self.shape)})"


class HybridCommunicateGroup:
    """The reference's fleet/base/topology.py:174: the rank mesh and the
    per-axis groups (module docstring)."""

    def __init__(self, topology: CommunicateTopology = None, dp=1, mp=1,
                 pp=1, sharding=1, sep=1):
        from .parallel import get_world_size
        if topology is not None:
            self._topo = topology
            dims = dict(zip(topology.get_hybrid_group_names(),
                            topology._dims))
            dp = dims.get("dp", 1)
            pp = dims.get("pp", 1)
            sharding = dims.get("sharding", 1)
            sep = dims.get("sep", 1)
            mp = dims.get("mp", 1)
        else:
            self._topo = CommunicateTopology(
                list(_AXES), [dp, pp, sharding, sep, mp])
        self._degrees = {"dp": dp, "pp": pp, "sharding": sharding,
                         "sep": sep, "mp": mp}
        world = dp * pp * sharding * sep * mp
        have = get_world_size()
        if world > have:
            raise ValueError(
                f"hybrid topology needs {world} devices, have {have}")
        ranks = np.arange(world).reshape(dp, pp, sharding, sep, mp)
        self.mesh = RankMesh(ranks, _AXES)
        self.nranks = world
        self._groups: Dict[str, Group] = {}
        if _pg_active():
            import torch.distributed as dist
            self.global_rank = dist.get_rank()
            self._coord = dict(zip(_AXES, (
                int(c) for c in np.unravel_index(self.global_rank,
                                                 ranks.shape))))
            for name in _AXES:
                self._groups[name] = self._axis_group(ranks, (name,), name)
            self._groups["dp_sep"] = self._axis_group(ranks, ("dp", "sep"),
                                                      "dp_sep")
        else:
            self.global_rank = 0        # one controller
            self._coord = dict.fromkeys(_AXES, 0)
            for name in _AXES:
                self._groups[name] = _new_group_obj(
                    list(range(self._degrees[name])), mesh=self.mesh,
                    mesh_axis=name, axis_name=name)
            # the fused dp x sep group of the gradient sync (the
            # reference's topology.py:225-246)
            self._groups["dp_sep"] = _new_group_obj(
                list(range(dp * sep)), mesh=self.mesh,
                mesh_axis=("dp", "sep"), axis_name="dp_sep")

    def _axis_group(self, ranks, axes, name):
        """The torch.distributed group over `axes` holding this rank:
        every group of those axes is made, in one order, on every
        process."""
        import torch.distributed as dist
        keep = [_AXES.index(a) for a in axes]
        rest = [i for i in range(len(_AXES)) if i not in keep]
        moved = np.moveaxis(ranks, keep + rest, range(len(_AXES)))
        lines = moved.reshape(int(np.prod([ranks.shape[i] for i in keep])),
                              -1).T
        mine = None
        for line in lines:
            members = [int(r) for r in line]
            pg = dist.new_group(members)
            if self.global_rank in members:
                mine = _new_group_obj(members, mesh=self.mesh,
                                      mesh_axis=axes if len(axes) > 1
                                      else axes[0], axis_name=name,
                                      process_group=pg)
        return mine

    # ---- degrees ----
    def get_data_parallel_world_size(self):
        return self._degrees["dp"]

    def get_model_parallel_world_size(self):
        return self._degrees["mp"]

    def get_pipe_parallel_world_size(self):
        return self._degrees["pp"]

    def get_sharding_parallel_world_size(self):
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self):
        return self._degrees["sep"]

    # ---- this process's coordinates (0 with one controller) ----
    def get_data_parallel_rank(self):
        return self._coord["dp"]

    def get_model_parallel_rank(self):
        return self._coord["mp"]

    def get_stage_id(self):
        return self._coord["pp"]

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sep_parallel_rank(self):
        return self._coord["sep"]

    # ---- groups ----
    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pp"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_dp_sep_parallel_group(self) -> Group:
        return self._groups["dp_sep"]

    def get_check_parallel_group(self, *a, **kw) -> Group:
        return self._groups["dp_sep"]

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        # the reference's ParallelMode: data, tensor, pipeline, sharding
        if self._degrees["pp"] > 1:
            return "pipeline"
        if self._degrees["sharding"] > 1:
            return "sharding"
        if self._degrees["mp"] > 1 or self._degrees["sep"] > 1:
            return "tensor"
        return "data"


_HCG: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG
