"""The pipeline model description and its stage placement (counterpart
of paddle_tpu/distributed/meta_parallel/pp_layers.py).

As in the reference's single controller, every part is built here (the
reference's reference builds only the local rank's). With a pipeline
degree above 1 each stage gets a sub-mesh of the hybrid mesh's "pp"
axis, recorded on the parameters its parts hold (`topology.place`), and
an activation entering another stage passes the cross-stage transfer:
an autograd Function that is the identity both ways on one device (the
reference's differentiable ``device_put``, the p2p send / recv pair),
noting a ``pp_transfer`` reshard with the activation's bytes when
observability is on. A shared layer (tied embeddings) keeps one home
copy; its other positions call it, so its gradient gathers every use.
"""
from __future__ import annotations

import re
import weakref
from typing import List, Optional

import torch

from ...core.tensor import Tensor
from ...nn.layer import Layer
from ...nn.layers.container import LayerList
from ...observability import comms as _comms
from ...observability import metrics as _om
from ..topology import PartitionSpec as P
from ..topology import RankMesh, get_hybrid_communicate_group, place
from ..topology import placement as _placement

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers",
           "PipelineLayer"]

_STAGE_AXES = ("dp", "sharding", "sep", "mp")


class LayerDesc:
    """The reference's pp_layers.py:56."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_func, Layer):
            raise TypeError("LayerDesc expects a Layer subclass")

    def build_layer(self) -> Layer:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """The reference's pp_layers.py:76: one layer shared by several
    positions (a tied embedding and LM head)."""

    def __init__(self, key, layer_func, *inputs, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """The reference's pp_layers.py:92: N layer descriptions cut into
    `num_parts` parts, uniformly or on a layer-class name regex."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.descs)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            cls_name = self.method.split(":", 1)[1]
            weights = [0] * n
            for i, d in enumerate(self.descs):
                name = (d.layer_func.__name__ if isinstance(d, LayerDesc)
                        else type(d).__name__)
                if re.search(cls_name, name):
                    weights[i] = 1
            total = sum(weights)
            assert total % self.num_parts == 0 or total >= self.num_parts, (
                f"{total} {cls_name} layers cannot fill {self.num_parts} "
                "stages")
            return self._segment_by_weight(weights)
        raise ValueError(f"unknown seg method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts) -> List[int]:
        result = [0] * (num_parts + 1)
        part = num_items // num_parts
        extra = num_items % num_parts
        for i in range(num_parts):
            result[i + 1] = result[i] + part + (1 if i < extra else 0)
        result[num_parts] = num_items
        return result

    def _segment_by_weight(self, weights) -> List[int]:
        total = sum(weights)
        per = total / self.num_parts
        bounds = [0]
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if acc >= per * len(bounds) and len(bounds) < self.num_parts:
                bounds.append(i + 1)
        bounds.append(len(weights))
        return bounds


class _StageTransfer(torch.autograd.Function):
    """The cross-stage send / recv pair on one device: the identity for
    the activation and for its cotangent."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _nbytes(t: Tensor) -> int:
    return int(t.size) * t._data.element_size()


class PipelineLayer(Layer):
    """The reference's pp_layers.py:237."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        hcg = get_hybrid_communicate_group()
        if num_stages is None:
            num_stages = (hcg.get_pipe_parallel_world_size()
                          if hcg is not None else 1)
        self._num_stages = num_stages
        # interleaved VPP: num_stages * v parts, part j on stage
        # j % num_stages (Megatron's round-robin chunks)
        self._num_chunks = int(num_virtual_pipeline_stages or 1)
        num_parts = num_stages * self._num_chunks
        self._descs = list(layers)
        bounds = SegmentLayers(self._descs, num_parts,
                               seg_method).do_segment()
        self.segment_parts = bounds

        # every part; a shared description builds once (by key)
        self._shared: dict = {}
        self._stage_of_layer: List[int] = []
        part_lists = []
        for part in range(num_parts):
            s = self.stage_of_part(part)
            mods = []
            for i in range(bounds[part], bounds[part + 1]):
                d = self._descs[i]
                if isinstance(d, SharedLayerDesc):
                    first_use = d.layer_name not in self._shared
                    if first_use:
                        self._shared[d.layer_name] = (d.build_layer(), s)
                    layer, home = self._shared[d.layer_name]
                    mods.append(_SharedCall(layer, d.forward_func, home, s,
                                            own_params=first_use,
                                            pipe=self))
                elif isinstance(d, LayerDesc):
                    mods.append(d.build_layer())
                elif isinstance(d, Layer):
                    mods.append(d)
                else:   # a plain callable (a reshape, say)
                    mods.append(_FnLayer(d))
                self._stage_of_layer.append(s)
            part_lists.append(LayerList(mods))
        self.stages = LayerList(part_lists)   # parts == stages when v == 1

        # the stage sub-meshes and the parameters' placement
        self._stage_meshes: List[Optional[RankMesh]] = [None] * num_stages
        if hcg is not None and hcg.get_pipe_parallel_world_size() > 1:
            self._build_stage_meshes(hcg)

    def _build_stage_meshes(self, hcg):
        devs = hcg.mesh.devices     # (dp, pp, sharding, sep, mp)
        for s in range(self._num_stages):
            self._stage_meshes[s] = RankMesh(devs[:, s], _STAGE_AXES)
        for part, mods in enumerate(self.stages):
            mesh = self._stage_meshes[self.stage_of_part(part)]
            for mod in mods:
                if isinstance(mod, _SharedCall):
                    # a shared layer lives on its home stage's mesh
                    self._commit_layer(
                        mod.layer, self._stage_meshes[mod.home_stage])
                else:
                    self._commit_layer(mod, mesh)

    # ---- part topology ----
    @property
    def num_parts(self) -> int:
        return len(self.stages)

    @property
    def num_chunks(self) -> int:
        return self._num_chunks

    def stage_of_part(self, part: int) -> int:
        return part % self._num_stages

    @staticmethod
    def _commit_layer(layer: Layer, mesh: RankMesh):
        for p in layer.parameters():
            spec = p._dist_attr
            if spec is None or any(ax not in mesh.axis_names
                                   for ax in _spec_axes(spec)):
                spec = P()
            place(p, mesh, spec)

    # ---- the stage-by-stage forward ----
    def _transfer(self, x: Tensor, dst_stage: int) -> Tensor:
        mesh = self._stage_meshes[dst_stage]
        if mesh is None:
            return x
        if _om._ENABLED:
            # the activation send / recv: count, bytes and a marker
            _comms.note_reshard("pp_transfer", f"stage{dst_stage}",
                                _nbytes(x))
        src = _placement(x)
        spec = P()
        if src is not None and all(ax in mesh.axis_names
                                   for ax in _spec_axes(src.spec)):
            spec = src.spec
        out = Tensor._wrap(_StageTransfer.apply(x._data))
        return place(out, mesh, spec)

    def transfer_to_part(self, x: Tensor, part: int) -> Tensor:
        """The differentiable move of an activation onto `part`'s stage
        (a scheduled F unit's recv)."""
        return self._transfer(x, self.stage_of_part(part))

    def transfer_cotangent(self, ct, dst_part: int):
        """The move of a cotangent onto the upstream part's stage (a
        scheduled B unit's gradient send), unrecorded."""
        mesh = self._stage_meshes[self.stage_of_part(dst_part)]
        if mesh is None or ct is None:
            return ct
        t = ct if isinstance(ct, Tensor) else Tensor._wrap(ct)
        if _om._ENABLED:
            # the scheduled B unit's gradient send (see _transfer)
            _comms.note_reshard(
                "pp_transfer", f"stage{self.stage_of_part(dst_part)}",
                _nbytes(t))
        src = _placement(t)
        spec = P()
        if src is not None and all(ax in mesh.axis_names
                                   for ax in _spec_axes(src.spec)):
            spec = src.spec
        out = Tensor._wrap(t._data.detach(), stop_gradient=True)
        return place(out, mesh, spec)

    def forward_stage(self, x, stage_id: int):
        """The stage-indexed forward: only without virtual chunks (with
        VPP a stage holds several parts that are not contiguous)."""
        assert self._num_chunks == 1, (
            "forward_stage is stage-indexed; with "
            "num_virtual_pipeline_stages > 1 use forward_part")
        return self.forward_part(x, stage_id)

    def forward_part(self, x, part: int):
        mods = list(self.stages[part])
        i = 0
        while i < len(mods):
            if (self._recompute_interval > 0 and
                    not isinstance(mods[i], _SharedCall)):
                from .recompute import recompute_sequential
                j = min(i + self._recompute_interval, len(mods))
                chunk = [m for m in mods[i:j]
                         if not isinstance(m, _SharedCall)]
                if len(chunk) == j - i:
                    x = recompute_sequential({"segments": 1}, chunk, x)
                    i = j
                    continue
            x = mods[i](x)
            i += 1
        return x

    def forward(self, x):
        for part in range(self.num_parts):
            s = self.stage_of_part(part)
            if part > 0:
                x = self._transfer(x, s) if not isinstance(x, tuple) else \
                    tuple(self._transfer(t, s) for t in x)
            x = self.forward_part(x, part)
        return x

    def get_stage_params(self, stage_id):
        """The parameters on pipeline stage `stage_id`: with VPP those of
        every part the stage holds (parts stage_id, stage_id + p, ...)."""
        out = []
        for part in range(stage_id, self.num_parts, self._num_stages):
            out.extend(self.stages[part].parameters())
        return out


class _FnLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kw):
        return self._fn(*args, **kw)


class _SharedCall(Layer):
    """A call position of a shared layer. Away from its home stage the
    activation moves to the home stage first (the shared weight is not
    copied), so the gradient of every use accumulates on the one copy
    (the reference's reference all-reduces the shared gradients across
    the stage pair instead)."""

    def __init__(self, layer: Layer, forward_func, home_stage: int,
                 stage: int, own_params=False, pipe=None):
        super().__init__()
        if own_params:
            self.layer = layer      # registers the parameters (home only)
        else:
            object.__setattr__(self, "layer", layer)
        self.forward_func = forward_func
        self.home_stage = home_stage
        self.stage = stage
        self._pipe = weakref.ref(pipe) if pipe is not None else None

    def forward(self, x):
        pipe = self._pipe() if self._pipe is not None else None
        if (pipe is not None and self.stage != self.home_stage and
                pipe._stage_meshes[self.home_stage] is not None):
            x = pipe._transfer(x, self.home_stage)
        if self.forward_func is not None:
            return self.forward_func(self.layer, x)
        return self.layer(x)


def _spec_axes(spec):
    axes = []
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(entry)
        else:
            axes.append(entry)
    return axes
