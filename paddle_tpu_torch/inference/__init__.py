"""paddle_tpu_torch.inference: the deployment facade and the serving
engine (counterpart of paddle_tpu/inference/__init__.py).

Reference: paddle.inference (python/paddle/inference/wrapper.py;
engine: paddle/fluid/inference/api/analysis_predictor.h — Config →
AnalysisPredictor with named input/output handles). The Predictor keeps
the reference's handle-style API (get_input_names / get_input_handle /
run / get_output_handle) over the program ``jit.save`` wrote, loaded
with no Python model class (``jit.load``). The reference compiles that
program on load for the chip present (:6-10); the port, on the card,
captures it as one CUDA graph per input signature
(``jit.cuda_graph.CapturedStep``, name "predictor") and replays it for
every run, the inputs copied into the graph's static tensors first. On
the CPU each run calls the program eagerly.

The fleet layer of the reference's package (router, autoscaler,
traffic, disaggregation) is not ported yet (ROADMAP Queue A item 24).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .llm_engine import GenerationResult, LLMEngine, calibrate_kv_scales
from .paged_cache import BlockAllocator, PagedKVCache
# speculative decoding: draft proposers and the config of
# LLMEngine(speculative_config=...)
from .speculative import (DraftModelProposer, DraftProposer, NgramProposer,
                          SpeculativeConfig)

__all__ = ["BlockAllocator", "Config", "DraftModelProposer", "DraftProposer",
           "GenerationResult", "LLMEngine", "NgramProposer", "PagedKVCache",
           "Predictor", "SpeculativeConfig", "calibrate_kv_scales",
           "create_predictor"]


class Config:
    """ref: paddle/fluid/inference/api/paddle_analysis_config.h. The
    device is the default place unless ``enable_use_gpu`` or
    ``disable_gpu`` says otherwise."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # paddle passes "model.pdmodel", "model.pdiparams"; accept that
        # or the bare prefix
        def strip(p, suf):
            return p[:-len(suf)] if p and p.endswith(suf) else p
        self._prefix = strip(prog_file, ".pdmodel") if prog_file else None
        if params_file:
            pp = strip(params_file, ".pdiparams")
            if self._prefix is None:
                self._prefix = pp
        self._device = None
        self._extra: Dict = {}

    def set_prog_file(self, path):
        self._prefix = path[:-len(".pdmodel")] \
            if path.endswith(".pdmodel") else path

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def enable_use_gpu(self, *a, **kw):
        """(memory_pool_init_size_mb, device_id): the card of
        `device_id` (0 by default); the pool size is not read."""
        device_id = kw.get("device_id", a[1] if len(a) > 1 else 0)
        self._device = f"cuda:{device_id}"

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self, *a, **kw):
        pass  # the caching allocator and the graph pool own the buffers

    def switch_ir_optim(self, *a, **kw):
        pass  # the exported program runs as saved

    def set_cpu_math_library_num_threads(self, n):
        self._extra["threads"] = n


class _Handle:
    """Named input/output tensor handle (ref ZeroCopyTensor)."""

    def __init__(self):
        self._value = None

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._value)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    @property
    def shape(self):
        return list(self._value.shape) if self._value is not None else None


class Predictor:
    """ref: AnalysisPredictor (analysis_predictor.h:59). Inputs are named
    x0, x1, ..., outputs out0, out1, ... (the program's output leaves in
    order). On the card every run replays the CUDA graph of its input
    signature (shapes and dtypes; a ``jit.cuda_graph.GraphCache``),
    captured at the signature's first run: a capture that fails raises,
    and nothing runs the program eagerly there."""

    def __init__(self, config: Config):
        from ..jit import TranslatedLayer, load
        if config._prefix is None:
            raise ValueError("Config needs a model path")
        layer = load(config._prefix, device=config._device)
        if not isinstance(layer, TranslatedLayer):
            raise ValueError(
                f"{config._prefix}.pdmodel has no serialized program; "
                "re-save with jit.save(layer, path, input_spec=[...])")
        self._layer = layer
        self._input_names = [f"x{i}" for i in
                             range(len(layer._input_dtypes or ()))]
        self._inputs = {n: _Handle() for n in self._input_names}
        self._output_names: List[str] = []
        self._outputs: Dict[str, _Handle] = {}
        self._graphs = None     # a GraphCache, made on the card at need

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name) -> _Handle:
        return self._inputs[name]

    def _replay(self, host):
        """The captured graph of these inputs' signature, replayed after
        the inputs are copied into its static tensors: its outputs
        (static tensors of the graph's pool)."""
        from ..jit.cuda_graph import CapturedStep, GraphCache
        if self._graphs is None:
            self._graphs = GraphCache()
        key = tuple((tuple(h.shape), h.dtype) for h in host)
        entry = self._graphs.get(key)
        if entry is None:
            dev = self._layer._device
            statics = [torch.empty(h.shape, dtype=h.dtype, device=dev)
                       for h in host]
            for s, h in zip(statics, host):
                s.copy_(h)
            entry = self._graphs.put(key, (CapturedStep(
                "predictor", lambda: self._layer._run(statics),
                pool=self._graphs.pool()), statics))
        captured, statics = entry
        for s, h in zip(statics, host):
            s.copy_(h)
        return captured.replay()

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Direct style: run([x, y]) -> [np arrays]; or handle style:
        fill input handles, run(), read output handles."""
        from ..core.tensor import Tensor
        if inputs is not None:
            for n, x in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(x)
        layer = self._layer
        host = [torch.as_tensor(self._inputs[n]._value).to(dt) for n, dt in
                zip(self._input_names, layer._input_dtypes)]
        if layer._device.type == "cuda":
            out = self._replay(host)
        else:
            out = layer._run([h.to(layer._device) for h in host])
        leaves = torch.utils._pytree.tree_leaves(out)
        self._output_names = [f"out{i}" for i in range(len(leaves))]
        self._outputs = {}
        results = []
        for n, t in zip(self._output_names, leaves):
            h = _Handle()
            h.copy_from_cpu(Tensor._wrap(t).numpy())
            self._outputs[n] = h
            results.append(h.copy_to_cpu())
        return results

    def get_output_names(self):
        return list(self._output_names)

    def get_output_handle(self, name) -> _Handle:
        return self._outputs[name]


def create_predictor(config: Config) -> Predictor:
    """ref: paddle_infer.create_predictor"""
    return Predictor(config)
