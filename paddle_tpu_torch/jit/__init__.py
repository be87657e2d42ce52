"""Trace and save path (counterpart of paddle_tpu/jit/__init__.py): the
input spec, ``to_static`` with its staging probe, the graph-break
fallback, ``save`` / ``load`` of an inference program, and the fused
train step.

``to_static`` (:220) converts tensor-predicate ``if`` / ``while`` into
torch's ``cond`` / ``while_loop`` under a trace (``jit/dy2static.py``)
and probes each input signature once with a fake-tensor trace
(``make_fx``), which raises the reference's RuntimeError on Python
control flow that branches on a tensor's value; the traced graphs are
``concrete_programs``. Calls run the converted function eagerly,
through the op registry and torch autograd, so they are differentiable
(the reference dispatches one traced op, :165-181).

``save`` (:593) exports the layer's forward with ``torch.export`` where
the reference exports StableHLO with ``jax.export``: the parameters and
buffers are inputs of the program (the reference's ``consts``), each
``None`` or negative dim of an input spec its own ``torch.export.Dim``.
The three files are the reference's: ``.pdiparams`` (the state dict as
numpy arrays, the same pickle), ``.pdmodel`` (a meta dict whose
``program`` holds the ``torch.export.save`` bytes, format
``paddle_tpu_torch.export.v1``) and ``.pdconsts`` (the program's
constants as numpy arrays). ``load`` (:674) rebuilds a
``TranslatedLayer`` with no Python model class: it needs
``paddle_tpu_torch`` importable, whose kernels register the operators a
program may call (kernels/__init__.py), and it moves the program to the
device it serves on (``move_to_device_pass``), so a program saved on
one device serves on another.

The fused train step (:314).

paddle_tpu compiles forward, backward and the optimizer update into one
XLA executable with donated buffers (:450-481). The port, on CUDA
parameters, captures the same three as one CUDA graph per batch
signature (``jit/cuda_graph.py::CapturedStep``, name "train_step") and
replays it at every later call: the forward under the caller's
``loss_fn``, ``torch.autograd.grad``, and the optimizer's update in
place (Adam/AdamW: one multi-tensor kernel launch for every f32
parameter). Parameters, moments and powers are written in place (the
analog of donation), the batch is copied into static inputs and the lr
refilled into the optimizer's static scalar before each replay. The
first call of a signature runs the step eagerly before capturing it:
that run is the call's step, so N calls make N updates. A capture that
fails raises; nothing falls back to the eager step. On CPU parameters
every step runs eagerly: the same step, with the update's plain
version.

The forward and the update run inside profiler ranges
"TrainStep.forward" and "TrainStep.update", so a torch.profiler trace
of an eager step splits its device time into forward, backward (the
rest: autograd launches it from its own thread) and update
(tools/torch_train_profile.py); a replay is one graph launch to the
profiler. With no profiler active a range costs a few microseconds.

Observability (while enabled): the first call of each batch signature is
the "train_step" family's compile (on the card the graph's capture
reports it, `cuda_graph.CapturedStep`; on the CPU the TrainStep reports
its eager first call), with the family's expectation counted from the
shapes (`observability.perf.count_cost`) for a model that states its
`attention_shape()` (the GPT, LLaMA and BERT models do; another model
records no expectation and no roofline). The
``train_step`` roofline takes each later step's time from CUDA events
recorded on the step's stream around its replay, read at a later call
once they have completed: a replay is one launch, so the host runs
ahead of the card and a host clock between calls would measure
nothing. Reading them adds no synchronisation. On the CPU the step is
synchronous and the host clock around it is the step's time. As in the
reference, the first call of a signature (its capture) gives no sample
and a call's sample is published at a later call: after N calls of one
signature, N - 2 samples. Each sample also publishes the goodput
fractions (`observability.comms.note_train_step`, the same seconds and
expectation).

The numerics plane (`observability.numerics`, while enabled; the
reference's :400-412, :444-472, :504-540): the step's update is the
optimizer's statistics variant, and the plane's flag is part of the
graph key, so a signature has a statistics graph beside its plain one
(its capture is a "train_step" compile). Its packed bundle is a static
output of the graph; a sampled call submits it with the loss
(`numerics.submit` starts its host copy on the stream at once, before
the next replay can overwrite it), under the trainable parameters'
names and group labels (computed once), source "train_step"; every call
ticks the plane's cadence. The CPU's eager step does the same without a
graph, taking the statistics on sampled calls only."""
from __future__ import annotations

import collections
import functools
import io
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.tensor import Tensor
from ..kernels import tracing
from ..nn.layer import Layer
from ..observability import comms as _cm
from ..observability import metrics as _om
from ..observability import numerics as _num
from ..observability import perf as _pf
from ..optimizer.lr import LRScheduler
from ..utils.watchdog import watchdog
from .cuda_graph import CapturedStep, GraphCache

__all__ = ["InputSpec", "StaticFunction", "to_static", "GraphBreakFunction",
           "not_to_static", "ignore_module", "TrainStep", "save", "load",
           "TranslatedLayer"]

# TrainSteps whose step body is running (eager or being captured): an
# observer (quantization's abs-max quanters) updates only outside one,
# as the reference's updates only outside a trace
_STEPPING = [0]


def in_train_step() -> bool:
    """True while a TrainStep's step body runs on this process."""
    return _STEPPING[0] > 0


# the .pdmodel format of this package's programs (the reference's is
# its StableHLO format, which load refuses)
FORMAT = "paddle_tpu_torch.export.v1"


class InputSpec:
    """(ref: python/paddle/static/input.py InputSpec)"""

    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def _value_key(v):
    try:
        hash(v)
        return ("V", type(v).__name__, v)
    except TypeError:
        return ("V", type(v).__name__)


def _signature(leaves, spec):
    """The input signature a probe is kept for, from the call's
    flattened arguments: each tensor's shape, dtype and device, each
    other value (by type when unhashable)."""
    def one(a):
        t = _raw(a)
        if isinstance(t, torch.Tensor):
            return ("T", isinstance(a, Tensor), tuple(t.shape), t.dtype,
                    t.device)
        return _value_key(a)
    return (str(spec), tuple(one(a) for a in leaves))


class StaticFunction:
    """Result of @to_static: the function, probed once per input
    signature by a fake-tensor trace (ref: program_translator.py
    StaticFunction:327 concrete-program cache). Calls run it eagerly,
    through the op registry and torch autograd, so they stay
    differentiable; ``concrete_programs`` holds the probes' traced
    graphs (``torch.fx.GraphModule``s)."""

    def __init__(self, function, layer: Optional[nn.Module] = None,
                 input_spec=None, build_strategy=None, backend=None,
                 full_graph=True, source_available=True):
        self._fn = function
        self._layer = layer
        self._input_spec = input_spec
        self._full_graph = full_graph
        self._source_available = source_available
        self._programs: Dict[Any, Any] = {}
        functools.update_wrapper(self, function)

    def _probe_stageable(self, key, leaves, spec):
        """full_graph=True contract (ref jit/api.py to_static): the
        whole function must stage into ONE graph. Eager execution would
        happily run data-dependent Python branches per call, and a later
        export (jit.save) would silently bake in one branch. Probe with a
        fake-tensor trace once per signature and report the limitation
        up front (the reference detects this in its SOT bytecode
        translator, sot/opcode_translator/executor/opcode_executor.py:
        1457)."""
        from torch._subclasses.fake_tensor import DataDependentOutputException
        from torch.fx.experimental.proxy_tensor import make_fx
        from torch.fx.experimental.symbolic_shapes import \
            GuardOnDataDependentSymNode

        pos = [i for i, a in enumerate(leaves)
               if isinstance(_raw(a), torch.Tensor)]

        def traced(*arrays):
            vals = list(leaves)
            for i, a in zip(pos, arrays):
                vals[i] = Tensor._wrap(a) if isinstance(leaves[i], Tensor) \
                    else a
            a, kw = tree_unflatten(vals, spec)
            out = self._fn(*a, **kw)
            return [_raw(o) for o in tree_flatten(out)[0]
                    if isinstance(_raw(o), torch.Tensor)]

        try:
            with torch.no_grad():
                program = make_fx(traced, tracing_mode="fake",
                                  _allow_non_fake_inputs=True)(
                                      *[_raw(leaves[i]).detach()
                                        for i in pos])
        except (GuardOnDataDependentSymNode,
                DataDependentOutputException) as e:
            src_note = "" if self._source_available else (
                " NOTE: this function's source is unretrievable "
                "(lambda, REPL/exec-defined, or stripped bytecode), so "
                "the dy2static AST converter that would stage this "
                "control flow into cond/while_loop could not run "
                "(bytecode-level SOT capture is a documented mechanism "
                "delta, README).")
            raise RuntimeError(
                "to_static(full_graph=True): the function branches on a "
                "Tensor VALUE (data-dependent Python control flow), "
                "which trace-based staging cannot capture in one graph. "
                "Rewrite with paddle_tpu_torch.ops.where / select-style "
                "ops, or use @to_static(full_graph=False) to keep "
                "per-call eager semantics (no whole-graph trace)."
                f"{src_note} Underlying tracer error: "
                f"{type(e).__name__}: {e}") from e
        # marked only on success: a caught-and-retried failure must be
        # detected again, not skipped into a silent one-branch export
        self._programs[key] = program

    def __call__(self, *args, **kwargs):
        leaves, spec = tree_flatten((list(args), dict(kwargs)))
        if self._full_graph and not any(tracing(_raw(a)) for a in leaves):
            training = self._layer.training if self._layer is not None \
                else False
            key = (_signature(leaves, spec), training)
            if key not in self._programs:
                self._probe_stageable(key, leaves, spec)
        return self._fn(*args, **kwargs)

    @property
    def concrete_programs(self):
        return list(self._programs.values())


def _source_available(fn) -> bool:
    import inspect
    try:
        inspect.getsource(fn)
        return True
    except (OSError, TypeError):
        return False


def _warn_no_source(fn):
    import warnings
    warnings.warn(
        f"to_static: source for {getattr(fn, '__qualname__', fn)!r} is "
        "unretrievable (lambda, REPL/exec-defined, or stripped "
        "bytecode), so dy2static AST control-flow conversion is "
        "disabled. Straight-line tensor code still stages into one "
        "graph via tracing; tensor-dependent Python control flow will "
        "raise at first call — use full_graph=False to run such "
        "regions eagerly (ref: the reference's bytecode-level SOT "
        "executor, jit/sot/opcode_translator/executor/"
        "opcode_executor.py:1457, is a documented mechanism delta).",
        UserWarning, stacklevel=3)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True):
    """@to_static decorator (ref: jit/api.py:171). `backend` and
    `build_strategy` are taken for API parity and not read.

    A layer (any ``torch.nn.Module``) gets its ``forward`` replaced;
    functions without retrievable source (lambdas, REPL/exec-defined)
    stage as long as they are straight-line tensor code; their
    data-dependent control flow cannot be AST-converted, which is
    detected up front (warning) and reported clearly at first call."""

    def decorate(fn):
        if isinstance(fn, nn.Module):
            fwd = fn.forward
            if full_graph:
                from .dy2static import ast_transform
                src_ok = _source_available(fwd)
                if not src_ok:
                    _warn_no_source(fwd)
                fwd = ast_transform(fwd) or fwd
                sf = StaticFunction(fwd, layer=fn, input_spec=input_spec,
                                    full_graph=True,
                                    source_available=src_ok)
            else:
                sf = GraphBreakFunction(fwd, layer=fn)
            fn.forward = sf
            return fn
        layer = getattr(fn, "__self__", None)
        layer = layer if isinstance(layer, nn.Module) else None
        if full_graph:
            # AST control-flow conversion (the SOT/AST dy2static path):
            # tensor-predicate if/while stage into cond/while_loop
            from .dy2static import ast_transform
            src_ok = _source_available(fn)
            if not src_ok:
                _warn_no_source(fn)
            fn = ast_transform(fn) or fn
            return StaticFunction(fn, layer=layer, input_spec=input_spec,
                                  full_graph=True,
                                  source_available=src_ok)
        return GraphBreakFunction(fn, layer=layer)

    if function is not None:
        return decorate(function)
    return decorate


class GraphBreakFunction:
    """full_graph=False: SOT-style partial staging (ref:
    python/paddle/jit/sot/translate.py:31). The function body is split
    into maximal stageable regions, with the unsupported statements
    (data-dependent if/while, loops, return-in-branch) executing eagerly
    between them, under ordinary Python semantics. `region_count` /
    `regions` (each with `staged_calls` / `eager_calls`) expose the break
    structure for tests and debugging; jit/dy2static.py says how the
    port runs a region."""

    def __init__(self, function, layer: Optional[nn.Module] = None):
        from .dy2static import graph_break_transform
        self._layer = layer
        r = graph_break_transform(function)
        if r is None:
            # no source or nothing to stage: plain eager execution (ops
            # still dispatch through the registry one by one)
            self._fn, self._regions = function, []
        else:
            self._fn, self._regions = r
        functools.update_wrapper(self, function)

    @property
    def region_count(self):
        return len(self._regions)

    @property
    def regions(self):
        return list(self._regions)

    def __call__(self, *args, **kwargs):
        if self._layer is not None and getattr(
                self._fn, "__self__", None) is None:
            return self._fn(self._layer, *args, **kwargs)
        return self._fn(*args, **kwargs)


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    return None


# ---------------------------------------------------------------------------
# save / load: the inference program
# ---------------------------------------------------------------------------
def _state_arrays(layer) -> Dict[str, np.ndarray]:
    """The state dict as numpy arrays (bfloat16 as ml_dtypes'), by the
    reference's names: a Layer's own ``state_dict()``, a torch module's
    torch one."""
    sd = layer.state_dict() if isinstance(layer, Layer) \
        else nn.Module.state_dict(layer)
    return {k: (v if isinstance(v, Tensor) else Tensor._wrap(v.detach()))
            .numpy() for k, v in sd.items()}


def _slots(layer):
    """Every parameter and buffer slot of `layer`'s modules as (slot
    dict, name, index into the program's constants), and the distinct
    tensors in first-seen order: a tensor held twice (tied weights) is
    one constant."""
    slots, consts, index = [], [], {}
    for m in layer.modules():
        for table in (m._parameters, m._buffers):
            for name, t in table.items():
                if t is None:
                    continue
                i = index.get(id(t))
                if i is None:
                    i = index[id(t)] = len(consts)
                    consts.append(t.detach())
                slots.append((table, name, i))
    return slots, consts


class _bound:
    """The layer's parameter and buffer slots bound to the program's
    constant inputs while its forward is traced, and put back after
    (with the Parameter wrappers the layers cache)."""

    def __init__(self, layer, slots, values):
        self.layer, self.slots, self.values = layer, slots, values

    def __enter__(self):
        self.saved = [(table, name, table[name])
                      for table, name, _ in self.slots]
        self.wrappers = [(m, dict(m.__dict__["_wrappers"]))
                         for m in self.layer.modules()
                         if "_wrappers" in m.__dict__]
        for table, name, i in self.slots:
            table[name] = self.values[i]
        return self

    def __exit__(self, *exc):
        for table, name, t in self.saved:
            table[name] = t
        for m, w in self.wrappers:
            m.__dict__["_wrappers"] = w
        return False


class _Program(nn.Module):
    """What ``save`` exports: ``forward(consts, inputs)`` runs the layer
    with its parameters and buffers bound to `consts`. A ``Layer`` is
    called on Tensors (the eager API's inputs), any other module on
    torch tensors; the outputs' Tensors come out as their torch
    tensors, in the same structure. The layer is held outside torch's
    registry, so the program owns no state of its own."""

    def __init__(self, layer, slots):
        super().__init__()
        self.__dict__["_target"] = layer
        self._slots = slots

    def forward(self, consts, inputs):
        layer = self.__dict__["_target"]
        with _bound(layer, self._slots, consts):
            if isinstance(layer, Layer):
                out = layer(*[Tensor._wrap(x) for x in inputs])
            else:
                out = layer(*inputs)
        leaves, spec = tree_flatten(out)
        return tree_unflatten(
            [_raw(o) for o in leaves], spec)


def _spec_dtype(dtype):
    from ..core.dtype import to_dtype
    return to_dtype(dtype if isinstance(dtype, torch.dtype) else str(dtype))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _from_array(a, device) -> torch.Tensor:
    """A saved numpy array as a torch tensor of its own dtype (no
    narrowing; ml_dtypes' bfloat16 bit for bit) on `device`."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _export_specs(input_spec, device):
    """InputSpec list -> (sample inputs, dynamic shapes). Each None or
    negative dim becomes a ``torch.export.Dim`` of its own (named
    s<input>_<dim>, as the reference names its symbols), so two dynamic
    inputs are not tied to one size; the sample sizes there differ
    (2, 3, 4, ...), so no two are taken for equal while tracing."""
    samples, dynamic, k = [], [], 0
    for i, s in enumerate(input_spec):
        if isinstance(s, InputSpec):
            shape, dtype = s.shape, _spec_dtype(s.dtype)
        else:
            t = _raw(s)
            shape, dtype = list(t.shape), t.dtype
        dims, size = {}, []
        for j, d in enumerate(shape):
            if d is None or (isinstance(d, int) and d < 0):
                dims[j] = torch.export.Dim(f"s{i}_{j}")
                size.append(2 + k)
                k += 1
            else:
                size.append(int(d))
        samples.append(torch.zeros(size, dtype=dtype, device=device))
        dynamic.append(dims or None)
    return samples, dynamic


def _layer_device(layer) -> torch.device:
    from ..core.device import default_torch_device
    for t in list(nn.Module.parameters(layer)) + list(
            nn.Module.buffers(layer)):
        return t.device
    return default_torch_device()


def save(layer, path, input_spec=None, **config):
    """jit.save (ref: jit/api.py:755): the PROGRAM, exported by
    ``torch.export`` with the parameters and buffers as its inputs,
    next to the params: the counterpart of the reference's inference
    program + params pair that its analysis predictor loads
    (paddle/fluid/inference/api/analysis_predictor.h). jit.load and
    paddle_tpu_torch.inference rebuild a callable with no Python model
    class. The layer runs in eval while it is traced, and its mode is
    put back after. Without input_spec only params are saved
    (state-dict style). Takes any ``torch.nn.Module`` (a Layer, or one
    of the port's models), or a to_static function of one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(layer, (StaticFunction, GraphBreakFunction)):
        layer = layer._layer
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(_state_arrays(layer), f, protocol=4)

    meta = {"format": FORMAT,
            "input_spec": [(getattr(s, "shape", None),
                            str(getattr(s, "dtype", "float32")))
                           for s in (input_spec or [])],
            "program": None, "param_names": None}
    if input_spec:
        slots, consts = _slots(layer)
        device = _layer_device(layer)
        samples, dynamic = _export_specs(input_spec, device)
        was_training = layer.training
        layer.eval()
        try:
            with torch.no_grad():
                ep = torch.export.export(
                    _Program(layer, slots), (consts, samples),
                    dynamic_shapes=([None] * len(consts), dynamic))
        finally:
            if was_training:
                layer.train()
        # the sample inputs hold the constants, which .pdconsts carries
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        meta.update(program=buf.getvalue(), n_consts=len(consts),
                    input_dtypes=[_dtype_name(s.dtype) for s in samples],
                    device=str(device))
        with open(path + ".pdconsts", "wb") as f:
            pickle.dump([Tensor._wrap(c).numpy() for c in consts], f,
                        protocol=4)
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(meta, f, protocol=4)


class TranslatedLayer(Layer):
    """jit.load result (ref: translated_layer.py TranslatedLayer): a
    callable rebuilt from the saved program and constants, no Python
    model class required. Inference-only: the constants are the
    program's inputs, held on the device it serves on. Inputs (Tensors,
    torch tensors or arrays) are cast to the dtypes the program was
    saved with; outputs come back as Tensors in the program's
    structure."""

    def __init__(self, program, consts, state, input_dtypes=None):
        super().__init__()
        self.__dict__["_program"] = program
        self._consts = consts
        self._state = state
        self._input_dtypes = input_dtypes
        self._device = consts[0].device if consts else torch.device("cpu")

    def _inputs(self, inputs):
        out = []
        for i, x in enumerate(inputs):
            t = _raw(x)
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.asarray(t))
            dt = self._input_dtypes[i] if self._input_dtypes else t.dtype
            out.append(t.to(self._device, dt))
        return out

    def _run(self, inputs):
        """The program on torch tensors already on its device and of its
        dtypes: torch tensors out."""
        return self.__dict__["_program"](self._consts, inputs)

    def forward(self, *inputs):
        out = self._run(self._inputs(inputs))
        leaves, spec = tree_flatten(out)
        return tree_unflatten(
            [Tensor._wrap(o) for o in leaves], spec)

    def state_dict(self, *a, **kw):
        return {k: Tensor(v, place=self._device)
                for k, v in self._state.items()}


def load(path, **config):
    """jit.load (ref: jit/api.py:1081). Returns a TranslatedLayer when
    the artifact carries a program saved by this package, else the raw
    state dict (numpy arrays), as for a params-only artifact of either
    package. ``device`` (config) is where it serves: the default place
    when not given."""
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    try:
        with open(path + ".pdmodel", "rb") as f:
            meta = pickle.load(f)
    except FileNotFoundError:
        return state
    if not isinstance(meta, dict) or not (meta.get("program")
                                          or meta.get("stablehlo")):
        return state
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path}.pdmodel holds a {meta.get('format')!r} program, which "
            f"this package cannot run; save the layer again with "
            f"paddle_tpu_torch.jit.save")
    from torch.export.passes import move_to_device_pass

    # the kernels' modules register the operators a program may call
    from ..kernels import flash_attention, norms  # noqa: F401
    from ..core.device import default_torch_device, resolve_device
    device = config.get("device")
    device = default_torch_device() if device is None \
        else resolve_device(device)
    ep = move_to_device_pass(torch.export.load(io.BytesIO(meta["program"])),
                             device)
    with open(path + ".pdconsts", "rb") as f:
        consts = [_from_array(c, device) for c in pickle.load(f)]
    dtypes = [getattr(torch, d) for d in meta.get("input_dtypes", [])]
    return TranslatedLayer(ep.module(), consts, state, dtypes or None)


# ---------------------------------------------------------------------------
# fused train step
# ---------------------------------------------------------------------------
class TrainStep:
    """One training step per call: loss, gradients of every trainable
    parameter, optimizer update.

    Usage:
        step = TrainStep(model, optimizer, loss_fn)   # loss_fn(model, *batch)
        for x, y in loader:
            loss = step(x, y)
        step.sync()

    If loss_fn is None the model itself must return the scalar loss. Batch
    arrays (numpy, torch tensors, or the port's Tensors, which step as
    the torch tensors they hold) are moved to the device of the model's
    parameters. On CUDA parameters each batch signature (shapes and
    dtypes of the arrays, values of the other arguments) is captured
    once as a CUDA graph, the last 8 kept; loss_fn must then take
    nothing from the host (no ``.item()``, no shape that depends on
    data). As in the reference:
      * the update uses the first parameter group's hyperparameters and
        applies NO ``grad_clip`` (``Optimizer.step`` does clip), and
        updates the parameters themselves, not multi_precision masters,
        as ``functional_update`` does;
      * the module's buffers come out of each step as they went in: the
        reference's compiled step takes them as inputs and returns none
        (:450-473), so what a layer writes into them during the forward
        (a batch norm's running statistics) is dropped after the step.
        The port copies every buffer at the start of the step and writes
        the copy back after the update (inside the graph too). Eager
        training (``loss.backward(); opt.step()``) keeps what the layers
        write, as the reference's eager path does. ROADMAP Queue C
        lists this, beside the missing ``grad_clip``, as a quirk that
        changes on both sides together or not at all;
      * the learning rate is read at every call (a scheduler's or a
        ``set_lr`` value);
      * an ``LRScheduler`` steps after the call.
    The returned loss is a detached device tensor of its own: reading it
    is the caller's host sync."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Callable = None, has_aux=False, donate=True,
                 mesh=None, shard_param=None, shard_data=None):
        if mesh is not None or shard_param is not None \
                or shard_data is not None:
            raise NotImplementedError(
                "sharded (mesh) training is not ported yet")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.has_aux = has_aux
        self._params = [p for p in nn.Module.parameters(model)
                        if p.requires_grad]
        self._buffers = list(nn.Module.buffers(model))
        if not self._params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        self.device = self._params[0].device
        # the numerics plane's names and group labels of the trainable
        # parameters, computed once (the reference's :400-412)
        names = {id(p): n for n, p in nn.Module.named_parameters(model)}
        gidx = {id(p): i for i, g in enumerate(optimizer._param_groups)
                for p in g["params"]}
        self._train_pnames = [names[id(p)] for p in self._params]
        self._train_groups = [f"g{gidx.get(id(p), 0)}"
                              for p in self._params]
        # the optimizer's state exists before any capture
        for p in self._params:
            optimizer._get_state(p)
        self._step_count = 0
        self._graphs = GraphCache()   # one graph per batch signature
        # observability: the signatures whose first (compile) call ran
        # eagerly, their expectations, and the timings of earlier steps
        # not read yet: ((start, end) CUDA events or host seconds, the
        # step's expectation)
        self._compiled = {}
        self._pending = collections.deque()
        # checking only: run steps on CUDA parameters eagerly, without a
        # graph (the same update in place)
        self._eager = False

    def _batch(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(a, device=self.device)

    def __call__(self, *args, **kwargs):
        # Tensor batches (a DataLoader's) step as their torch tensors, as
        # the reference unwraps its Tensors first (jit/__init__.py:483)
        args = [a._data if isinstance(a, Tensor) else a for a in args]
        kwargs = {k: v._data if isinstance(v, Tensor) else v
                  for k, v in kwargs.items()}
        opt = self.optimizer
        obs = _om._ENABLED
        if obs:
            self._read_timings()
        numerics = _num._ENABLED
        lr = opt.get_lr()
        # FLAGS_watchdog_timeout_s arms a hang detector around the step,
        # as the reference's TrainStep does; armed, the step waits for
        # the card so that the detector sees the device finish
        with watchdog(what=f"TrainStep step {self._step_count}") as wd:
            if self.device.type == "cuda" and not self._eager:
                loss, packed = self._graph_step(args, kwargs, obs,
                                                numerics)
            else:
                loss, packed = self._eager_step(
                    args, kwargs, obs, numerics and _num.want_stats())
            if wd is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if numerics:
            if packed is not None and _num.want_stats():
                _num.submit(packed, names=self._train_pnames,
                            groups=self._train_groups, loss=loss,
                            lr=float(lr), source="train_step")
            _num.tick()
        self._step_count += 1
        if isinstance(opt._lr, LRScheduler):
            opt._lr.step()
        return loss

    def _eager_step(self, args, kwargs, obs, stats=False):
        """One step run eagerly (the CPU, or `_eager` on the card), its
        compile and time reported while observability is on: the first
        call of a signature is the family's compile, a later call's
        host time a roofline sample (a CPU step is synchronous). Returns
        (loss, the numerics bundle with `stats`, else None)."""
        first = False
        if obs:
            key = (self._key(args, kwargs), _num._ENABLED)
            first = key not in self._compiled
            if first:
                self._compiled[key] = _pf.record_compile(
                    "train_step", self._count_cost(args))
        t0 = time.perf_counter()
        loss, packed = self._step_in_place(
            [self._batch(a) for a in args],
            {k: self._batch(v) if isinstance(v, torch.Tensor)
             else v for k, v in kwargs.items()}, stats)
        if obs:
            seconds = time.perf_counter() - t0
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                seconds = time.perf_counter() - t0
            if first:
                c, h = _om.compile_metrics()
                c.labels(family="train_step", outcome="compile").inc()
                h.labels(family="train_step").observe(seconds)
            else:
                self._pending.append((seconds, self._compiled[key]))
        return loss, packed

    def _read_timings(self):
        """Publish the roofline of every earlier step whose timing is in
        hand: host seconds, or CUDA events that have completed (an event
        still queued waits for a later call; nothing here waits for the
        card)."""
        pend = self._pending
        while pend:
            t, cost = pend[0]
            if isinstance(t, tuple):
                if not t[1].query():
                    break
                seconds = t[0].elapsed_time(t[1]) / 1e3
            else:
                seconds = t
            pend.popleft()
            _pf.observe_roofline("train_step", seconds, cost)
            _cm.note_train_step(seconds, cost)

    def _count_cost(self, args):
        """The step's expectation (`perf.count_cost`) from the model's
        `attention_shape()` (layers, heads, head_dim, causal) and the
        first argument's [batch, seq] token ids; None for a model that
        states no attention shape."""
        shape = getattr(self.model, "attention_shape", None)
        ids = args[0] if args else None
        if shape is None or ids is None \
                or len(getattr(ids, "shape", ())) != 2:
            return None
        opt = self.optimizer
        nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
        update = sum(3 * nbytes(p) + 2 * sum(
            nbytes(v) for v in opt._get_state(p).values()
            if isinstance(v, torch.Tensor) and v.numel() > 1)
            for p in self._params)
        return _pf.count_cost(
            "train_step", params=float(sum(p.numel() for p in self._params)),
            tokens=float(ids.shape[0] * ids.shape[1]), seq=ids.shape[1],
            param_bytes=float(sum(nbytes(p) for p in self._params)),
            update_bytes=float(update), **shape())

    def _step_in_place(self, args, kwargs, stats=False):
        """One step that writes parameters and state in place (what a
        graph captures): the first group's hyperparameters, no clip, no
        masters; the buffers put back as they were. Returns (loss, the
        packed numerics bundle of the update with `stats`, else None)."""
        opt = self.optimizer
        held = [b.detach().clone() for b in self._buffers]
        _STEPPING[0] += 1
        try:
            with record_function("TrainStep.forward"):
                if self.loss_fn is None:
                    loss = self.model(*args, **kwargs)
                else:
                    loss = self.loss_fn(self.model, *args, **kwargs)
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
        finally:
            _STEPPING[0] -= 1
        group = opt._param_groups[0] if opt._param_groups else {}
        packed = None
        with torch.no_grad(), record_function("TrainStep.update"):
            # an unused parameter gets a zero gradient, as jax.grad gives
            pgs = [(p, torch.zeros_like(p) if g is None else g, group)
                   for p, g in zip(self._params, grads)]
            if stats:
                packed = opt._update_with_stats(pgs, masters=False)
            else:
                opt._update_in_place(pgs, masters=False)
        with torch.no_grad():
            for b, h in zip(self._buffers, held):
                b.copy_(h)
        return loss.detach(), packed

    @staticmethod
    def _signature(a):
        if isinstance(a, (torch.Tensor, np.ndarray)):
            return ("array", tuple(a.shape), torch.as_tensor(a).dtype)
        return ("value", a)

    def _key(self, args, kwargs):
        """The batch signature: shapes and dtypes of the arrays, values
        of the other arguments."""
        return (tuple(map(self._signature, args)),
                tuple((k, self._signature(kwargs[k]))
                      for k in sorted(kwargs)))

    def _graph_step(self, args, kwargs, obs=False, stats=False):
        """Replay the graph of this batch signature (its statistics
        variant with `stats`), capturing it first (the capture's warm-up
        run is this call's step). With `obs`, a replay is timed by CUDA
        events around it on the step's stream. Returns (loss, the static
        packed bundle or None)."""
        names = sorted(kwargs)
        key = (self._key(args, kwargs), stats)
        entry = self._graphs.get(key)
        if entry is not None:
            captured, statics = entry
            if obs:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            self._fill(statics, list(args) + [kwargs[k] for k in names])
            # this call's lr into the static scalar the graph reads (an
            # eager or captured step's update refills it itself)
            opt = self.optimizer
            opt._lr_tensor(opt.get_lr(), self.device)
            loss, packed = captured.replay()
            loss = loss.clone()
            if obs:
                t1.record()
                self._pending.append(((t0, t1), captured.expected))
            return loss, packed
        vals = list(args) + [kwargs[k] for k in names]
        statics = [torch.empty(tuple(v.shape), device=self.device,
                               dtype=torch.as_tensor(v).dtype)
                   if isinstance(v, (torch.Tensor, np.ndarray)) else None
                   for v in vals]
        self._fill(statics, vals)
        inputs = [v if s is None else s for v, s in zip(vals, statics)]
        s_args = inputs[:len(args)]
        s_kwargs = dict(zip(names, inputs[len(args):]))
        captured = CapturedStep(
            "train_step",
            lambda: self._step_in_place(s_args, s_kwargs, stats),
            generators=self._generators(), warmup_counts=True,
            pool=self._graphs.pool(), expected=self._count_cost(args))
        self._graphs.put(key, (captured, statics))
        loss, packed = captured.warmup_output
        return loss.clone(), packed

    def _generators(self):
        """The CUDA generators the model's modules draw dropout masks
        from (a ``generator`` attribute, as GPT's layers keep theirs):
        registered with the graph, each replay draws new masks, as
        eager steps would. The default generator is registered by
        PyTorch itself."""
        gens = {}
        for m in self.model.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and g.device.type == "cuda":
                gens[id(g)] = g
        return tuple(gens.values())

    @staticmethod
    def _fill(statics, vals):
        """Copy the call's arrays into the static inputs."""
        for s, v in zip(statics, vals):
            if s is not None:
                s.copy_(torch.as_tensor(v))

    def sync(self, copy=None):
        """The reference writes its compiled loop's state back into the
        model here; the port updates the model's parameters and the
        optimizer's state in place at every step, so nothing is left to
        write. Returns the model."""
        return self.model
