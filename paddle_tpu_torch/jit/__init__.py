"""The fused train step (counterpart of paddle_tpu/jit/__init__.py:314).

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
profiler. With no profiler active a range costs a few microseconds."""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..optimizer.lr import LRScheduler
from ..utils.watchdog import watchdog
from .cuda_graph import CapturedStep

__all__ = ["TrainStep"]


class TrainStep:
    """One training step per call: loss, gradients of every trainable
    parameter, optimizer update.

    Usage:
        step = TrainStep(model, optimizer, loss_fn)   # loss_fn(model, *batch)
        for x, y in loader:
            loss = step(x, y)
        step.sync()

    If loss_fn is None the model itself must return the scalar loss. Batch
    arrays (numpy or tensors) are moved to the device of the model's
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

    # graphs kept, one per batch signature (generation._FusedLoop's rule)
    MAX_GRAPHS = 8

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
        # the optimizer's state exists before any capture
        for p in self._params:
            optimizer._get_state(p)
        self._step_count = 0
        self._graphs: OrderedDict = OrderedDict()
        self._pool = None       # the graphs' memory pool, made at need
        # checking only: run steps on CUDA parameters eagerly, without a
        # graph (the same update in place)
        self._eager = False

    def _batch(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(a, device=self.device)

    def __call__(self, *args, **kwargs):
        opt = self.optimizer
        # FLAGS_watchdog_timeout_s arms a hang detector around the step,
        # as the reference's TrainStep does; armed, the step waits for
        # the card so that the detector sees the device finish
        with watchdog(what=f"TrainStep step {self._step_count}") as wd:
            if self.device.type == "cuda" and not self._eager:
                loss = self._graph_step(args, kwargs)
            else:
                loss = self._step_in_place(
                    [self._batch(a) for a in args],
                    {k: self._batch(v) if isinstance(v, torch.Tensor)
                     else v for k, v in kwargs.items()})
            if wd is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._step_count += 1
        if isinstance(opt._lr, LRScheduler):
            opt._lr.step()
        return loss

    def _step_in_place(self, args, kwargs):
        """One step that writes parameters and state in place (what a
        graph captures): the first group's hyperparameters, no clip, no
        masters; the buffers put back as they were."""
        opt = self.optimizer
        held = [b.detach().clone() for b in self._buffers]
        with record_function("TrainStep.forward"):
            if self.loss_fn is None:
                loss = self.model(*args, **kwargs)
            else:
                loss = self.loss_fn(self.model, *args, **kwargs)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        group = opt._param_groups[0] if opt._param_groups else {}
        with torch.no_grad(), record_function("TrainStep.update"):
            # an unused parameter gets a zero gradient, as jax.grad gives
            opt._update_in_place(
                [(p, torch.zeros_like(p) if g is None else g, group)
                 for p, g in zip(self._params, grads)], masters=False)
        with torch.no_grad():
            for b, h in zip(self._buffers, held):
                b.copy_(h)
        return loss.detach()

    @staticmethod
    def _signature(a):
        if isinstance(a, (torch.Tensor, np.ndarray)):
            return ("array", tuple(a.shape), torch.as_tensor(a).dtype)
        return ("value", a)

    def _graph_step(self, args, kwargs):
        """Replay the graph of this batch signature, capturing it first
        (the capture's warm-up run is this call's step)."""
        names = sorted(kwargs)
        key = (tuple(map(self._signature, args)),
               tuple((k, self._signature(kwargs[k])) for k in names))
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            captured, statics = entry
            self._fill(statics, list(args) + [kwargs[k] for k in names])
            # this call's lr into the static scalar the graph reads (an
            # eager or captured step's update refills it itself)
            opt = self.optimizer
            opt._lr_tensor(opt.get_lr(), self.device)
            return captured.replay().clone()
        vals = list(args) + [kwargs[k] for k in names]
        statics = [torch.empty(tuple(v.shape), device=self.device,
                               dtype=torch.as_tensor(v).dtype)
                   if isinstance(v, (torch.Tensor, np.ndarray)) else None
                   for v in vals]
        self._fill(statics, vals)
        inputs = [v if s is None else s for v, s in zip(vals, statics)]
        s_args = inputs[:len(args)]
        s_kwargs = dict(zip(names, inputs[len(args):]))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        captured = CapturedStep(
            "train_step", lambda: self._step_in_place(s_args, s_kwargs),
            generators=self._generators(), warmup_counts=True,
            pool=self._pool)
        self._graphs[key] = (captured, statics)
        if len(self._graphs) > self.MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return captured.warmup_output.clone()

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
