"""The fused train step (counterpart of paddle_tpu/jit/__init__.py:314).

paddle_tpu compiles forward, backward and the optimizer update into one
XLA executable with donated buffers. The port runs the same three as
one eager call: forward and backward through torch.autograd, then the
optimizer's ``functional_update`` written into the parameters in place
(the analog of donation). A CUDA graph of the step is later work.

The forward and the update run inside profiler ranges
"TrainStep.forward" and "TrainStep.update", so a torch.profiler trace
splits a step's device time into forward, backward (the rest: autograd
launches it from its own thread) and update
(tools/torch_train_profile.py); with no profiler active a range costs a
few microseconds a step."""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from ..optimizer.lr import LRScheduler

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
    parameters. As in the reference:
      * the update goes through ``optimizer.functional_update``, so it
        uses the first parameter group's hyperparameters and applies NO
        ``grad_clip`` (``Optimizer.step`` does clip);
      * the learning rate is read at every call (a scheduler's or a
        ``set_lr`` value);
      * an ``LRScheduler`` steps after the call.
    The returned loss is a detached device tensor: reading it is the
    caller's host sync."""

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
        self._params = [p for p in model.parameters() if p.requires_grad]
        if not self._params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        self.device = self._params[0].device
        for p in self._params:
            optimizer._get_state(p)
        self._step_count = 0

    def _batch(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(a, device=self.device)

    def __call__(self, *args, **kwargs):
        args = [self._batch(a) for a in args]
        kwargs = {k: self._batch(v) if isinstance(v, torch.Tensor) else v
                  for k, v in kwargs.items()}
        opt = self.optimizer
        lr = opt._lr_tensor(opt.get_lr(), self.device)
        with record_function("TrainStep.forward"):
            if self.loss_fn is None:
                loss = self.model(*args, **kwargs)
            else:
                loss = self.loss_fn(self.model, *args, **kwargs)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        with torch.no_grad(), record_function("TrainStep.update"):
            # an unused parameter gets a zero gradient, as jax.grad gives
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._params, grads)]
            states = [opt._get_state(p) for p in self._params]
            new_params, new_states = opt.functional_update(
                [p.detach() for p in self._params], grads, states, lr)
            for p, n, st in zip(self._params, new_params, new_states):
                p.copy_(n)
                opt._accumulators[id(p)] = st
        self._step_count += 1
        if isinstance(opt._lr, LRScheduler):
            opt._lr.step()
        return loss.detach()

    def sync(self, copy=None):
        """The reference writes its compiled loop's state back into the
        model here; the port updates the model's parameters and the
        optimizer's state in place at every step, so nothing is left to
        write. Returns the model."""
        return self.model
