"""LookAhead and ModelAverage (counterpart of
paddle_tpu/incubate/optimizer.py): optimizers over running copies of the
parameters, written in place with the reference's arithmetic.
``LookAhead`` steps its inner optimizer (Adam and AdamW: the
multi-tensor update on the card), and every k steps pulls the
parameters to slow <- slow + alpha * (fast - slow). ``ModelAverage``
sums the parameters over a window; ``apply()`` swaps the averages in for
evaluation and ``restore()`` puts the live weights back bit for bit
(also as a context manager)."""
from __future__ import annotations

import torch

from ..optimizer.optimizer import Optimizer

__all__ = ["ModelAverage", "LookAhead"]


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging for evaluation (:17)."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(learning_rate=0.0, parameters=parameters)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._sum = {id(p): torch.zeros_like(p, requires_grad=False)
                     for p in self._parameter_list}
        self._num_accumulates = 0
        self._num_updates = 0
        self._saved = None

    @torch.no_grad()
    def step(self):
        for p in self._parameter_list:
            self._sum[id(p)].add_(p)
        self._num_accumulates += 1
        self._num_updates += 1
        window = min(self.max_average_window,
                     self._num_updates * self.average_window)
        if (self._num_accumulates >= self.min_average_window
                and self._num_accumulates >= window):
            # restart the window from the current value
            for p in self._parameter_list:
                self._sum[id(p)].copy_(p)
            self._num_accumulates = 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged weights in (a context manager too: its exit
        restores unless need_restore is False)."""
        self._saved = {id(p): p.detach().clone()
                       for p in self._parameter_list}
        self._need_restore = need_restore
        if self._num_accumulates == 0:
            return self
        denom = self._num_accumulates
        for p in self._parameter_list:
            p.copy_((self._sum[id(p)] / denom).to(p.dtype))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if getattr(self, "_need_restore", True):
            self.restore()
        return False

    @torch.no_grad()
    def restore(self, executor=None):
        if self._saved is None:
            return
        for p in self._parameter_list:
            p.copy_(self._saved[id(p)])
        self._saved = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()


class LookAhead(Optimizer):
    """k fast steps of the inner optimizer, then slow <- slow + alpha *
    (fast - slow) and the parameters set to slow (:84)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._parameter_list = inner_optimizer._parameter_list
        self._slow = {id(p): p.detach().clone()
                      for p in self._parameter_list}
        self._step_num = 0

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_num += 1
        if self._step_num % self.k == 0:
            for p in self._parameter_list:
                slow = self._slow[id(p)]
                slow.add_(self.alpha * (p - slow))
                p.copy_(slow)

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
