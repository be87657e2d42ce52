"""Grad mode and the reverse pass (counterpart of
paddle_tpu/autograd/tape.py's public surface).

The reference records one ``GradNode`` per eager op and replays them in
its own engine (:96-506). The port's Tensors carry torch.autograd's
graph, so torch's engine takes the place of both: ``GradNode``,
``InputEdge``, ``build_node`` and ``record_apply`` are the JAX tape's
own and are not ported. Grad mode is torch's (``torch.is_grad_enabled``),
which is per thread where the reference's is per process.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["is_grad_enabled", "set_grad_enabled", "no_grad", "enable_grad",
           "run_backward"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> bool:
    """Set grad mode; returns the previous mode."""
    old = torch.is_grad_enabled()
    torch.set_grad_enabled(bool(mode))
    return old


class no_grad:
    """Context manager / decorator that records no graph."""

    def __enter__(self):
        self._old = set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._old)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)

        return wrapper


class enable_grad:
    def __enter__(self):
        self._old = set_grad_enabled(True)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._old)
        return False


def _seed(t, g, create_graph):
    """The cotangent torch receives for output `t` (a torch tensor)."""
    if g is None:
        if t.numel() != 1:
            raise RuntimeError(
                "grad can be implicitly created only for scalar outputs; "
                f"got shape {tuple(t.shape)}")
        return torch.ones_like(t)
    from ..core.tensor import Tensor
    g = g._data if isinstance(g, Tensor) else torch.as_tensor(
        g, dtype=t.dtype, device=t.device)
    return g if create_graph else g.detach()


def run_backward(tensors, grad_tensors=None, retain_graph=False,
                 grad_targets=None, create_graph=False,
                 accumulate_leaf_grads=True):
    """The reverse pass from `tensors` (Tensors) with cotangents
    `grad_tensors` (None: ones for a scalar). Outputs that require no
    grad contribute nothing, as in the reference. With `grad_targets`
    and ``accumulate_leaf_grads=False`` (paddle.grad) it returns the
    torch gradient of each target (None where unreachable) and touches
    no ``.grad``; otherwise it accumulates into the leaves' ``.grad``."""
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    outs, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        d = t._data
        if d.requires_grad:
            outs.append(d)
            seeds.append(_seed(d, g, create_graph))
    if grad_targets is not None and not accumulate_leaf_grads:
        results = [None] * len(grad_targets)
        live = [i for i, x in enumerate(grad_targets)
                if x._data.requires_grad]
        if outs and live:
            got = torch.autograd.grad(
                outs, [grad_targets[i]._data for i in live], seeds,
                retain_graph=retain_graph, create_graph=create_graph,
                allow_unused=True)
            for i, r in zip(live, got):
                results[i] = r
        return results
    if outs:
        torch.autograd.backward(outs, seeds, retain_graph=retain_graph,
                                create_graph=create_graph)
    if grad_targets is not None:
        return [None if x.grad is None else x.grad._data
                for x in grad_targets]
    return None
