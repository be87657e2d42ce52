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

from ..observability import numerics as _num
from . import dispatch_queue

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


class _LeafTap:
    """The numerics plane's backward tap (the reference's leaf-edge tap,
    paddle_tpu/autograd/dispatch_queue.py:530-541): one `[grad_sq,
    nonfinite]` device pair over the cotangents this backward adds to the
    leaves, not over their accumulated ``.grad``. A hook on each leaf
    that the graph of `outs` accumulates into sees that cotangent before
    torch adds it (and returns nothing, so the gradient is untouched);
    the pairs are summed in the graph walk's order. The reference taps
    each fused segment of its own backward engine; the port runs one
    torch backward, so a backward is one tap (a record's
    ``backward.segments`` counts backwards)."""

    def __init__(self, outs):
        self.leaves, self.pairs, self.handles = [], {}, []
        seen, stack = set(), [t.grad_fn for t in outs]
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            leaf = getattr(fn, "variable", None)
            if leaf is not None and id(leaf) not in self.pairs:
                self.pairs[id(leaf)] = None
                self.leaves.append(leaf)
                self.handles.append(leaf.register_hook(
                    functools.partial(self._note, id(leaf))))
            stack.extend(f for f, _ in fn.next_functions)

    @torch.no_grad()
    def _note(self, key, g):
        gf = g.detach().float()
        self.pairs[key] = torch.stack([torch.sum(gf * gf),
                                       torch.sum(~torch.isfinite(gf)).float()])

    def close(self):
        for h in self.handles:
            h.remove()

    @torch.no_grad()
    def pair(self):
        got = [self.pairs[id(leaf)] for leaf in self.leaves
               if self.pairs[id(leaf)] is not None]
        if not got:
            return torch.zeros(2)
        return torch.stack(got).sum(0)


def run_backward(tensors, grad_tensors=None, retain_graph=False,
                 grad_targets=None, create_graph=False,
                 accumulate_leaf_grads=True):
    """The reverse pass from `tensors` (Tensors) with cotangents
    `grad_tensors` (None: ones for a scalar). Outputs that require no
    grad contribute nothing, as in the reference. With `grad_targets`
    and ``accumulate_leaf_grads=False`` (paddle.grad) it returns the
    torch gradient of each target (None where unreachable) and touches
    no ``.grad``; otherwise it accumulates into the leaves' ``.grad``,
    and on the numerics plane's sampled steps, in the "whole_graph"
    dispatch mode, notes a backward tap (`_LeafTap`)."""
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
        tap = _LeafTap(outs) if _num._ENABLED and _num.want_stats() \
            and dispatch_queue.dispatch_mode() == "whole_graph" else None
        try:
            torch.autograd.backward(outs, seeds, retain_graph=retain_graph,
                                    create_graph=create_graph)
        finally:
            if tap is not None:
                tap.close()
        if tap is not None:
            _num.note_backward_tap(tap.pair())
    if grad_targets is not None:
        return [None if x.grad is None else x.grad._data
                for x in grad_targets]
    return None
