"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py:13-103).

Clippers are callables over [(param, grad)] lists, the contract the
optimizers use; they return new gradient tensors and leave the given
ones untouched. ``clip_grad_norm_`` scales the ``.grad`` of parameters
in place."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _torch(t):
    return t._data if isinstance(t, Tensor) else t


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, None if g is None else _torch(g).clamp(self.min,
                                                             self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most clip_norm (f32 norm,
    scale applied in the gradient's dtype, :44-48)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            g = _torch(g)
            norm = g.float().square().sum().sqrt()
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-12),
                                max=1.0)
            out.append((p, (g * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by clip_norm / max(global_norm, clip_norm),
    the global norm summed in f32 over every gradient (:52-81)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _global_norm_sq(self, params_grads):
        sq = None
        for _p, g in params_grads:
            if g is None:
                continue
            s = _torch(g).float().square().sum()
            sq = s if sq is None else sq + s
        return sq

    def __call__(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        global_norm = sq.sqrt()
        scale = self.clip_norm / torch.clamp(global_norm,
                                             min=self.clip_norm)
        return [(p, None if g is None
                 else (_torch(g).float() * scale).to(_torch(g).dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every parameter's ``.grad`` in place by min(max_norm /
    max(total, 1e-6), 1), total being the norm_type-norm of all the
    grads taken over f32 copies (inf: the largest absolute value), and
    return total as a 0-d tensor (zeros when no parameter has a grad).
    error_if_nonfinite is accepted and ignored, as the reference does
    (:84-103)."""
    if isinstance(parameters, (torch.Tensor, Tensor)):
        parameters = [parameters]
    parameters = [_torch(p) for p in parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = sum(g.float().abs().pow(norm_type).sum()
                    for g in grads).pow(1.0 / norm_type)
    scale = torch.clamp(max_norm / total.clamp_min(1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.device))
    return total
