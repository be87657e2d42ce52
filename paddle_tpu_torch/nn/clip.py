"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py:13-84).

Clippers are callables over [(param, grad)] lists, the contract the
optimizers use; they return new gradient tensors and leave the given
ones untouched."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
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
            s = g.float().square().sum()
            sq = s if sq is None else sq + s
        return sq

    def __call__(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        global_norm = sq.sqrt()
        scale = self.clip_norm / torch.clamp(global_norm,
                                             min=self.clip_norm)
        return [(p, None if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
