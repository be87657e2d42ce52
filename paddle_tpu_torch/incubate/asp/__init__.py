"""Automatic SParsity, 2:4 structured pruning (counterpart of
paddle_tpu/incubate/asp/__init__.py): n:m masks of the prunable weights
(the n largest |w| of every m consecutive weights along the last axis,
ties broken by index, :45-64), applied by ``prune_model`` and re-applied
after every step by the ``decorate``d optimizer, so pruned weights stay
zero through training. Masks are in the weight's dtype and equal the
reference's exactly; they are kept by the parameter's torch tensor."""
from __future__ import annotations

import torch

from ...core.tensor import Tensor

__all__ = ["decorate", "prune_model", "set_excluded_layers",
           "reset_excluded_layers", "calculate_density",
           "OptimizerWithSparsityGuarantee"]

_excluded: set = set()
_masks: dict = {}   # id(the parameter's torch tensor) -> (name, mask)


def _torch(p):
    return p._data if isinstance(p, Tensor) else p


def set_excluded_layers(param_names, main_program=None):
    """Exclude parameters, by name, from pruning (:31)."""
    _excluded.update(param_names)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def calculate_density(x):
    """The share of nonzero entries of x (a Tensor, torch tensor or
    array), as a float."""
    t = torch.as_tensor(_torch(x))
    return float((t != 0).float().mean())


def _mask_1d(w, n, m):
    """Keep the n largest |w| of every m consecutive weights along the
    last axis: threshold at the n-th largest magnitude of each group,
    then keep the first n (by index) of those at or above it. A last
    axis that m does not divide is left dense."""
    shape = w.shape
    if shape[-1] % m != 0:
        return torch.ones_like(w)
    mag = w.reshape(-1, m).abs()
    kth = torch.sort(mag, dim=-1).values[:, m - n][:, None]
    mask = (mag >= kth).to(w.dtype)
    mask = mask * (torch.cumsum(mask, dim=-1) <= n)
    return mask.reshape(shape)


_MASK_ALGOS = {"mask_1d": _mask_1d, "mask_2d_greedy": _mask_1d,
               "mask_2d_best": _mask_1d}


def _prunable(name, d):
    # the reference prunes FC and conv weights, and skips biases / norms
    return name not in _excluded and d.dim() >= 2 and min(d.shape) >= 4


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Compute and apply n:m masks to the model's prunable weights
    (:75); with_mask keeps them for the decorated optimizer. Returns
    {parameter name: mask}."""
    if mask_algo not in _MASK_ALGOS:
        raise ValueError(f"unknown mask_algo {mask_algo!r}")
    algo = _MASK_ALGOS[mask_algo]
    out = {}
    for name, p in model.named_parameters():
        d = _torch(p)
        if not _prunable(name, d):
            continue
        with torch.no_grad():
            mask = algo(d.detach(), n, m)
            d.mul_(mask)
        if with_mask:
            _masks[id(d)] = (name, mask)
            out[name] = Tensor._wrap(mask)
    return out


class OptimizerWithSparsityGuarantee:
    """Re-applies the kept masks after every step of the optimizer it
    wraps (:93); any other attribute is the optimizer's."""

    def __init__(self, optimizer):
        self._inner = optimizer

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "_inner"), item)

    def step(self):
        self._inner.step()
        if not _masks:
            return
        with torch.no_grad():
            for p in (getattr(self._inner, "_parameter_list", None) or []):
                hit = _masks.get(id(_torch(p)))
                if hit is not None:
                    _torch(p).mul_(hit[1])


def decorate(optimizer):
    """Wrap an optimizer with the sparsity guarantee (:113)."""
    return OptimizerWithSparsityGuarantee(optimizer)
