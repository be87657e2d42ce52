"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py:102).

Each optimizer defines ``_update_rule(param, grad, state, lr, group) ->
(new_param, new_state)`` over tensors, op for op as paddle_tpu writes it
in jnp. The eager ``step()`` applies it per parameter after the
optional ``grad_clip``; ``TrainStep`` applies it through
``functional_update``, which (as in the reference, :523-534) uses the
first group's hyperparameters and applies no clip. The learning rate
enters the rule as an f32 scalar tensor on the parameters' device, so
no step reads a value back to the host.

Not ported yet: ``multi_precision`` master weights (raises) and the
reference's fused one-executable step (``_fused_step_apply`` :317), a
performance path.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


def _unpack(item, index):
    """(name, tensor) of one `parameters` entry: a tensor (named
    ``param_<index>``) or a (name, tensor) pair as
    ``Module.named_parameters()`` yields."""
    if isinstance(item, tuple):
        return item
    return f"param_{index}", item


class Optimizer:
    """`parameters`: tensors, (name, tensor) pairs, or group dicts
    ``{"params": [...], "weight_decay": ..., "learning_rate": ...}``. The
    names key ``state_dict`` as ``<name>_<accumulator>``, the reference's
    key format (:481-520); pass ``model.named_parameters()`` to key it by
    the model's parameter names."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if multi_precision:
            raise NotImplementedError(
                "multi_precision master weights are not ported yet")
        self._lr = learning_rate
        self._names: Dict[int, str] = {}
        self._parameter_list, self._param_groups = self._build_groups(
            parameters)
        self.weight_decay = weight_decay
        self._grad_clip = grad_clip
        # state: param id -> dict of accumulator name -> tensor
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        self._lr_cache = None

    # -- param plumbing --
    def _build_groups(self, parameters):
        """(flat parameter list, groups); plain entries form group 0, as
        in the reference's _build_groups (:130)."""
        if parameters is None:
            return [], []
        flat, groups, plain = [], [], []
        for item in list(parameters):
            if isinstance(item, dict):
                ps = []
                for q in item["params"]:
                    n, p = _unpack(q, len(flat))
                    self._names[id(p)] = n
                    flat.append(p)
                    ps.append(p)
                groups.append(dict(item, params=ps))
            else:
                n, p = _unpack(item, len(flat))
                self._names[id(p)] = n
                flat.append(p)
                plain.append(p)
        if plain:
            groups.insert(0, {"params": plain})
        return flat, groups

    def _all_params(self):
        for g in self._param_groups:
            yield from g["params"]

    # -- lr --
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    def _lr_tensor(self, lr, device):
        """The learning rate as an f32 scalar tensor on `device`, made once
        per value (the reference's _lr32 cache, :303)."""
        hit = self._lr_cache
        if hit is not None and hit[0] == (lr, device):
            return hit[1]
        t = torch.tensor(lr, dtype=torch.float32, device=device)
        self._lr_cache = ((lr, device), t)
        return t

    # -- state --
    def _state_names(self) -> List[str]:
        """accumulator names, e.g. ['moment1', 'moment2', ...]"""
        return []

    def _init_state(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _get_state(self, p) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._init_state(p)
            self._accumulators[id(p)] = st
        return st

    # -- the rule (override) --
    def _update_rule(self, param, grad, state, lr, group):
        raise NotImplementedError

    def _apply_decay(self, param, grad, group):
        """coupled L2: grad += wd * param (ref: regularizer semantics)."""
        wd = group.get("weight_decay", self.weight_decay)
        if wd:
            return grad + float(getattr(wd, "_coeff", wd)) * param
        return grad

    # -- public API --
    @torch.no_grad()
    def step(self):
        """Apply the rule to every parameter with a gradient, after
        `grad_clip` (:213-260)."""
        params_grads = []
        seen = set()
        for group in self._param_groups:
            for p in group["params"]:
                if not p.requires_grad or p.grad is None or id(p) in seen:
                    continue
                seen.add(id(p))
                params_grads.append((p, p.grad, group))
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for p, g, _ in params_grads])
            params_grads = [(p, g2, grp) for (p, _g, grp), (_, g2) in
                            zip(params_grads, clipped)]
        self._step_count += 1
        lr = self.get_lr()
        for p, g, group in params_grads:
            garr = g if g.dtype == p.dtype else g.to(p.dtype)
            new_p, new_state = self._update_rule(
                p.detach(), garr, self._get_state(p),
                self._lr_tensor(lr, p.device), group)
            p.copy_(new_p)
            self._accumulators[id(p)] = new_state

    def clear_grad(self, set_to_zero=False):
        for p in self._all_params():
            p.grad = None

    clear_gradients = clear_grad

    def functional_update(self, params_flat, grads_flat, states, lr):
        """params/grads: flat lists of tensors; states: list of dicts; lr
        an f32 scalar tensor. Returns (new_params, new_states) without
        touching the inputs. Uses the first group's hyperparameters and
        applies no grad_clip, as the reference's (:523-534) does."""
        group = self._param_groups[0] if self._param_groups else {}
        new_ps, new_sts = [], []
        for parr, garr, st in zip(params_flat, grads_flat, states):
            if garr.dtype != parr.dtype:
                garr = garr.to(parr.dtype)
            np_, ns_ = self._update_rule(parr, garr, st, lr, group)
            new_ps.append(np_)
            new_sts.append(ns_)
        return new_ps, new_sts

    # -- checkpointing --
    def state_dict(self):
        """Accumulators (copied) keyed ``<param name>_<accumulator>``, the
        scheduler's state under "LR_Scheduler", and "global_step"."""
        sd = OrderedDict()
        for p in self._all_params():
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                sd[f"{self._names[id(p)]}_{k}"] = v.clone()
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        sd["global_step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        for p in self._all_params():
            st = {}
            for name in self._state_names():
                key = f"{self._names[id(p)]}_{name}"
                if key in state_dict:
                    st[name] = torch.as_tensor(state_dict[key]).to(
                        p.device).clone()
            if st:
                self._accumulators[id(p)] = st
        if "LR_Scheduler" in state_dict and isinstance(self._lr,
                                                      LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        self._step_count = int(state_dict.get("global_step", 0))

    load_state_dict = set_state_dict
