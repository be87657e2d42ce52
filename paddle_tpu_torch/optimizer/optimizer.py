"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py:102).

Each optimizer defines ``_update_rule(param, grad, state, lr, group) ->
(new_param, new_state)`` over tensors, op for op as paddle_tpu writes it
in jnp. ``step()`` applies, after the optional ``grad_clip``:

  * the optimizer's multi-tensor form of the rule (Adam and AdamW:
    ``kernels/multi_tensor_adam.py``) to every parameter whose work
    array is f32, in one call: one kernel launch on the card, the plain
    per-tensor rule on the CPU. This is the reference's fused step
    (``_fused_step_apply`` :317-458), one executable for all of them;
  * the per-tensor rule to the rest (bf16/f16 parameters without
    masters, as the reference keeps them off its fused path :331-337).

Both write parameters, moments and powers in place, so a CUDA graph that
captured an update (``TrainStep``) replays it on the same storage.
``TrainStep`` takes the same in-place update on every device, with the
first group's hyperparameters, no clip and no masters, as the
reference's ``functional_update`` (:523-534) does; the port's
``functional_update`` keeps that public name and its out-of-place form.
The learning rate enters the rule as one f32 scalar tensor per device,
refilled in place, so no step reads a value back to the host.

``multi_precision=True`` keeps an f32 master of every parameter that is
not f32 (``_master``, reference :173-183): the update runs on the master
and its cast is written into the parameter; the moments follow the
master's dtype unless ``moment_dtype`` is set; ``state_dict`` carries it
as ``<name>_master`` (reference :491-494, :512-515).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import torch

from ..core.tensor import Tensor
from .lr import LRScheduler

__all__ = ["Optimizer"]


def _unpack(item, index):
    """(name, torch tensor) of one `parameters` entry: a tensor (named
    ``param_<index>``, or by its name when it is an eager ``Tensor``) or
    a (name, tensor) pair as ``Module.named_parameters()`` yields. An
    eager ``Tensor`` parameter is stepped through its torch tensor
    (``_data``), in place, and its grad is that tensor's."""
    if isinstance(item, tuple):
        name, p = item
    else:
        name, p = None, item
    if isinstance(p, Tensor):
        name = name or p.name
        p = p._data
    return name or f"param_{index}", p


class Optimizer:
    """`parameters`: tensors (torch tensors or eager Tensors), (name,
    tensor) pairs, or group dicts
    ``{"params": [...], "weight_decay": ..., "learning_rate": ...}``. The
    names key ``state_dict`` as ``<name>_<accumulator>``, the reference's
    key format (:481-520); pass ``model.named_parameters()`` to key it by
    the model's parameter names."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        self._lr = learning_rate
        self._names: Dict[int, str] = {}
        self._parameter_list, self._param_groups = self._build_groups(
            parameters)
        self.weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # state: param id -> dict of accumulator name -> tensor
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        # param id -> f32 master of a parameter that is not f32
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0
        # device -> [f32 scalar tensor, the value it holds]
        self._lr_scalars: Dict[torch.device, list] = {}

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
        """The learning rate as an f32 scalar tensor on `device` (the
        reference's _lr32, :303): one static tensor per device, refilled
        in place when the value changes, so a captured graph that reads
        it sees each call's value."""
        hit = self._lr_scalars.get(device)
        if hit is None:
            hit = [torch.empty((), dtype=torch.float32, device=device), None]
            self._lr_scalars[device] = hit
        if hit[1] != lr:
            hit[0].fill_(lr)
            hit[1] = lr
        return hit[0]

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

    def _master(self, p):
        """The f32 master of `p` under multi_precision (made at first
        use from p's value), None for an f32 parameter or without
        multi_precision (reference :173-183)."""
        if not self._multi_precision or p.dtype == torch.float32:
            return None
        mw = self._master_weights.get(id(p))
        if mw is None:
            mw = p.detach().to(torch.float32).clone()
            self._master_weights[id(p)] = mw
        return mw

    # -- the rule (override) --
    def _update_rule(self, param, grad, state, lr, group):
        raise NotImplementedError

    # the rule over many f32 work arrays in one call, in place (override):
    # items are (work, grad, state, group, out: the parameter receiving
    # the work array's cast, or None). None: the optimizer has none, and
    # every parameter takes the per-tensor rule.
    _multi_tensor_update = None

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
        self._update_in_place(params_grads)

    @torch.no_grad()
    def _update_in_place(self, params_grads, masters=True):
        """Update each (param, grad, group) in place: every f32 work
        array (an f32 parameter, or a master) through
        ``_multi_tensor_update`` in one call per device, the rest through
        ``_update_rule`` tensor by tensor, at the lr scalar of each
        device (``_lr_tensor``). TrainStep passes the first group for
        every parameter and ``masters=False``: like the reference's
        functional_update, it updates the parameters themselves."""
        lr = self.get_lr()
        fused = {}
        for p, g, grp in params_grads:
            mw = self._master(p) if masters else None
            work = p.detach() if mw is None else mw
            state = self._get_state(p)
            out = None if mw is None else p.detach()
            if self._multi_tensor_update is not None \
                    and work.dtype == torch.float32:
                fused.setdefault(work.device, []).append(
                    (work, g, state, grp, out))
                continue
            garr = g if g.dtype == work.dtype else g.to(work.dtype)
            new_w, new_state = self._update_rule(
                work, garr, state, self._lr_tensor(lr, work.device), grp)
            work.copy_(new_w)
            if out is not None:
                out.copy_(new_w)
            for k, v in new_state.items():
                state[k].copy_(v)
        for dev, items in fused.items():
            self._multi_tensor_update(items, self._lr_tensor(lr, dev))

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
            mw = self._master_weights.get(id(p))
            if mw is not None:
                sd[f"{self._names[id(p)]}_master"] = mw.clone()
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        sd["global_step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        """Load accumulators and masters. A tensor that already exists
        with the same shape and dtype is refilled in place, so a
        captured TrainStep graph goes on reading the loaded values."""
        def load(old, value, dtype=None):
            new = torch.as_tensor(value).to(p.device, dtype)
            if old is not None and old.shape == new.shape \
                    and old.dtype == new.dtype:
                return old.copy_(new)
            return new.clone()

        for p in self._all_params():
            name = self._names[id(p)]
            old = self._accumulators.get(id(p)) or {}
            st = {k: load(old.get(k), state_dict[f"{name}_{k}"])
                  for k in self._state_names()
                  if f"{name}_{k}" in state_dict}
            if st:
                self._accumulators[id(p)] = dict(old, **st)
            if f"{name}_master" in state_dict:
                self._master_weights[id(p)] = load(
                    self._master_weights.get(id(p)),
                    state_dict[f"{name}_master"], torch.float32)
        if "LR_Scheduler" in state_dict and isinstance(self._lr,
                                                      LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        self._step_count = int(state_dict.get("global_step", 0))

    load_state_dict = set_state_dict
