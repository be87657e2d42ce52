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

Observability (while enabled): an ``Optimizer.step`` whose every work
array is f32 is the reference's fused step, counted on
``paddle_tpu_optimizer_fused_step_total{outcome=}`` (reference :75-96):
"hit" when the optimizer has a multi-tensor form (its one kernel
launch is the port's fused step), "fallback" when it runs the
per-tensor rule; a step with a low-precision work array counts nothing,
as in the reference. Departure: the port builds no executable, so it
never counts "compile" and reports no "optimizer_fused" compile; each
new set of work shapes records the family's expectation instead
(`observability.perf.count_cost`, the executable gauges). TrainStep's
update (inside its graph) counts nothing, as the reference's
``functional_update`` does not. ``PADDLE_TPU_FUSED_OPT=0`` is read as
the reference reads it (:317-321) for what a step reports: no fused step
is counted and the numerics source is ``optimizer_eager``. It does not
move the update: the multi-tensor form computes the per-tensor rule op
for op, so every f32 work array still goes through it (the kernel on the
card).

The numerics plane (``observability.numerics``, while enabled): the
``numerics.check`` fault point fires at the top of ``step`` (before
clipping, ctx ``where="step"``) when faults are armed; on a sampled step
the update also writes each parameter's statistics into a [P, 5] table
(the multi-tensor kernel's statistics variant, with its per-chunk
scratch, both kept beside the table; the per-tensor rule's from
``work``, the gradient and the new value before ``work.copy_``, so no
copy is kept), ``pack_rows`` lays it out as ``pack_stats`` does, and
one ``submit`` hands it over, labelled ``g<i>`` by group position and
sourced ``optimizer_fused`` when every work array is f32 and the fused
step is on (the reference's fused step; whether the port has a kernel
for the rule does not matter), else ``optimizer_eager``. ``tick`` ends
every step.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List

import torch

from ..core.tensor import Tensor
from ..kernels.multi_tensor_adam import STATS_COLS, pack_rows, \
    scratch_floats
from ..observability import metrics as _om
from ..observability import numerics as _num
from ..observability import perf as _pf
from ..resilience import faults as _faults
from .lr import LRScheduler

__all__ = ["Optimizer"]

_FUSED_COUNTER = None


def _fused_counter(outcome: str) -> None:
    """paddle_tpu_optimizer_fused_step_total{outcome=} (the module
    docstring says what each outcome counts here)."""
    global _FUSED_COUNTER
    if _FUSED_COUNTER is None:
        _FUSED_COUNTER = _om.registry().counter(
            "paddle_tpu_optimizer_fused_step_total",
            "fused optimizer-step executable cache outcomes",
            ("outcome",))
    _FUSED_COUNTER.labels(outcome=outcome).inc()


def fused_enabled() -> bool:
    """False when ``PADDLE_TPU_FUSED_OPT`` is "0", as the reference reads
    it (optimizer.py:317-321): then no step reports itself fused (the
    module docstring)."""
    return os.environ.get("PADDLE_TPU_FUSED_OPT", "1") != "0"


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

    def _numerics_group_labels(self, groups):
        """The numerics plane's per-group labels: g<i> by position in
        the optimizer's groups (reference :204-210)."""
        gidx = {id(g): i for i, g in enumerate(self._param_groups)}
        return [f"g{gidx.get(id(grp), 0)}" for grp in groups]

    def _numerics_source(self, params_grads) -> str:
        """"optimizer_fused" when the step is the reference's fused step
        (every work array f32, PADDLE_TPU_FUSED_OPT not "0"), else
        "optimizer_eager"."""
        if fused_enabled() and all(
                self._master(p) is not None or p.dtype == torch.float32
                for p, _g, _grp in params_grads):
            return "optimizer_fused"
        return "optimizer_eager"

    def _stats_table(self, params_grads, device):
        """The statistics buffers of an update of `params_grads` on
        `device`: the [P, STATS_COLS] table, its packed [2P + 3] bundle
        and the multi-tensor kernel's per-chunk scratch (sized for every
        parameter). Made once for each (device, parameter sizes), so a
        graph that captured an update writes the same buffers at each
        replay."""
        sizes = tuple(p.numel() for p, _g, _grp in params_grads)
        tabs = self.__dict__.setdefault("_stats_tables", {})
        hit = tabs.get((device, sizes))
        if hit is None:
            n = len(sizes)
            hit = tabs[(device, sizes)] = (
                torch.zeros((n, STATS_COLS), dtype=torch.float32,
                            device=device),
                torch.zeros(2 * n + 3, dtype=torch.float32, device=device),
                torch.zeros(max(1, scratch_floats(sizes)),
                            dtype=torch.float32, device=device))
        return hit

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
        # numerics.check chaos hook (ctx where="step"), before clipping;
        # the disarmed loop never builds the pairs
        if _faults._ACTIVE:
            _num.check_fault("step", [(self._names[id(p)], g)
                                      for p, g, _ in params_grads])
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for p, g, _ in params_grads])
            params_grads = [(p, g2, grp) for (p, _g, grp), (_, g2) in
                            zip(params_grads, clipped)]
        self._step_count += 1
        packed = None
        if _num._ENABLED and _num.want_stats() and params_grads:
            packed = self._update_with_stats(params_grads)
        else:
            self._update_in_place(params_grads)
        if _om._ENABLED and params_grads:
            self._note_fused_step(params_grads)
        if packed is not None:
            _num.submit(
                packed, names=[self._names[id(p)] for p, _, _ in
                               params_grads],
                groups=self._numerics_group_labels(
                    [grp for _, _, grp in params_grads]),
                lr=self.get_lr(), source=self._numerics_source(
                    params_grads))
        if _num._ENABLED:
            _num.tick()

    def _update_with_stats(self, params_grads, masters=True):
        """`_update_in_place` with the statistics: returns the packed
        bundle (a buffer of the optimizer's, rewritten by the next such
        update)."""
        devs = {p.device for p, _g, _grp in params_grads}
        if len(devs) != 1:
            raise ValueError("the numerics plane's statistics need every "
                             "parameter on one device, got "
                             f"{sorted(map(str, devs))}")
        table, packed, scratch = self._stats_table(params_grads,
                                                   devs.pop())
        self._update_in_place(params_grads, masters=masters,
                              stats=(table, scratch))
        return pack_rows(table, out=packed)

    def _note_fused_step(self, params_grads):
        """The step's fused-step outcome (module docstring), and the
        expectation of a new set of work shapes."""
        if not fused_enabled():
            return              # no fused step, as in the reference
        work = []
        for p, _g, _grp in params_grads:
            mw = self._master(p)
            w = p if mw is None else mw
            if w.dtype != torch.float32:
                return          # not a fused step, as in the reference
            work.append(w)
        if self._multi_tensor_update is None:
            _fused_counter("fallback")
            return
        _fused_counter("hit")
        key = tuple((tuple(w.shape), g.dtype) for w, (_p, g, _grp)
                    in zip(work, params_grads))
        seen = self.__dict__.setdefault("_fused_shapes", set())
        if key in seen:
            return
        seen.add(key)
        elements = update = 0
        for w, (p, g, _grp) in zip(work, params_grads):
            n = w.numel()
            mom = [v for v in self._get_state(p).values()
                   if isinstance(v, torch.Tensor) and v.numel() > 1]
            elements += n
            update += n * (2 * 4 + g.element_size()
                           + 2 * sum(v.element_size() for v in mom)
                           + (0 if w is p else p.element_size()))
        _pf.record_compile("optimizer_fused", _pf.count_cost(
            "optimizer_fused", elements=float(elements),
            update_bytes=float(update)))

    @torch.no_grad()
    def _update_in_place(self, params_grads, masters=True, stats=None):
        """Update each (param, grad, group) in place: every f32 work
        array (an f32 parameter, or a master) through
        ``_multi_tensor_update`` in one call per device, the rest through
        ``_update_rule`` tensor by tensor, at the lr scalar of each
        device (``_lr_tensor``). TrainStep passes the first group for
        every parameter and ``masters=False``: like the reference's
        functional_update, it updates the parameters themselves.
        `stats`: (a [P, STATS_COLS] table that receives row i's
        statistics for params_grads[i], the multi-tensor form's scratch)
        (module docstring)."""
        lr = self.get_lr()
        multi = self._multi_tensor_update is not None
        table, scratch = (None, None) if stats is None else stats
        fused = {}
        for i, (p, g, grp) in enumerate(params_grads):
            mw = self._master(p) if masters else None
            work = p.detach() if mw is None else mw
            state = self._get_state(p)
            out = None if mw is None else p.detach()
            if multi and work.dtype == torch.float32:
                fused.setdefault(work.device, []).append(
                    (i, (work, g, state, grp, out)))
                continue
            garr = g if g.dtype == work.dtype else g.to(work.dtype)
            new_w, new_state = self._update_rule(
                work, garr, state, self._lr_tensor(lr, work.device), grp)
            if table is not None:
                table[i].copy_(_num.pack_stats([work], [garr], [new_w]))
            work.copy_(new_w)
            if out is not None:
                out.copy_(new_w)
            for k, v in new_state.items():
                state[k].copy_(v)
        for dev, items in fused.items():
            self._multi_tensor_update(
                [item for _i, item in items], self._lr_tensor(lr, dev),
                **({} if table is None else dict(
                    stats=table, positions=[i for i, _item in items],
                    scratch=scratch)))

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
        """Load accumulators and masters (torch tensors, arrays, or the
        Tensors ``load`` reads back from ``save(opt.state_dict())``). A
        tensor that already exists with the same shape and dtype is
        refilled in place, so a captured TrainStep graph goes on reading
        the loaded values."""
        def load(old, value, dtype=None):
            if isinstance(value, Tensor):
                value = value._data
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
