"""Explicit pipeline schedules: F-then-B, 1F1B, interleaved (VPP)
(counterpart of paddle_tpu/distributed/meta_parallel/pipeline_schedules.py).

A schedule is a linearization of the unit DAG (F(part, micro) and
B(part, micro) with the reference's dependencies); the generator is
pure Python and is the reference's, so the unit lists are equal. The
executor cuts autograd at part boundaries: a part's input is a detached
leaf, so a B unit's ``run_backward(out, cotangent)`` fills this part's
parameter gradients and leaves the input's cotangent for the part
before it, which `PipelineLayer.transfer_cotangent` moves upstream.

Activations may be pytrees of Tensors (tuples, lists, dicts). They are
flattened by the reference's rule, JAX's tree flatten with Tensors as
leaves, under which a None entry is an empty subtree and yields no
leaf (``torch.utils._pytree`` would keep it as a leaf): the cotangent
list a B unit receives must align with the downstream part's input
leaves, so both sides use this one rule (`_tree_leaves`, `_tree_map`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

__all__ = ["Unit", "build_schedule", "max_in_flight", "ScheduleExecutor"]


@dataclass(frozen=True)
class Unit:
    kind: str        # "F" | "B"
    part: int        # model chunk index (== stage when v == 1)
    micro: int
    stage: int       # owning pipeline stage = part % num_stages
    cycle: int       # simulated clock cycle (units sharing a cycle
                     # run on disjoint stage meshes -> overlap)


def _simulate(num_stages: int, num_micro: int, num_chunks: int,
              warmup: List[int], prefer_depth_first: bool) -> List[Unit]:
    """Event-driven linearization of the pipeline unit DAG.

    Per cycle each stage executes at most one ready unit; a stage
    prefers F while it has executed fewer forwards than its warmup
    quota, then alternates B-first (the 1F1B steady state). With
    warmup == all forwards this degenerates to F-then-B.
    """
    p, n, v = num_stages, num_micro, num_chunks
    parts = p * v
    f_done = [[False] * n for _ in range(parts)]
    b_done = [[False] * n for _ in range(parts)]
    stage_parts = {s: [c * p + s for c in range(v)] for s in range(p)}
    f_count = [0] * p
    b_count = [0] * p
    total_f = n * v
    order: List[Unit] = []
    cycle = 0
    while any(f_count[s] < total_f or b_count[s] < total_f
              for s in range(p)):
        progressed = False
        for s in range(p):
            unit = None
            # ready F units owned by this stage, chunk-major then micro
            ready_f = [(part, m) for part in stage_parts[s]
                       for m in range(n)
                       if not f_done[part][m]
                       and (part == 0 or f_done[part - 1][m])]
            ready_b = [(part, m) for part in reversed(stage_parts[s])
                       for m in range(n)
                       if not b_done[part][m] and f_done[part][m]
                       and (part == parts - 1 or b_done[part + 1][m])]
            if prefer_depth_first:
                # micro-major F order: finish micro m through this
                # stage's chunks before starting m+1 (interleave style
                # groups handled by the warmup quota)
                ready_f.sort(key=lambda pm: (pm[1] // p, pm[0], pm[1]))
            if f_count[s] < warmup[s] and ready_f:
                unit = ("F",) + ready_f[0]
            elif ready_b:
                unit = ("B",) + ready_b[0]
            elif (ready_f and f_count[s] < total_f
                  and f_count[s] - b_count[s] <= warmup[s]):
                # steady state: one F per completed B — keeps in-flight
                # activations capped at warmup + 1 (the 1F1B invariant);
                # without the cap a stage would run ahead through the
                # bubble and hold every micro-batch like F-then-B
                unit = ("F",) + ready_f[0]
            if unit is None:
                continue
            kind, part, m = unit
            if kind == "F":
                f_done[part][m] = True
                f_count[s] += 1
            else:
                b_done[part][m] = True
                b_count[s] += 1
            order.append(Unit(kind, part, m, s, cycle))
            progressed = True
        cycle += 1
        if not progressed and cycle > 4 * parts * n + 16:
            raise RuntimeError("pipeline schedule deadlocked")
    return order


@functools.lru_cache(maxsize=64)
def build_schedule(mode: str, num_stages: int, num_micro: int,
                   num_chunks: int = 1) -> List[Unit]:
    """mode: 'FThenB' | '1F1B' | 'Interleaved1F1B' (needs num_chunks>1).

    Warmup quotas match the reference:
      1F1B: p - s - 1            (pipeline_parallel.py:431)
      VPP:  (p - s - 1) * 2 + (v - 1) * p   (:1091, Megatron layout)

    The simulation is pure in its arguments, so the unit list is
    memoized — a training loop pays it once, not per step.
    """
    p, n, v = num_stages, num_micro, num_chunks
    total_f = n * v
    if mode == "FThenB":
        warmup = [total_f] * p
        return _simulate(p, n, v, warmup, prefer_depth_first=False)
    if mode == "1F1B":
        if v != 1:
            raise ValueError("1F1B uses one chunk; use Interleaved1F1B")
        warmup = [min(p - s - 1, total_f) for s in range(p)]
        return _simulate(p, n, 1, warmup, prefer_depth_first=False)
    if mode == "Interleaved1F1B":
        if v < 2:
            raise ValueError(
                "Interleaved1F1B needs num_virtual_pipeline_stages >= 2")
        warmup = [min((p - s - 1) * 2 + (v - 1) * p, total_f)
                  for s in range(p)]
        return _simulate(p, n, v, warmup, prefer_depth_first=True)
    raise ValueError(f"unknown pipeline schedule mode {mode!r}")


def max_in_flight(order: List[Unit], num_stages: int) -> List[int]:
    """Peak (#F executed - #B executed) per stage — the activation
    memory high-water mark the schedule implies."""
    peak = [0] * num_stages
    live = [0] * num_stages
    for u in order:
        live[u.stage] += 1 if u.kind == "F" else -1
        peak[u.stage] = max(peak[u.stage], live[u.stage])
    return peak


def _tree_leaves(tree) -> list:
    """The leaves of `tree` in JAX's order: tuples, lists and dicts (by
    sorted key) are containers, None is an empty subtree, anything else
    (a Tensor among them) is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in
                _tree_leaves(tree[k])]
    return [tree]


def _tree_map(fn, tree):
    """`tree` with `fn` applied to each leaf (`_tree_leaves`' rule; None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in tree}
    return fn(tree)


class ScheduleExecutor:
    """Runs a unit order against a PipelineLayer, cutting autograd at
    part boundaries so that each B unit touches only its part's
    parameters.

    Stage activations may be pytrees of Tensors (a transformer stage
    threading (hidden, attention_mask, position_ids) works under every
    schedule): the cut detaches each Tensor leaf, and the B unit
    back-propagates into every float leaf that received a cotangent."""

    def __init__(self, pipe, loss_fn, scaler=None):
        self._pipe = pipe
        self._loss_fn = loss_fn
        self._scaler = scaler
        self._cotangent = {}
        self.executed: List[Tuple[str, int, int]] = []  # (kind, part, m)

    def run(self, order: List[Unit], micro_inputs, micro_labels,
            forward_only=False):
        from ...autograd.tape import run_backward
        from ...core.tensor import Tensor

        pipe = self._pipe
        n_parts = pipe.num_parts
        n = len(micro_inputs)
        # saved[(part, m)] = (input tree, output tree)
        saved = {}
        total = None
        for u in order:
            if u.kind == "F":
                if u.part == 0:
                    x = micro_inputs[u.micro]
                else:
                    key = (u.part - 1, u.micro)
                    prev_out = saved[key][1]
                    if forward_only:
                        # no B unit will pop it: release it now, or an
                        # eval holds every micro-batch at every part
                        del saved[key]
                    x = _tree_map(
                        lambda t: pipe.transfer_to_part(t, u.part)
                        if isinstance(t, Tensor) else t, prev_out)
                if not forward_only:
                    def cut(t):
                        if not isinstance(t, Tensor):
                            return t
                        d = t.detach()
                        if d._data.is_floating_point() or \
                                d._data.is_complex():
                            d.stop_gradient = False
                        return d
                    x = _tree_map(cut, x)
                out = pipe.forward_part(x, u.part)
                if u.part == n_parts - 1:
                    loss = out
                    if self._loss_fn is not None and \
                            micro_labels[u.micro] is not None:
                        loss = self._loss_fn(out, micro_labels[u.micro])
                    if not isinstance(loss, Tensor):
                        raise RuntimeError(
                            "the last pipeline stage must produce a "
                            "Tensor loss (set loss_fn on the "
                            "PipelineLayer for pytree outputs)")
                    loss = loss / n
                    if self._scaler is not None:
                        out = self._scaler.scale(loss)
                    else:
                        out = loss
                    d = loss.detach()
                    total = d if total is None else total + d
                if not (forward_only and u.part == n_parts - 1):
                    saved[(u.part, u.micro)] = (x, out)
                self.executed.append(("F", u.part, u.micro))
            else:
                if forward_only:
                    continue
                x, out = saved.pop((u.part, u.micro))
                if u.part == n_parts - 1:
                    if out.ndim != 0 and out.size != 1:
                        raise RuntimeError(
                            "scheduled train_batch needs a scalar loss "
                            "(set loss_fn on the PipelineLayer)")
                    run_backward([out], [None])
                else:
                    # the flat cotangent list, aligned with the
                    # downstream part's input leaves == this part's
                    # output leaves
                    g_leaves = self._cotangent.pop((u.part, u.micro))
                    out_leaves = _tree_leaves(out)
                    pairs = [(o, g) for o, g in zip(out_leaves, g_leaves)
                             if isinstance(o, Tensor) and g is not None
                             and not o.stop_gradient]
                    if pairs:
                        run_backward([o for o, _ in pairs],
                                     [g for _, g in pairs])
                if u.part > 0:
                    def pop_grad(t):
                        if not isinstance(t, Tensor):
                            return None
                        ct = t.grad
                        t.grad = None
                        if ct is None:
                            return None
                        return pipe.transfer_cotangent(ct, u.part - 1)
                    self._cotangent[(u.part - 1, u.micro)] = [
                        pop_grad(t) for t in _tree_leaves(x)]
                self.executed.append(("B", u.part, u.micro))
        return total
