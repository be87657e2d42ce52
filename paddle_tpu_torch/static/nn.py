"""paddle.static.nn control-flow sugar (counterpart of
paddle_tpu/static/nn.py, after python/paddle/static/nn/control_flow.py).

On a concrete predicate only the taken branch runs (a predicate on the
card is read back to the host once, the reference's semantics for a
materialized condition). Under a trace (``torch.export``, ``make_fx``;
the predicate is a fake tensor) `cond` and `while_loop` stage into
torch's cond / while_loop through the same converters `jit.to_static`
lowers Python ``if`` / ``while`` onto (jit/dy2static.py), and `case` /
`switch_case` into nested conds."""
from __future__ import annotations

import types

from ..core.tensor import Tensor
from ..jit.dy2static import convert_ifelse, convert_while
from ..kernels import tracing

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _arr(x):
    return x._data if isinstance(x, Tensor) else x


class _Tupled:
    """`fn` with its outputs as a tuple, what the converters carry, and
    with `fn`'s closure, which they rebind to the traced operands while
    they trace it (so a tensor `fn` reads from its scope is an operand,
    not a constant)."""

    def __init__(self, fn):
        self.fn = fn
        self.__closure__ = fn.__closure__
        self.single = None

    def __call__(self, *args):
        out = self.fn(*args)
        self.single = not isinstance(out, (list, tuple))
        return (out,) if self.single else tuple(out)


def cond(pred, true_fn=None, false_fn=None, name=None,
         return_names=None):
    """Run true_fn or false_fn depending on pred (a 0-D bool tensor).
    Traced, both branches are traced and must return the same structure
    of tensors (the reference's select_input contract)."""
    if not tracing(_arr(pred)):
        taken = true_fn if bool(_arr(pred)) else false_fn
        return taken() if taken is not None else None
    if true_fn is None or false_fn is None:
        raise ValueError(
            "cond under tracing requires both true_fn and false_fn")
    true_t = _Tupled(true_fn)
    outs = convert_ifelse(pred, true_t, _Tupled(false_fn), ())
    return outs[0] if true_t.single else outs


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """loop_vars (a list or tuple of tensors) threaded through body_fn
    while cond_fn holds; returns the final loop_vars as a tuple."""
    return tuple(convert_while(cond_fn, _Tupled(body_fn),
                               tuple(loop_vars)))


class _Case:
    """`case` over the remaining (pred, fn) pairs as one callable, the
    false branch of a traced cond. Its closure is the predicates (cells
    of its own) and every remaining function's closure, so the
    converters rebind all of them to that cond's operands."""

    def __init__(self, pairs, default):
        self.preds = [types.CellType(p) for p, _fn in pairs]
        self.fns = [fn for _p, fn in pairs]
        self.default = default
        cells = list(self.preds)
        for fn in self.fns + ([default] if default is not None else []):
            cells.extend(fn.__closure__ or ())
        self.__closure__ = tuple(cells)

    def __call__(self):
        return case([(c.cell_contents, fn)
                     for c, fn in zip(self.preds, self.fns)], self.default)


def case(pred_fn_pairs, default=None, name=None):
    """The first (pred, fn) whose pred holds wins (ref: control_flow.py
    case)."""
    for i, (pred, fn) in enumerate(pred_fn_pairs):
        if tracing(_arr(pred)):
            rest = pred_fn_pairs[i + 1:]
            return cond(pred, fn,
                        _Case(rest, default) if rest else default)
        if bool(_arr(pred)):
            return fn()
    if default is not None:
        return default()
    raise ValueError("case: no predicate matched and no default given")


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Integer-indexed branches (ref: control_flow.py switch_case):
    branch_fns a dict or (index, fn) pairs; an index with no branch
    takes `default` (traced: the last branch when none is given, as in
    the reference)."""
    idx = _arr(branch_index)
    fns = dict(branch_fns) if not isinstance(branch_fns, dict) \
        else branch_fns
    if not tracing(idx):
        fn = fns.get(int(idx), default)
        if fn is None:
            raise ValueError(
                f"switch_case: no branch for index {int(idx)} and no "
                "default")
        return fn()
    keys = sorted(fns)
    if default is None:
        default = fns[keys[-1]]
    return case([(idx == k, fns[k]) for k in keys], default)
