"""Public op namespace and Tensor method patching (counterpart of
paddle_tpu/ops/__init__.py).

Every registered op whose first parameter is a tensor becomes a Tensor
method, and the Python operators route through the registry, so they
are AMP-aware and recorded (:102-260).

The reference's in-place methods (``add_``, ``clip_``, ...) and
``__setitem__`` rebind ``_data`` to a new array (:69, :216). The port's
rebind too: ``x[i] = v`` writes into a clone (``setitem``) and ``x.add_(y)``
computes ``x + y``; neither writes into storage that autograd saved or
into a leaf that requires a grad (where torch raises and the reference
does not). A leaf rebound to a recorded result keeps its grad
(``Tensor._leaf``); one rebound without a record (under ``no_grad``, or
``zero_``/``fill_``) stays a leaf that requires a grad, with its grad.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import NARROW, Tensor
from ..core.tensor import _diffable
from . import (creation, linalg, logic, manipulation, math,  # noqa: F401
               nn_ops, random, reduction, registry, search)
from . import longtail, parity, sequence_ops, vision_ops  # noqa: F401
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .nn_ops import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .registry import OPS, get_op, register_op  # noqa: F401
from .search import *  # noqa: F401,F403
from ..nn.functional import pad  # noqa: F401
from .longtail import *  # noqa: F401,F403
from .sequence_ops import *  # noqa: F401,F403
from .vision_ops import *  # noqa: F401,F403
from ..core.generator import torch_generator as _torch_generator
from .math import abs as _abs_op, pow as _pow_op
from .math import add, divide, floor_divide, mod, multiply, neg, subtract
from .logic import (bitwise_and, bitwise_not, bitwise_or, bitwise_xor,
                    equal, greater_equal, greater_than, less_equal,
                    less_than, not_equal)
from .manipulation import cast


# ---------------------------------------------------------------------------
# indexing ops
# ---------------------------------------------------------------------------
@register_op("getitem")
def _getitem(x, index):
    return x[index]


@register_op("setitem")
def _setitem(x, index, value):
    out = x.clone()
    out[index] = value.to(x.dtype) if isinstance(value, torch.Tensor) \
        else value
    return out


def _rebind(self: Tensor, new: torch.Tensor) -> Tensor:
    """Point `self` at `new`, the result of an in-place method, keeping
    the grad of a leaf that requires one."""
    old = self._data
    if old.requires_grad and old.grad_fn is None and new.grad_fn is not None:
        if self._leaf is None:
            self._leaf = old
    elif old.requires_grad and not new.requires_grad and _diffable(new):
        holder = self._grad_holder()
        if new is not old:
            new.requires_grad_(True)
            g = holder.grad
            if g is not None and g.dtype == new.dtype \
                    and g.shape == new.shape:
                new.grad = g
        self._leaf = None
    self._data = new
    return self


def _tensor_getitem(self, idx):
    return _getitem(self, idx)


def _tensor_setitem(self, idx, value):
    _rebind(self, _setitem(self, idx, value)._data)


Tensor.__getitem__ = _tensor_getitem
Tensor.__setitem__ = _tensor_setitem


# ---------------------------------------------------------------------------
# operator dunders
# ---------------------------------------------------------------------------
def _binop(op):
    def f(self, other):
        return op(self, other)

    return f


def _as_tensor_like(other, like: Tensor) -> Tensor:
    """A Python value as the reference's ``Tensor(other)`` makes it (a
    typed 0-d array: float32, int32 or bool), on `like`'s device."""
    if isinstance(other, Tensor):
        return other
    t = torch.as_tensor(np.asarray(other), device=like._data.device)
    return Tensor._wrap(t.to(NARROW.get(t.dtype, t.dtype)),
                        stop_gradient=True)


def _rbinop(op):
    def f(self, other):
        return op(_as_tensor_like(other, self), self)

    return f


Tensor.__add__ = _binop(add)
Tensor.__radd__ = _rbinop(add)
Tensor.__sub__ = _binop(subtract)
Tensor.__rsub__ = _rbinop(subtract)
Tensor.__mul__ = _binop(multiply)
Tensor.__rmul__ = _rbinop(multiply)
Tensor.__truediv__ = _binop(divide)
Tensor.__rtruediv__ = _rbinop(divide)
Tensor.__floordiv__ = _binop(floor_divide)
Tensor.__rfloordiv__ = _rbinop(floor_divide)
Tensor.__mod__ = _binop(mod)
Tensor.__rmod__ = _rbinop(mod)
Tensor.__pow__ = _binop(_pow_op)
Tensor.__rpow__ = _rbinop(_pow_op)
Tensor.__matmul__ = _binop(matmul)  # noqa: F405
Tensor.__rmatmul__ = _rbinop(matmul)  # noqa: F405
Tensor.__neg__ = lambda self: neg(self)
Tensor.__abs__ = lambda self: _abs_op(self)
Tensor.__eq__ = _binop(equal)
Tensor.__ne__ = _binop(not_equal)
Tensor.__gt__ = _binop(greater_than)
Tensor.__ge__ = _binop(greater_equal)
Tensor.__lt__ = _binop(less_than)
Tensor.__le__ = _binop(less_equal)
Tensor.__and__ = _binop(bitwise_and)
Tensor.__or__ = _binop(bitwise_or)
Tensor.__xor__ = _binop(bitwise_xor)
Tensor.__invert__ = lambda self: bitwise_not(self)
Tensor.__hash__ = lambda self: id(self)


# ---------------------------------------------------------------------------
# method patching
# ---------------------------------------------------------------------------
_METHOD_NAMES = [
    # math
    "abs", "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "pow", "maximum", "minimum", "fmax", "fmin", "exp", "expm1", "log",
    "log2", "log10", "log1p", "sqrt", "rsqrt", "square", "reciprocal",
    "sign", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "ceil", "floor", "round", "trunc",
    "frac", "erf", "erfinv", "lgamma", "digamma", "sigmoid", "neg", "clip",
    "isnan", "isinf", "isfinite", "nan_to_num", "lerp", "scale", "atan2",
    "heaviside", "hypot",
    # reductions
    "sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp", "var",
    "std", "median", "nanmedian", "nansum", "nanmean", "quantile", "all",
    "any", "count_nonzero", "cumsum", "cumprod", "cummax", "cummin",
    # manipulation
    "reshape", "transpose", "flatten", "squeeze", "unsqueeze", "tile",
    "expand", "expand_as", "broadcast_to", "roll", "flip", "gather",
    "gather_nd", "scatter", "scatter_nd_add", "index_select", "index_sample",
    "index_add", "index_fill", "masked_select", "masked_fill", "split",
    "chunk", "unbind", "cast", "repeat_interleave", "moveaxis", "swapaxes",
    "take_along_axis", "put_along_axis", "unfold", "view", "as_strided",
    "tril", "triu", "diagonal", "masked_scatter",
    # linalg
    "matmul", "mm", "bmm", "dot", "inner", "outer", "mv", "t", "cross",
    "norm", "dist", "cholesky", "inverse", "pinv", "trace", "kron",
    "matrix_power",
    # logic
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "is_empty",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "nonzero", "unique", "unique_consecutive", "searchsorted", "bucketize",
    # creation-ish
    "zeros_like", "ones_like", "full_like",
]

_ns = globals()
for _name in _METHOD_NAMES:
    if not hasattr(Tensor, _name) or _name == "t":
        setattr(Tensor, _name, _ns[_name])

Tensor.remainder = _ns["mod"]


def _astype(self, dtype):
    return cast(self, dtype)


Tensor.astype = _astype
Tensor.type = _astype


# ---- in-place variants: functional underneath, rebinding `_data` ----
def _make_inplace(op):
    def f(self, *args, **kwargs):
        return _rebind(self, op(self, *args, **kwargs)._data)

    f.__name__ = op.__name__ + "_"
    return f


for _name in ["add", "subtract", "multiply", "divide", "clip", "scale",
              "floor", "ceil", "exp", "sqrt", "rsqrt", "reciprocal",
              "tanh", "sigmoid", "cast"]:
    setattr(Tensor, _name + "_", _make_inplace(_ns[_name]))


def _unrecorded(self, fill):
    """Rebind `self` to `fill(torch.Tensor) -> new tensor`, unrecorded."""
    with torch.no_grad():
        new = fill(self._data)
    return _rebind(self, new)


def _zero_(self):
    return _unrecorded(self, torch.zeros_like)


def _fill_(self, value):
    return _unrecorded(self, lambda d: torch.full_like(d, value))


def _uniform_(self, min=-1.0, max=1.0, seed=0):
    def fill(d):
        g = _torch_generator(d.device)
        return torch.empty_like(d).uniform_(min, max, generator=g)
    return _unrecorded(self, fill)


def _normal_(self, mean=0.0, std=1.0):
    def fill(d):
        g = _torch_generator(d.device)
        return torch.empty_like(d).normal_(mean, std, generator=g)
    return _unrecorded(self, fill)


def _exponential_(self, lam=1.0):
    def fill(d):
        g = _torch_generator(d.device)
        return torch.empty_like(d).exponential_(lam, generator=g)
    return _unrecorded(self, fill)


Tensor.zero_ = _zero_
Tensor.fill_ = _fill_
Tensor.uniform_ = _uniform_
Tensor.normal_ = _normal_
Tensor.exponential_ = _exponential_
