"""Autograd public API (counterpart of paddle_tpu/autograd/__init__.py).

``backward`` and ``grad`` (:24, :32) run torch.autograd over the
Tensors' torch graphs, with ``retain_graph``, ``create_graph`` and
``allow_unused``; ``PyLayer`` (:70-215) is a ``torch.autograd.Function``
underneath whose forward and backward take and return Tensors;
``jacobian`` and ``hessian`` (:216-330) build their rows from ``grad``
as the reference does. ``GradNode``, ``InputEdge`` and ``run_batched``
are the JAX tape's own (``tape.py``, ``dispatch_queue.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dispatch_queue, tape  # noqa: F401
from .dispatch_queue import (backward_dispatch_mode, dispatch_mode,
                             set_dispatch_mode)
from .tape import (enable_grad, is_grad_enabled, no_grad, run_backward,
                   set_grad_enabled)
from ..core.tensor import Tensor

__all__ = ["backward", "grad", "PyLayer", "PyLayerContext", "PyLayerMeta",
           "Jacobian", "Hessian", "jacobian", "hessian", "no_grad",
           "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "run_backward", "dispatch_mode", "set_dispatch_mode",
           "backward_dispatch_mode", "dispatch_queue", "tape"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `tensors` (seeded by `grad_tensors`,
    ones for a scalar) into the leaves' ``.grad``."""
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    run_backward(list(tensors), grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    touching no leaf's ``.grad``. An input the outputs do not reach
    raises unless ``allow_unused`` (then None). With ``create_graph`` the
    results are differentiable."""
    if isinstance(outputs, Tensor):
        outputs = [outputs]
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    if isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    retain = bool(retain_graph) if retain_graph is not None else create_graph
    results = run_backward(list(outputs), grad_outputs, retain_graph=retain,
                           grad_targets=list(inputs),
                           create_graph=create_graph,
                           accumulate_leaf_grads=False)
    out = []
    for i, r in enumerate(results):
        if r is None:
            if not allow_unused:
                raise RuntimeError(
                    f"input {i} is unreachable from outputs "
                    "(pass allow_unused=True to return None)")
            out.append(None)
        else:
            out.append(Tensor._wrap(r if create_graph else r.detach()))
    return out


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved

    saved_tensors = property(lambda self: self._saved)


class PyLayerMeta(type):
    pass


class _Slot:
    """Where the i-th Tensor argument of a PyLayer call sits."""
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _take_tensors(obj, found):
    if isinstance(obj, Tensor):
        found.append(obj)
        return _Slot(len(found) - 1)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_take_tensors(o, found) for o in obj)
    return obj


def _put_tensors(obj, datas):
    if isinstance(obj, _Slot):
        return Tensor._wrap(datas[obj.i])
    if isinstance(obj, (list, tuple)):
        return type(obj)(_put_tensors(o, datas) for o in obj)
    return obj


class _PyLayerFunction(torch.autograd.Function):
    """The torch Function every PyLayer call runs through: its forward
    calls the layer's forward on Tensors around the inputs, its
    backward the layer's backward on Tensors around the cotangents."""

    @staticmethod
    def forward(fctx, layer, ctx, spec, *datas):
        args, kwargs = _put_tensors(spec, datas)
        out = layer.forward(ctx, *args, **kwargs)
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        fctx.layer, fctx.pyctx, fctx.n_in = layer, ctx, len(datas)
        fctx.set_materialize_grads(ctx.materialize_grads)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(fctx, *grads):
        gin = [None if g is None else Tensor._wrap(g) for g in grads]
        res = fctx.layer.backward(fctx.pyctx, *gin)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        res = list(res) + [None] * (fctx.n_in - len(res))
        return (None, None, None) + tuple(
            r._data if isinstance(r, Tensor) else r for r in res)


class PyLayer(metaclass=PyLayerMeta):
    """Custom autograd function (ref: python/paddle/autograd/py_layer.py).

    class Exp(PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = paddle.exp(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * y

    forward runs unrecorded; backward returns one gradient (or None) per
    Tensor argument, in order."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        found = []
        spec = _take_tensors((args, kwargs.items()), found)
        spec = (spec[0], dict(spec[1]))
        outs = _PyLayerFunction.apply(cls, PyLayerContext(), spec,
                                      *(t._data for t in found))
        wrapped = [Tensor._wrap(o) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else tuple(wrapped)


class Jacobian:
    """Materialized Jacobian of `ys` with respect to `xs`: shape (M, N)
    for batch_axis=None (M = ys.numel, N = xs.numel) or (B, M, N) for
    batch_axis=0. Indexable like a Tensor; `.tensor` is the Tensor."""

    def __init__(self, tensor):
        self._t = tensor

    @property
    def tensor(self):
        return self._t

    @property
    def shape(self):
        return self._t.shape

    def __getitem__(self, idx):
        return self._t[idx]

    def numpy(self):
        return self._t.numpy()

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._t.numpy())
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return f"Jacobian(shape={self.shape})"


class Hessian(Jacobian):
    def __repr__(self):
        return f"Hessian(shape={self.shape})"


def _one_hot_seed(y, flat_idx, batch_axis):
    d = y._data
    if batch_axis is None:
        seed = torch.zeros(d.numel(), dtype=d.dtype, device=d.device)
        seed[flat_idx] = 1
    else:
        seed = torch.zeros(d.shape[0], d[0].numel(), dtype=d.dtype,
                           device=d.device)
        seed[:, flat_idx] = 1
    return Tensor._wrap(seed.reshape(d.shape), stop_gradient=True)


def _jacobian_single(y, x, batch_axis, create_graph):
    from ..ops import stack, zeros_like
    yshape, xshape = tuple(y._data.shape), tuple(x._data.shape)
    if batch_axis not in (None, 0):
        raise ValueError("batch_axis must be None or 0")
    if batch_axis is None:
        m = int(np.prod(yshape)) if yshape else 1
        row_shape = [int(np.prod(xshape)) if xshape else 1]
    else:
        m = int(np.prod(yshape[1:])) if len(yshape) > 1 else 1
        row_shape = [xshape[0],
                     int(np.prod(xshape[1:])) if len(xshape) > 1 else 1]
    rows = []
    for i in range(m):
        (gx,) = grad([y], [x], grad_outputs=[_one_hot_seed(y, i, batch_axis)],
                     retain_graph=True, create_graph=create_graph,
                     allow_unused=True)
        if gx is None:
            gx = zeros_like(x.detach())
        rows.append(gx.reshape(row_shape))
    return Jacobian(stack(rows, axis=0 if batch_axis is None else 1))


def jacobian(ys, xs, batch_axis=None, create_graph=False):
    """Jacobian of ys with respect to xs: a Jacobian (one xs) or a tuple
    of them (one per xs). create_graph=True to differentiate through
    it."""
    single_x = isinstance(xs, Tensor)
    xs_list = [xs] if single_x else list(xs)
    if not isinstance(ys, Tensor):
        raise TypeError("jacobian currently supports a single ys Tensor")
    jacs = [_jacobian_single(ys, x, batch_axis, create_graph)
            for x in xs_list]
    return jacs[0] if single_x else tuple(jacs)


def hessian(ys, xs, batch_axis=None):
    """Hessian of a scalar ys (per sample with batch_axis=0: shape (B,)
    or (B, 1)) with respect to xs, by a double backward."""
    single_x = isinstance(xs, Tensor)
    xs_list = [xs] if single_x else list(xs)
    yshape = tuple(ys._data.shape)
    if batch_axis is None:
        if ys.size != 1:
            raise ValueError("hessian requires scalar ys when batch_axis=None")
        seeds = None
    else:
        if len(yshape) > 2 or (len(yshape) == 2 and yshape[1] != 1):
            raise ValueError(
                "hessian with batch_axis=0 requires per-sample scalar ys "
                f"of shape (B,) or (B, 1); got {yshape}")
        seeds = [Tensor._wrap(torch.ones_like(ys._data), stop_gradient=True)]
    g = grad([ys], xs_list, grad_outputs=seeds, create_graph=True,
             allow_unused=True)
    out = []
    for gx, x in zip(g, xs_list):
        xshape = tuple(x._data.shape)
        if gx is None or not gx._data.requires_grad:
            if batch_axis is None:
                n = int(np.prod(xshape)) if xshape else 1
                zshape = (n, n)
            else:
                n = int(np.prod(xshape[1:])) if len(xshape) > 1 else 1
                zshape = (xshape[0], n, n)
            out.append(Hessian(Tensor._wrap(
                torch.zeros(zshape, dtype=x._data.dtype,
                            device=x._data.device), stop_gradient=True)))
            continue
        jac = _jacobian_single(gx, x, batch_axis, create_graph=False)
        out.append(Hessian(jac.tensor))
    return out[0] if single_x else tuple(out)
