"""Eager Tensor (counterpart of paddle_tpu/core/tensor.py).

The reference's ``Tensor`` wraps a ``jax.Array`` and keeps its own
autograd meta (a grad node, hooks, the grad). The port's wraps a
``torch.Tensor`` in ``_data`` and leaves the autograd meta to
torch.autograd: ``stop_gradient`` is ``not _data.requires_grad`` for a
float tensor (the default is True), ``grad`` is ``_data.grad`` as a
Tensor (or None), ``clear_grad()`` sets it to None, ``register_hook``
and ``retain_grads`` are torch's. It does not subclass ``torch.Tensor``:
paddle's ``reshape``, ``transpose``, ``sum(axis=)``, ``shape`` and
``grad`` differ from torch's in signature and meaning.

Dtypes follow the reference as it runs, without JAX's x64: a 64-bit
integer, float or complex becomes its 32-bit type, so
``to_tensor(np.array([1, 2]))`` is int32 and a float64 array float32.
The ops keep that rule for their outputs (``ops/registry.py``).

The reference's in-place methods rebind ``_data`` to a new array; the
port's do too (``ops/__init__.py``), so they never write into storage
that autograd saved or into a leaf that requires a grad. A leaf that is
rebound keeps its grad: ``grad`` reads the leaf the tensor started as
(``_leaf``), where backward accumulates it, as the reference's tape
does. ``set_value``/``copy_`` write into the storage in place without
recording (the optimizer's and a loader's path), so a tensor's address
stays fixed for the multi-tensor update and CUDA graphs.

Most math and manipulation methods are patched on by
``paddle_tpu_torch.ops``, as the reference patches them.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from . import dtype as dtypes
from .device import (Place, _parse, default_torch_device, get_place,
                     place_of)

__all__ = ["Tensor", "to_tensor"]

_name_counter = itertools.count()

# the reference's dtypes without x64: 64-bit types become 32-bit ones
NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
          torch.complex128: torch.complex64}
_NP_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
              np.dtype(np.float64): np.float32,
              np.dtype(np.complex128): np.complex64}


def _diffable(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class Tensor:
    __slots__ = ("_data", "_sg", "_leaf", "persistable", "name",
                 "__weakref__")

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name: Optional[str] = None):
        if isinstance(data, Tensor):
            data = data._data.detach()
        if isinstance(data, torch.Tensor):
            dev = data.device if place is None else _parse(
                place).torch_device()
            # a copy, as paddle.to_tensor makes: the optimizer steps a
            # Tensor's storage in place
            data = data.detach().to(
                dev, NARROW.get(data.dtype, data.dtype) if dtype is None
                else _narrow_dtype(dtype), copy=True)
        else:
            arr = np.asarray(data)
            if dtype is None:
                arr = arr.astype(_NP_NARROW.get(arr.dtype, arr.dtype),
                                 copy=False)
            dev = default_torch_device() if place is None else _parse(
                place).torch_device()
            if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
                # ml_dtypes' bfloat16 (what the reference's numpy() gives)
                data = torch.from_numpy(
                    np.array(arr).view(np.int16)).view(torch.bfloat16).to(
                        dev)
            else:
                data = torch.tensor(arr, device=dev)
            if dtype is not None:
                data = data.to(_narrow_dtype(dtype))
        _init(self, data, stop_gradient, name)

    @staticmethod
    def _wrap(data: torch.Tensor, stop_gradient=None, name=None) -> "Tensor":
        """A Tensor around `data` as it is (no copy, no cast). Its
        stop_gradient is ``not data.requires_grad`` unless given."""
        t = Tensor.__new__(Tensor)
        t._data = data
        t._sg = not data.requires_grad if stop_gradient is None \
            else bool(stop_gradient)
        t._leaf = None
        t.persistable = False
        t.name = name
        return t

    # ---- metadata ----
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    dim = ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def place(self) -> Place:
        return place_of(self._data.device)

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    @property
    def stop_gradient(self) -> bool:
        d = self._data
        if d.requires_grad:
            return False
        return True if _diffable(d) else self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        d = self._data
        value = bool(value)
        if _diffable(d):
            if value and d.requires_grad:
                self._data = d.detach() if d.grad_fn is not None \
                    else d.requires_grad_(False)
            elif not value and not d.requires_grad:
                d.requires_grad_(True)
        self._sg = value

    # ---- grad ----
    def _grad_holder(self) -> torch.Tensor:
        return self._data if self._leaf is None else self._leaf

    @property
    def grad(self):
        h = self._grad_holder()
        if not (h.is_leaf or h.retains_grad):
            return None
        g = h.grad
        return None if g is None else Tensor._wrap(g, stop_gradient=True)

    @grad.setter
    def grad(self, value):
        if value is not None:
            value = value._data if isinstance(value, Tensor) \
                else torch.as_tensor(value, device=self._data.device)
        self._grad_holder().grad = value

    def clear_grad(self, set_to_zero=False):
        """Sets the grad to None (the reference's clear_grad does, with
        or without `set_to_zero`)."""
        self._grad_holder().grad = None

    clear_gradient = clear_grad

    def retain_grads(self):
        if self._data.grad_fn is not None:
            self._data.retain_grad()
        return self

    def backward(self, grad_tensor=None, retain_graph=False):
        from ..autograd import backward
        backward([self], None if grad_tensor is None else [grad_tensor],
                 retain_graph=retain_graph)

    def register_hook(self, hook):
        """`hook(grad: Tensor) -> Tensor | None` runs on the gradient
        reaching this tensor; a returned Tensor replaces it. Returns a
        handle whose ``remove()`` takes the hook off."""
        def torch_hook(g):
            out = hook(Tensor._wrap(g, stop_gradient=True))
            return out._data if isinstance(out, Tensor) else out
        return self._data.register_hook(torch_hook)

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._data.detach(), stop_gradient=True,
                            name=self.name)

    def detach_(self):
        self._data = self._data.detach()
        self._leaf = None
        self._sg = True
        return self

    # ---- interop ----
    def numpy(self):
        """The value as a numpy array; bfloat16 as ml_dtypes' bfloat16,
        as the reference's numpy() gives it."""
        d = self._data.detach()
        # a copy, as the reference's is a snapshot: backward accumulates
        # a grad in place
        h = d.cpu()
        h = h.clone() if h.data_ptr() == d.data_ptr() else h
        if d.dtype == torch.bfloat16:
            import ml_dtypes
            return h.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return h.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        d = self._data
        return (d[args] if args else d).detach().item()

    def tolist(self):
        return self._data.detach().tolist()

    def __float__(self):
        return float(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __bool__(self):
        return bool(self._data.detach())

    def __index__(self):
        return int(self._data)

    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __hash__(self):
        return id(self)

    def __iter__(self):
        if self._data.dim() == 0:
            raise TypeError("iteration over a 0-d tensor")
        for i in range(self._data.shape[0]):
            yield self[i]

    # ---- data management ----
    def _set_data(self, data):
        """Rebind ``_data`` (a torch.Tensor or a Tensor's)."""
        self._data = data._data if isinstance(data, Tensor) else data
        return self

    def set_value(self, value):
        """Write `value` (reshaped to this tensor's shape, cast to its
        dtype) into its storage, unrecorded."""
        if isinstance(value, Tensor):
            value = value._data
        value = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value, device=self._data.device)
        with torch.no_grad():
            self._data.copy_(value.reshape(self._data.shape))
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def get_tensor(self):
        return self

    def clone(self) -> "Tensor":
        from ..ops import assign
        return assign(self)

    def to_sparse_coo(self, sparse_dim=None):
        """The nonzero sites as a SparseCooTensor (row-major); with
        sparse_dim below the rank a hybrid COO: indices over the leading
        sparse_dim dims, values keeping the trailing ones."""
        from ..sparse import _dense_to_coo
        nd = self._data.dim()
        if sparse_dim is not None and not 1 <= int(sparse_dim) <= nd:
            raise ValueError(
                f"to_sparse_coo: sparse_dim must be in [1, {nd}], "
                f"got {sparse_dim}")
        return _dense_to_coo(self._data, sparse_dim)

    def to_sparse_csr(self):
        """A 2-D Tensor as a SparseCsrTensor."""
        from ..sparse import _dense_to_csr
        return _dense_to_csr(self._data)

    def to(self, *args, **kwargs):
        """to(dtype) / to(place or device string) / to(place, dtype),
        recorded: the gradient flows back through a move or a cast."""
        dst_dtype = dst_dev = None
        for a in list(args) + list(kwargs.values()):
            if a is None or isinstance(a, bool):
                continue
            if isinstance(a, torch.dtype) or (
                    isinstance(a, str) and a in dtypes._BY_NAME):
                dst_dtype = _narrow_dtype(a)
            else:
                dst_dev = _parse(a).torch_device()
        out = self._data
        if dst_dev is not None:
            out = out.to(dst_dev)
        if dst_dtype is not None:
            from ..ops import cast
            return cast(Tensor._wrap(out), dst_dtype)
        return self if out is self._data else Tensor._wrap(out)

    def cpu(self):
        return self.to("cpu")

    def cuda(self, device_id=0, blocking=True):
        return self.to(f"gpu:{device_id}")

    def pin_memory(self):
        return self

    def __deepcopy__(self, memo):
        d = self._data.detach().clone().requires_grad_(
            self._data.requires_grad)
        t = Tensor._wrap(d, stop_gradient=self.stop_gradient,
                         name=self.name)
        t.persistable = self.persistable
        memo[id(self)] = t
        return t

    def __reduce__(self):
        # through numpy: the payload is device-neutral and carries no
        # autograd meta, as the reference's pickle (core/tensor.py:312):
        # it unpickles onto the default place of the process that loads
        # it, so a Tensor a CPU-only DataLoader worker made lands on the
        # parent's card. bf16 travels as f32 and is cast back
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return (_rebuild_tensor, (d.cpu().numpy(), str(self._data.dtype),
                                  self.stop_gradient, self.name))

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype="
                f"{dtypes._name(self.dtype)}, place={self.place}"
                f"{grad_info},\n       {self._data.detach()!r})")

    # __getitem__/__setitem__ and the math dunders are patched on in
    # paddle_tpu_torch/ops/__init__.py


def _init(t: Tensor, data: torch.Tensor, stop_gradient, name):
    t._data = data
    t._sg = bool(stop_gradient)
    t._leaf = None
    t.persistable = False
    t.name = name or f"generated_tensor_{next(_name_counter)}"
    if not stop_gradient and _diffable(data):
        data.requires_grad_(True)


def _narrow_dtype(dtype) -> torch.dtype:
    d = dtypes.to_dtype(dtype)
    return NARROW.get(d, d)


def _rebuild_tensor(arr, dtype, stop_gradient, name):
    """Unpickle target of Tensor.__reduce__: the array on the default
    place (which raises without a card until ``set_device("cpu")``)."""
    d = torch.from_numpy(arr).to(getattr(torch, dtype.removeprefix("torch.")))
    return Tensor(d, place=get_place(), stop_gradient=stop_gradient,
                  name=name)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: a new leaf Tensor from numpy data, a Python
    scalar or list, a torch tensor or a Tensor, on `place` (default: the
    default place, which raises without a card until
    ``set_device("cpu")``; a torch tensor or a Tensor stays on its
    device). 64-bit types become 32-bit ones, as in the reference."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
