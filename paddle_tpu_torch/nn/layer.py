"""nn.Layer, Parameter and HookRemoveHelper (counterpart of
paddle_tpu/nn/layer.py:21-363).

One storage serves two kinds of caller. ``Layer`` subclasses
``torch.nn.Module``: torch's ``_parameters`` holds each
``torch.nn.Parameter`` and ``_buffers`` each buffer, so torch's own
machinery (``Module.parameters()``, ``state_dict()`` from a torch
parent, ``load_state_dict``, ``to``, autograd, CUDA graphs, the
multi-tensor update) sees plain torch tensors at fixed addresses. The
eager API sees the reference's objects: ``layer.weight`` is a
``Parameter``, a ``Tensor`` whose ``_data`` *is* that
``torch.nn.Parameter`` (made once per name and kept while the layer
holds the same tensor), and a buffer read by attribute is a ``Tensor``
over the buffer. The paddle-named methods whose meaning differs from
torch's return those wrappers: ``parameters``, ``named_parameters``,
``buffers``, ``named_buffers``, ``state_dict`` (when called as the
reference calls it), ``register_buffer``; ``to`` takes the reference's
arguments. ``set_state_dict`` writes each value into the storage in
place, as ``set_value`` does, so nothing is rebound.

The port's layers (``nn/layers/``) read their torch parameters in
``forward`` (``self._parameters["weight"]``), so a torch input runs
through the registered ops untouched and returns torch tensors, and a
``Tensor`` input is dispatched as a ``Tensor``. The port's torch-level
code (the models, the engine, ``TrainStep``) calls torch's methods
(``nn.Module.parameters(model)``) and reads ``layer.weight._data``.

Write a parameter with ``set_value`` (as the optimizers and
``set_state_dict`` do): an in-place method such as ``scale_`` rebinds
the ``Parameter`` to a new tensor, as the reference's rebinds its
array, and the layer keeps reading its own storage.

Defaults are the reference's: ``create_parameter`` draws XavierUniform
(a bias: Constant(0)) in the layer's dtype, on the default place
(``set_device``; the card unless the CPU was asked for) or the given
``device``, from the port's default generator (``core/generator.py``,
reseeded by ``seed``) or the given ``torch.Generator``. JAX's pytree
registration of ``Parameter`` (layer.py:42-46) is JAX's own and is not
ported.
"""
from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..core import dtype as dtypes
from ..core.device import Place, default_torch_device, resolve_device
from ..core.generator import torch_generator
from ..core.tensor import Tensor, _init

__all__ = ["Parameter", "HookRemoveHelper", "Layer"]


class Parameter(Tensor):
    """A trainable Tensor (``stop_gradient=False`` by default,
    ``persistable=True``) over a ``torch.nn.Parameter``."""

    __slots__ = ()

    def __init__(self, data, dtype=None, name=None, trainable=True):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable,
                         name=name)
        self.persistable = True
        d = self._data
        self._data = nn.Parameter(d, requires_grad=d.requires_grad)

    @classmethod
    def _of(cls, p: torch.Tensor, name=None) -> "Parameter":
        """The Parameter over `p` (a torch.nn.Parameter) itself: no
        copy, its requires_grad as it is."""
        t = cls.__new__(cls)
        _init(t, p, not p.requires_grad, name)
        t.persistable = True
        return t

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v):
        self.stop_gradient = not v

    def __deepcopy__(self, memo):
        # the torch parameter through the memo: a deep-copied layer's
        # Parameter wraps that layer's copy of it
        t = Parameter._of(copy.deepcopy(self._data, memo), name=self.name)
        t._sg = self._sg
        memo[id(self)] = t
        return t

    def __repr__(self):
        return "Parameter " + super().__repr__()


class HookRemoveHelper:
    def __init__(self, hooks, hid):
        self._hooks, self._hid = hooks, hid

    def remove(self):
        self._hooks.pop(self._hid, None)


def layer_device(device=None) -> torch.device:
    """The torch device a layer's parameters are made on: the default
    place when `device` is None (the card, raising without one, unless
    ``set_device`` chose the CPU), else `device` (a Place, "gpu:N",
    "cuda:N", "cpu", "meta" or a torch.device)."""
    if device is None:
        return default_torch_device()
    if isinstance(device, Place):
        return device.torch_device()
    dev = torch.device(str(device).replace("gpu", "cuda"))
    return dev if dev.type == "meta" else resolve_device(dev)


def _wrapper(module: nn.Module, name: str, t, param: bool):
    """The Parameter (or, for a buffer, the Tensor) over `module`'s
    torch tensor `t` named `name`, kept in the module's ``__dict__``
    while the module holds the same tensor."""
    if t is None:
        return None
    cache = module.__dict__.get("_wrappers")
    if cache is None:
        cache = module.__dict__["_wrappers"] = {}
    w = cache.get(name)
    if w is None or w._data is not t:
        if param:
            w = Parameter._of(t)
        else:
            w = Tensor.__new__(Tensor)
            _init(w, t, not t.requires_grad, None)
        cache[name] = w
    return w


def _join(prefix, name):
    return f"{prefix}.{name}" if prefix else name


# One walk per iterator, over any torch module (a Layer, or a plain
# nn.Module a Layer holds, whose tensors are wrapped the same way).
def _named_children(module):
    return ((n, m) for n, m in module._modules.items() if m is not None)


def _named_parameters(module, prefix, include_sublayers=True):
    """A parameter a module holds twice is given once for that module,
    as in the reference."""
    seen = set()
    for name, p in module._parameters.items():
        if p is not None and id(p) not in seen:
            seen.add(id(p))
            yield _join(prefix, name), _wrapper(module, name, p, True)
    if include_sublayers:
        for lname, child in _named_children(module):
            yield from _named_parameters(child, _join(prefix, lname))


def _named_buffers(module, prefix, include_sublayers=True,
                   persistable_only=False):
    skip = module._non_persistent_buffers_set if persistable_only else ()
    for name, b in module._buffers.items():
        if b is not None and name not in skip:
            yield _join(prefix, name), _wrapper(module, name, b, False)
    if include_sublayers:
        for lname, child in _named_children(module):
            yield from _named_buffers(child, _join(prefix, lname), True,
                                      persistable_only)


def _named_sublayers(module, prefix):
    yield prefix, module
    for name, child in _named_children(module):
        yield from _named_sublayers(child, _join(prefix, name))


class Layer(nn.Module):
    """The base of every layer (reference layer.py:58): parameters,
    sublayers and buffers registered by attribute, state_dict with the
    persistable buffers, train/eval, forward pre/post hooks, to/astype.
    The module docstring says how it shares its storage with torch."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes._name(dtypes.to_dtype(dtype or "float32"))
        self._name_scope = name_scope or type(self).__name__.lower()

    # ------------- registration -------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            if self.__dict__.get("_parameters") is None:
                raise RuntimeError(
                    "call super().__init__() before assigning parameters")
            if not isinstance(value._data, nn.Parameter):
                value._data = nn.Parameter(
                    value._data.detach(),
                    requires_grad=value._data.requires_grad)
            super().__setattr__(name, value._data)
            self.__dict__.setdefault("_wrappers", {})[name] = value
            return
        if isinstance(value, Tensor):
            buffers = self.__dict__.get("_buffers")
            if buffers is not None and name in buffers:
                buffers[name] = value._data
                self.__dict__.setdefault("_wrappers", {})[name] = value
                return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        d = self.__dict__
        params = d.get("_parameters")
        if params is not None and name in params:
            return _wrapper(self, name, params[name], True)
        buffers = d.get("_buffers")
        if buffers is not None and name in buffers:
            return _wrapper(self, name, buffers[name], False)
        return super().__getattr__(name)

    def __delattr__(self, name):
        self.__dict__.get("_wrappers", {}).pop(name, None)
        super().__delattr__(name)

    def add_parameter(self, name, parameter):
        if parameter is None:
            self.register_parameter(name, None)
            return None
        if not isinstance(parameter, Parameter):
            parameter = Parameter(parameter)
        setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        """`tensor`: a Tensor (kept as this buffer's Tensor) or a torch
        tensor; non-persistable buffers stay out of ``state_dict``."""
        data = tensor._data if isinstance(tensor, Tensor) else tensor
        nn.Module.register_buffer(self, name, data, persistent=persistable)
        if isinstance(tensor, Tensor):
            self.__dict__.setdefault("_wrappers", {})[name] = tensor
        return tensor

    def create_parameter(self, shape, dtype=None, attr=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None):
        """A Parameter of `shape` in `dtype` (default: the layer's),
        drawn by `attr`'s initializer (a ParamAttr's, or `attr` itself
        when it is callable), else `default_initializer`, else
        XavierUniform (Constant(0) when `is_bias`); named by a
        ParamAttr's `name`. Made on `device` (``layer_device``), drawn
        from `generator` (None: the port's default generator there)."""
        from .initializer import Constant, XavierUniform
        from .param_attr import ParamAttr
        init = name = None
        if attr is not None and attr is not False:
            if isinstance(attr, ParamAttr):
                init, name = attr.initializer, attr.name
            elif callable(attr):
                init = attr
        if init is None:
            init = default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        shape = tuple(int(s) for s in shape)
        dt = dtypes.to_dtype(dtype or self._dtype)
        dev = layer_device(device)
        if dev.type == "meta":      # shapes only: nothing to draw
            data = torch.empty(shape, dtype=dt, device=dev)
        else:
            data = init(shape, dt, device=dev, generator=generator
                        if generator is not None else torch_generator(dev))
        return Parameter._of(nn.Parameter(data, requires_grad=(
            data.is_floating_point() or data.is_complex())), name=name)

    def create_tensor(self, dtype=None, name=None):
        return Tensor._wrap(torch.zeros(
            (), dtype=dtypes.to_dtype(dtype or self._dtype),
            device=default_torch_device()), name=name)

    # ------------- iteration -------------
    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        """(structured name, Parameter) pairs, the layer's own first,
        then each sublayer's; a parameter a layer holds twice is given
        once for that layer, as in the reference. `recurse` /
        `remove_duplicate` are torch's: ``nn.Module.parameters(layer)``
        passes them, and gets torch's pairs."""
        if recurse is not None:
            return nn.Module.named_parameters(
                self, prefix, recurse=recurse,
                remove_duplicate=remove_duplicate)
        return _named_parameters(self, prefix, include_sublayers)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True, *,
                      recurse=None, remove_duplicate=True):
        """(structured name, Tensor) pairs of every buffer, persistable
        or not; `recurse` / `remove_duplicate` as in
        ``named_parameters``."""
        if recurse is not None:
            return nn.Module.named_buffers(
                self, prefix, recurse=recurse,
                remove_duplicate=remove_duplicate)
        return _named_buffers(self, prefix, include_sublayers)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def children(self):
        for _, layer in self.named_children():
            yield layer

    def named_children(self):
        return _named_children(self)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        walk = _named_sublayers(self, prefix)
        if not include_self:
            next(walk)
        yield from walk

    # ------------- state dict -------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """The parameters (as Parameters) and the persistable buffers
        (as Tensors) by structured name, over the layer's own storage.
        As in the reference, `include_sublayers` and `use_hook` are
        taken and not read. `prefix` / `keep_vars` are torch's: a torch
        parent's ``state_dict`` recursing into this layer passes them,
        and gets torch's entries."""
        if prefix is not None:
            return nn.Module.state_dict(self, destination=destination,
                                        prefix=prefix, keep_vars=keep_vars)
        dest = OrderedDict() if destination is None else destination
        pre = structured_name_prefix.rstrip(".")
        for n, p in _named_parameters(self, pre):
            dest[n] = p
        for n, b in _named_buffers(self, pre, persistable_only=True):
            dest[n] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Write each value (a Tensor, a torch tensor or an array) into
        the parameter or buffer of its name, in place, cast to its dtype
        and reshaped to its shape; returns (missing, unexpected) keys.
        `use_structured_name` is taken and not read, as in the
        reference."""
        own = self.state_dict()
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                tgt = own.get(k)
                if tgt is None:
                    unexpected.append(k)
                    continue
                d = tgt._data
                if isinstance(v, Tensor):
                    v = v._data
                elif not isinstance(v, torch.Tensor):
                    v = Tensor(np.asarray(v), place=d.device)._data
                d.copy_(v.reshape(d.shape))
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ------------- hooks -------------
    def register_forward_pre_hook(self, hook):
        """`hook(layer, inputs)`: a returned value (a tuple, or one
        value) replaces the inputs. Removable through the helper."""
        h = nn.Module.register_forward_pre_hook(self, hook)
        return HookRemoveHelper(self._forward_pre_hooks, h.id)

    def register_forward_post_hook(self, hook):
        """`hook(layer, inputs, output)`: a returned value replaces the
        output. Removable through the helper."""
        h = nn.Module.register_forward_hook(self, hook)
        return HookRemoveHelper(self._forward_hooks, h.id)

    # ------------- dtype / device movement -------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move the parameters and buffers to `device` and cast the
        floating ones to `dtype` (either may be None; a dtype may come
        first, as torch's ``Module.to(dtype)`` takes it). The
        ``torch.nn.Parameter`` objects stay; their storage is replaced,
        as the reference rebinds its arrays."""
        if dtype is None and device is not None and (
                isinstance(device, torch.dtype)
                or str(device) in dtypes._BY_NAME):
            device, dtype = None, device
        kw = {}
        if device is not None:
            kw["device"] = layer_device(device)
        if dtype is not None:
            kw["dtype"] = dtypes.to_dtype(dtype)
            self._dtype = dtypes._name(kw["dtype"])
        if kw:
            nn.Module.to(self, **kw)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def half(self):
        return self.to(dtype="float16")

    def full_name(self):
        return self._name_scope

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, child in self.named_children():
            child_repr = repr(child).replace("\n", "\n  ")
            lines.append(f"  ({name}): {child_repr}")
        main = f"{type(self).__name__}({self.extra_repr()}"
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

