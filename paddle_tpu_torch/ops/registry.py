"""Op registry and eager dispatch (counterpart of
paddle_tpu/ops/registry.py).

``register_op`` turns a function over torch tensors into an op of the
eager API, as the reference's turns a jnp function into one (:522). The
returned wrapper takes Tensors (and Python scalars, numpy arrays and
lists of Tensors) and returns Tensors. Its dispatch (the reference's
``_dispatch``, :315):

1. takes the function's own signature as the binding: arguments pass
   through in place, so no ``inspect`` binding runs per call;
2. unwraps every Tensor to its torch tensor (numpy arrays become torch
   tensors on the Tensors' device) and checks that all of them lie on
   one device: a CUDA Tensor and a CPU Tensor in one call raise, and no
   data moves;
3. applies the op's AMP policy under ``auto_cast`` through
   ``amp.state.cast_target`` (the reference's ``maybe_cast_inputs``,
   the same lists and rule), the cast recorded so the gradient reaches
   the original tensor; an op that applies its policy itself
   (``amp_in_fn``: the nn ops of ``nn/functional.py``) is not cast
   twice;
4. calls the function, with ``generator`` set to the eager generator of
   the Tensors' device for a random op (``random=True``);
5. wraps each torch output in a Tensor, its ``stop_gradient`` whether
   torch recorded it (grad mode on and a differentiable input requiring
   a grad), 64-bit types narrowed to 32-bit ones as the reference
   computes them without x64;
6. under ``FLAGS_check_nan_inf`` raises ``FloatingPointError`` on a NaN
   or Inf in a float output (:512, the same message).

A call whose arguments hold no Tensor but a torch tensor runs the
function directly and returns what it returns: the port's models, its
engine and ``TrainStep`` call the nn ops that way, with no wrapping and
no second AMP cast.

While a ``profiler.Profiler`` session runs, ``dispatch`` is the
profiled variant, which times each op for the profiler's per-op table.

Gradients come from torch.autograd, never from a registered rule. The
per-signature executable cache (:120-287, ``exec_cache_size``) is
XLA's and is not ported: torch runs each op eagerly.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..amp.state import amp_state, cast_target
from ..core.flags import _REGISTRY as _FLAGS
from ..core.flags import define_flag
from ..core.generator import torch_generator
from ..core.tensor import NARROW, Tensor

__all__ = ["OPS", "OpDef", "register_op", "eager_function", "eager_method",
           "get_op", "dispatch", "dispatch_count"]

define_flag("FLAGS_check_nan_inf", False,
            "post-op NaN/Inf sanitizer: an eager op whose float output "
            "holds a NaN or an Inf raises FloatingPointError")
_NAN_FLAG = _FLAGS["FLAGS_check_nan_inf"]

OPS: Dict[str, "OpDef"] = {}

# eager dispatches since import (phase 22 of chip_smoke.py reads it)
_count = [0]


def dispatch_count() -> int:
    """How many eager dispatches ran in this process."""
    return _count[0]


class OpDef:
    __slots__ = ("name", "fn", "amp_policy", "tags", "amp_in_fn", "random")

    def __init__(self, name, fn, amp_policy=None, tags=(), amp_in_fn=False,
                 random=False):
        self.name = name
        self.fn = fn
        # None (follow the input), 'white', 'black' or 'keep'
        self.amp_policy = amp_policy
        self.tags = tags
        self.amp_in_fn = amp_in_fn
        self.random = random


class _Call:
    """The device and AMP state of one dispatch while it unwraps."""
    __slots__ = ("device", "cast", "opdef", "numpy")

    def __init__(self, opdef, cast):
        self.device = None
        self.cast = cast
        self.opdef = opdef
        self.numpy = False


def _unwrap(a, call: _Call):
    if isinstance(a, Tensor):
        d = a._data
        if call.device is None:
            call.device = d.device
        elif d.device != call.device:
            raise RuntimeError(
                f"op `{call.opdef.name}` got Tensors on {call.device} and "
                f"{d.device}; move them to one device first")
        if call.cast and (d.is_floating_point()):
            target = cast_target(call.opdef.name, call.opdef.amp_policy,
                                 d.dtype)
            if target != d.dtype:
                d = d.to(target)
        return d
    tp = type(a)
    if tp is list or tp is tuple:
        return tp(_unwrap(x, call) for x in a)
    if tp is np.ndarray:
        call.numpy = True
    return a


def _from_numpy(a, device):
    tp = type(a)
    if tp is np.ndarray:
        return Tensor(a, place=device)._data
    if tp is list or tp is tuple:
        return tp(_from_numpy(x, device) for x in a)
    return a


def _wrap(out, name):
    if isinstance(out, torch.Tensor):
        n = NARROW.get(out.dtype)
        if n is not None:
            out = out.to(n)
        if _NAN_FLAG.value and (out.is_floating_point() or out.is_complex()):
            _check_nan_inf(name, out)
        return Tensor._wrap(out)
    tp = type(out)
    if tp is tuple or tp is list:
        return tp(_wrap(o, name) for o in out)
    return out


def _check_nan_inf(op_name, t):
    """FLAGS_check_nan_inf sanitizer (ref: fluid/eager/nan_inf_utils.cc)."""
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(
            f"NaN or Inf detected in output of op `{op_name}`")


def _dispatch(opdef: OpDef, args, kwargs):
    """The eager per-op path (module docstring, steps 2-6)."""
    _count[0] += 1
    st = amp_state()
    call = _Call(opdef, st.enabled and not opdef.amp_in_fn
                 and opdef.amp_policy != "keep")
    args = [_unwrap(a, call) for a in args]
    if kwargs:
        kwargs = {k: _unwrap(v, call) for k, v in kwargs.items()}
    if call.numpy:
        from ..core.device import default_torch_device
        dev = call.device if call.device is not None \
            else default_torch_device()
        args = [_from_numpy(a, dev) for a in args]
        kwargs = {k: _from_numpy(v, dev) for k, v in kwargs.items()}
    if opdef.random and kwargs.get("generator") is None:
        from ..core.device import default_torch_device
        kwargs["generator"] = torch_generator(
            call.device if call.device is not None
            else default_torch_device())
    out = opdef.fn(*args, **kwargs)
    if isinstance(out, torch.Tensor):
        for a in args:
            if a is out:
                # an op that returns its input (dropout off, a real
                # tensor's conj) gives a Tensor of its own: a view, so
                # setting its stop_gradient leaves the input's alone
                out = out.view_as(out)
                break
    return _wrap(out, opdef.name)


def _dispatch_profiled(opdef: OpDef, args, kwargs):
    """The profiling variant of the dispatch (the reference's
    ``_dispatch_profiled``, :288): each call's host time goes to the
    profiler's per-op table (``profiler._record_op``). Under
    ``FLAGS_benchmark`` it waits for the card after the op, so the time
    covers the op's device work. `Profiler.start()` / `stop()` swap the
    module's `dispatch` between this and the plain `_dispatch`
    (`_set_op_profiling`; every wrapper resolves `dispatch` at call
    time), so the path that is not profiled pays nothing."""
    from ..profiler import _BENCHMARK, _record_op
    t0 = time.perf_counter_ns()
    try:
        return _dispatch(opdef, args, kwargs)
    finally:
        if _BENCHMARK.value and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _record_op(opdef.name, t0, False)


dispatch = _dispatch
_PROFILING = False


def _set_op_profiling(on: bool) -> None:
    """Swap the profiled dispatch in (on) or out."""
    global dispatch, _PROFILING
    _PROFILING = on
    dispatch = _dispatch_profiled if on else _dispatch


def _holds_tensor(seq):
    for a in seq:
        if isinstance(a, Tensor):
            return True
        if type(a) in (list, tuple) and _holds_tensor(a):
            return True
    return False


def _holds_torch(seq):
    for a in seq:
        if isinstance(a, torch.Tensor):
            return True
        if type(a) in (list, tuple) and _holds_torch(a):
            return True
    return False


def _torch_level(args, kwargs):
    """True when the call holds no Tensor but a torch tensor among its
    positional arguments (or in a list or tuple of them, as concat's)."""
    if _holds_tensor(args) or (kwargs and _holds_tensor(kwargs.values())):
        return False
    return _holds_torch(args)


def register_op(name: str = None, amp_policy: str = None, tags=(),
                cacheable=True, amp_in_fn=False, random=False):
    """Register a function over torch tensors as an eager op.

    The wrapper dispatches Tensor calls (module docstring) and runs a
    call that holds torch tensors and no Tensor directly. `amp_policy`:
    None (follow the input), 'white', 'black' or 'keep'. `amp_in_fn`:
    the function applies its AMP policy itself. `random`: the function
    takes a ``generator`` keyword, which the dispatch fills with the
    eager generator of the Tensors' device. `cacheable` is the
    reference's executable-cache opt-out, accepted and unused."""

    def deco(fn: Callable):
        op_name = name or fn.__name__
        opdef = OpDef(op_name, fn, amp_policy=amp_policy, tags=tags,
                      amp_in_fn=amp_in_fn, random=random)
        OPS[op_name] = opdef
        return _wrapper(opdef)

    return deco


def _wrapper(opdef: OpDef):
    """The public function of `opdef`: a torch-level call runs its
    function directly, any other is dispatched."""
    fn = opdef.fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _torch_level(args, kwargs):
            return fn(*args, **kwargs)
        return dispatch(opdef, args, kwargs)

    wrapper.op_def = opdef
    wrapper.raw_fn = fn
    return wrapper


def eager_function(random=False):
    """Make a function over torch tensors take Tensors as a registered op
    does, without joining the op table: the composites the reference
    leaves unregistered (the fused attention and feed-forward blocks,
    the serving functionals), whose bodies call registered ops or apply
    their AMP rules themselves. A call that holds Tensors (or numpy
    arrays) is dispatched like an ``amp_in_fn`` op, `random` filling its
    ``generator``; a torch-level call runs the function directly."""

    def deco(fn: Callable):
        return _wrapper(OpDef(fn.__name__, fn, amp_in_fn=True,
                              random=random))

    return deco


def eager_method(fn: Callable):
    """Make a model's ``forward`` (or another entry point over torch
    tensors) take Tensors: a call that holds a Tensor, in its positional
    or keyword arguments or in a list or tuple of them, is dispatched as
    an ``eager_function`` call (Tensors unwrapped, the outputs wrapped,
    no input cast: the body applies AMP itself); any other call, torch
    tensors from the engine or ``TrainStep`` included, runs the function
    directly, with no wrap."""
    opdef = OpDef(fn.__qualname__, fn, amp_in_fn=True)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _holds_tensor(args) or (kwargs and _holds_tensor(
                kwargs.values())):
            return dispatch(opdef, args, kwargs)
        return fn(*args, **kwargs)

    wrapper.raw_fn = fn
    return wrapper


def get_op(name: str) -> OpDef:
    return OPS[name]
