"""Static-graph facade (counterpart of paddle_tpu/static/__init__.py,
after python/paddle/static/).

As in the reference, the "static graph" is a traced program, not a
ProgramDesc: `Program` and `program_guard` are parity objects, `data`
makes an `InputSpec`, and `Executor.run` calls a Python callable (a
function or a layer) with its feed, eagerly, on the device of what it is
fed. `gradients` is `autograd.grad`. Where the reference raises, the
port's inference-model pair goes through its own `jit.save` / `jit.load`
(a ``torch.export`` program, reloadable without the model class):
`save_inference_model` exports the layer given as `program` with
`feed_vars` as its input spec, and `load_inference_model` returns
``[program, feed_target_names, fetch_targets]``, a program that
`Executor.run` takes with a feed keyed by those names. `nn` holds the
control-flow sugar (`cond`, `while_loop`, `case`, `switch_case`)."""
from __future__ import annotations

import contextlib
import json
from typing import List, Optional

from ..jit import InputSpec  # noqa: F401

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "data", "Executor", "gradients",
           "save_inference_model", "load_inference_model", "name_scope",
           "InputSpec", "nn"]

_static_mode = False


def _enable_static_mode():
    global _static_mode
    _static_mode = True


def _disable_static_mode():
    global _static_mode
    _static_mode = False


def _in_static_mode():
    return _static_mode


class Program:
    """A deferred computation: a parity object for Executor-style code
    (the reference's :27-41)."""

    def __init__(self):
        self._build_fns = []
        self.random_seed = 0

    def global_block(self):
        return self

    def clone(self, for_test=False):
        import copy
        return copy.copy(self)


_default_main = Program()
_default_startup = Program()


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


class program_guard:
    def __init__(self, main_program, startup_program=None):
        self.main = main_program

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def data(name, shape, dtype="float32", lod_level=0):
    return InputSpec(shape, dtype, name)


class _InferenceProgram:
    """A loaded inference model as `Executor.run` takes it: called with
    the feed keyed by its feed names, in their order."""

    def __init__(self, layer, feed_names):
        self.layer = layer
        self.feed_names = list(feed_names)

    def __call__(self, **feed):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise KeyError(f"the feed lacks {missing}")
        return self.layer(*[feed[n] for n in self.feed_names])


class Executor:
    """(ref: python/paddle/base/executor.py:1151) — run() calls a Python
    callable (a function, a layer, or a loaded inference program) with
    its feed and returns its outputs as a list."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kw):
        if callable(program):
            out = program(**(feed or {}))
            return list(out) if isinstance(out, (list, tuple)) else [out]
        raise NotImplementedError(
            "paddle_tpu_torch.static.Executor runs callables; build "
            "models with paddle_tpu_torch.jit.to_static instead of "
            "Program IR")


def gradients(targets, inputs, target_gradients=None):
    from ..autograd import grad
    return grad(targets, inputs, grad_outputs=target_gradients,
                allow_unused=True)


def _feed_path(path_prefix):
    return path_prefix + ".pdfeed"


def save_inference_model(path_prefix, feed_vars, fetch_vars=None,
                         executor=None, program=None, **kw):
    """Export `program` (the layer whose forward maps the feed to the
    fetches) with `feed_vars` (`static.data` specs) as its input spec,
    through `jit.save` (the reference raises here). The feed names go
    beside it in ``<path_prefix>.pdfeed``; the fetches are the forward's
    outputs, so `fetch_vars` is not read."""
    from .. import jit as _jit
    if program is None or not callable(program):
        raise ValueError("save_inference_model needs program=<the layer "
                         "to export>: the port has no Program IR")
    specs = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    _jit.save(program, path_prefix, input_spec=specs)
    names = [s.name or f"feed_{i}" for i, s in enumerate(specs)]
    with open(_feed_path(path_prefix), "w") as f:
        json.dump(names, f)


def load_inference_model(path_prefix, executor=None, **kw):
    """[program, feed_target_names, fetch_targets] of a model saved by
    `save_inference_model`: the program is the `jit.load`ed layer,
    which `Executor.run(program, feed={name: value})` calls; the fetch
    targets are its outputs (an empty list: everything it returns)."""
    from .. import jit as _jit
    layer = _jit.load(path_prefix, **kw)
    with open(_feed_path(path_prefix)) as f:
        names = json.load(f)
    return [_InferenceProgram(layer, names), names, []]


def name_scope(prefix=None):
    return contextlib.nullcontext()


# control-flow sugar (ref: python/paddle/static/nn/control_flow.py)
from . import nn  # noqa: E402,F401
