"""Runtime flag registry (counterpart of paddle_tpu/core/flags.py).

Flags are typed, registered as data, and initialised from ``FLAGS_*``
environment variables when they are defined (at import). The port's
copy of the reference's registry. Only the flags whose behaviour the
port has are registered: ``FLAGS_fast_bn_stats`` (read by
``nn.functional.batch_norm``), ``FLAGS_watchdog_timeout_s`` and
``FLAGS_watchdog_abort`` (read by ``utils.watchdog``). Setting one of the reference's other
flags raises "unknown flag" here until the code that acts on it is
ported (ROADMAP.md lists them).

The reference's ``FLAGS_fast_bn_stats`` clears its JAX trace caches when
it changes, since a trace bakes the value in; the port keeps no such
caches: an eager op reads the flag at every call, and a CUDA graph
(``TrainStep``) bakes the value read at its capture, as the reference's
``TrainStep`` bakes the value of its first trace per batch signature.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "flag_value"]


class _Flag:
    __slots__ = ("name", "value", "default", "type", "help")

    def __init__(self, name, default, typ, help_str):
        self.name = name
        self.default = default
        self.value = default
        self.type = typ
        self.help = help_str


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default: Any, help_str: str = ""):
    """Register flag `name` with `default` (its type is the flag's); an
    environment variable of the same name sets its first value."""
    flag = _Flag(name, default, type(default), help_str)
    _REGISTRY[name] = flag
    env = os.environ.get(name)
    if env is not None:
        set_flags({name: env})
    return flag


def _coerce(flag: _Flag, value):
    if flag.type is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return flag.type(value)


def set_flags(flags: Dict[str, Any]):
    """Set each named flag, coerced to its type; an unknown name raises
    ValueError."""
    for name, value in flags.items():
        if name not in _REGISTRY:
            raise ValueError(f"unknown flag {name!r}")
        flag = _REGISTRY[name]
        flag.value = _coerce(flag, value)


def get_flags(flags):
    """{name: value} of a flag name or a list of them; an unknown name
    raises ValueError."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for name in flags:
        if name not in _REGISTRY:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = _REGISTRY[name].value
    return out


def flag_value(name: str):
    return _REGISTRY[name].value


# the reference's flags that the port acts on, with its defaults
define_flag("FLAGS_fast_bn_stats", False,
            "one-pass batch-norm statistics (running-mean pivot): both "
            "sums over the same centered input. Exact for normalized "
            "activations; loses f32 precision only if a channel's |mean| "
            "exceeds ~1e3 x its std while the running mean is still far "
            "from the data (cold start). Default off = exact two-pass "
            "statistics.")
define_flag("FLAGS_watchdog_timeout_s", 0.0,
            "hang watchdog: dump thread stacks when a blocking region "
            "(an engine step's device call) exceeds this many seconds; "
            "0 off")
define_flag("FLAGS_watchdog_abort", False,
            "hang watchdog: os._exit(124) after the dump so a "
            "supervisor restarts the worker")
