"""Deterministic fault injection for chaos testing (counterpart of
paddle_tpu/resilience/faults.py, whose names, fault points and
semantics it keeps; the port's own copy, so that the package imports
nothing of paddle_tpu).

Every resilience path is wired through named **fault points**, so
tests (and operators) can inject failures deterministically:

    from paddle_tpu_torch.resilience import faults

    with faults.inject("engine.decode.seq", exc=MemoryError("chaos"),
                       match={"rid": "bad"}):
        engine.generate(...)     # request "bad" fails, others finish

A fault point is a single call at an instrumented site::

    faults.fault_point("engine.step")

and costs one truthiness check on a module-level dict when nothing is
injected: cheap enough to leave in production paths.

Registered fault points (grep `fault_point(` for ground truth):

    engine.prefill.seq        per-sequence, before the packed prefill
                              wave is launched (ctx: rid)
    engine.decode.seq         per-sequence, before the decode chunk is
                              launched (ctx: rid)
    engine.verify.seq         per-sequence, before the speculative
                              verify wave is launched (ctx: rid)
    engine.step               once per LLMEngine.step() (ctx: none)

The reference's other points (checkpoint.*, framework_io.*, io.*,
supervisor.act, disagg.migrate) sit in modules the port does not have
yet; arming one is allowed and fires nothing until its site exists.

Injection specs support:

    exc=...         exception instance or class to raise
    delay=...       seconds to sleep before continuing (composable with
                    exc: sleep then raise)
    exit_code=N     call os._exit(N) — simulates a hard crash /
                    SIGKILL'd process (no exception propagates, no
                    cleanup runs).
    times=N         fire at most N times (None = every hit)
    match={k: v}    fire only when the fault point's context kwargs
                    contain all given key/values (picklable: crosses
                    a spawn boundary)
    when=callable   fire only when `when(ctx_dict)` is truthy (not
                    picklable; in-process use only)

`inject` doubles as a context manager that removes the spec on exit;
called plainly it stays active until `clear(name)` / `clear_all()`.
A spawned process receives a `snapshot()` of the picklable specs and
`install()`s it."""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

__all__ = ["inject", "clear", "clear_all", "fault_point", "fired",
           "snapshot", "install", "set_on_fire", "FaultSpec"]


# reentrant: fault_point() evaluates user `when=` predicates under the
# lock, and a predicate may legitimately call back into this module
# (e.g. when=lambda ctx: faults.fired("other.point") > 0)
_LOCK = threading.RLock()
# name -> FaultSpec; module-level dict so fault_point's disarmed path is
# one truthiness check
_ACTIVE: Dict[str, "FaultSpec"] = {}
_FIRED: Dict[str, int] = {}
# observer called as cb(name, ctx) right after a fault fires, BEFORE
# its effect (delay/exit/raise), so a recorder sees the pre-crash
# state even for exit_code faults. Survives
# clear_all(): the observer belongs to whoever installed it, not to
# the armed specs.
_ON_FIRE = None


class FaultSpec:
    """One armed fault. Attribute bag + remaining-fire accounting."""

    __slots__ = ("name", "exc", "delay", "exit_code", "times", "match",
                 "when")

    def __init__(self, name, exc=None, delay=None, exit_code=None,
                 times=None, match=None, when=None):
        if exc is None and delay is None and exit_code is None:
            raise ValueError(
                f"fault {name!r}: give at least one of exc=, delay=, "
                "exit_code=")
        self.name = name
        self.exc = exc
        self.delay = delay
        self.exit_code = exit_code
        self.times = times
        self.match = dict(match) if match else None
        self.when = when

    def _matches(self, ctx: dict) -> bool:
        if self.match is not None:
            for k, v in self.match.items():
                if ctx.get(k) != v:
                    return False
        if self.when is not None and not self.when(ctx):
            return False
        return True

    def _picklable(self) -> bool:
        # `when` callables don't cross a spawn boundary; exceptions
        # and match dicts do
        return self.when is None

    def __getstate__(self):
        return {s: getattr(self, s) for s in self.__slots__}

    def __setstate__(self, state):
        for s in self.__slots__:
            setattr(self, s, state.get(s))


class _Injection:
    """Handle returned by inject(): context manager + .remove()."""

    def __init__(self, name):
        self._name = name

    def remove(self):
        clear(self._name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove()
        return False


def inject(name: str, exc=None, delay: Optional[float] = None,
           exit_code: Optional[int] = None, times: Optional[int] = None,
           match: Optional[dict] = None, when=None) -> _Injection:
    """Arm fault point `name`. See module docstring for the spec
    semantics. Returns a handle usable as a context manager."""
    spec = FaultSpec(name, exc=exc, delay=delay, exit_code=exit_code,
                     times=times, match=match, when=when)
    with _LOCK:
        _ACTIVE[name] = spec
    return _Injection(name)


def clear(name: str) -> None:
    with _LOCK:
        _ACTIVE.pop(name, None)


def clear_all() -> None:
    with _LOCK:
        _ACTIVE.clear()
        _FIRED.clear()


def fired(name: str) -> int:
    """How many times fault `name` has fired in this process."""
    with _LOCK:
        return _FIRED.get(name, 0)


def fault_point(name: str, **ctx) -> None:
    """Instrumented-site hook. No-op (one dict truthiness check) unless
    a matching fault is armed."""
    if not _ACTIVE:
        return
    with _LOCK:
        spec = _ACTIVE.get(name)
        if spec is None or not spec._matches(ctx):
            return
        if spec.times is not None:
            spec.times -= 1
            if spec.times <= 0:
                _ACTIVE.pop(name, None)
        _FIRED[name] = _FIRED.get(name, 0) + 1
    if _ON_FIRE is not None:
        try:
            _ON_FIRE(name, ctx)
        except Exception:
            pass        # an observer must never mask the fault itself
    if spec.delay:
        time.sleep(spec.delay)
    if spec.exit_code is not None:
        import os
        os._exit(spec.exit_code)
    if spec.exc is not None:
        exc = spec.exc() if isinstance(spec.exc, type) else spec.exc
        raise exc


def set_on_fire(cb) -> None:
    """Install (or with None, remove) the fire observer: cb(name,
    ctx) runs after a spec fires and before its effect. One
    observer."""
    global _ON_FIRE
    _ON_FIRE = cb


def snapshot() -> list:
    """Picklable list of the currently armed specs — ship this across
    a spawn boundary and `install()` it in the child."""
    with _LOCK:
        return [s for s in _ACTIVE.values() if s._picklable()]


def install(specs) -> None:
    """Arm a snapshot()'d spec list in this (child) process."""
    if not specs:
        return
    with _LOCK:
        for s in specs:
            _ACTIVE[s.name] = s
