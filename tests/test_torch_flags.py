"""paddle_tpu_torch.core.flags against paddle_tpu.core.flags: the flags
the port acts on (FLAGS_fast_bn_stats, utils.watchdog's
FLAGS_watchdog_timeout_s and FLAGS_watchdog_abort, the op registry's
FLAGS_check_nan_inf, core.generator's FLAGS_seed, the profiler's
FLAGS_benchmark and device.memory's FLAGS_allocator_strategy, the last
with a default of its own) with the reference's default and type, what FLAGS_check_nan_inf and FLAGS_seed
do, set / get (one name or a list, strings coerced to the
flag's type), errors for unknown names and for the reference's flags the port
does not act on yet, define_flag, and FLAGS_fast_bn_stats read from the
environment when the flags are defined (in a fresh process, where the
port imports no jax)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.core.flags as jflags
import paddle_tpu_torch as ptt
import paddle_tpu_torch.core.flags as tflags
from torch_port_helpers import cpu_place

ROOT = Path(__file__).resolve().parents[1]
PORTED = ["FLAGS_allocator_strategy", "FLAGS_benchmark",
          "FLAGS_check_nan_inf", "FLAGS_fast_bn_stats", "FLAGS_seed",
          "FLAGS_watchdog_abort", "FLAGS_watchdog_timeout_s"]
# a ported flag whose default is the port's own (device/memory.py says
# why: the reference's "pjrt" names its allocator, the port's is torch's
# caching allocator, Paddle's "auto_growth")
OWN_DEFAULTS = {"FLAGS_allocator_strategy": "auto_growth"}


def test_the_ported_flags_and_defaults():
    import paddle_tpu_torch.device  # noqa: F401 (registers its flag)
    import paddle_tpu_torch.profiler  # noqa: F401 (registers its flag)
    assert sorted(tflags._REGISTRY) == PORTED
    for name in PORTED:
        flag, mine = jflags._REGISTRY[name], tflags._REGISTRY[name]
        want = OWN_DEFAULTS.get(name, flag.default)
        assert (mine.default, mine.type) == (want, flag.type), name
    assert ptt.get_flags is tflags.get_flags
    assert ptt.set_flags is tflags.set_flags


@pytest.mark.parametrize("value,want", [
    ("true", True), ("0", False), (1, True), ("on", True), ("no", False),
    (True, True)])
def test_set_and_get_match_reference(value, want):
    name = "FLAGS_fast_bn_stats"
    saved = (pt.get_flags(name), ptt.get_flags(name))
    try:
        pt.set_flags({name: value})
        ptt.set_flags({name: value})
        assert ptt.get_flags(name) == pt.get_flags(name) == {name: want}
        assert ptt.get_flags([name]) == pt.get_flags([name])
        assert tflags.flag_value(name) == jflags.flag_value(name) == want
    finally:
        pt.set_flags(saved[0])
        ptt.set_flags(saved[1])


def test_unknown_flags_raise_as_in_the_reference():
    for mod in (pt, ptt):
        with pytest.raises(ValueError, match="unknown flag"):
            mod.set_flags({"FLAGS_no_such_flag": 1})
        with pytest.raises(ValueError, match="unknown flag"):
            mod.get_flags("FLAGS_no_such_flag")
        with pytest.raises(ValueError, match="unknown flag"):
            mod.get_flags(["FLAGS_fast_bn_stats", "FLAGS_no_such_flag"])


@pytest.mark.parametrize("name", sorted(set(jflags._REGISTRY) - set(PORTED)))
def test_flags_not_acted_on_yet_raise(name):
    """A reference flag whose behaviour the port lacks is not accepted
    and ignored: setting or reading it raises until it is ported."""
    pt.get_flags(name)
    with pytest.raises(ValueError, match="unknown flag"):
        ptt.set_flags({name: jflags._REGISTRY[name].default})
    with pytest.raises(ValueError, match="unknown flag"):
        ptt.get_flags(name)


def test_define_flag():
    name = "FLAGS_port_test_only"
    try:
        flag = tflags.define_flag(name, 2, "a test flag")
        assert flag.value == 2 and tflags.get_flags(name) == {name: 2}
        tflags.set_flags({name: "5"})
        assert tflags.flag_value(name) == 5
    finally:
        tflags._REGISTRY.pop(name, None)


_ENV = """
import json, sys
import paddle_tpu_torch as ptt
print(json.dumps(ptt.get_flags("FLAGS_fast_bn_stats")))
import paddle_tpu as pt
"""


def _fresh(**env):
    return subprocess.run(
        [sys.executable, "-c", _ENV], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
                 **env))


@pytest.mark.parametrize("value,want", [("on", True), ("0", False)])
def test_fast_bn_stats_from_the_environment(value, want):
    """The port reads FLAGS_fast_bn_stats from the environment. The
    reference cannot (ROADMAP Queue C, known gaps): its flag's on_change
    hook calls _bump_trace_epoch, which core/flags.py defines only after
    the flag, so importing paddle_tpu with the variable set raises
    NameError."""
    out = _fresh(FLAGS_fast_bn_stats=value)
    mine = json.loads(out.stdout.splitlines()[0])
    assert mine == {"FLAGS_fast_bn_stats": want}
    assert out.returncode != 0
    assert "NameError" in out.stderr and "_bump_trace_epoch" in out.stderr


def _nan_case(P, op):
    x = P.to_tensor(np.array([1.0, -1.0, 0.0], np.float32))
    return {"log": lambda: P.log(x), "divide": lambda: x / x,
            "sqrt": lambda: P.sqrt(x)}[op]()


@pytest.mark.parametrize("op", ["log", "divide", "sqrt"])
def test_check_nan_inf_raises_as_in_the_reference(op):
    """Under FLAGS_check_nan_inf an op whose float output holds a NaN or
    an Inf raises FloatingPointError with the reference's message; off,
    it returns the value."""
    with cpu_place():
        _check_nan_inf_case(op)


def _check_nan_inf_case(op):
    for P in (pt, ptt):
        assert np.isnan(_nan_case(P, op).numpy()).any() or \
            np.isinf(_nan_case(P, op).numpy()).any()
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError,
                               match=f"NaN or Inf detected in output of "
                                     f"op `{op}`"):
                _nan_case(P, op)
            finite = P.exp(P.to_tensor(np.zeros(2, np.float32)))
            assert finite.numpy().tolist() == [1.0, 1.0]
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False})


def test_flags_seed_seeds_the_default_generator_at_import():
    """FLAGS_seed from the environment is the default generator's seed
    in a fresh process (the reference only registers the flag)."""
    code = ("import paddle_tpu_torch as P\n"
            "from paddle_tpu_torch.core import generator as G\n"
            "print(G.default_generator().seed(), "
            "P.get_flags('FLAGS_seed')['FLAGS_seed'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT),
                                  FLAGS_seed="17"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["17", "17"]
