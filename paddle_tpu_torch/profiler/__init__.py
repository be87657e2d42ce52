"""Profiler (counterpart of paddle_tpu/profiler/__init__.py; ref:
python/paddle/profiler/profiler.py:346).

Host spans: RecordEvent context managers go into the observability
trace ring (`observability.tracing`), ONE event stream shared with
`observability.span`, so `export_chrome_tracing` here and the
observability exporters write consistent files whichever API recorded
the span. While a session runs, each eager op's dispatch is timed for
the per-op summary (`ops.registry._set_op_profiling`).

Device timeline: on the card a session also runs ``torch.profiler``
with CPU and CUDA activity (CUPTI), where the reference runs
``jax.profiler.start_trace``. At `stop()` the CUDA kernels, copies and
fills it saw are taken from its chrome trace, moved onto the ring's
``time.perf_counter`` clock (an anchor range recorded at `start()`
gives the offset) and kept beside the host spans: `events()` and the
exported trace hold both, each kernel under a ``gpu:<index>`` pid with
its stream as tid. Departure: the reference wraps its device trace in
``try`` and drops it when it fails to start or stop; here a device
trace that fails to start or stop raises, so a session on the card
never silently lacks its device timeline. A session cannot start while
a CUDA graph capture is under way (the profiler's own CUDA calls would
invalidate the capture): `start()` raises then.

``FLAGS_benchmark`` (the reference's flag, default off, "sync after
each op") is registered here: under it a profiled op waits for the card
before its time is taken, so the per-op table covers device time."""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from enum import Enum

from ..core.flags import define_flag
from ..observability import tracing as _tracing

__all__ = ["Profiler", "RecordEvent", "make_scheduler",
           "export_chrome_tracing", "ProfilerTarget", "ProfilerState",
           "load_profiler_result"]

_BENCHMARK = define_flag("FLAGS_benchmark", False,
                         "benchmark mode: sync after each op")

# the kinds of device event a session keeps from torch.profiler's trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_ANCHOR = "paddle_tpu_torch.profiler.anchor"


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


# --- per-op dispatch times: ops.registry._dispatch_profiled reports
# here while a session runs. No chrome-trace event is written per op
# (that would distort the timeline the device trace covers).
_op_stats: dict = {}
_op_stats_lock = threading.Lock()


def _record_op(name: str, t0_ns: int, cached: bool) -> None:
    dur = (time.perf_counter_ns() - t0_ns) / 1e6
    with _op_stats_lock:
        st = _op_stats.get(name)
        if st is None:
            st = _op_stats[name] = [0, 0.0, 0.0, 0]  # calls,total,max,hits
        st[0] += 1
        st[1] += dur
        if dur > st[2]:
            st[2] = dur
        if cached:
            st[3] += 1


class RecordEvent:
    """(ref: paddle.profiler.RecordEvent / C++ platform/profiler/
    event_tracing.h:43)

    Idempotent: a second end() (or __exit__ after an explicit end()) is
    a no-op. Events land in the shared observability trace ring
    whenever tracing is enabled (by a running Profiler or by
    observability.enable())."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter_ns()

    def end(self):
        t0, self._t0 = self._t0, None       # consume: double end no-ops
        if t0 is None or not _tracing.enabled():
            return
        t1 = time.perf_counter_ns()
        _tracing.add_event(self.name, t0 / 1000.0, (t1 - t0) / 1000.0)

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed=0, ready=1, record=4, repeat=0, skip_first=0):
    total = closed + ready + record

    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        if repeat and s >= repeat * total:
            return ProfilerState.CLOSED
        pos = s % total
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: str = None):
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        fname = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(dir_name, f"{fname}.pb.trace.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": prof.events()}, f)
        return path

    return handler


def _device_events(kineto_trace: dict, t_anchor_us: float) -> list:
    """The CUDA kernels, copies and fills of a torch.profiler chrome
    trace, in the ring's event shape, on the perf_counter clock: the
    anchor range opened at `t_anchor_us` gives the offset."""
    evs = kineto_trace.get("traceEvents", [])
    anchor = [e for e in evs if e.get("name") == _ANCHOR]
    if not anchor:
        raise RuntimeError("the device trace holds no anchor range: the "
                           "torch.profiler session recorded no host "
                           "events")
    shift = t_anchor_us - float(anchor[0]["ts"])
    out = []
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        args = e.get("args", {})
        dev = args.get("device", 0)
        out.append({"name": e["name"], "ph": "X", "cat": e["cat"],
                    "pid": f"gpu:{dev}",
                    "tid": f"stream {args.get('stream', 0)}",
                    "ts": float(e["ts"]) + shift,
                    "dur": float(e.get("dur", 0.0)),
                    "args": {"device": dev,
                             "stream": args.get("stream"),
                             "graph": args.get("graph id")}})
    return out


class Profiler:
    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.targets = targets
        self.step_num = 0
        self._torch_prof = None
        self._anchor_us = None
        self._device = []

    def _wants_device_trace(self) -> bool:
        import torch
        if self.timer_only or not torch.cuda.is_available():
            return False
        return self.targets is None or ProfilerTarget.GPU in self.targets

    def start(self):
        # one event stream: a session records into the shared
        # observability ring, cleared at start (a session is a fresh
        # window); tracing stays enabled afterwards only if
        # observability had it on before this session
        import torch
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("Profiler.start() during a CUDA graph "
                               "capture: start the session after it")
        self._trace_was_enabled = _tracing.enabled()
        _tracing.clear()
        _tracing.enable()
        from ..ops import registry as _registry
        _registry._set_op_profiling(True)
        _op_stats.clear()
        self._device = []
        if self._wants_device_trace():
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           acc_events=True)
            prof.start()        # raises: no device trace is dropped
            self._torch_prof = prof
            with torch.profiler.record_function(_ANCHOR):
                self._anchor_us = time.perf_counter_ns() / 1000.0
        return self

    def stop(self):
        if not getattr(self, "_trace_was_enabled", False):
            _tracing.disable()
        from ..ops import registry as _registry
        _registry._set_op_profiling(False)
        prof, self._torch_prof = self._torch_prof, None
        if prof is not None:
            import torch
            torch.cuda.synchronize()
            prof.stop()
            tmp = tempfile.mkdtemp(prefix="ptt_profiler_")
            try:
                path = os.path.join(tmp, "device.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    self._device = _device_events(json.load(f),
                                                  self._anchor_us)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self, num_samples=None):
        self.step_num += 1

    def events(self):
        """The host spans of the ring, then the session's device
        events (none on the CPU)."""
        return _tracing.events() + list(self._device)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        lines = []
        with _op_stats_lock:
            op_rows = sorted(_op_stats.items(), key=lambda kv: -kv[1][1])
        if op_detail and op_rows:
            # per-op dispatch table (ref: profiler_statistic.py
            # "Operator Summary": calls / total / avg / max host time;
            # the reference's executable-cache column has no
            # counterpart here: eager ops run no cached executable)
            lines.append("-------------------  Operator Summary  "
                         "-------------------")
            lines.append(f"{'op':<36} {'calls':>7} {'total_ms':>10} "
                         f"{'avg_ms':>8} {'max_ms':>8}")
            for name, (n, tot, mx, _hits) in op_rows:
                lines.append(
                    f"{name:<36} {n:>7} {tot:>10.3f} {tot / n:>8.3f} "
                    f"{mx:>8.3f}")
        agg = {}
        for e in self.events():
            a = agg.setdefault(e["name"], [0.0, 0])
            a[0] += e["dur"] / 1000.0
            a[1] += 1
        if agg:
            lines.append("-------------------  UserDefined Summary  "
                         "-----------------")
            lines.append(f"{'name':<50} {'calls':>8} {'total_ms':>12}")
            for name, (tot, n) in sorted(agg.items(),
                                         key=lambda kv: -kv[1][0]):
                lines.append(f"{name:<50} {n:>8} {tot:>12.3f}")
        return "\n".join(lines)

    def op_stats(self):
        """Raw per-op rows: {name: (calls, total_ms, max_ms,
        cache_hits)}; cache_hits is always 0 here (no executable
        cache)."""
        with _op_stats_lock:
            return {k: tuple(v) for k, v in _op_stats.items()}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def load_profiler_result(path):
    with open(path) as f:
        return json.load(f)
