"""Anomaly flight recorder: when something goes wrong, snapshot the
observable state ATOMICALLY to disk before it scrolls out of the ring
(the port's copy of paddle_tpu/observability/flight.py: the same
bundle layout and trigger reasons).

The always-on cost is one module-flag check (`_ARMED`) at each wired
trigger site — the recorder does nothing until `arm()`:

    from paddle_tpu_torch.observability import flight

    flight.arm("/var/log/paddle_tpu_torch/flight", retention=8,
               step_latency_threshold_s=0.5,   # slow LLMEngine.step
               preempt_storm=4,                # preemptions in one step
               capture_faults=True,            # any fault_point firing
               min_interval_s=5.0)             # bundle-storm cooldown

Wired triggers in this package (grep `_fl._ARMED` / `flight.trigger`
for ground truth): LLMEngine.step latency over threshold, request
deadline miss, a preemption storm inside one step, any resilience
fault point firing (capture_faults), SLO breaches found by
`slo.evaluate()` and training divergence found by the numerics plane
(``numerics_divergence``: nonfinite values, a gradient-norm spike, a
loss scale at its floor). The reference's other reasons (collective
skew, autopilot and autoscale decisions) stay in `TRIGGER_REASONS` for
their modules, which are not ported yet. Anything else can call
`flight.trigger(reason, detail=...)` directly.

A bundle is one directory, written to a hidden tmp name and renamed
into place (the checkpoint atomicity idiom — a crash mid-dump never
leaves a half bundle visible):

    <dir>/bundle_<seq>_<reason>/
        meta.json      trigger reason + detail + wall/monotonic time
        metrics.json   full registry export (to_json)
        trace.jsonl    the trace ring at trigger time (ID-carrying)

Retention keeps the newest `retention` bundles; older ones are
deleted after each dump. `min_interval_s` rate-limits dumping so a
pathological steady state (every step slow) produces one bundle per
cooldown window, not one per step. Every dump also increments
`paddle_tpu_flight_bundles_total{reason=}`."""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import List, Optional

from . import metrics as _m
from . import tracing as _t

__all__ = ["arm", "disarm", "armed", "config", "trigger", "bundles",
           "load_bundle", "FlightConfig"]

# single-check hot-path flag (mirrors metrics._ENABLED / the faults
# dict): instrumented sites read `flight._ARMED` directly
_ARMED = False
_CFG: Optional["FlightConfig"] = None
_LOCK = threading.Lock()
_SEQ = 0
_LAST_DUMP = -float("inf")      # perf_counter of the last bundle
_BUNDLES_COUNTER = None

TRIGGER_REASONS = ("step_latency", "deadline_miss", "preempt_storm",
                   "fault_point", "slo_breach", "collective_skew",
                   "numerics_divergence", "autopilot_remediation",
                   "autoscale_decision", "manual")


class FlightConfig:
    __slots__ = ("dir", "retention", "step_latency_threshold_s",
                 "preempt_storm", "capture_faults", "min_interval_s",
                 "collective_skew_s")

    def __init__(self, dir, retention=8, step_latency_threshold_s=None,
                 preempt_storm=None, capture_faults=False,
                 min_interval_s=0.0, collective_skew_s=None):
        self.dir = str(dir)
        self.retention = max(1, int(retention))
        self.step_latency_threshold_s = step_latency_threshold_s
        self.preempt_storm = preempt_storm
        self.capture_faults = capture_faults
        self.min_interval_s = float(min_interval_s)
        self.collective_skew_s = collective_skew_s


def _bundles_counter():
    global _BUNDLES_COUNTER
    if _BUNDLES_COUNTER is None:
        _BUNDLES_COUNTER = _m.registry().counter(
            "paddle_tpu_flight_bundles_total",
            "flight-recorder bundles dumped, by trigger reason",
            ("reason",))
    return _BUNDLES_COUNTER


def arm(dir: str, retention: int = 8,
        step_latency_threshold_s: Optional[float] = None,
        preempt_storm: Optional[int] = None,
        capture_faults: bool = False,
        min_interval_s: float = 0.0,
        collective_skew_s: Optional[float] = None) -> FlightConfig:
    """Arm the recorder (see module docstring for the knobs).
    collective_skew_s: cross-rank arrival skew (seconds) over which
    the FleetAggregator dumps a `collective_skew` bundle — at most
    once per (op, group, call-seq) key, so a single straggling
    collective yields a single bundle."""
    global _ARMED, _CFG, _SEQ
    cfg = FlightConfig(dir, retention, step_latency_threshold_s,
                       preempt_storm, capture_faults, min_interval_s,
                       collective_skew_s)
    os.makedirs(cfg.dir, exist_ok=True)
    # resume numbering past bundles a previous incarnation left behind
    # (a postmortem tool restarts by definition — colliding names
    # would make the rename fail and silently drop the next dump),
    # and sweep half-written tmp dirs from a crash mid-dump (safe
    # here: nothing can be dumping before the recorder is armed)
    high = 0
    for n in os.listdir(cfg.dir):
        if n.startswith(".tmp_bundle_"):
            shutil.rmtree(os.path.join(cfg.dir, n),
                          ignore_errors=True)
            continue
        if n.startswith("bundle_"):
            try:
                high = max(high, int(n.split("_")[1]))
            except (IndexError, ValueError):
                pass
    with _LOCK:
        _SEQ = max(_SEQ, high)
        _CFG = cfg
        _ARMED = True
    # install OR remove unconditionally: re-arming with
    # capture_faults=False must not leave a previous incarnation's
    # observer dumping fault bundles against the new config
    from ..resilience import faults
    faults.set_on_fire(_on_fault_fire if capture_faults else None)
    return cfg


def disarm() -> None:
    global _ARMED, _CFG, _LAST_DUMP
    with _LOCK:
        was = _CFG
        _ARMED = False
        _CFG = None
        _LAST_DUMP = -float("inf")
    if was is not None:
        from ..resilience import faults
        faults.set_on_fire(None)


def armed() -> bool:
    return _ARMED


def config() -> Optional[FlightConfig]:
    return _CFG


def _on_fault_fire(name: str, ctx: dict) -> None:
    trigger("fault_point",
            detail={"fault": name,
                    "ctx": {k: repr(v) for k, v in ctx.items()}})


def trigger(reason: str, detail: Optional[dict] = None,
            extra: Optional[dict] = None) -> Optional[str]:
    """Dump one bundle. Returns its path, or None when disarmed or
    inside the cooldown window. Never raises: a broken disk must not
    take the serving loop down with it."""
    global _SEQ, _LAST_DUMP
    with _LOCK:
        cfg = _CFG
        if cfg is None:
            return None
        now = time.perf_counter()
        if now - _LAST_DUMP < cfg.min_interval_s:
            return None
        prev_dump, _LAST_DUMP = _LAST_DUMP, now
        _SEQ += 1
        seq = _SEQ
    name = f"bundle_{seq:06d}_{reason}"
    final = os.path.join(cfg.dir, name)
    tmp = os.path.join(cfg.dir, f".tmp_{name}")
    try:
        os.makedirs(tmp, exist_ok=True)
        meta = {
            "reason": reason,
            "detail": detail or {},
            "seq": seq,
            "pid": os.getpid(),
            "time_unix": time.time(),
            "perf_counter_us": time.perf_counter_ns() / 1000.0,
        }
        if extra:
            meta["extra"] = extra
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            f.write(_m.registry().to_json())
        with open(os.path.join(tmp, "trace.jsonl"), "w") as f:
            for ev in _t.events():
                f.write(json.dumps(ev))
                f.write("\n")
        # meta last: its presence marks the bundle complete even if
        # someone peeks past the atomic rename
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True, default=repr)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        # a failed dump must not consume the cooldown window: the
        # next trigger in the anomaly burst should retry (e.g. after
        # a transient ENOSPC), not be silently suppressed
        with _LOCK:
            if _LAST_DUMP == now:
                _LAST_DUMP = prev_dump
        return None
    _bundles_counter().labels(reason=reason)._value += 1
    _enforce_retention(cfg)
    return final


def _enforce_retention(cfg: FlightConfig) -> None:
    try:
        names = sorted(n for n in os.listdir(cfg.dir)
                       if n.startswith("bundle_"))
        for n in names[:-cfg.retention]:
            shutil.rmtree(os.path.join(cfg.dir, n),
                          ignore_errors=True)
    except OSError:
        pass


def bundles(dir: Optional[str] = None) -> List[str]:
    """Complete bundle paths in `dir` (default: the armed config's),
    oldest first."""
    d = dir if dir is not None else (_CFG.dir if _CFG else None)
    if d is None or not os.path.isdir(d):
        return []
    out = []
    for n in sorted(os.listdir(d)):
        p = os.path.join(d, n)
        if n.startswith("bundle_") and \
                os.path.exists(os.path.join(p, "meta.json")):
            out.append(p)
    return out


def load_bundle(path: str) -> dict:
    """{"meta": dict, "metrics": dict (to_json shape), "trace":
    [events]} for one bundle directory."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "metrics.json")) as f:
        metrics = json.load(f)
    trace = []
    with open(os.path.join(path, "trace.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                trace.append(json.loads(line))
    return {"meta": meta, "metrics": metrics, "trace": trace}
