"""Collective & mesh observability (counterpart of
paddle_tpu/observability/comms.py: the same series, labels, trace events,
fault point and ledger families).

* **Per-collective telemetry.** A collective records through
  `start()`/`finish()` (a host-launched collective, timed) or `count()`
  (count-only sites): ``paddle_tpu_collective_seconds{op,group}``
  latency histograms, ``paddle_tpu_collective_bytes_total{op}`` payload
  bytes (per-rank message size, the nccl-tests convention),
  ``paddle_tpu_collective_launches_total{op,mode}`` and the
  algorithmic-bandwidth gauge
  ``paddle_tpu_collective_algbw_bytes_per_sec{op}``, read against the
  card's interconnect peaks in `observability.perf`
  (``paddle_tpu_collective_link_utilization{op,link}``, published only
  when the peaks are known). A latency sample exists only where a
  completion edge exists: `finish(rec, out)` waits for the stream that
  produces `out` (it reads no value), so a sync collective's bandwidth
  is real, not a launch-time fiction. The port has no collectives yet
  (ROADMAP item 26 brings `distributed` and their call sites); until
  then the callers are the tests, which drive `start`/`finish` as the
  reference's sync collectives do.

* **Cross-rank arrival timestamps.** `start()` appends a
  ``comms.arrival`` trace event per (op, group, per-process call-seq) on
  the perf_counter clock. The call-seq counters are per process and
  survive `reset_window()`, so ranks in lockstep keep matching sequence
  numbers across measurement windows. The ``comms.collective`` fault
  point fires at the top of `start()`, before the arrival timestamp and
  inside the span window, so an injected delay models a rank arriving
  late: its arrival lands late and its ``comms.<op>`` span covers the
  delay.

* **Goodput accounting.** `note_train_step(period, cost)` — called where
  `TrainStep` publishes its roofline, with the same CUDA-event-timed
  seconds and expectation — publishes
  ``paddle_tpu_train_goodput_fraction{component=}``: `comms` = timed
  collective seconds since the last call over the period; `compute` =
  the expectation's roofline time (the larger of flops over the peak
  rate and bytes over the peak bandwidth) over the period, only when
  the card's peaks are known; `stall` = the remainder, only when compute
  is.

The per-op window accumulators feed `family_records()` (``comms_<op>``
keys, the perf family record's shape); `reset_window()` clears them
(`observability.reset()` calls it; the call-seq counters survive).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from . import metrics as _m
from . import perf as _perf
from . import tracing as _t
from ..resilience import faults as _faults

__all__ = [
    "start", "finish", "count", "note_reshard", "note_train_step",
    "family_records", "reset_window", "window_comms_seconds",
    "COLLECTIVE_BUCKETS",
]

# collective latencies straddle µs (in-node memcpy) to seconds (a
# straggling peer): the default latency buckets start too coarse at
# the bottom for the fast end, so widen both directions
COLLECTIVE_BUCKETS = (
    10e-6, 25e-6, 50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3, 100e-3,
    250e-3, 500e-3, 1.0, 2.5,
)

_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        r = _m.registry()
        _METRICS = {
            "seconds": r.histogram(
                "paddle_tpu_collective_seconds",
                "host-observed latency of one eager collective, "
                "launch to completion edge (sync collectives block on "
                "the result inside the timing window; sync_op=False "
                "closes at Work.wait()) — in-trace collectives record "
                "no latency, only counts",
                ("op", "group"), buckets=COLLECTIVE_BUCKETS),
            "bytes": r.counter(
                "paddle_tpu_collective_bytes_total",
                "per-rank payload bytes moved by collectives (the "
                "nccl-tests message-size convention: the local "
                "tensor's bytes, not the wire amplification), by op",
                ("op",)),
            "launches": r.counter(
                "paddle_tpu_collective_launches_total",
                "collective calls by op and mode: eager = host-"
                "dispatched (timed), in_trace = recorded once at "
                "shard_map trace time (count-only — host timing near "
                "traced code would be fiction), reshard = GSPMD "
                "reshard boundaries (sequence-parallel, ZeRO, "
                "pipeline stage transfers; async, untimed)",
                ("op", "mode")),
            "algbw": r.gauge(
                "paddle_tpu_collective_algbw_bytes_per_sec",
                "algorithmic bandwidth of the op's most recent timed "
                "collective: per-rank payload bytes over the measured "
                "launch-to-completion latency",
                ("op",)),
            "util": r.gauge(
                "paddle_tpu_collective_link_utilization",
                "achieved algorithmic bandwidth over the per-chip "
                "interconnect peak (observability.perf "
                "ICI_BYTES_PER_SEC/DCN_BYTES_PER_SEC); unknown "
                "devices publish no series — the roofline honesty "
                "convention",
                ("op", "link")),
            "goodput": r.gauge(
                "paddle_tpu_train_goodput_fraction",
                "per-step goodput decomposition sampled at the "
                "TrainStep roofline hook: comms = host-timed "
                "collective seconds in the step window over the "
                "period; compute = cost-model roofline-implied device "
                "time over the period (known device peaks only); "
                "stall = the remainder once compute is known",
                ("component",)),
        }
    return _METRICS


# ---------------------------------------------------------------------------
# per-process call-sequence counters (cross-rank straggler matching
# key) and per-op window accumulators (the perf-ledger source)
# ---------------------------------------------------------------------------
_SEQ: Dict[Tuple[str, str], int] = {}       # (op, group) -> calls so far
_WINDOW: Dict[str, dict] = {}               # op -> runs/seconds/bytes
_STEP_COMMS = [0.0]                         # timed comms s since last step


def _window_slot(op: str) -> dict:
    slot = _WINDOW.get(op)
    if slot is None:
        slot = _WINDOW[op] = {"runs": 0, "seconds": 0.0, "bytes": 0.0}
    return slot


def reset_window() -> None:
    """Drop the per-op window accumulators and the goodput comms
    accumulator (obs.reset() calls this). The per-process call-seq
    counters survive deliberately: SPMD ranks match arrivals by them,
    and a reset on one rank mid-run would desynchronize the key."""
    _WINDOW.clear()
    _STEP_COMMS[0] = 0.0


def window_comms_seconds() -> float:
    """Total timed collective seconds accumulated this window."""
    return sum(s["seconds"] for s in _WINDOW.values())


class _Rec:
    """One in-flight eager collective's timing state."""

    __slots__ = ("op", "group", "nbytes", "t0", "trace", "done")

    def __init__(self, op, group, nbytes, t0, trace):
        self.op = op
        self.group = group
        self.nbytes = nbytes
        self.t0 = t0
        self.trace = trace
        self.done = False


def start(op: str, group: str, nbytes: int) -> Optional[_Rec]:
    """Open one eager collective's record: count + bytes now, latency
    at finish(). Returns None after ONE flag check when observability
    is off — call sites pay nothing else. The `comms.collective` fault
    point fires here, before the arrival timestamp (see module
    docstring for why that ordering models a late rank)."""
    if not _m._ENABLED:
        return None
    t0 = time.perf_counter()
    _faults.fault_point("comms.collective", op=op, group=group)
    m = _metrics()
    m["launches"].labels(op=op, mode="eager").inc()
    nbytes = int(nbytes or 0)
    if nbytes:
        m["bytes"].labels(op=op).inc(nbytes)
    trace = None
    if _t._ENABLED:
        key = (op, group)
        seq = _SEQ.get(key, 0) + 1
        _SEQ[key] = seq
        cur = _t.current_trace()
        trace = (cur["trace_id"] if cur else _t.new_trace_id(),
                 _t.new_span_id(),
                 cur["span_id"] if cur else None)
        # the cross-rank matching event: ts is the moment this rank
        # actually reaches the collective's dispatch
        _t.add_event("comms.arrival", time.perf_counter_ns() / 1000.0,
                     0.0, args={"op": op, "group": group, "seq": seq})
    return _Rec(op, group, nbytes, t0, trace)


def _completion_edge(out) -> None:
    """Wait until the work producing `out` (a tensor, or a list or tuple
    of them) is done: an event recorded on the current stream of each
    CUDA tensor's device, synchronized. Nothing is read back; a CPU
    tensor is done already."""
    import torch
    outs = out if isinstance(out, (list, tuple)) else [out]
    for dev in {t.device for t in outs if isinstance(t, torch.Tensor)
                and t.device.type == "cuda"}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def finish(rec: Optional[_Rec], out=None) -> None:
    """Close one eager collective's timing with a completion edge:
    waits for the stream producing `out` when given (only reached with
    observability on), records the
    latency sample, the algorithmic-bandwidth gauge, the
    link-utilization gauges (known interconnect peaks only) and the
    `comms.<op>` span event. Idempotent — Work.wait() may race or
    repeat a site-level finish."""
    if rec is None or rec.done:
        return
    rec.done = True
    if out is not None:
        _completion_edge(out)
    dt = time.perf_counter() - rec.t0
    m = _metrics()
    m["seconds"].labels(op=rec.op, group=rec.group).observe(dt)
    if rec.trace is not None and _t._ENABLED:
        _t.add_event("comms." + rec.op, rec.t0 * 1e6, dt * 1e6,
                     args={"group": rec.group, "bytes": rec.nbytes},
                     trace=rec.trace)
    slot = _window_slot(rec.op)
    slot["runs"] += 1
    slot["seconds"] += dt
    slot["bytes"] += rec.nbytes
    _STEP_COMMS[0] += dt
    if rec.nbytes and dt > 0:
        bw = rec.nbytes / dt
        m["algbw"].labels(op=rec.op).set(bw)
        peaks = _perf.interconnect_peaks()
        if peaks is not None:
            for link, peak in peaks.items():
                if peak > 0:
                    m["util"].labels(op=rec.op, link=link).set(bw / peak)


def count(op: str, group: str, nbytes: int, mode: str = "in_trace",
          n: int = 1) -> None:
    """Count-only record for collectives without an honest host timing
    instant (mode "in_trace": recorded once where a program is built;
    "reshard": see note_reshard). One flag check when off."""
    if not _m._ENABLED:
        return
    m = _metrics()
    m["launches"].labels(op=op, mode=mode).inc(n)
    nbytes = int(nbytes or 0)
    if nbytes:
        m["bytes"].labels(op=op).inc(nbytes)


def note_reshard(op: str, group: str, nbytes: int) -> None:
    """One reshard boundary (sequence-parallel scatter/gather, ZeRO
    shard/re-gather, pipeline stage transfer): count + bytes + a
    zero-duration `comms.reshard` marker event (an asynchronous transfer
    has no completion edge here, so a duration would be a launch-time
    fiction; the marker still places it on the timeline). One flag
    check when off."""
    if not _m._ENABLED:
        return
    count(op, group, nbytes, mode="reshard")
    if _t._ENABLED:
        _t.add_event("comms.reshard", time.perf_counter_ns() / 1000.0,
                     0.0, args={"op": op, "group": group,
                                "bytes": int(nbytes or 0)})


def note_train_step(period_s: float, cost) -> None:
    """Goodput decomposition for one steady-state train step (called
    where TrainStep publishes its roofline sample). Consumes the timed
    collective seconds accumulated since the previous call. Guards on
    the metrics flag itself."""
    if not _m._ENABLED or period_s <= 0.0:
        return
    comms_s, _STEP_COMMS[0] = _STEP_COMMS[0], 0.0
    g = _metrics()["goodput"]
    comms_f = min(comms_s / period_s, 1.0)
    g.labels(component="comms").set(comms_f)
    if cost is None:
        return      # no cost model: comms fraction only, honestly
    peaks = _perf.device_peaks()
    if peaks is None:
        return      # unknown device: comms fraction only, honestly
    peak_flops, peak_bw = peaks
    est = 0.0
    if peak_flops > 0:
        est = max(est, cost.flops / peak_flops)
    if peak_bw > 0:
        est = max(est, cost.bytes_accessed / peak_bw)
    if est <= 0.0:
        return
    compute_f = min(est / period_s, 1.0)
    g.labels(component="compute").set(compute_f)
    g.labels(component="stall").set(
        max(0.0, 1.0 - compute_f - comms_f))


def family_records() -> Dict[str, dict]:
    """This window's per-op achieved summary in the perf family record
    shape (`comms_<op>` keys, beside perf.family_records()).
    utilization_ici only with known interconnect peaks."""
    out = {}
    ipeaks = _perf.interconnect_peaks()
    for op, slot in sorted(_WINDOW.items()):
        rec = {
            "runs": slot["runs"],
            "compiles": 0,
            "seconds": round(slot["seconds"], 6),
            "expected": None,
            "achieved_flops_per_s": None,
            "achieved_bytes_per_s": None,
            "utilization_hbm": None,
            "utilization_flops": None,
            "utilization_ici": None,
        }
        if slot["runs"] and slot["seconds"] > 0 and slot["bytes"]:
            bps = slot["bytes"] / slot["seconds"]
            rec["achieved_bytes_per_s"] = round(bps, 1)
            if ipeaks is not None and ipeaks.get("ici", 0) > 0:
                rec["utilization_ici"] = round(bps / ipeaks["ici"], 6)
        out["comms_" + op] = rec
    return out
