"""Unified observability: metrics registry + structured tracing +
request-scoped lifecycle instrumentation (counterpart of
paddle_tpu/observability/__init__.py). Every series name, label name,
span name, flight trigger reason and fault-point name is the
reference's, ``paddle_tpu_`` prefix included, so a dashboard or an SLO
rule written for the reference reads this package unchanged.

Built-in instrumentation (recorded only while enabled):

* `inference.LLMEngine`: step latency, prefill / packed-wave /
  decode-chunk / verify timing histograms, queue-depth and page-pool
  gauges, every `engine.stats` counter mirrored as
  ``paddle_tpu_engine_events_total{event=...}``, per-request TTFT /
  TPOT / queue-wait / e2e histograms (``paddle_tpu_request_*_seconds``),
  the decode graphs' captures as compiles, the ``engine_decode`` and
  ``engine_ragged`` rooflines, and the HBM gauges at step boundaries.
  Each request's admission, queue wait, prefill, decode chunks,
  preemption and finish form ONE connected trace.
* `io.DataLoader`: the consumer's batch wait in every tier, worker
  restarts and SharedMemory bytes, and in spawned workers the produce
  latency, batch counts and trace events, merged into the parent when
  each worker finishes (`fleet.worker_farewell`).
* `jit.TrainStep`: the captures as compiles, the ``train_step``
  roofline and the goodput fractions, timed by CUDA events on the
  card; the optimizer's
  ``paddle_tpu_optimizer_fused_step_total``; `amp.GradScaler`'s loss
  scale, step outcomes and scale decreases.
* `profiler.RecordEvent` and `profiler.Profiler`'s host spans go
  through the same trace ring.

Sub-surfaces: `slo` (declarative latency objectives read from the
registry), `flight` (atomic metrics + trace bundles on slow steps,
deadline misses, preemption storms, fault-point fires and SLO
breaches), `perf` (shape-counted cost models and the roofline gauges)
`fleet`'s local part (the worker bundle), `numerics` (in-step gradient
and parameter statistics, the NaN/Inf sentinel, loss-scale forensics)
and `comms` (collective timing and goodput). The fleet's agent and
aggregator are not ported yet (ROADMAP).

Quick start::

    from paddle_tpu_torch import observability as obs
    obs.enable()
    ...            # run the workload
    print(obs.to_prometheus())
    obs.export_chrome_trace("trace.json")

`enable()`/`disable()` flip metrics AND tracing together; the
submodules expose the flags separately (`obs.metrics.enable()`,
`obs.tracing.enable()`). Everything is process-global; `snapshot()` /
`merge()` carry metrics across spawn boundaries."""
from __future__ import annotations

from . import (comms, fleet, flight, metrics, numerics, perf,  # noqa: F401
               slo, tracing)
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, registry,
    DEFAULT_BUCKETS, MergeSkewError,
)
from .tracing import (  # noqa: F401
    span, current_trace, trace_context, export_chrome_trace,
    export_jsonl,
)
from .slo import SLO  # noqa: F401

__all__ = [
    "enable", "disable", "enabled", "registry", "snapshot", "merge",
    "reset", "to_prometheus", "to_json", "span", "current_trace",
    "trace_context", "trace_events", "trace_clear",
    "export_chrome_trace", "export_jsonl", "summary",
    "metrics", "tracing", "slo", "flight", "perf", "fleet", "comms",
    "numerics", "SLO",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS", "MergeSkewError",
]


def enable() -> None:
    """Enable metric recording and tracing, process-wide."""
    metrics.enable()
    tracing.enable()


def disable() -> None:
    metrics.disable()
    tracing.disable()


def enabled() -> bool:
    return metrics.enabled()


def snapshot() -> dict:
    return registry().snapshot()


def merge(snap: dict, on_skew: str = "raise") -> list:
    """Aggregate a snapshot() into the process-global registry; see
    MetricsRegistry.merge for the schema-skew contract (raise a
    MergeSkewError by default, or route skewed series to quarantined
    names with on_skew="quarantine")."""
    return registry().merge(snap, on_skew=on_skew)


def reset() -> None:
    """Full observable-state reset: zero every metric series, drop every
    buffered trace event, the perf and comms windows' accumulators and
    the numerics window (pending bundle, taps, sentinel windows, cadence
    and latch), which move together so a fresh measurement window never
    mixes old spans with new counters. Use `trace_clear()` for the ring
    alone."""
    registry().reset()
    tracing.clear()
    perf.reset_window()
    comms.reset_window()
    numerics.reset_window()


def to_prometheus() -> str:
    return registry().to_prometheus()


def to_json() -> str:
    return registry().to_json()


def trace_events() -> list:
    return tracing.events()


def trace_clear() -> None:
    """Drop buffered trace events only (metrics keep counting)."""
    tracing.clear()


def summary() -> dict:
    """Compact summary for machine consumers: non-zero counters/gauges
    as flat `name{k=v}` keys and per-histogram {count, sum, mean, min,
    max, p50, p95}, the percentiles estimated from the bucket vectors
    (metrics.quantile_from_buckets); use to_prometheus()/to_json() for
    the vectors themselves."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for name, rec in snapshot().items():
        for key, val in sorted(rec["series"].items()):
            lbl = name if not key else name + "{" + ",".join(
                f"{k}={v}" for k, v in zip(rec["labelnames"], key)) + "}"
            if rec["kind"] == "histogram":
                if val["count"]:
                    entry = {
                        "count": val["count"],
                        "sum": round(val["sum"], 6),
                        "mean": round(val["sum"] / val["count"], 6),
                        "min": round(val["min"], 6),
                        "max": round(val["max"], 6),
                    }
                    for pname, q in (("p50", 0.5), ("p95", 0.95)):
                        est = metrics.quantile_from_buckets(
                            rec["buckets"], val["buckets"], q,
                            lo=val["min"], hi=val["max"])
                        if est is not None:
                            entry[pname] = round(est, 6)
                    out["histograms"][lbl] = entry
            elif val:
                out["counters" if rec["kind"] == "counter"
                    else "gauges"][lbl] = val
    return {k: v for k, v in out.items() if v}
