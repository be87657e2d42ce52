"""Declarative SLOs evaluated from the metrics registry (the port's
copy of paddle_tpu/observability/slo.py).

A serving deployment states its latency objectives once::

    from paddle_tpu_torch.observability import slo

    slo.add(slo.SLO("ttft_p95", "paddle_tpu_request_ttft_seconds",
                    threshold_s=0.5, objective=0.95))
    slo.add(slo.SLO("e2e_p99", "paddle_tpu_request_e2e_seconds",
                    threshold_s=5.0, objective=0.99))
    ...
    for r in slo.evaluate():
        if not r.ok:
            page_someone(r)

and `evaluate()` reads attainment straight out of the registered
histograms: `attained` is the estimated fraction of observations at or
under `threshold_s` (bucket interpolation — see
`metrics.fraction_le`), `ok` is `attained >= objective`. Rules with no
samples yet pass vacuously. Every breaching evaluation increments
`paddle_tpu_slo_breaches_total{slo=<name>}` (rule names are
config-static, so the label stays a closed set) and — when the flight
recorder is armed — drops a flight bundle (reason "slo_breach") so the
metrics/trace state that broke the objective is preserved for
postmortem.

Evaluation is pull-based by design: it walks bucket vectors, so it
belongs on a scrape/report cadence (a report epilogue, a dashboard
frame, a periodic operator loop), not in the per-token hot path."""
from __future__ import annotations

import threading
from typing import List, Optional

from . import metrics as _m

__all__ = ["SLO", "SLOResult", "add", "remove", "rules", "clear",
           "evaluate"]

_LOCK = threading.Lock()
_RULES: dict = {}            # name -> SLO
_BREACHES = None             # lazy counter handle


class SLO:
    """One latency objective: `objective` fraction of `metric`'s
    observations must be <= `threshold_s`."""

    __slots__ = ("name", "metric", "threshold_s", "objective")

    def __init__(self, name: str, metric: str, threshold_s: float,
                 objective: float):
        if not 0.0 < objective <= 1.0:
            raise ValueError(
                f"SLO {name!r}: objective must be in (0, 1], got "
                f"{objective}")
        if threshold_s <= 0:
            raise ValueError(
                f"SLO {name!r}: threshold_s must be positive")
        self.name = name
        self.metric = metric
        self.threshold_s = float(threshold_s)
        self.objective = float(objective)

    def __repr__(self):
        return (f"SLO({self.name!r}, {self.metric!r}, "
                f"threshold_s={self.threshold_s}, "
                f"objective={self.objective})")


class SLOResult:
    """Outcome of evaluating one rule: `attained` is the measured
    fraction <= threshold (None with no samples), `ok` whether the
    objective holds (vacuously True when empty). `missing` separates
    "no such unlabeled histogram in the registry" — a typo'd metric
    name or a rule against a labeled-only series — from "registered
    but no traffic yet", so a misconfigured alerting rule is
    detectable instead of passing vacuously forever."""

    __slots__ = ("name", "metric", "threshold_s", "objective",
                 "attained", "count", "ok", "missing")

    def __init__(self, rule: SLO, attained: Optional[float],
                 count: int, missing: bool = False):
        self.name = rule.name
        self.metric = rule.metric
        self.threshold_s = rule.threshold_s
        self.objective = rule.objective
        self.attained = attained
        self.count = count
        self.ok = attained is None or attained >= rule.objective
        self.missing = missing

    def to_dict(self) -> dict:
        # walk the MRO: `self.__slots__` alone resolves to the most
        # derived class's tuple, silently dropping these base fields
        # from subclass dumps (FleetSLOResult bundles lost the rule
        # name and threshold)
        out = {}
        for klass in reversed(type(self).__mro__):
            for s in getattr(klass, "__slots__", ()):
                out[s] = getattr(self, s)
        return out

    def __repr__(self):
        att = "n/a" if self.attained is None else f"{self.attained:.4f}"
        state = ("MISSING-METRIC" if self.missing
                 else "OK" if self.ok else "BREACH")
        return (f"SLOResult({self.name}: {state}"
                f" attained={att} objective={self.objective} "
                f"n={self.count})")


def _breach_counter():
    global _BREACHES
    if _BREACHES is None:
        _BREACHES = _m.registry().counter(
            "paddle_tpu_slo_breaches_total",
            "SLO rule evaluations that found the objective missed",
            ("slo",))
    return _BREACHES


def add(rule: SLO) -> SLO:
    """Register (or replace) a rule by name."""
    with _LOCK:
        _RULES[rule.name] = rule
    return rule


def remove(name: str) -> None:
    with _LOCK:
        _RULES.pop(name, None)


def clear() -> None:
    with _LOCK:
        _RULES.clear()


def rules() -> List[SLO]:
    with _LOCK:
        return list(_RULES.values())


def evaluate(registry=None, flight_on_breach: bool = True
             ) -> List[SLOResult]:
    """Evaluate every registered rule against `registry` (default: the
    process-global one). Counts breaches; when `flight_on_breach` and
    the flight recorder is armed, each breaching evaluation dumps one
    bundle (subject to the recorder's cooldown)."""
    reg = registry if registry is not None else _m.registry()
    out = []
    for rule in rules():
        metric = reg.get(rule.metric)
        attained, count, missing = None, 0, True
        if metric is not None and metric.kind == "histogram":
            child = metric._children.get(())
            if child is not None:
                missing = False
                if child._count:
                    count = child._count
                    attained = _m.fraction_le(child._bounds,
                                              child._buckets,
                                              rule.threshold_s,
                                              hi=child._max)
        res = SLOResult(rule, attained, count, missing=missing)
        out.append(res)
        if not res.ok:
            # breach accounting bypasses the enabled flag like merge()
            # does: an operator evaluating SLOs wants the breach
            # recorded regardless of whether hot-path recording is on
            _breach_counter().labels(slo=rule.name)._value += 1
            if flight_on_breach:
                from . import flight as _fl
                if _fl._ARMED:
                    _fl.trigger("slo_breach", detail=res.to_dict())
    return out
