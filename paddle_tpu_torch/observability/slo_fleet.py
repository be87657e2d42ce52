"""Fleet-level SLO evaluation over process-merged request series
(counterpart of paddle_tpu/observability/slo_fleet.py).

`slo.evaluate()` reads a histogram's UNLABELED series — correct inside
one engine process, blind in the aggregator, where every replica
process's TTFT/TPOT/e2e/queue-wait observations arrive on FleetAgent
bundles and merge under the `process` label
(`FleetAggregator.ingest`). `FleetSLOMonitor` closes that gap: the
same declarative `slo.SLO` rules, evaluated against the SUM of a
metric's bucket vectors across every labeled series — the fleet-wide
distribution — with per-process attainment computed alongside so a
breach names the process that broke it::

    from paddle_tpu_torch.observability import slo, slo_fleet

    mon = slo_fleet.FleetSLOMonitor(agg, rules=[
        slo.SLO("ttft_p95", "paddle_tpu_request_ttft_seconds",
                threshold_s=0.5, objective=0.95)])
    for res in mon.evaluate():        # on a scan cadence
        if not res.ok:
            print(res.worst_process, res.per_process)

Differences from the single-process evaluator, all deliberate:

* **Windowed by default.** A long-lived fleet's cumulative
  distribution buries the last minute under hours of history — a
  monitor that can only see the cumulative fraction would detect a
  burst breach an epoch late and hold the breach long after recovery.
  Each `evaluate()` therefore reads the bucket DELTA since the
  previous call (the obs_top between-frames idiom; window extrema are
  unknowable, so attainment interpolates on the bucket grid).
  `window=False` restores cumulative reads.
* **Breach episodes, not breach evaluations.** A flight bundle
  (reason "slo_breach", fleet-scoped detail naming the triggering
  series, threshold, per-process attainment and the worst process) is
  dumped once per not-ok -> ok -> not-ok EPISODE, latched per rule —
  a breach that persists across N scans is one incident, not N
  bundles. The `paddle_tpu_slo_breaches_total{slo=}` counter still
  counts per breaching evaluation, matching `slo.evaluate()`.
* **Verdict gauges.** Every evaluation publishes
  `paddle_tpu_slo_attained_fraction{slo=}` and
  `paddle_tpu_slo_objective_fraction{slo=}` into the evaluated
  registry, so any export of it (aggregator JSON file, flight bundle)
  carries objective-vs-observed for the obs_top "== slo ==" panel —
  and the autoscaler reads the same verdicts it acts on.

Like `merge()` and the capacity gauges, all accounting bypasses the
hot-path enabled flag: an operator evaluating fleet SLOs wants the
verdict recorded regardless of whether local recording is on."""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from . import metrics as _m
from . import slo as _slo

__all__ = ["FleetSLOResult", "FleetSLOMonitor"]


class FleetSLOResult(_slo.SLOResult):
    """A fleet-wide `SLOResult` plus the attribution that makes it
    actionable: `per_process` maps each contributing process label to
    its own attained fraction over the same window, `worst_process`
    names the lowest-attaining one (None when the histogram has no
    process dimension — e.g. an in-process bench registry)."""

    __slots__ = ("per_process", "worst_process")

    def __init__(self, rule, attained, count, missing=False,
                 per_process: Optional[Dict[str, float]] = None,
                 worst_process: Optional[str] = None):
        super().__init__(rule, attained, count, missing=missing)
        self.per_process = per_process or {}
        self.worst_process = worst_process

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["per_process"] = dict(self.per_process)
        d["worst_process"] = self.worst_process
        return d

    def __repr__(self):
        base = super().__repr__()
        if self.worst_process is not None and not self.ok:
            base = base[:-1] + f" worst={self.worst_process})"
        return base


def _sum_series(metric) -> Dict[object, dict]:
    """{series_key: {"buckets", "count", "sum"}} for every child of a
    histogram, plus the fleet-wide sum under key None."""
    out: Dict[object, dict] = {}
    fleet = None
    try:
        pidx = metric.labelnames.index("process")
    except ValueError:
        pidx = None
    for key, child in metric._series():
        rec = {"buckets": list(child._buckets), "count": child._count,
               "sum": child._sum, "max": child._max}
        if fleet is None:
            fleet = {"buckets": list(child._buckets),
                     "count": child._count, "sum": child._sum,
                     "max": child._max}
        else:
            fleet["buckets"] = [a + b for a, b in
                                zip(fleet["buckets"], rec["buckets"])]
            fleet["count"] += rec["count"]
            fleet["sum"] += rec["sum"]
            fleet["max"] = max(fleet["max"], rec["max"])
        if pidx is not None:
            out[key[pidx]] = rec
    # zero vector must be full-length: it seeds the windowed delta,
    # and zip() against a shorter prev would silently truncate the
    # next frame's distribution (count > 0 with no buckets reads as
    # a vacuous window and hides the breach)
    out[None] = fleet or {"buckets": [0] * (len(metric.buckets) + 1),
                          "count": 0, "sum": 0.0, "max": -math.inf}
    return out


class FleetSLOMonitor:
    """Stateful fleet SLO evaluator. Construct against a
    `FleetAggregator` (its merged registry hosts the process-labeled
    request series) or any registry; call `evaluate()` on a scan
    cadence — the serving aggregator loop, a bench driver, the
    autoscaler's `scan()`.

    rules: the `slo.SLO` list to evaluate; None = the module-global
    `slo.rules()` registrations. min_count: windows with fewer
    observations than this pass vacuously (attained=None) — a
    one-sample window is noise, not a verdict."""

    def __init__(self, agg=None, registry=None, rules=None, *,
                 window: bool = True, min_count: int = 1,
                 flight_on_breach: bool = True):
        if registry is None:
            registry = agg.registry if agg is not None \
                else _m.registry()
        self.agg = agg
        self.registry = registry
        self.window = bool(window)
        self.min_count = max(1, int(min_count))
        self.flight_on_breach = bool(flight_on_breach)
        self._rules = list(rules) if rules is not None else None
        self._lock = threading.Lock()
        self._prev: Dict[str, Dict[object, dict]] = {}
        self._breached: Dict[str, bool] = {}    # episode latch per rule
        r = registry
        self._g_att = r.gauge(
            "paddle_tpu_slo_attained_fraction",
            "fleet-wide attained fraction of each SLO rule at its last "
            "evaluation (windowed since the previous evaluation by "
            "default); pairs with paddle_tpu_slo_objective_fraction "
            "for the obs_top slo panel's objective-vs-observed read",
            ("slo",))
        self._g_obj = r.gauge(
            "paddle_tpu_slo_objective_fraction",
            "each SLO rule's configured objective fraction — "
            "config-as-a-series so exports are self-describing",
            ("slo",))

    def rules(self) -> List[_slo.SLO]:
        return list(self._rules) if self._rules is not None \
            else _slo.rules()

    def add(self, rule: _slo.SLO) -> _slo.SLO:
        if self._rules is None:
            self._rules = []
        self._rules.append(rule)
        return rule

    @staticmethod
    def _attained(rule, bounds, rec, windowed: bool):
        if rec["count"] <= 0:
            return None, 0
        hi = None if windowed else (
            rec["max"] if rec["max"] != -math.inf else None)
        return _m.fraction_le(bounds, rec["buckets"], rule.threshold_s,
                              hi=hi), int(rec["count"])

    def evaluate(self) -> List[FleetSLOResult]:
        """Evaluate every rule over the window since the last call
        (cumulative with window=False). Publishes the verdict gauges,
        counts breaches, and — once per breach EPISODE, when the flight
        recorder is armed — dumps one fleet-scoped slo_breach bundle
        attributing the worst process."""
        out: List[FleetSLOResult] = []
        breaches: List[FleetSLOResult] = []
        with self._lock:
            for rule in self.rules():
                metric = self.registry.get(rule.metric)
                attained, count, missing = None, 0, True
                per_proc: Dict[str, float] = {}
                worst = None
                windowed = False
                if metric is not None and metric.kind == "histogram":
                    missing = False
                    series = _sum_series(metric)
                    prev = self._prev.get(rule.name)
                    if self.window and prev is not None:
                        cur = {k: {"buckets":
                                   [a - b for a, b in zip(
                                       v["buckets"],
                                       prev[k]["buckets"])]
                                   if k in prev else v["buckets"],
                                   "count": v["count"] - (
                                       prev[k]["count"]
                                       if k in prev else 0),
                                   "max": v["max"]}
                               for k, v in series.items()
                               if v is not None}
                        windowed = True
                    else:
                        cur = series
                    self._prev[rule.name] = series
                    fleet = cur.get(None)
                    if fleet is not None and \
                            fleet["count"] >= self.min_count:
                        attained, count = self._attained(
                            rule, metric.buckets, fleet, windowed)
                    for proc, rec in cur.items():
                        if proc is None or rec["count"] <= 0:
                            continue
                        att, _n = self._attained(
                            rule, metric.buckets, rec, windowed)
                        if att is not None:
                            per_proc[proc] = att
                    if per_proc:
                        worst = min(per_proc, key=per_proc.get)
                res = FleetSLOResult(rule, attained, count,
                                     missing=missing,
                                     per_process=per_proc,
                                     worst_process=worst)
                out.append(res)
                # verdict gauges bypass the enabled flag (see module
                # docstring); rule names are config-static labels
                self._g_obj.labels(slo=rule.name)._value = \
                    rule.objective
                if attained is not None:
                    self._g_att.labels(slo=rule.name)._value = attained
                was = self._breached.get(rule.name, False)
                if not res.ok:
                    _slo._breach_counter().labels(
                        slo=rule.name)._value += 1
                    if not was:
                        breaches.append(res)
                    self._breached[rule.name] = True
                else:
                    self._breached[rule.name] = False
        if self.flight_on_breach and breaches:
            from . import flight as _fl
            if _fl._ARMED:
                for res in breaches:    # bundle I/O outside the lock
                    _fl.trigger("slo_breach", detail=dict(
                        res.to_dict(), scope="fleet",
                        windowed=self.window))
        return out
