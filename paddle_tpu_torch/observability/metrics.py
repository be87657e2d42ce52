"""Process-global metrics registry: Counter / Gauge / Histogram with
label sets, Prometheus text exposition and JSON export (the port's copy
of paddle_tpu/observability/metrics.py; the series names, label names,
bucket bounds and export formats are the reference's, so a dashboard or
an SLO rule written for the reference reads the port unchanged).

Design constraints (the subsystem is compiled into hot paths — the
LLMEngine step loop, DataLoader queues, the fused optimizer step):

* **Near-zero cost when disabled.** Every mutation method's first
  action is one module-global flag check (`if not _ENABLED: return`) —
  no allocation, no lock, no label lookup. Child handles (the objects
  returned by `labels()`) are created eagerly by the instrumented
  modules at first use, so the disabled path never touches the
  registry at all.
* **Process-global with snapshot + reset.** One `MetricsRegistry` per
  process (`registry()`); `snapshot()` returns a picklable plain-data
  view that crosses the DataLoader spawn boundary (the same
  snapshot/install idiom as `resilience.faults`), and `merge()`
  aggregates a child's snapshot into the parent additively.
* **Idempotent registration.** `registry().counter(name, ...)` is
  get-or-create: instrumented modules can re-request their metrics on
  every import/instance without duplicating series. Re-registering a
  name with a different kind/labelnames/buckets is a bug and raises.

Naming conventions (see README "Observability"): metrics are prefixed
`paddle_tpu_`, carry base units in the suffix (`_seconds`, `_bytes`),
and monotonic counters end in `_total`.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "enable", "disable", "enabled", "DEFAULT_BUCKETS",
    "quantile_from_buckets", "fraction_le", "quantiles_by_label",
    "MergeSkewError", "quarantine_name",
]

# module-global so instrumented call sites pay exactly one attribute
# load + truthiness test when observability is off
_ENABLED = False

# latency-oriented default buckets (seconds), Prometheus-style
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def enable() -> None:
    """Turn metric recording on, process-wide."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn metric recording off (recorded values are kept)."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


# ---------------------------------------------------------------------------
# children: the leaf objects mutation happens on. Updates are plain
# attribute stores on floats/ints under the GIL — racing increments can
# interleave but never corrupt, which is the standard tradeoff for
# in-process metrics (a lock per inc() would cost more than the metric).
# ---------------------------------------------------------------------------
class _CounterChild:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        self._value -= n

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild:
    __slots__ = ("_bounds", "_buckets", "_sum", "_count", "_min", "_max")

    def __init__(self, bounds: Tuple[float, ...]):
        self._bounds = bounds
        self._buckets = [0] * (len(bounds) + 1)     # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        self._buckets[bisect.bisect_left(self._bounds, v)] += 1
        self._sum += v
        self._count += 1
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile of the recorded values (bucket linear
        interpolation clamped to the observed min/max; None when
        empty). An ESTIMATE: resolution is the bucket grid — size the
        buckets for the latencies you care about."""
        if self._count == 0:
            return None
        return quantile_from_buckets(self._bounds, self._buckets, q,
                                     lo=self._min, hi=self._max)

    @property
    def value(self) -> dict:
        return {
            "buckets": list(self._buckets), "sum": self._sum,
            "count": self._count,
            "min": None if self._count == 0 else self._min,
            "max": None if self._count == 0 else self._max,
        }


_CHILD_FOR = {"counter": _CounterChild, "gauge": _GaugeChild,
              "histogram": _HistogramChild}


# ---------------------------------------------------------------------------
# bucket math: quantile / fraction estimators shared by
# Histogram.quantile, obs.summary(), the SLO evaluator and tools that
# work from exported snapshots. Prometheus
# histogram_quantile semantics — linear interpolation inside the
# containing bucket — tightened with the tracked min/max so estimates
# never leave the observed range (and the +Inf bucket has a finite
# answer).
# ---------------------------------------------------------------------------
def quantile_from_buckets(bounds, counts, q, lo=None, hi=None
                          ) -> Optional[float]:
    """Estimate the q-quantile from cumulative-izable bucket counts.
    bounds: upper bucket bounds (len n); counts: per-bucket counts
    (len n+1, last = +Inf overflow); lo/hi: observed min/max used to
    clamp the interpolation. Returns None when there are no samples."""
    total = sum(counts)
    if total <= 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if acc + c >= rank:
            b_lo = 0.0 if i == 0 else float(bounds[i - 1])
            b_hi = float(bounds[i]) if i < len(bounds) else \
                (hi if hi is not None else float(bounds[-1]))
            if hi is not None:
                b_hi = min(b_hi, hi)
            if b_hi < b_lo:
                b_hi = b_lo
            frac = (rank - acc) / c
            est = b_lo + (b_hi - b_lo) * min(max(frac, 0.0), 1.0)
            if lo is not None:
                est = max(est, lo)
            if hi is not None:
                est = min(est, hi)
            return est
        acc += c
    return hi if hi is not None else float(bounds[-1])


def fraction_le(bounds, counts, v, hi=None) -> Optional[float]:
    """Estimated fraction of observations <= v (the SLO attainment
    read): exact at bucket bounds, linearly interpolated inside the
    containing bucket. hi: the observed max — lets a v past it count
    the +Inf overflow bucket as fully attained instead of
    conservatively exceeded. None when there are no samples."""
    total = sum(counts)
    if total <= 0:
        return None
    v = float(v)
    acc = 0.0
    for i, c in enumerate(counts):
        b_lo = 0.0 if i == 0 else float(bounds[i - 1])
        b_hi = float(bounds[i]) if i < len(bounds) else math.inf
        if v >= b_hi or (b_hi == math.inf
                         and hi is not None and v >= hi):
            acc += c
            continue
        if v > b_lo and b_hi != math.inf:
            acc += c * (v - b_lo) / (b_hi - b_lo)
        return min(acc / total, 1.0)
    return min(acc / total, 1.0)


def quantiles_by_label(doc, name, label, qs=(0.5, 0.95), prev=None):
    """Per-label-value percentile estimates for a labeled histogram in
    a to_json() document, summing bucket vectors across the remaining
    label dimensions (e.g. paddle_tpu_collective_seconds{op,group}
    aggregated per op, or a fleet-merged request histogram per
    process). `doc` is the parsed `to_json()` shape: {name: {kind,
    help, buckets?, series: [{labels: {...}, value}]}}.

    With `prev` (an earlier doc of the same export), quantiles come
    from the BETWEEN-FRAMES bucket delta — the live read for high-rate
    histograms, where the cumulative distribution would bury the last
    few seconds; window extrema are unknowable from two cumulative
    frames, so delta estimates are bounded by the bucket grid instead
    of the observed min/max. Falls back to the cumulative series when
    the delta is empty (idle between frames). Returns {label_value:
    {"count": n, "p50": ..., "p95": ...}} with one pNN key per entry
    of `qs`; label values with no samples are omitted."""
    rec = doc.get(name)
    if not rec or rec.get("kind") != "histogram":
        return {}

    def collect(d):
        acc = {}
        for s in (d.get(name) or {}).get("series", []):
            key = s["labels"].get(label)
            if key is None:
                continue
            v = s["value"]
            cur = acc.get(key)
            if cur is None:
                acc[key] = {"buckets": list(v["buckets"]),
                            "lo": v["min"], "hi": v["max"]}
            else:
                cur["buckets"] = [a + b for a, b in
                                  zip(cur["buckets"], v["buckets"])]
                if v["min"] is not None:
                    cur["lo"] = v["min"] if cur["lo"] is None \
                        else min(cur["lo"], v["min"])
                if v["max"] is not None:
                    cur["hi"] = v["max"] if cur["hi"] is None \
                        else max(cur["hi"], v["max"])
        return acc

    out = {}
    acc, pacc = collect(doc), collect(prev) if prev else {}
    for key, v in acc.items():
        counts, lo, hi = v["buckets"], v["lo"], v["hi"]
        pv = pacc.get(key)
        if pv is not None:
            dl = [c - p for c, p in zip(counts, pv["buckets"])]
            if sum(dl) > 0:
                counts, lo, hi = dl, None, None
        n = sum(counts)
        if not n:
            continue
        out[key] = {
            "count": n,
            **{f"p{int(q * 100)}": quantile_from_buckets(
                rec["buckets"], counts, q, lo=lo, hi=hi)
               for q in qs},
        }
    return out


# ---------------------------------------------------------------------------
# parent metric: owns the label-set -> child map
# ---------------------------------------------------------------------------
class _Metric:
    kind: str = ""

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (),
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = (tuple(buckets) if buckets is not None
                        else DEFAULT_BUCKETS) \
            if self.kind == "histogram" else None
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._default = self._new_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _new_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self.buckets)
        return _CHILD_FOR[self.kind]()

    def labels(self, **kv):
        """Child handle for one label set. Cached: repeated lookups with
        the same values return the same object, so instrumented modules
        can hold the handle and skip the lookup on the hot path."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    # unlabeled convenience: forward to the default child
    def inc(self, n: float = 1.0):
        self._require_default().inc(n)

    def set(self, v: float):
        self._require_default().set(v)

    def dec(self, n: float = 1.0):
        self._require_default().dec(n)

    def observe(self, v: float):
        self._require_default().observe(v)

    def quantile(self, q: float):
        """Histogram only: q-quantile estimate of the default
        (unlabeled) series; use .labels(...).quantile(q) per series."""
        return self._require_default().quantile(q)

    def _require_default(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first")
        return self._default

    def _series(self):
        """[(labelvalues_tuple, child)] snapshot-stable list."""
        with self._lock:
            return list(self._children.items())

    def _reset(self):
        with self._lock:
            for key in list(self._children):
                self._children[key] = self._new_child()
            if self._default is not None:
                self._default = self._children[()]


class Counter(_Metric):
    kind = "counter"


class Gauge(_Metric):
    kind = "gauge"


class Histogram(_Metric):
    kind = "histogram"


_KIND_CLASS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    # -- registration (get-or-create) --
    def _get_or_create(self, kind, name, help, labelnames, buckets=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                want_buckets = (tuple(buckets) if buckets is not None
                                else DEFAULT_BUCKETS)
                if m.kind != kind or m.labelnames != tuple(labelnames) \
                        or (kind == "histogram"
                            and m.buckets != want_buckets):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames} — conflicting "
                        "re-registration")
                return m
            m = _KIND_CLASS[kind](name, help, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets)

    def get(self, name) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def _items(self):
        with self._lock:
            return sorted(self._metrics.items())

    # -- lifecycle --
    def reset(self) -> None:
        """Zero every series; registrations (and handed-out parent
        objects) survive, so instrumented modules keep working."""
        for _, m in self._items():
            m._reset()

    # -- snapshot / merge (spawn-boundary aggregation) --
    def snapshot(self) -> dict:
        """Picklable plain-data view: {name: {kind, help, labelnames,
        buckets?, series: {labelvalues_tuple: value}}}. Histogram values
        are dicts (buckets/sum/count/min/max)."""
        out = {}
        for name, m in self._items():
            series = {key: child.value for key, child in m._series()}
            rec = {"kind": m.kind, "help": m.help,
                   "labelnames": m.labelnames, "series": series}
            if m.kind == "histogram":
                rec["buckets"] = m.buckets
            out[name] = rec
        return out

    def merge(self, snap: dict, on_skew: str = "raise") -> List[str]:
        """Aggregate a snapshot() (typically from a DataLoader worker
        process or a fleet obs agent) into this registry: counters and
        histograms add; gauges add too (a worker gauge is that worker's
        contribution — e.g. bytes in flight — so sum is the meaningful
        aggregate). Merging bypasses the enabled flag: the child only
        has a snapshot to ship because recording was on when it
        mattered.

        Schema skew (a peer running a different revision ships a series
        whose kind / label names / bucket boundaries / value shape
        differ from the local registration) would silently corrupt
        counts if merged additively. on_skew="raise" (default) raises
        MergeSkewError before touching any series of the skewed metric;
        on_skew="quarantine" merges the skewed metric under
        quarantine_name(name, kind) with the INCOMING schema, leaving
        the local series untouched — the fleet aggregator uses this so
        one stale process cannot poison (or stall) the whole plane.
        Returns the list of quarantined series names (empty normally).
        Two-phase: every metric of the snapshot is resolved (including
        quarantine routing) and every series' value shape validated
        BEFORE any count is mutated, so a raise anywhere leaves the
        registry's counts exactly as they were — no half-merged
        snapshot (quarantine registrations made during the failed
        resolve pass may remain, but they hold no counts)."""
        if not snap:
            return []
        if on_skew not in ("raise", "quarantine"):
            raise ValueError(f"on_skew must be 'raise' or 'quarantine',"
                             f" got {on_skew!r}")
        quarantined: List[str] = []
        resolved = []               # (metric, [(key, val)]) per name
        for name, rec in snap.items():
            try:
                kind = rec["kind"]
                labelnames = tuple(rec["labelnames"])
                series_in = rec["series"]
            except (TypeError, KeyError) as e:
                raise MergeSkewError(
                    f"merge skew on {name!r}: malformed snapshot "
                    f"record ({e!r})") from e
            if kind not in _KIND_CLASS:
                # a kind this revision doesn't know cannot be stored,
                # quarantined or not — MergeSkewError either way so the
                # caller's skew handling (not a bare KeyError) decides
                raise MergeSkewError(
                    f"merge skew on {name!r}: unknown metric kind "
                    f"{kind!r} (peer runs a newer revision?)")
            try:
                m = self._get_or_create(kind, name, rec["help"],
                                        labelnames, rec.get("buckets"))
            except ValueError as e:
                local = self.get(name)
                detail = (
                    f"merge skew on {name!r}: incoming "
                    f"{rec['kind']}{labelnames}"
                    + (f" buckets={tuple(rec['buckets'])}"
                       if rec.get("buckets") is not None else "")
                    + f" vs local {local.kind}{local.labelnames}"
                    + (f" buckets={local.buckets}"
                       if local.buckets is not None else ""))
                if on_skew == "raise":
                    raise MergeSkewError(detail) from e
                qname = quarantine_name(name, rec["kind"])
                try:
                    m = self._get_or_create(
                        rec["kind"], qname,
                        rec["help"] + " (quarantined: schema skew "
                        "against the local registration)",
                        labelnames, rec.get("buckets"))
                except ValueError as e2:
                    # two DIFFERENT skewed schemas fighting over the
                    # quarantine slot: no safe place left to put it
                    raise MergeSkewError(
                        detail + f"; quarantine slot {qname!r} is "
                        "already taken by a different schema") from e2
                quarantined.append(qname)
            # validate every series' value TYPE and shape in the
            # resolve pass — the mutation phase below must be unable
            # to raise, or a malformed series mid-snapshot would leave
            # earlier metrics half-added
            series = []
            for key, val in series_in.items():
                key = tuple(key)
                if len(key) != len(m.labelnames):
                    raise MergeSkewError(
                        f"merge skew on {name!r}: series key {key} has "
                        f"{len(key)} label values, local schema has "
                        f"{len(m.labelnames)} ({m.labelnames})")
                if m.kind == "histogram":
                    ok = (isinstance(val, dict)
                          and isinstance(val.get("buckets"), list)
                          and len(val["buckets"]) == len(m.buckets) + 1
                          and all(isinstance(b, (int, float))
                                  for b in val["buckets"])
                          and isinstance(val.get("sum"), (int, float))
                          and isinstance(val.get("count"), (int, float))
                          and (not val["count"]
                               or (isinstance(val.get("min"),
                                              (int, float))
                                   and isinstance(val.get("max"),
                                                  (int, float)))))
                    if not ok:
                        raise MergeSkewError(
                            f"merge skew on {name!r}: series {key} "
                            "histogram value is malformed or its "
                            "bucket count disagrees with the local "
                            f"bounds ({len(m.buckets) + 1})")
                elif not isinstance(val, (int, float)) \
                        or isinstance(val, bool):
                    raise MergeSkewError(
                        f"merge skew on {name!r}: series {key} value "
                        f"{type(val).__name__} is not numeric")
                series.append((key, val))
            resolved.append((m, series))
        for m, series in resolved:  # mutation phase: cannot raise
            for key, val in series:
                child = m._children.get(key)
                if child is None:
                    with m._lock:
                        child = m._children.setdefault(
                            key, m._new_child())
                if m.kind == "histogram":
                    for i, b in enumerate(val["buckets"]):
                        child._buckets[i] += b
                    child._sum += val["sum"]
                    child._count += val["count"]
                    if val["count"]:
                        child._min = min(child._min, val["min"])
                        child._max = max(child._max, val["max"])
                else:
                    child._value += val
        return quarantined

    # -- exporters --
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name, m in self._items():
            lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, child in sorted(m._series()):
                base = list(zip(m.labelnames, key))

                def render(suffix, extra, v):
                    pairs = base + extra
                    lbl = ("{" + ",".join(
                        f'{k}="{_escape_label(str(x))}"'
                        for k, x in pairs) + "}") if pairs else ""
                    lines.append(f"{name}{suffix}{lbl} {_fmt(v)}")

                if m.kind == "histogram":
                    acc = 0
                    for bound, n in zip(m.buckets, child._buckets):
                        acc += n
                        render("_bucket", [("le", _fmt(bound))], acc)
                    acc += child._buckets[-1]
                    render("_bucket", [("le", "+Inf")], acc)
                    render("_sum", [], child._sum)
                    render("_count", [], child._count)
                else:
                    render("", [], child._value)
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> str:
        """JSON export: same data as snapshot() with JSON-safe keys
        (label values joined into an object per series)."""
        out = {}
        for name, m in self._items():
            series = []
            for key, child in sorted(m._series()):
                series.append({
                    "labels": dict(zip(m.labelnames, key)),
                    "value": child.value,
                })
            rec = {"kind": m.kind, "help": m.help, "series": series}
            if m.kind == "histogram":
                rec["buckets"] = list(m.buckets)
            out[name] = rec
        return json.dumps(out, sort_keys=True)


class MergeSkewError(ValueError):
    """merge() found a snapshot series whose schema (kind, label names,
    histogram bucket boundaries, or per-series value shape) differs
    from the local registration. Merging it additively would silently
    corrupt counts — a version-skewed peer's buckets would land in the
    wrong bins — so the skew is surfaced instead: raised by default, or
    routed to a quarantined series name with merge(on_skew=
    "quarantine")."""


def quarantine_name(name: str, kind: str) -> str:
    """Series name a schema-skewed snapshot merges under in quarantine
    mode — `_skew` spliced in BEFORE the convention-bearing suffix, so
    the quarantined series still satisfies the naming rules (counters
    end `_total`, histograms keep their unit suffix) and is grep-ably
    derived from the original."""
    if kind == "counter" and name.endswith("_total"):
        return name[:-len("_total")] + "_skew_total"
    if kind == "histogram":
        for suf in ("_seconds", "_bytes", "_size"):
            if name.endswith(suf):
                return name[:-len(suf)] + "_skew" + suf
    return name + "_skew"


_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every built-in instrumentation
    records into."""
    return _GLOBAL


def compile_metrics() -> Tuple[Counter, Histogram]:
    """(counter, histogram) parents for the process-wide compile
    telemetry, labeled by family. ONE registration site shared by every
    reporter. The port compiles no executable: its counterpart of the
    reference's jitted executables is a CUDA graph, so
    `jit.cuda_graph.CapturedStep` reports each capture here under its
    family ("engine_decode", "train_step", "generate_decode", ...) with
    outcome=compile, and the histogram holds the capture's wall time
    (its eager warm-up run plus the capture). The reference's other
    outcome, disk_hit (an executable loaded from its persistent cache),
    never occurs: the port has no such cache."""
    return (
        _GLOBAL.counter(
            "paddle_tpu_compile_total",
            "executables instantiated (in this package: CUDA graphs "
            "captured), by family and outcome (compile = a fresh "
            "capture; disk_hit = loaded from a persistent cache, which "
            "this package does not have); entries beyond the "
            "steady-state bucket set are recaptures",
            ("family", "outcome")),
        _GLOBAL.histogram(
            "paddle_tpu_compile_seconds",
            "wall time of each executable's first call (in this "
            "package: a CUDA graph's warm-up run and capture), by "
            "family",
            ("family",)),
    )
