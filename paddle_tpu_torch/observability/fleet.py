"""The fleet observability plane (counterpart of
paddle_tpu/observability/fleet.py): a process's fleet identity, the
snapshot-delta encoding, the wire bundle and its local merge, the
one-shot farewell a spawned DataLoader worker ships when it finishes,
and the standing plane over the HMAC RPC layer (`distributed.rpc`):

* **FleetAgent** (one per process) periodically, and at shutdown,
  pushes a bundle ``{seq, metrics snapshot-delta, trace events,
  heartbeat}`` to an aggregator. Deltas are against the last
  acknowledged snapshot; trace events past the last shipped high-water
  mark go into a bounded outbound buffer, and every loss is counted
  (``paddle_tpu_fleet_agent_dropped_events_total{reason=ring|buffer}``).
  A failed ship freezes the bundle and retries it verbatim, so the
  aggregator's seq dedupe makes redelivery exactly-once accounting.
* **FleetAggregator** (served by `serve_aggregator`) merges each
  bundle's metrics into its own registry under an appended ``process``
  label, ingests foreign spans into the trace ring verbatim (ids keep
  cross-process trees connected), and publishes fleet health: heartbeat
  age, staleness, bundle / duplicate / quarantine totals, respawns.
  ``capacity_records()`` turns the merged counters into achieved req/s
  and tok/s per process, the autoscaler's capacity input.

The worker farewell ships this bundle format and the parent folds it in
with `merge_bundle_local`: one wire shape and one merge path, whether
the peer reports once or forever."""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import flight as _fl
from . import metrics as _m
from . import tracing as _t

__all__ = [
    "BUNDLE_VERSION", "delta_snapshot", "make_bundle",
    "merge_bundle_local", "worker_farewell", "set_identity",
    "suggest_role", "identity", "FleetAgent", "FleetAggregator",
    "aggregator", "serve_aggregator",
]

BUNDLE_VERSION = 1


# ---------------------------------------------------------------------------
# process identity: the `process` label value and `process_role` every
# shipped series is attributed to. Explicit set_identity wins; absent
# that, the first subsystem suggestion (Router suggests "router",
# LLMEngine "engine") names the role, and the process name defaults to
# "<role>-<pid>".
# ---------------------------------------------------------------------------
_IDENT_LOCK = threading.Lock()
_PROCESS: Optional[str] = None
_ROLE: Optional[str] = None
_ROLE_EXPLICIT = False


def set_identity(process: Optional[str] = None,
                 role: Optional[str] = None) -> None:
    """Pin this process's fleet identity explicitly (launch CLIs and
    tests call this; it beats any suggest_role)."""
    global _PROCESS, _ROLE, _ROLE_EXPLICIT
    with _IDENT_LOCK:
        if process is not None:
            _PROCESS = str(process)
        if role is not None:
            _ROLE = str(role)
            _ROLE_EXPLICIT = True


def suggest_role(role: str) -> None:
    """Weak role hint from an instantiated subsystem — first suggestion
    wins, an explicit set_identity always wins. Router/LLMEngine call
    this on construction so an unconfigured replica process still ships
    a meaningful process_role."""
    global _ROLE
    with _IDENT_LOCK:
        if _ROLE is None and not _ROLE_EXPLICIT:
            _ROLE = str(role)


def identity() -> Tuple[str, str]:
    """(process, role) this process ships under."""
    with _IDENT_LOCK:
        role = _ROLE or "proc"
        proc = _PROCESS or f"{role}-{os.getpid()}"
        return proc, role


# ---------------------------------------------------------------------------
# snapshot-delta encoding (the one wire format)
# ---------------------------------------------------------------------------
def delta_snapshot(cur: dict, base: Optional[dict]) -> dict:
    """Mergeable snapshot of `cur - base`: feeding every delta through
    `MetricsRegistry.merge` reconstructs `cur` exactly (sequence-
    numbered redelivery is deduped by the aggregator, so sums never
    double-count). Zero-delta series are pruned — an idle process ships
    bytes proportional to what changed, not to what is registered.

    Per kind: counters and histograms subtract (bucket-wise for
    histograms; the delta's min/max are the CUMULATIVE extrema — the
    window's own extrema are unknowable from two cumulative snapshots,
    and merge() only widens, so the merged extrema stay correct);
    gauges subtract, so the additive merge telescopes to the current
    reading. A counter or histogram that went BACKWARDS (the peer reset
    its registry mid-run) ships its full current value — a restart
    re-contributes, it never subtracts."""
    out: Dict[str, dict] = {}
    base = base or {}
    for name, rec in cur.items():
        brec = base.get(name)
        bseries = brec["series"] if brec else {}
        series = {}
        for key, val in rec["series"].items():
            bval = bseries.get(key)
            if rec["kind"] == "histogram":
                d = None
                if (bval is not None
                        and bval["count"] <= val["count"]
                        and len(bval["buckets"]) == len(val["buckets"])):
                    d = {
                        "buckets": [c - b for c, b in
                                    zip(val["buckets"], bval["buckets"])],
                        "sum": val["sum"] - bval["sum"],
                        "count": val["count"] - bval["count"],
                        "min": val["min"], "max": val["max"],
                    }
                    # a reset can hide behind a total count that grew
                    # back past the baseline; any individual bucket
                    # going backwards unmasks it, as does a shrinking
                    # sum (sound for the non-negative quantities every
                    # histogram here records). A reset whose new
                    # distribution dominates every bucket AND the sum
                    # is the epoch-free residual: it under-ships by
                    # the lost pre-reset counts, it never corrupts.
                    if any(b < 0 for b in d["buckets"]) or d["sum"] < 0:
                        d = None
                if d is None:       # no base, or reset: ship in full
                    d = dict(val)
                if d["count"] == 0:
                    continue
                series[key] = d
            else:
                dv = val - bval if bval is not None else val
                if rec["kind"] == "counter" and dv < 0:
                    dv = val        # reset: re-contribute in full
                if dv == 0.0:
                    continue
                series[key] = dv
        if series:
            drec = {"kind": rec["kind"], "help": rec["help"],
                    "labelnames": rec["labelnames"], "series": series}
            if rec["kind"] == "histogram":
                drec["buckets"] = rec["buckets"]
            out[name] = drec
    return out


def _relabel(snap: dict, labelname: str, labelvalue: str) -> dict:
    """Append one label dimension (`process=<value>`) to every series
    of a snapshot, so per-process series merge side-by-side in the
    aggregator's registry instead of summing into one anonymous blob.
    A metric that already carries the dimension (a re-aggregated
    bundle) passes through unchanged."""
    out = {}
    for name, rec in snap.items():
        if labelname in rec["labelnames"]:
            out[name] = rec
            continue
        rrec = {"kind": rec["kind"], "help": rec["help"],
                "labelnames": tuple(rec["labelnames"]) + (labelname,),
                "series": {tuple(k) + (str(labelvalue),): v
                           for k, v in rec["series"].items()}}
        if rec["kind"] == "histogram":
            rrec["buckets"] = rec["buckets"]
        out[name] = rrec
    return out


def make_bundle(process: str, role: str, seq: int,
                metrics_delta: Optional[dict] = None,
                trace: Optional[list] = None,
                heartbeat_extra: Optional[dict] = None) -> dict:
    """One fleet wire bundle (picklable plain data; `v` gates decoding
    so a future format bump fails loudly, not quietly wrong)."""
    hb = {"pid": os.getpid(), "time_unix": time.time()}
    if heartbeat_extra:
        hb.update(heartbeat_extra)
    return {"v": BUNDLE_VERSION, "process": str(process),
            "role": str(role), "seq": int(seq),
            "metrics": metrics_delta, "trace": trace, "heartbeat": hb}


def merge_bundle_local(payload: Optional[dict]) -> None:
    """Fold a bundle from the SAME logical process tree (the DataLoader
    worker farewell) into the process-global stores WITHOUT a process
    label: worker series are the parent's own work, shipped from a
    helper pid. Accepts the v1 bundle and the legacy
    ``{"metrics", "trace"}`` farewell shape alike — one merge path."""
    if not payload:
        return
    _m.registry().merge(payload.get("metrics") or {})
    _t.ingest(payload.get("trace") or ())


def worker_farewell(metrics: bool = True, trace: bool = True) -> dict:
    """The one-shot farewell a spawn worker ships when it finishes:
    a seq-1 bundle holding this process's full recorded history (a
    delta against the empty base — same pruning, same merge path as
    the standing agent)."""
    proc, role = identity()
    md = delta_snapshot(_m.registry().snapshot(), None) if metrics \
        else None
    tr = _t.events() if trace else None
    return make_bundle(proc, role, 1, metrics_delta=md, trace=tr)


# ---------------------------------------------------------------------------
# agent-side self-metrics (registered in the LOCAL registry, so they
# ship inside the next bundle — the plane observes itself). Increments
# bypass the enabled flag like SLO-breach accounting: ship/drop totals
# must count even when hot-path recording is off.
# ---------------------------------------------------------------------------
def _agent_metrics(r: Optional[_m.MetricsRegistry] = None):
    """Self-metric parents registered in `r` (default: the process-
    global registry). Registration is get-or-create, so per-agent
    calls against one registry share series — and an agent shipping a
    CUSTOM registry keeps its self-accounting in that same registry,
    so 'the plane observes itself' holds whichever store it ships."""
    if r is None:
        r = _m.registry()
    return {
        "shipped": r.counter(
            "paddle_tpu_fleet_agent_shipped_bundles_total",
            "bundles this process's fleet obs agent delivered to "
            "the aggregator (acknowledged sends only)"),
        "failures": r.counter(
            "paddle_tpu_fleet_agent_ship_failures_total",
            "bundle ship attempts that failed (aggregator "
            "unreachable, rejected frame); the delta and seq roll "
            "back and redeliver on the next interval"),
        "dropped": r.counter(
            "paddle_tpu_fleet_agent_dropped_events_total",
            "trace events lost before shipping: reason=ring means "
            "the bounded trace ring rotated them out between "
            "collections, reason=buffer means the agent's bounded "
            "outbound buffer overflowed while the aggregator was "
            "unreachable",
            ("reason",)),
    }


def _bump(parent, n=1.0, **labels):
    """Flag-bypassing increment on a metric parent (unlabeled or one
    label set) — plane bookkeeping counts regardless of the hot-path
    recording flag (the SLO-breach precedent)."""
    child = parent.labels(**labels) if labels else parent._require_default()
    child._value += n


def _rpc():
    # lazy: importing the distributed package pulls the whole
    # distributed surface; only processes that actually ship pay it
    from ..distributed import rpc as _r
    return _r


class FleetAgent:
    """Per-process shipping loop. Construct with the aggregator's
    endpoint (`serve_aggregator(...).endpoint`), `start()` the
    background thread (or call `ship()` on your own cadence), `stop()`
    at shutdown for the final farewell ship.

    All state transitions happen under one lock held across the send:
    a ship either fully commits (seq advances, baseline moves, buffer
    clears) or fully rolls back — there is no window where a delta is
    half-acknowledged."""

    def __init__(self, endpoint, process: Optional[str] = None,
                 role: Optional[str] = None, interval_s: float = 2.0,
                 buffer_events: int = 4096, timeout_s: float = 10.0,
                 registry: Optional[_m.MetricsRegistry] = None):
        ident_proc, ident_role = identity()
        self.process = str(process) if process is not None else ident_proc
        self.role = str(role) if role is not None else ident_role
        self.endpoint = endpoint
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._registry = registry if registry is not None \
            else _m.registry()
        self._am = _agent_metrics(self._registry)
        self._buffer: collections.deque = collections.deque(
            maxlen=max(1, int(buffer_events)))
        self._base: Optional[dict] = None
        self._seq = 0
        # the frozen not-yet-acknowledged bundle: (bundle, cur_snapshot)
        self._pending: Optional[tuple] = None
        # start the trace high-water mark at "everything currently in
        # the ring is unshipped" — the first bundle carries the live
        # ring once, and only rotations AFTER construction count as
        # drops
        evs0, total0 = _t.events_with_total()
        self._trace_hw = total0 - len(evs0)
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- collection --
    def _collect_trace_locked(self) -> None:
        # consistent (ring copy, total) pair: evs[i] is globally event
        # number (appended - len(evs) + i), so the unshipped tail is
        # exactly evs[len(evs) - new:] and anything the ring rotated
        # out past the high-water mark is a counted drop — a racy
        # separate read of the two could re-ship old events and skip
        # new ones
        evs, appended = _t.events_with_total()
        new = appended - self._trace_hw
        if new <= 0:
            return
        take = evs[max(0, len(evs) - new):]
        ring_dropped = new - len(take)
        # events the aggregator ingested FROM the fleet are not ours
        # to ship: a co-resident agent re-shipping them would echo
        # them around the fleet forever (tracing.ingest tags them)
        take = [ev for ev in take if not ev.get("ingested")]
        overflow = max(0, len(self._buffer) + len(take)
                       - self._buffer.maxlen)
        self._buffer.extend(take)
        self._trace_hw = appended
        if ring_dropped:
            _bump(self._am["dropped"], ring_dropped, reason="ring")
        if overflow:
            _bump(self._am["dropped"], overflow, reason="buffer")

    # -- shipping --
    def ship(self) -> bool:
        """Collect and push one bundle; True when the aggregator
        acknowledged it. With observability fully off (and nothing
        previously shipped) the bundle is heartbeat-only — no snapshot
        walk, no trace copy.

        A bundle that fails to send is FROZEN (seq, delta, trace) and
        retried verbatim while new activity accumulates toward the
        NEXT bundle — a retry must be byte-identical to what the
        aggregator may have already merged under that seq, or a lost
        ack would turn seq-dedupe into silent loss of whatever grew
        between attempts. A duplicate-ack therefore means "this exact
        bundle already landed" and commits like a success."""
        with self._lock:
            if self._pending is None:
                self._collect_trace_locked()
                cur = delta = None
                if _m.enabled() or self._base is not None:
                    cur = self._registry.snapshot()
                    delta = delta_snapshot(cur, self._base) or None
                # move (not copy) the buffered events into the frozen
                # bundle: the buffer only holds events of FUTURE
                # bundles while this one awaits its ack
                trace = list(self._buffer) or None
                self._buffer.clear()
                bundle = make_bundle(
                    self.process, self.role, self._seq + 1,
                    metrics_delta=delta, trace=trace,
                    heartbeat_extra={"interval_s": self.interval_s})
                self._pending = (bundle, cur)
            bundle, cur = self._pending
            try:
                r = _rpc()
                r.call_endpoint(self.endpoint, _ingest_bundle,
                                args=(bundle,), timeout=self.timeout_s)
            except Exception:
                # the frozen bundle redelivers on the next interval;
                # the aggregator's seq dedupe makes redelivery after a
                # lost ack harmless because the payload is identical
                _bump(self._am["failures"])
                return False
            self._pending = None
            self._seq = bundle["seq"]
            if cur is not None:
                self._base = cur
            _bump(self._am["shipped"])
            return True

    # -- lifecycle --
    def start(self) -> "FleetAgent":
        if self._thread is None or not self._thread.is_alive():
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._run, name="fleet-obs-agent", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            self.ship()

    def stop(self, final_ship: bool = True) -> None:
        """Stop the loop; final_ship pushes the farewell bundle (the
        done-farewell pattern, generalized) so nothing recorded since
        the last interval is lost."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.interval_s)
            self._thread = None
        if final_ship:
            self.ship()


# ---------------------------------------------------------------------------
# aggregator
# ---------------------------------------------------------------------------
_AGGREGATOR: Optional["FleetAggregator"] = None


def _ingest_bundle(bundle):
    """RPC target executed IN the aggregator process (module-level so
    it pickles by reference across the HMAC frame)."""
    agg = _AGGREGATOR
    if agg is None:
        raise RuntimeError(
            "no fleet aggregator is serving in this process "
            "(serve_aggregator() was not called, or it was closed)")
    return agg.ingest(bundle)


def aggregator() -> Optional["FleetAggregator"]:
    """The aggregator serving in this process, if any."""
    return _AGGREGATOR


class FleetAggregator:
    """Merges agent bundles into a fleet-wide registry (every series
    gains a ``process`` label) + the process-global trace ring, and
    answers fleet health. Use `serve_aggregator` to expose it over the
    HMAC RPC layer; `ingest()` can also be called directly (tests, an
    in-process fleet)."""

    # straggler-attribution state bound: arrival keys tracked at once
    ARRIVAL_KEY_CAP = 4096

    def __init__(self, stale_after_s: float = 10.0,
                 straggler_threshold_s: float = 0.25):
        self.stale_after_s = float(stale_after_s)
        self.straggler_threshold_s = float(straggler_threshold_s)
        self.registry = _m.MetricsRegistry()
        self._procs: Dict[str, dict] = {}
        # cross-rank collective arrivals: (op, group, seq) ->
        # {"procs": {process: ts_us}, "fired": bool}; insertion-ordered
        # so the cap evicts the oldest keys
        self._arrivals: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._straggler_cur: Dict[str, str] = {}    # op -> flagged proc
        self._lock = threading.Lock()
        self._server = None
        self.endpoint: Optional[str] = None
        # ingest observers: callbacks fired OUTSIDE the lock after a
        # bundle commits, with (process, bundle) — the training
        # autopilot's supervisor watches the plane through this hook
        # instead of polling the merged registry
        self._observers: List = []
        h = self.registry
        self._h = {
            "bundles": h.counter(
                "paddle_tpu_fleet_bundles_total",
                "bundles the aggregator accepted, by shipping process",
                ("process",)),
            "dups": h.counter(
                "paddle_tpu_fleet_duplicate_bundles_total",
                "redelivered bundles dropped by sequence-number "
                "dedupe (at-least-once transport made exactly-once "
                "accounting)",
                ("process",)),
            "quarantined": h.counter(
                "paddle_tpu_fleet_quarantined_series_total",
                "schema-skewed series a bundle tried to merge, routed "
                "to a *_skew quarantine name instead of corrupting "
                "the fleet registry",
                ("process",)),
            "restarts": h.counter(
                "paddle_tpu_fleet_process_restarts_total",
                "bundle arrivals whose heartbeat pid differed from the "
                "process name's previous incarnation — the seq epoch "
                "resets so a respawned replica (crash-restart) is not "
                "deduped into silence, and its capacity rates "
                "re-baseline",
                ("process",)),
            "rejected": h.counter(
                "paddle_tpu_fleet_rejected_bundles_total",
                "bundles whose metric delta could not be merged even "
                "under quarantine (two peers fighting over one "
                "quarantine slot with different schemas) — the seq "
                "still advances so a poison bundle cannot wedge the "
                "agent into redelivering it forever; the loss is "
                "counted here, never silent",
                ("process",)),
            "age": h.gauge(
                "paddle_tpu_fleet_heartbeat_age_seconds",
                "seconds since the aggregator last heard from the "
                "process (aggregator clock; refreshed by health())",
                ("process",)),
            "up": h.gauge(
                "paddle_tpu_fleet_process_up",
                "1 while the process's heartbeat age is inside the "
                "staleness window, 0 once it is suspected dead",
                ("process",)),
            "seq": h.gauge(
                "paddle_tpu_fleet_last_seq",
                "highest bundle sequence number accepted from the "
                "process",
                ("process",)),
            "pid": h.gauge(
                "paddle_tpu_fleet_process_pid",
                "os pid of the process's current incarnation (from "
                "its heartbeat), labeled with its fleet role — the "
                "obs_top replica panel joins per-process rows on "
                "this series",
                ("process", "role")),
            "cap_req": h.gauge(
                "paddle_tpu_fleet_capacity_req_per_s",
                "achieved finished-requests rate over the process's "
                "reporting window (capacity_records(); absent until "
                "a second bundle gives the window a width)",
                ("process",)),
            "cap_tok": h.gauge(
                "paddle_tpu_fleet_capacity_tok_per_s",
                "achieved decode-tokens rate over the process's "
                "reporting window (capacity_records())",
                ("process",)),
            "skew": h.gauge(
                "paddle_tpu_collective_skew_seconds",
                "cross-rank arrival skew of the op's most recently "
                "matched collective: max - min of the per-process "
                "comms.arrival timestamps sharing one (op, group, "
                "call-seq) key (perf_counter is CLOCK_MONOTONIC — "
                "cross-process comparable on one host)",
                ("op",)),
            "straggler": h.gauge(
                "paddle_tpu_collective_straggler",
                "one-hot straggler attribution per collective op: 1 "
                "on the process whose arrival trailed the rest by "
                "more than the straggler threshold, 0 elsewhere; no "
                "row is set while skew stays under the threshold (a "
                "clean fleet names no straggler)",
                ("op", "process")),
        }

    # -- ingest --
    def ingest(self, bundle) -> dict:
        if not isinstance(bundle, dict) \
                or bundle.get("v") != BUNDLE_VERSION:
            raise ValueError(
                "unrecognized fleet bundle (want v="
                f"{BUNDLE_VERSION}, got "
                f"{bundle.get('v') if isinstance(bundle, dict) else type(bundle).__name__!r})")
        proc = str(bundle.get("process") or "unknown")
        seq = int(bundle.get("seq") or 0)
        hb = bundle.get("heartbeat") or {}
        now = time.time()
        with self._lock:
            st = self._procs.get(proc)
            if st is None:
                st = self._procs[proc] = {
                    "first_seen": now, "last_seen": 0.0, "last_seq": 0,
                    "role": str(bundle.get("role") or "proc"),
                    "pid": None, "bundles": 0}
            elif hb.get("pid") is not None \
                    and st["pid"] is not None \
                    and hb["pid"] != st["pid"]:
                # same process NAME, new pid: the process respawned
                # (router crash-restart) and its agent restarted seq at
                # 1 — without an epoch reset every bundle of the new
                # life would dedupe as a duplicate and the live,
                # shipping process would read as stale forever. Merged
                # history stays (totals are cumulative across lives);
                # the seq epoch and the capacity-rate baseline restart
                st["last_seq"] = 0
                st.pop("cap_base", None)
                _bump(self._h["restarts"], process=proc)
            if seq <= st["last_seq"]:
                # bookkeeping writes bypass the enabled flag (the
                # aggregator's registry is its own; recording must not
                # depend on the aggregator process's hot-path flag)
                _bump(self._h["dups"], process=proc)
                return {"ok": True, "duplicate": True,
                        "last_seq": st["last_seq"]}
            # merge the payload BEFORE committing any process state:
            # if the merge raised after last_seq advanced, the agent's
            # rollback-redelivery would be deduped and the bundle's
            # data silently lost. A merge that fails even under
            # quarantine is counted and the bundle's metrics dropped
            # deliberately — the seq still advances, so one poison
            # bundle cannot wedge its agent into redelivering (and
            # partially re-merging) it forever.
            rejected = False
            md = bundle.get("metrics")
            if md:
                try:
                    q = self.registry.merge(
                        _relabel(md, "process", proc),
                        on_skew="quarantine")
                except _m.MergeSkewError:
                    rejected = True
                else:
                    if q:
                        _bump(self._h["quarantined"], len(q),
                              process=proc)
            tr = bundle.get("trace")
            skew_triggers = []
            if tr:
                # ingest BEFORE straggler matching: a skew-triggered
                # flight bundle must already hold this bundle's spans
                # (the slow comms.<op> span ships alongside the late
                # arrival that crosses the threshold)
                _t.ingest(tr)
                skew_triggers = self._note_arrivals(proc, tr)
            st["last_seen"] = now
            st["last_seq"] = seq
            st["bundles"] += 1
            st["role"] = str(bundle.get("role") or st["role"])
            if hb.get("pid") is not None:
                st["pid"] = hb["pid"]
            if rejected:
                _bump(self._h["rejected"], process=proc)
            else:
                _bump(self._h["bundles"], process=proc)
            self._h["seq"].labels(process=proc)._value = float(seq)
            if "cap_base" not in st:
                # capacity-rate baseline: the FIRST bundle may carry a
                # long pre-agent history (delta against the empty
                # base); rating that history over the inter-bundle
                # window would inflate req/s / tok/s by orders of
                # magnitude, so rates measure growth PAST this point
                snap = self.registry.snapshot()
                st["cap_base"] = {
                    "req": self._sum_with_process(
                        snap, "paddle_tpu_request_finished_total",
                        proc),
                    "tok": self._sum_with_process(
                        snap, "paddle_tpu_engine_events_total", proc,
                        event="decode_tokens"),
                }
        # flight dumps happen OUTSIDE the lock: a bundle write is disk
        # I/O at exactly the moment every other rank's agent is
        # shipping — holding the lock across it would stall the whole
        # plane into ship-failure rollbacks. The once-per-key `fired`
        # flag was committed under the lock, so no duplicate dump can
        # race in between.
        for detail in skew_triggers:
            _fl.trigger("collective_skew", detail=detail)
        # observers also run outside the lock, and an observer that
        # raises must not turn the agent's acknowledged ship into a
        # redelivery loop — the bundle already committed
        for cb in list(self._observers):
            try:
                cb(proc, bundle)
            except Exception:
                import logging
                logging.getLogger("paddle_tpu_torch.observability.fleet") \
                    .exception("fleet ingest observer failed")
        return {"ok": True, "seq": seq, "rejected_metrics": rejected}

    def add_observer(self, cb) -> None:
        """Register a post-ingest callback `cb(process, bundle)`, fired
        outside the aggregator lock after each accepted (non-duplicate)
        bundle commits. The supervisor (resilience.supervisor) attaches
        here to watch divergence events and heartbeats as they arrive."""
        with self._lock:
            if cb not in self._observers:
                self._observers.append(cb)

    def remove_observer(self, cb) -> None:
        with self._lock:
            if cb in self._observers:
                self._observers.remove(cb)

    # -- cross-rank straggler attribution (called under self._lock) --
    def _note_arrivals(self, proc: str, events) -> list:
        """Match `comms.arrival` events from this bundle against other
        processes' arrivals sharing the same (op, group, call-seq) key:
        publish the per-op skew gauge, flag the straggler one-hot once
        skew crosses the threshold, and (when the flight recorder is
        armed with collective_skew_s) return at most one
        `collective_skew` trigger detail per key for the caller to
        dump after releasing the lock."""
        triggers = []
        for ev in events:
            if ev.get("name") != "comms.arrival":
                continue
            a = ev.get("args") or {}
            op, group, seq = a.get("op"), a.get("group"), a.get("seq")
            ts = ev.get("ts")
            if op is None or group is None or seq is None or ts is None:
                continue
            key = (str(op), str(group), int(seq))
            ent = self._arrivals.get(key)
            if ent is None:
                while len(self._arrivals) >= self.ARRIVAL_KEY_CAP:
                    self._arrivals.popitem(last=False)
                ent = self._arrivals[key] = {"procs": {}, "fired": False}
            ent["procs"][proc] = float(ts)
            if len(ent["procs"]) < 2:
                continue            # skew needs two ranks, honestly
            procs = ent["procs"]
            slow = max(procs, key=procs.get)
            skew = (procs[slow] - min(procs.values())) / 1e6
            op = key[0]
            self._h["skew"].labels(op=op)._value = skew
            cur = self._straggler_cur.get(op)
            if skew >= self.straggler_threshold_s:
                if cur != slow:
                    if cur is not None:
                        self._h["straggler"].labels(
                            op=op, process=cur)._value = 0.0
                    self._h["straggler"].labels(
                        op=op, process=slow)._value = 1.0
                    self._straggler_cur[op] = slow
            elif cur is not None:
                # the fleet recovered: clear the stale attribution so
                # a long-healed straggler doesn't read as current
                self._h["straggler"].labels(
                    op=op, process=cur)._value = 0.0
                del self._straggler_cur[op]
            if not ent["fired"]:
                cfg = _fl.config()
                thr = cfg.collective_skew_s if cfg is not None else None
                if _fl._ARMED and thr is not None and skew >= thr:
                    ent["fired"] = True
                    triggers.append({
                        "op": op, "group": key[1], "seq": key[2],
                        "skew_s": round(skew, 6), "straggler": slow,
                        "arrivals_us": dict(procs)})
        return triggers

    def stragglers(self) -> Dict[str, str]:
        """Current one-hot straggler attribution: op -> flagged
        process (empty while the fleet is clean). The supervisor's
        sustained-straggler detector samples this on each scan."""
        with self._lock:
            return dict(self._straggler_cur)

    # -- health --
    def processes(self) -> Dict[str, dict]:
        with self._lock:
            return {p: dict(st) for p, st in self._procs.items()}

    def health(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per-process liveness view; refreshes the heartbeat-age /
        process-up gauges so exports carry current staleness. `now`
        is injectable for tests."""
        now = time.time() if now is None else now
        out = {}
        for proc, st in self.processes().items():
            age = max(0.0, now - st["last_seen"])
            up = age <= self.stale_after_s
            self._h["age"].labels(process=proc)._value = age
            self._h["up"].labels(process=proc)._value = 1.0 if up else 0.0
            if st["pid"] is not None:
                self._h["pid"].labels(
                    process=proc,
                    role=st["role"] or "")._value = float(st["pid"])
            out[proc] = {"role": st["role"], "age_s": age, "up": up,
                         "last_seq": st["last_seq"], "pid": st["pid"],
                         "bundles": st["bundles"]}
        return out

    # -- exports --
    def to_json(self) -> str:
        self.health()
        self.capacity_records()     # refresh the capacity gauges
        return self.registry.to_json()

    def to_prometheus(self) -> str:
        self.health()
        self.capacity_records()
        return self.registry.to_prometheus()

    def export_json(self, path: str) -> str:
        doc = self.to_json()
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(doc)
        os.replace(tmp, path)       # readers never see a torn frame
        return path

    # -- capacity (the elastic scaler's input) --
    def _sum_with_process(self, snap, name, proc, **labels) -> float:
        rec = snap.get(name)
        if not rec:
            return 0.0
        names = list(rec["labelnames"])
        if "process" not in names:
            return 0.0
        total = 0.0
        for key, val in rec["series"].items():
            lab = dict(zip(names, key))
            if lab.get("process") != proc:
                continue
            if any(lab.get(k) != v for k, v in labels.items()):
                continue
            total += val if not isinstance(val, dict) else 0.0
        return total

    def _max_with_process(self, snap, name, proc, **labels):
        rec = snap.get(name)
        best = None
        if not rec:
            return best
        names = list(rec["labelnames"])
        for key, val in rec["series"].items():
            lab = dict(zip(names, key))
            if lab.get("process") != proc:
                continue
            if any(lab.get(k) != v for k, v in labels.items()):
                continue
            if not isinstance(val, dict) and \
                    (best is None or val > best):
                best = val
        return best

    def capacity_records(self, now: Optional[float] = None
                         ) -> List[dict]:
        """One record per process: achieved req/s and tok/s over the
        process's reporting window (first→last bundle, aggregator
        clock) plus the best shipped roofline utilizations. Rates
        divide the growth SINCE the first bundle by that window — the
        first bundle may carry arbitrary pre-agent history, which
        belongs in the totals but would wildly inflate a rate measured
        over the inter-bundle window. Single-bundle processes report
        totals with null rates — an honest absence, not a made-up
        rate."""
        snap = self.registry.snapshot()
        out = []
        for proc, st in sorted(self.processes().items()):
            window = max(0.0, st["last_seen"] - st["first_seen"])
            req = self._sum_with_process(
                snap, "paddle_tpu_request_finished_total", proc)
            tok = self._sum_with_process(
                snap, "paddle_tpu_engine_events_total", proc,
                event="decode_tokens")
            base = st.get("cap_base") or {"req": 0.0, "tok": 0.0}
            dreq = max(0.0, req - base["req"])
            dtok = max(0.0, tok - base["tok"])
            rec = {
                "process": proc, "process_role": st["role"],
                "window_s": round(window, 3),
                "requests_total": req, "tokens_total": tok,
                "req_per_s": round(dreq / window, 3)
                if window > 0 and dreq else None,
                "tok_per_s": round(dtok / window, 3)
                if window > 0 and dtok else None,
                "utilization_hbm": self._max_with_process(
                    snap, "paddle_tpu_roofline_utilization", proc,
                    bound="hbm"),
                "utilization_flops": self._max_with_process(
                    snap, "paddle_tpu_roofline_utilization", proc,
                    bound="flops"),
            }
            if rec["req_per_s"] is not None:
                self._h["cap_req"].labels(
                    process=proc)._value = rec["req_per_s"]
            if rec["tok_per_s"] is not None:
                self._h["cap_tok"].labels(
                    process=proc)._value = rec["tok_per_s"]
            out.append(rec)
        return out

    def append_capacity_ledger(self, path: str, config: str = "fleet",
                               rev: Optional[str] = None
                               ) -> List[dict]:
        """Append one capacity JSONL record per process to `path`, keyed
        by (config, process_role) — the reference's record shape."""
        import json
        recs = self.capacity_records()
        rev = rev if rev is not None else _git_rev()
        ts = round(time.time(), 3)
        lines = []
        for cap in recs:
            lines.append({
                "rev": rev, "config": config, "ts": ts,
                "device": "fleet",
                "process_role": cap["process_role"],
                "process": cap["process"],
                "capacity": cap, "families": {},
            })
        with open(path, "a", encoding="utf-8") as f:
            for rec in lines:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return lines

    # -- lifecycle --
    def close(self) -> None:
        global _AGGREGATOR
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if _AGGREGATOR is self:
            _AGGREGATOR = None


def _git_rev() -> str:
    """The checkout's short revision, with a +dirty suffix when the
    working tree differs from it ("unknown" outside a git checkout)."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], cwd=root,
            capture_output=True, text=True, check=True).stdout.strip()
        if not sha:
            return "unknown"
        dirty = subprocess.run(
            ["git", "diff", "--quiet", "HEAD"], cwd=root,
            capture_output=True).returncode != 0
        return sha + ("+dirty" if dirty else "")
    except Exception:
        return "unknown"


def serve_aggregator(bind: str = "127.0.0.1", port: int = 0,
                     stale_after_s: float = 10.0,
                     straggler_threshold_s: float = 0.25
                     ) -> FleetAggregator:
    """Start an aggregator in THIS process, serving on the HMAC RPC
    call handler (no rendezvous — agents connect straight to
    `.endpoint`, so fleet membership is elastic: processes join by
    shipping and leave by going stale, exactly the lifecycle the
    elastic scaler needs). One aggregator per process; close() the old
    one first."""
    global _AGGREGATOR
    if _AGGREGATOR is not None:
        raise RuntimeError(
            "a fleet aggregator is already serving in this process "
            f"at {_AGGREGATOR.endpoint}; close() it first")
    agg = FleetAggregator(stale_after_s=stale_after_s,
                          straggler_threshold_s=straggler_threshold_s)
    r = _rpc()
    server, endpoint = r.serve(bind=bind, port=port)
    agg._server = server
    agg.endpoint = endpoint
    _AGGREGATOR = agg
    return agg
