"""Structured tracing: nestable spans into a bounded in-memory ring
buffer, exported as Chrome-trace JSON (chrome://tracing / Perfetto) or
JSONL (the port's copy of paddle_tpu/observability/tracing.py: the same
event shape, ids and span names).

One event stream: `profiler.RecordEvent` routes its host spans through
the same ring buffer, so `profiler.export_chrome_tracing` and the
exporters here produce one consistent file whichever API recorded the
span.

Events are stored directly in chrome-trace "complete event" shape —
{"name", "ph": "X", "pid", "tid", "ts", "dur", "args"} with ts/dur in
microseconds on the monotonic `time.perf_counter_ns` clock — so export
is a dump, not a conversion.

Trace context (request-scoped observability): every recorded span
carries three IDs — `trace_id` (one per causal tree, 16 hex chars),
`span_id` (one per span, 8 hex chars) and `parent_id` (the enclosing
span's span_id, absent at the root). Propagation is contextvar-based,
so nesting works across threads-with-context and plain call stacks
alike: a span opened inside another span joins its trace automatically;
a span opened at top level starts a fresh trace. `span(...,
request_id=...)` stamps the request attribution into the event args
(IDs are for structure, args for attribution — per-request cardinality
never becomes a metric label). `current_trace()` exposes the ambient
(trace_id, span_id) so non-span events can be attributed to the live
trace, and `trace_context(trace_id, span_id)` adopts an EXISTING trace
— how the LLMEngine stitches one request's admission / prefill /
decode / preemption / finish events into a single connected tree even
though they happen in different engine steps. `ingest()` appends
events recorded in another process (the DataLoader farewell ships
worker rings to the parent; perf_counter is CLOCK_MONOTONIC on Linux,
so child timestamps order correctly against the parent's).

Cost model: `span()` returns a shared no-op singleton when tracing is
disabled (zero allocation on the hot path); when enabled, one small
object + one dict per finished span, into a deque bounded at
`capacity()` events (oldest dropped)."""
from __future__ import annotations

import collections
import contextvars
import json
import os
import threading
import time
from typing import List, Optional

__all__ = [
    "span", "add_event", "events", "clear", "enable", "disable",
    "enabled", "set_capacity", "capacity", "export_chrome_trace",
    "export_jsonl", "current_trace", "trace_context", "new_trace_id",
    "new_span_id", "ingest", "appended_total", "events_with_total",
]

_ENABLED = False
_DEFAULT_CAPACITY = 65536
_LOCK = threading.Lock()
_RING: collections.deque = collections.deque(maxlen=_DEFAULT_CAPACITY)
# events ever appended to the ring (monotonic — clear() does NOT reset
# it): incremental consumers (the fleet obs agent) diff it against
# their shipped high-water mark to know how many ring entries are new,
# and how many scrolled out (or were cleared) before they could ship —
# an honest drop count instead of a silent gap. Updated under _LOCK
# together with the ring append, so events_with_total() can hand out a
# CONSISTENT (ring copy, total) pair — the alignment incremental
# consumers need to map ring positions to global event indices.
_APPENDED = 0

# ambient trace context: (trace_id, span_id) of the innermost open
# span, or None at top level. contextvars (not a plain global) so
# threads that copy_context() and async frameworks propagate correctly.
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_trace_ctx", default=None)


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def set_capacity(n: int) -> None:
    """Resize the ring buffer (keeps the newest events that fit)."""
    global _RING
    with _LOCK:
        _RING = collections.deque(_RING, maxlen=max(1, int(n)))


def capacity() -> int:
    return _RING.maxlen


def appended_total() -> int:
    """Events ever appended (add_event + ingest), monotonic across
    clear()/set_capacity(). `appended_total() - events-you-have-seen`
    is the incremental-consumer read; the excess over `len(events())`
    is what the ring dropped before anyone copied it out. For a copy
    that is CONSISTENT with the total, use events_with_total()."""
    return _APPENDED


def events_with_total():
    """(ring copy oldest-first, appended_total) captured atomically:
    ring[i] is globally the (total - len(ring) + i)-th event ever
    appended, so an incremental consumer holding a shipped high-water
    mark can slice exactly the unshipped tail and count rotations as
    drops — a racy separate read of the two could mis-align by
    whatever landed in between."""
    with _LOCK:
        return list(_RING), _APPENDED


def clear() -> None:
    with _LOCK:
        _RING.clear()


def new_trace_id() -> str:
    """Fresh 64-bit trace id (16 hex chars)."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """Fresh 32-bit span id (8 hex chars)."""
    return os.urandom(4).hex()


def current_trace() -> Optional[dict]:
    """{"trace_id", "span_id"} of the innermost open span, or None."""
    cur = _CTX.get()
    if cur is None:
        return None
    return {"trace_id": cur[0], "span_id": cur[1]}


class _TraceContext:
    """Adopt an existing trace: spans/events opened inside join
    (trace_id, span_id) as their parent instead of starting fresh.
    Used by instrumentation that attributes work to a long-lived
    logical trace (one serving request) across separate call stacks."""

    __slots__ = ("_trace_id", "_span_id", "_token")

    def __init__(self, trace_id, span_id):
        self._trace_id = trace_id
        self._span_id = span_id
        self._token = None

    def __enter__(self):
        self._token = _CTX.set((self._trace_id, self._span_id))
        return self

    def __exit__(self, *exc):
        try:
            _CTX.reset(self._token)
        except ValueError:      # reset from a different context: drop
            _CTX.set(None)
        return False


def trace_context(trace_id: str, span_id: Optional[str] = None):
    """Context manager adopting an existing trace (see _TraceContext).
    No-op singleton when tracing is disabled."""
    if not _ENABLED:
        return _NULL_SPAN
    return _TraceContext(trace_id, span_id)


def add_event(name: str, ts_us: float, dur_us: float,
              pid: Optional[int] = None, tid: Optional[int] = None,
              args: Optional[dict] = None,
              trace: Optional[tuple] = None) -> None:
    """Append one complete event to the ring. ts_us must come from the
    perf_counter clock (microseconds) so events from different
    recording APIs order consistently. trace: optional
    (trace_id, span_id, parent_id_or_None) attached as top-level keys
    (span() passes these automatically; manual events may stitch
    themselves into a trace the same way)."""
    ev = {"name": name, "ph": "X",
          "pid": os.getpid() if pid is None else pid,
          "tid": threading.get_ident() if tid is None else tid,
          "ts": ts_us, "dur": dur_us}
    if trace is not None:
        ev["trace_id"], ev["span_id"] = trace[0], trace[1]
        if trace[2] is not None:
            ev["parent_id"] = trace[2]
    if args:
        ev["args"] = args
    global _APPENDED
    # one uncontended lock per recorded event (noise next to the dict
    # just built) buys the append-counter consistency the incremental
    # consumers rely on; the disabled path never reaches here
    with _LOCK:
        _APPENDED += 1
        _RING.append(ev)


def ingest(evs) -> None:
    """Append events recorded elsewhere (another process's ring, a
    bundle) — pid/tid/ts/ids are preserved. Bypasses the enabled flag
    for the same reason metrics merge() does: the child only has
    events to ship because recording was on when it mattered. Each
    event is tagged ("ingested": True) so a FleetAgent sharing the
    ingesting process never ships it back out — an aggregator
    co-resident with an agent (single-process fleets: tests,
    chief-hosted aggregation) would otherwise echo every received
    event into its own next bundle forever (one shipped
    numerics.divergence event would re-detect on every heartbeat)."""
    if not evs:
        return
    global _APPENDED
    tagged = [dict(ev, ingested=True) for ev in evs]
    with _LOCK:
        _APPENDED += len(tagged)
        _RING.extend(tagged)


def events() -> List[dict]:
    """Copy of the buffered events, oldest first."""
    with _LOCK:
        return list(_RING)


class _NullSpan:
    """Shared disabled-mode span: no state, no allocation."""
    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self):
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0", "trace_id", "span_id",
                 "parent_id", "_token")

    def __init__(self, name, args, trace_id=None):
        self.name = name
        self.args = args
        self._t0 = None
        self.trace_id = trace_id        # explicit adoption, else ambient
        self.span_id = None
        self.parent_id = None
        self._token = None

    def __enter__(self):
        cur = _CTX.get()
        if self.trace_id is None:
            self.trace_id = cur[0] if cur else new_trace_id()
        if cur is not None and cur[0] == self.trace_id:
            self.parent_id = cur[1]
        self.span_id = new_span_id()
        self._token = _CTX.set((self.trace_id, self.span_id))
        self._t0 = time.perf_counter_ns()
        return self

    def end(self):
        """Idempotent: the second end()/__exit__ is a no-op."""
        t0, self._t0 = self._t0, None
        if t0 is None:
            return
        if self._token is not None:
            try:
                _CTX.reset(self._token)
            except ValueError:  # ended from a different context: drop
                _CTX.set(None)
            self._token = None
        t1 = time.perf_counter_ns()
        add_event(self.name, t0 / 1000.0, (t1 - t0) / 1000.0,
                  args=self.args,
                  trace=(self.trace_id, self.span_id, self.parent_id))

    def __exit__(self, *exc):
        self.end()
        return False


def span(name: str, request_id=None, trace_id: Optional[str] = None,
         **attrs) -> object:
    """Nestable timing context:

        with tracing.span("engine.step", batch=8):
            ...

    Records one complete event on exit when tracing is enabled; returns
    a shared no-op context when disabled. The event carries trace
    context IDs: a span opened inside another span becomes its child
    (same trace_id, parent_id = enclosing span_id); at top level a
    fresh trace starts. request_id= stamps request attribution into the
    event args; trace_id= adopts an existing trace explicitly."""
    if not _ENABLED:
        return _NULL_SPAN
    if request_id is not None:
        attrs["request_id"] = request_id
    return _Span(name, attrs or None, trace_id=trace_id)


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def export_chrome_trace(path: str, extra_events: Optional[list] = None
                        ) -> str:
    """Write the ring buffer as a chrome://tracing / Perfetto-loadable
    JSON object (trace/span/parent ids ride along as top-level keys —
    the viewers ignore unknown keys, jq/scripts can join on them).
    Returns the path written."""
    evs = events()
    if extra_events:
        evs = evs + list(extra_events)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return path


def export_jsonl(path: str) -> str:
    """Write the ring buffer as one JSON object per line (stream-
    friendly: cat/grep/jq-able, appendable across runs). Each line
    carries the trace context ids, so `jq 'select(.trace_id == ...)'`
    reconstructs one request's span tree."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for ev in events():
            f.write(json.dumps(ev))
            f.write("\n")
    return path
