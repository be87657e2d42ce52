"""Replicated serving with failover: a health-checked Router over N
LLMEngine replicas (counterpart of paddle_tpu/inference/router.py, the
same policy).

Everything below this file, the serving stack is a single `LLMEngine`
on a single card: one poisoned step, one hung launch, one dead process
takes every in-flight request with it. The Router is the scale-out
front-end that removes that single point of failure:

  * `ReplicaSet` owns N engine replicas behind one narrow surface
    (`add_request` / `step` / `abort_request` / `has_unfinished` — the
    exact `LLMEngine` methods): in-process engines, or replica
    processes (`inference.replica_proc`) behind the same interface —
    the router never reaches past it, so the policy layer is
    transport-agnostic. A process-backed client signals a
    vanished peer by raising `ReplicaGone` from `step()`; in-process
    chaos tests inject the same exception through the
    `router.replica.step` fault point.
  * **Admission + SLO-aware shedding**: a request is rejected up front
    (`finish_reason="rejected"`, reason on `.error`) when the healthy
    fleet is at capacity or the estimated time-to-first-token blows the
    configured SLO — when replicas die, capacity drops and the router
    degrades by shedding instead of letting queues collapse onto the
    survivors.
  * **Prefix-cache affinity routing**: each healthy replica's page pool
    is PEEKED (`PagedKVCache.match_prefix` — refcounts untouched) for
    the request's longest cached page-aligned prefix, and the request
    routes to the replica already holding the most of it (ties and
    misses fall back to least-loaded, then lowest index). A session's
    later turns therefore land where its KV already lives, prefilling
    only the new tail — the cross-replica analogue of what prefix
    caching does inside one engine.
  * **Health checking + failover**: every replica step is wall-timed.
    A step that raises (`ReplicaGone`, a watchdog trip, any engine
    error) marks the replica dead — its engine object is discarded
    like the crashed process it models — while a step that completes
    but exceeds `unhealthy_step_s` quarantines the replica: still
    alive, so its in-flight requests are drained through
    `LLMEngine.abort_request` (pages reclaimed, shareable prefix
    blocks parked) and the warm engine is kept for reintegration.
    Either way the victims are RE-SERVED from their original prompts
    on surviving replicas with their original trace ids and enqueue
    timestamps carried (`add_request(obs_carry=...)`), so each request
    stays one connected trace tree and TTFT/e2e accounting keeps
    charging the time the dead replica burned. Greedy decoding is
    deterministic, so a re-served request's output is bit-identical to
    a never-failed run.
  * **Circuit breaker**: each failure trips the replica's breaker —
    state "dead" for a cooldown that doubles per consecutive trip
    (bounded by `max_cooldown_s`), then "probation" (serving, but one
    failure re-trips at the doubled backoff) until `probation_steps`
    clean steps restore "healthy" and reset the backoff.

Chaos coverage: the `router.replica.step` fault point fires per
replica per scheduling pass (ctx: `replica`) — `exc=` models a crash,
`exc=ReplicaGone(...)` a hard process exit, `delay=` a hang the
step-latency health check catches. `tests/test_router.py` pins greedy
outputs bit-identical with failover vs a single never-killed engine,
zero leaked pool blocks on survivors, and counter == injected-kill
accounting.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from ..observability import metrics as _om
from ..observability import tracing as _ot
from ..resilience import faults
from .llm_engine import GenerationResult, _metrics as _eng_metrics

__all__ = ["Router", "ReplicaSet", "ReplicaHandle", "ReplicaGone"]


class ReplicaGone(RuntimeError):
    """The replica's process is gone (hard exit, SIGKILL, lost
    transport). Raised by a process-backed replica client when the
    peer vanishes; chaos tests inject it at `router.replica.step` as
    the in-process stand-in for a hard exit. The engine object must be
    treated as unusable — no abort/drain is possible, its pages died
    with the process."""


# ---------------------------------------------------------------------------
# observability (see llm_engine._metrics for the conventions; per-router
# exact counts live on router.stats). Replica label values are the
# config-bounded "replica-<i>" names — a closed set, not request ids.
# ---------------------------------------------------------------------------
_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        r = _om.registry()
        _METRICS = {
            "state": r.gauge(
                "paddle_tpu_router_replica_state",
                "replica health one-hot after a router step: healthy "
                "(serving), probation (reintegrated, one failure "
                "re-trips the breaker), dead (breaker open, cooling "
                "down)",
                ("replica", "state")),
            "inflight": r.gauge(
                "paddle_tpu_router_replica_inflight",
                "requests currently routed to (queued or running on) "
                "each replica",
                ("replica",)),
            "failovers": r.counter(
                "paddle_tpu_router_failovers_total",
                "replica failure events that tripped the circuit "
                "breaker, by cause: exception = the step raised, gone "
                "= the replica process vanished (ReplicaGone), "
                "slow_step = the step finished but blew the "
                "unhealthy_step_s health check",
                ("cause",)),
            "reroutes": r.counter(
                "paddle_tpu_router_reroutes_total",
                "in-flight requests re-served from their original "
                "prompts on a surviving replica after a failover"),
            "shed": r.counter(
                "paddle_tpu_router_shed_total",
                "requests rejected at router admission, by reason: "
                "capacity = healthy fleet at max_inflight (or no "
                "healthy replica), slo = estimated TTFT past "
                "slo_ttft_s, infeasible = no replica can ever hold "
                "the request, exhausted = re-serve attempt budget "
                "spent",
                ("reason",)),
            "affinity": r.counter(
                "paddle_tpu_router_affinity_tokens_total",
                "prompt tokens already cached on the routed replica "
                "at routing time (hit) vs not (miss) — the routing-"
                "decision view of prefix-cache affinity; the engines' "
                "prefix counters record what admission then actually "
                "leased",
                ("outcome",)),
        }
    return _METRICS


@dataclasses.dataclass(eq=False)
class _RoutedRequest:
    """The router's authoritative record of one accepted request —
    everything a re-serve needs survives here, independent of any
    replica's fate."""
    rid: object
    prompt: object                  # original prompt, as submitted
    max_new: int
    session: object = None
    deadline_abs: Optional[float] = None    # router-clock absolute
    trace_id: Optional[str] = None
    root_span: Optional[str] = None
    t_enq: float = 0.0              # first submit (perf_counter)
    t_dispatch: float = 0.0         # latest replica hand-off
    attempts: int = 0               # serve attempts so far
    cancelled: bool = False         # router.abort() seen — never
                                    # re-serve, only await the result
    hashes: Optional[list] = None   # memoized block-hash chain


class ReplicaHandle:
    """One replica slot: the engine (or None while dead), breaker
    state, and the in-flight requests routed to it."""

    def __init__(self, idx: int, factory):
        self.idx = idx
        self.name = f"replica-{idx}"
        self._factory = factory
        self.engine = factory(idx)
        self.t_added = time.monotonic()     # replica-seconds anchor
        self.state = "healthy"      # healthy | probation | dead
        self.inflight: Dict[object, _RoutedRequest] = {}
        # rids aborted out of this ENGINE by a quarantine drain: their
        # finish_reason="aborted" results are stale by the time the
        # kept engine is stepped again (the request lives elsewhere
        # now) and must not be delivered as terminal
        self.drained: set = set()
        self.cooldown_until = 0.0
        self.cooldown_s = 0.0       # current backoff (0 = untripped)
        self.trips = 0
        self.probation_left = 0
        self.probation_fresh = False    # reintegrated THIS pass —
                                        # it hasn't survived one yet
        self.last_step_s = 0.0

    @property
    def live(self) -> bool:
        return self.state != "dead" and self.engine is not None

    @property
    def load(self) -> int:
        return len(self.inflight)

    def restart(self) -> None:
        """Bring a crashed replica back: a fresh engine from the
        factory (the restarted-process model — cold cache). A
        quarantined-but-alive engine is kept (warm cache)."""
        if self.engine is None:
            self.engine = self._factory(self.idx)


class ReplicaSet:
    """The N replica handles + fleet-level views the Router routes
    over. Construction is eager: every replica's engine exists (and
    has allocated its page pool) before the first request arrives."""

    def __init__(self, engine_factory, n_replicas: int):
        if n_replicas < 1:
            raise ValueError("ReplicaSet needs at least one replica")
        self.factory = engine_factory
        self.handles = [ReplicaHandle(i, engine_factory)
                        for i in range(n_replicas)]
        # elastic scaling: indices are MONOTONIC, never recycled — a
        # retired replica-3's gauges must not be inherited by a later
        # grow, and a process-backed factory keys its process name on
        # the index
        self._next_idx = n_replicas

    def __len__(self) -> int:
        return len(self.handles)

    def __iter__(self):
        return iter(self.handles)

    def add(self, engine_factory=None) -> ReplicaHandle:
        """Grow the set by one fresh replica (elastic scale-up; the
        autoscaler's actuator path). Eager like construction: the
        engine exists before this returns. `engine_factory` overrides
        the set's factory for THIS handle — an actuator that
        provisioned the engine out-of-band (async process spawn)
        passes a factory returning the ready client, so attach cost
        is O(ms) regardless of spawn cost."""
        h = ReplicaHandle(self._next_idx,
                          engine_factory or self.factory)
        self._next_idx += 1
        self.handles.append(h)
        return h

    def remove(self, h: ReplicaHandle) -> None:
        self.handles.remove(h)

    def live(self) -> List[ReplicaHandle]:
        """Replicas currently accepting traffic (healthy or on
        probation)."""
        return [h for h in self.handles if h.live]


class Router:
    """Admission + routing + health/failover policy over a ReplicaSet.

    Usage (mirrors LLMEngine):
        router = Router(lambda i: LLMEngine(model, ...), n_replicas=2)
        router.submit("a", prompt_ids, max_new_tokens=64)
        while router.has_unfinished:
            for r in router.step():
                ... r.output_ids ...
    or `results = router.generate(prompts, max_new_tokens=64)`.

    engine_factory(i) -> an LLMEngine (or anything with its
    add_request/step/abort_request/has_unfinished surface). The
    factory is re-invoked to replace a crashed replica at
    reintegration, so it must build an INDEPENDENT engine each call
    (sharing model weights is fine — they are read-only at serving).
    """

    def __init__(self, engine_factory, n_replicas: int = 2, *,
                 affinity: bool = True,
                 affinity_max_inflight_factor: Optional[float] = 2.0,
                 max_inflight: Optional[int] = None,
                 unhealthy_step_s: Optional[float] = None,
                 cooldown_s: float = 0.25,
                 cooldown_factor: float = 2.0,
                 max_cooldown_s: float = 8.0,
                 probation_steps: int = 3,
                 max_serve_attempts: int = 3,
                 slo_ttft_s: Optional[float] = None,
                 session_cache_size: int = 4096):
        """affinity: route on the prefix-cache peek (False = pure
        least-loaded; the A/B the router bench measures).
        affinity_max_inflight_factor: load headroom on the affinity
        pick — when the cached replica's inflight (counting this
        request) exceeds this factor times the least-loaded live
        candidate's, the pick falls back to least-loaded instead:
        re-prefilling a shared prefix on an idle replica beats
        queueing behind the pile affinity concentrated (session
        affinity erases fleet pipelining otherwise). None = always honor affinity.
        max_inflight: admission cap PER HEALTHY REPLICA — total
        accepted-and-unfinished requests above max_inflight *
        len(live) shed with reason "capacity"; None = never shed on
        load. unhealthy_step_s: a completed replica step slower than
        this trips the breaker with cause "slow_step" (None = trust
        the engine's own step_timeout_s watchdog to raise instead).
        slo_ttft_s: shed with reason "slo" when estimated TTFT
        (in-flight backlog over recent per-request service rate)
        exceeds this. max_serve_attempts: a request re-routed this
        many times (replica died under it each time) finishes as
        "rejected"/exhausted instead of bouncing forever.
        session_cache_size: LRU bound on the session -> sticky-replica
        map (the router is a long-lived front-end; per-session state
        must not grow with total sessions ever seen — an evicted
        session just falls back to the prefix peek / least-loaded)."""
        # fleet identity plumbing: a process fronting replicas ships
        # its series as process_role="router" unless the launcher
        # pinned something explicit (set_identity wins; suggested
        # BEFORE the replica engines construct so their weaker
        # "engine" suggestion does not name a router process)
        from ..observability import fleet as _ofleet
        _ofleet.suggest_role("router")
        self.replicas = ReplicaSet(engine_factory, n_replicas)
        self.affinity = bool(affinity)
        self.affinity_max_inflight_factor = (
            float(affinity_max_inflight_factor)
            if affinity_max_inflight_factor is not None else None)
        self.max_inflight = max_inflight
        self.unhealthy_step_s = unhealthy_step_s
        self.cooldown_s = float(cooldown_s)
        self.cooldown_factor = float(cooldown_factor)
        self.max_cooldown_s = float(max_cooldown_s)
        self.probation_steps = int(probation_steps)
        self.max_serve_attempts = int(max_serve_attempts)
        self.slo_ttft_s = slo_ttft_s
        self._now = time.monotonic         # stubbable breaker clock
        self._owner: Dict[object, ReplicaHandle] = {}
        self._pending: collections.deque = collections.deque()
        self._results: List[GenerationResult] = []  # router-terminal
        self._session_cap = int(session_cache_size)
        self._sessions: "collections.OrderedDict[object, ReplicaHandle]" \
            = collections.OrderedDict()
        self._ema_serve_s: Optional[float] = None
        self._step_pool = None          # lazy: concurrent fleet steps
        self._probe_pool = None         # lazy: concurrent cache peeks
        self._retired_replica_s = 0.0   # replica-seconds of retirees
        # per-router exact counts (plain dict — bench/tests read it;
        # the process-global series carry the same numbers)
        self.stats = dict(
            routed=0, shed=0, failovers=0, reroutes=0,
            affinity_hit_tokens=0, affinity_miss_tokens=0,
            grown=0, retired=0)

    # -- admission ---------------------------------------------------------
    def _terminal(self, rid, prompt, finish_reason: str, error: str,
                  req: Optional[_RoutedRequest] = None) -> None:
        """Finish a request ROUTER-side (shed, exhausted, expired mid-
        failover): outcome counter, the terminal `request` root event
        closing the trace tree, and the result the next step() drains
        — the router-side twin of the engine's _finish_obs."""
        if _om._ENABLED:
            _eng_metrics()["req_finished"].labels(
                reason=finish_reason).inc()
        if _ot._ENABLED and req is not None and \
                req.trace_id is not None:
            t = time.perf_counter()
            _ot.add_event(
                "request", req.t_enq * 1e6, (t - req.t_enq) * 1e6,
                trace=(req.trace_id, req.root_span, None),
                args={"request_id": str(rid),
                      "finish_reason": finish_reason})
        self._results.append(GenerationResult(
            request_id=rid, prompt_ids=prompt,
            output_ids=np.zeros((0,), np.int32),
            finish_reason=finish_reason, error=error))

    def _shed(self, rid, prompt, reason: str, detail: str,
              req: Optional[_RoutedRequest] = None) -> None:
        self.stats["shed"] += 1
        if _om._ENABLED:
            _metrics()["shed"].labels(reason=reason).inc()
        self._terminal(rid, prompt, "rejected",
                       f"{reason}: {detail}", req=req)

    def submit(self, request_id, prompt_ids, max_new_tokens: int = 32,
               session_id=None, deadline_s: Optional[float] = None):
        """Admit a request into the fleet (or shed it — the rejection
        surfaces as a finish_reason="rejected" result on the next
        step(), never an exception). session_id groups multi-turn
        traffic for affinity."""
        if request_id in self._owner or any(
                r.rid == request_id for r in self._pending):
            raise ValueError(
                f"request {request_id!r} is already in flight")
        live = self.replicas.live()
        backlog = len(self._pending) + sum(h.load for h in live)
        if not live:
            return self._shed(request_id, prompt_ids, "capacity",
                              "no healthy replica")
        if self.max_inflight is not None and \
                backlog >= self.max_inflight * len(live):
            return self._shed(
                request_id, prompt_ids, "capacity",
                f"{backlog} in flight >= {self.max_inflight} x "
                f"{len(live)} healthy replicas")
        if self.slo_ttft_s is not None and self._ema_serve_s and \
                backlog * self._ema_serve_s / len(live) \
                > self.slo_ttft_s:
            return self._shed(
                request_id, prompt_ids, "slo",
                f"estimated TTFT {backlog * self._ema_serve_s / len(live):.3f}s "
                f"exceeds slo_ttft_s={self.slo_ttft_s}")
        t_now = time.perf_counter()
        req = _RoutedRequest(
            rid=request_id, prompt=prompt_ids,
            max_new=int(max_new_tokens), session=session_id,
            deadline_abs=(self._now() + deadline_s
                          if deadline_s is not None else None),
            trace_id=_ot.new_trace_id() if _ot._ENABLED else None,
            root_span=_ot.new_span_id() if _ot._ENABLED else None,
            t_enq=t_now)
        self._dispatch(req)

    # -- routing -----------------------------------------------------------
    def _route_candidates(self, req: _RoutedRequest
                          ) -> List[ReplicaHandle]:
        """Live replicas eligible to serve `req` — the hook a
        disaggregated router (inference.disagg) narrows to one role
        pool, so a prefill admission never probes (or lands on) the
        decode pool."""
        return self.replicas.live()

    def _probe_affinity(self, req: _RoutedRequest, live
                        ) -> Dict[ReplicaHandle, int]:
        """Per-candidate cached-prefix peeks for the affinity scorer.
        Remote (process-backed) caches answer over RPC, so they are
        probed CONCURRENTLY — one RPC round per admission instead of
        one serial round-trip per pool member. Returns
        {handle: ncached_tokens} (candidates without prefix caching
        are absent — they score 0)."""
        cands = [h for h in live
                 if h.engine.cache.enable_prefix_caching]
        if not cands:
            return {}
        if req.hashes is None:  # hash the prompt ONCE — the chain is
            # reused across replicas, re-routes, and (via add_request)
            # the engine scheduler itself
            req.hashes = cands[0].engine.cache.block_hashes(req.prompt)
        if not req.hashes:      # sub-page prompt: nothing can match
            return {}
        out: Dict[ReplicaHandle, int] = {}
        remote = [h for h in cands
                  if getattr(h.engine.cache, "remote", False)]
        if len(remote) > 1:
            import concurrent.futures as _cf
            if self._probe_pool is None or \
                    self._probe_pool._max_workers < len(remote):
                if self._probe_pool is not None:
                    self._probe_pool.shutdown(wait=False)
                self._probe_pool = _cf.ThreadPoolExecutor(
                    max_workers=max(4, len(remote)),
                    thread_name_prefix="router-probe")
            futs = [(h, self._probe_pool.submit(
                h.engine.cache.match_prefix, req.prompt, req.hashes))
                for h in remote]
            for h, f in futs:
                out[h] = f.result()[0]
        for h in cands:
            if h not in out:
                out[h] = h.engine.cache.match_prefix(
                    req.prompt, req.hashes)[0]
        return out

    def _route(self, req: _RoutedRequest) -> ReplicaHandle:
        """Pick a live replica: longest prefix-cache peek first
        (affinity), then the session's sticky replica, then
        least-loaded (lowest index on ties — deterministic). An
        affinity/sticky pick whose inflight has blown the
        `affinity_max_inflight_factor` headroom over the least-loaded
        candidate is abandoned for least-loaded."""
        live = self._route_candidates(req)
        best = None
        cached: Dict[ReplicaHandle, int] = {}
        if self.affinity:
            cached = self._probe_affinity(req, live)
            best_cached = 0
            for h in live:
                ncached = cached.get(h, 0)
                if ncached > best_cached or (
                        ncached == best_cached and ncached > 0
                        and best is not None and h.load < best.load):
                    best, best_cached = h, ncached
            if best is None and req.session is not None:
                # session stickiness covers the window before the
                # session's first turn has committed any block (and
                # prompts shorter than a page, which never index)
                sticky = self._sessions.get(req.session)
                if sticky is not None and sticky.live \
                        and sticky in live:
                    best = sticky
        if best is not None and \
                self.affinity_max_inflight_factor is not None:
            lmin = min(h.load for h in live)
            if best.load + 1 > \
                    self.affinity_max_inflight_factor * (lmin + 1):
                best = None     # headroom blown — spread the load
        if best is None:
            best = min(live, key=lambda h: (h.load, h.idx))
        best_cached = cached.get(best, 0)
        self.stats["affinity_hit_tokens"] += best_cached
        self.stats["affinity_miss_tokens"] += \
            len(req.prompt) - best_cached
        if _om._ENABLED:
            am = _metrics()["affinity"]
            if best_cached:
                am.labels(outcome="hit").inc(best_cached)
            am.labels(outcome="miss").inc(
                len(req.prompt) - best_cached)
        return best

    def _dispatch(self, req: _RoutedRequest) -> None:
        """Route + hand the request to a replica engine, carrying the
        request's original trace identity and enqueue timestamp."""
        h = self._route(req)
        deadline_s = None
        if req.deadline_abs is not None:
            deadline_s = req.deadline_abs - self._now()
            if deadline_s <= 0:
                # expired while bouncing between replicas — terminal
                self._terminal(req.rid, req.prompt, "deadline",
                               "deadline expired during failover",
                               req=req)
                return
        try:
            # the 4th obs_carry element marks a RE-serve: a prior
            # replica already prefilled this context, so the new
            # life's prefill charges to the TTFT budget's
            # affinity_miss component (see llm_engine.add_request)
            h.engine.add_request(
                req.rid, req.prompt, req.max_new,
                deadline_s=deadline_s,
                obs_carry=(req.trace_id, req.root_span, req.t_enq,
                           req.attempts > 0),
                prefix_hashes=req.hashes)
        except ReplicaGone as e:
            # the peer vanished between routing and admission (a
            # process-backed replica died) — trip the breaker and
            # re-dispatch through whoever is left; _fail_replica's
            # reroute drains pending, so park the request there first
            self._pending.appendleft(req)
            self._fail_replica(h, e)
            return
        except Exception as e:
            # infeasible for every identically-provisioned replica
            # (over model len / over pool) — shed, don't crash.
            # (A shed_load=True engine rejects without raising; its
            # "rejected" result flows back through _collect instead.)
            return self._shed(req.rid, req.prompt, "infeasible",
                              f"{type(e).__name__}: {e}", req=req)
        req.attempts += 1
        req.t_dispatch = time.perf_counter()
        h.inflight[req.rid] = req
        self._owner[req.rid] = h
        if req.session is not None:
            self._sessions[req.session] = h
            self._sessions.move_to_end(req.session)
            while len(self._sessions) > self._session_cap:
                self._sessions.popitem(last=False)
        self.stats["routed"] += 1

    def _drain_pending(self) -> None:
        while self._pending and self.replicas.live():
            self._dispatch(self._pending.popleft())

    # -- health / failover -------------------------------------------------
    def _trip(self, h: ReplicaHandle, cause: str) -> None:
        """Open the replica's circuit breaker: bounded exponential
        backoff per consecutive trip (a clean probation resets it)."""
        h.trips += 1
        h.cooldown_s = (self.cooldown_s if h.cooldown_s == 0
                        else min(h.cooldown_s * self.cooldown_factor,
                                 self.max_cooldown_s))
        h.cooldown_until = self._now() + h.cooldown_s
        h.state = "dead"
        h.probation_left = 0
        self.stats["failovers"] += 1
        if _om._ENABLED:
            _metrics()["failovers"].labels(cause=cause).inc()
        if _ot._ENABLED:
            _ot.add_event(
                "router.failover", time.perf_counter() * 1e6, 0.0,
                args={"replica": h.name, "cause": cause,
                      "cooldown_s": h.cooldown_s,
                      "victims": len(h.inflight)})

    def _reroute(self, victims: List[_RoutedRequest]) -> None:
        """Re-serve failed-over requests from their ORIGINAL prompts
        on surviving replicas (partial outputs from the dead replica
        are discarded — greedy decoding re-derives them exactly; the
        survivor's prefix cache may shortcut the re-prefill)."""
        for req in victims:
            self._owner.pop(req.rid, None)
            if req.cancelled:
                # router.abort() raced the failure: the engine-side
                # aborted result is lost with the replica, so finish
                # the cancellation here — never re-serve it
                self._terminal(req.rid, req.prompt, "aborted",
                               "aborted; replica lost before the "
                               "abort surfaced", req=req)
                continue
            if req.attempts >= self.max_serve_attempts:
                self._shed(req.rid, req.prompt, "exhausted",
                           f"{req.attempts} serve attempts all lost "
                           "their replica", req=req)
                continue
            self.stats["reroutes"] += 1
            if _om._ENABLED:
                _metrics()["reroutes"].inc()
            if _ot._ENABLED and req.trace_id is not None:
                _ot.add_event(
                    "router.reroute", time.perf_counter() * 1e6, 0.0,
                    trace=(req.trace_id, _ot.new_span_id(),
                           req.root_span),
                    args={"request_id": str(req.rid),
                          "attempt": req.attempts})
            self._pending.append(req)
        self._drain_pending()

    def _fail_replica(self, h: ReplicaHandle, exc: Exception) -> None:
        """Crash-grade failure: the step raised. The engine state is
        unknowable (a launch may have half-written the pools, a device call
        wedged) — discard it like the dead process it models and
        re-serve its in-flight elsewhere."""
        cause = "gone" if isinstance(exc, ReplicaGone) else "exception"
        victims = list(h.inflight.values())
        h.inflight.clear()
        h.engine = None
        h.drained.clear()       # stale aborts died with the engine
        self._trip(h, cause)
        self._reroute(victims)

    def _quarantine_slow(self, h: ReplicaHandle, dt: float) -> None:
        """Health-check failure: the step completed but took too long
        (hung launch, thrashing host). The engine is alive, so its
        in-flight requests are DRAINED through abort_request — leased
        pages return, shareable prefix blocks park — and the warm
        engine is kept for reintegration after cooldown."""
        victims = list(h.inflight.values())
        for req in victims:
            try:
                h.engine.abort_request(req.rid)
                # marked stale regardless of the abort's return: a
                # False means the engine already holds a terminal
                # result for this rid in its _failed queue (e.g. a
                # shed_load rejection) — that result is just as stale
                # as a drain-abort once the request re-serves
                h.drained.add(req.rid)
            except Exception:
                # draining is best-effort: the breaker is tripping
                # regardless, and a refusing engine gets no more work
                pass
        h.inflight.clear()
        self._trip(h, "slow_step")
        self._reroute(victims)

    def _reintegrate(self, h: ReplicaHandle) -> None:
        h.restart()
        h.state = "probation"
        h.probation_left = self.probation_steps
        h.probation_fresh = True

    # -- elastic scaling (the autoscaler's actuator surface) ---------------
    def add_replica(self, engine_factory=None) -> str:
        """Grow the fleet by one replica (fresh engine from the
        factory — a cold cache, like a reintegrated crash; or from
        `engine_factory` when the caller pre-provisioned the engine,
        see ReplicaSet.add). Returns the new replica's name. Pending
        failover victims drain onto it immediately."""
        h = self.replicas.add(engine_factory)
        self.stats["grown"] += 1
        if _ot._ENABLED:
            _ot.add_event(
                "router.scale", time.perf_counter() * 1e6, 0.0,
                args={"action": "grow", "replica": h.name,
                      "replicas": len(self.replicas)})
        self._drain_pending()
        self._update_gauges()
        return h.name

    def retire_replica(self, name: Optional[str] = None
                       ) -> Optional[str]:
        """Shrink the fleet by one replica (elastic scale-down):
        in-flight requests are DRAINED through abort_request and
        re-served on the survivors (the quarantine idiom — pages were
        going away with the engine regardless), a process-backed
        engine's `shutdown()` is called so the OS process exits, and
        the retired replica's gauges zero so exports stop naming it.
        Picks the least-loaded live replica (newest on ties — older
        replicas hold the warmer prefix caches) unless `name` says
        otherwise. Refuses (returns None) when retirement would leave
        no live replica; returns the retired name otherwise."""
        live = self.replicas.live()
        if name is not None:
            h = next((x for x in self.replicas if x.name == name),
                     None)
            if h is None:
                return None
        elif live:
            h = min(live, key=lambda x: (x.load, -x.idx))
        elif len(self.replicas) > 1:
            # no live replica — retire a cooling-down dead one; it
            # has no engine and no inflight, so this is bookkeeping
            h = max(self.replicas.handles, key=lambda x: x.idx)
        else:
            return None
        if h.live and len([x for x in live if x is not h]) == 0:
            return None     # never retire the last serving replica
        victims = list(h.inflight.values())
        if h.engine is not None:
            for req in victims:
                try:
                    h.engine.abort_request(req.rid)
                except Exception:
                    pass    # best-effort: the engine is going away
            shutdown = getattr(h.engine, "shutdown", None)
            if callable(shutdown):
                try:
                    shutdown()
                except Exception:
                    pass
        h.inflight.clear()
        h.engine = None
        h.state = "dead"    # stale session stickiness sees not-live
        h.drained.clear()
        self.replicas.remove(h)
        self._retired_replica_s += time.monotonic() - h.t_added
        self.stats["retired"] += 1
        if _om._ENABLED:
            m = _metrics()
            for state in ("healthy", "probation", "dead"):
                m["state"].labels(replica=h.name, state=state).set(0.0)
            m["inflight"].labels(replica=h.name).set(0)
        if _ot._ENABLED:
            _ot.add_event(
                "router.scale", time.perf_counter() * 1e6, 0.0,
                args={"action": "retire", "replica": h.name,
                      "replicas": len(self.replicas),
                      "victims": len(victims)})
        self._reroute(victims)
        self._update_gauges()
        return h.name

    def replica_seconds(self) -> float:
        """Cumulative replica-alive seconds across the router's
        lifetime (retired replicas included) — the capacity cost an
        elastic fleet is trying to minimize; the traffic bench
        compares this against a static max-size fleet at equal work."""
        now = time.monotonic()
        return self._retired_replica_s + sum(
            now - h.t_added for h in self.replicas)

    # -- fleet stepping ----------------------------------------------------
    def _step_replicas(self, steppable):
        """Step every replica that has work; CONCURRENTLY when every
        engine declares `concurrent_step_safe` (process-backed
        replicas: the router thread only waits on a socket while the
        worker computes in its own process, so N replicas genuinely
        overlap — stepped sequentially, the whole fleet's compute
        would serialize through this one thread and fleet size would
        add batch slots but no throughput). In-process engines share
        this thread's devices, so they keep the sequential path.
        Returns [(handle, results, step_seconds, compiled, error)];
        all POLICY (failover, quarantine, collection) stays with the
        caller on the router thread."""
        def one(h):
            # steps that captured a new graph (the engine's `_fns`) are
            # exempt from the latency health check: a capture is seconds
            # of legitimate one-time work, and quarantining every
            # replica on its first bucket would melt a cold fleet
            fns = getattr(h.engine, "_fns", None)
            n_fns = len(fns) if fns is not None else -1
            t0 = time.perf_counter()
            try:
                faults.fault_point("router.replica.step",
                                   replica=h.name)
                results = h.engine.step()
            except Exception as e:
                return (h, None, time.perf_counter() - t0, False, e)
            dt = time.perf_counter() - t0
            compiled = fns is not None and len(fns) != n_fns
            return (h, results, dt, compiled, None)

        if len(steppable) > 1 and all(
                getattr(h.engine, "concurrent_step_safe", False)
                for h in steppable):
            import concurrent.futures as _cf
            if self._step_pool is None or \
                    self._step_pool._max_workers < len(steppable):
                if self._step_pool is not None:
                    self._step_pool.shutdown(wait=False)
                self._step_pool = _cf.ThreadPoolExecutor(
                    max_workers=max(4, len(steppable)),
                    thread_name_prefix="router-step")
            return list(self._step_pool.map(one, steppable))
        return [one(h) for h in steppable]

    # -- result plumbing ---------------------------------------------------
    def _collect(self, h: ReplicaHandle, results, finished) -> None:
        for r in results:
            if r.request_id in h.drained:
                # stale: a quarantine-drained request's terminal
                # result (abort, or a pre-drain shed_load rejection)
                # surfacing on the kept engine — the request was
                # re-served elsewhere (and may even be queued HERE
                # again, so this must be consumed before the inflight
                # lookup; the engine drains its _failed queue first,
                # so the stale result always surfaces before any
                # re-dispatched copy's real one)
                h.drained.discard(r.request_id)
                continue
            req = h.inflight.pop(r.request_id, None)
            if req is None:
                continue
            self._owner.pop(r.request_id, None)
            # service-rate EMA for the SLO shed estimate: time from
            # the replica HAND-OFF, not from enqueue — an e2e read
            # would already contain the queue wait and make the
            # backlog * rate estimate quadratic in the backlog. Only
            # SUCCESSFUL requests count (same rule as the e2e/TPOT
            # SLO observations): a burst of near-instant aborted or
            # rejected results would collapse the EMA and disable
            # the slo_ttft_s protection exactly when it matters
            if r.ok:
                served = time.perf_counter() - req.t_dispatch
                if self._ema_serve_s is None:
                    self._ema_serve_s = served
                else:
                    self._ema_serve_s += 0.2 * (
                        served - self._ema_serve_s)
            finished.append(r)

    def _update_gauges(self) -> None:
        if not _om._ENABLED:
            return
        m = _metrics()
        for h in self.replicas:
            for state in ("healthy", "probation", "dead"):
                m["state"].labels(replica=h.name, state=state).set(
                    1.0 if h.state == state else 0.0)
            m["inflight"].labels(replica=h.name).set(h.load)

    # -- main loop ---------------------------------------------------------
    @property
    def has_unfinished(self) -> bool:
        return (bool(self._results) or bool(self._pending)
                or bool(self._owner))

    def abort(self, request_id) -> bool:
        """Cancel a request wherever it is: pending re-route queue or
        routed to a replica (the replica's aborted result flows back
        on a later step). The request is flagged cancelled so a
        replica failure racing the abort can never resurrect it
        through failover."""
        for req in self._pending:
            if req.rid == request_id:
                self._pending.remove(req)
                self._terminal(req.rid, req.prompt, "aborted",
                               "aborted while awaiting re-route",
                               req=req)
                return True
        h = self._owner.get(request_id)
        if h is not None and h.engine is not None and \
                h.engine.abort_request(request_id):
            h.inflight[request_id].cancelled = True
            return True
        return False

    def step(self) -> List[GenerationResult]:
        """One fleet scheduling pass: reintegrate cooled-down
        replicas, re-dispatch pending failover victims, step every
        live replica that has work (failing over on error), and
        return every request that reached a terminal state."""
        finished: List[GenerationResult] = []
        if self._results:
            finished.extend(self._results)
            self._results.clear()
        with _ot.span("router.step", replicas=len(self.replicas)):
            now = self._now()
            for h in self.replicas:
                if h.state == "dead" and now >= h.cooldown_until:
                    self._reintegrate(h)
            self._drain_pending()
            steppable = [h for h in self.replicas
                         if h.live and h.inflight
                         and h.engine.has_unfinished]
            for h, results, dt, compiled, err in \
                    self._step_replicas(steppable):
                if err is not None:
                    self._fail_replica(h, err)
                    continue
                h.last_step_s = dt
                self._collect(h, results, finished)
                if self.unhealthy_step_s is not None \
                        and not compiled \
                        and dt > self.unhealthy_step_s:
                    self._quarantine_slow(h, dt)
            # probation burns down on every SURVIVED pass, idle or
            # not — an idle reintegrated replica cannot fail, and
            # leaving it in probation forever would make an unrelated
            # failure hours later read as a consecutive breaker trip
            # (doubled backoff). A failure this pass set state="dead"
            # above, so it never reaches here.
            for h in self.replicas:
                if h.state != "probation":
                    continue
                if h.probation_fresh:
                    h.probation_fresh = False   # first pass: observe
                    continue
                h.probation_left -= 1
                if h.probation_left <= 0:
                    h.state = "healthy"
                    h.cooldown_s = 0.0
            if self._results:       # terminal results made this pass
                finished.extend(self._results)
                self._results.clear()
        self._update_gauges()
        return finished

    def generate(self, prompts, max_new_tokens: int = 32
                 ) -> List[GenerationResult]:
        """Convenience driver: submit all prompts, run the fleet to
        completion, return results in submission order (shed requests
        included — check `.ok`)."""
        for i, p in enumerate(prompts):
            self.submit(i, p, max_new_tokens)
        done: Dict[object, GenerationResult] = {}
        while self.has_unfinished:
            for r in self.step():
                done[r.request_id] = r
        return [done[i] for i in range(len(prompts))]
