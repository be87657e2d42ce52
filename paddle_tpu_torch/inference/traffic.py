"""Heavy-tailed many-user serving traffic: the load shape production
fleets actually see, as a deterministic generator + driver (counterpart
of paddle_tpu/inference/traffic.py; host numpy, the same events for the
same seed).

Uniform prompt sweeps exercise the engine,
not the fleet: real traffic is bursty (on/off arrival phases on top of
Poisson), heavy-tailed (a few huge prompts and long generations under
a mass of small ones), session-shaped (multi-turn conversations whose
turns share a growing prefix, routed sticky by the Router's affinity)
and churning (sessions die, new ones arrive). `TrafficModel` produces
exactly that, statelessly: a **million-session id space** costs O(1)
memory because everything about a session — its cohort, its stable
context, its per-turn tails — is DERIVED by seeding a generator with
(seed, cohort, session, turn), never stored. Only the small active-
reuse window (which sessions are mid-conversation) is state, and it
is LRU-bounded like the router's session map.

Cohorts model user populations: each has a shared token prefix (the
"system prompt" every member re-hits), a lognormal body/output length
distribution (the heavy tail), and a mean turn count (session churn).
`run_traffic` drives the events against a `Router` in wall-clock
time, optionally scanning an `Autoscaler` between fleet steps, and
reports per-cohort accounting — affinity hit-token fraction (exact:
read as the router's counter delta around each submit), shed rate,
e2e percentiles — plus the fleet-level numbers the traffic bench
ships to the BENCH line and perf ledger."""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = ["Cohort", "TrafficEvent", "TrafficModel", "run_traffic",
           "DEFAULT_COHORTS"]


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One user population in the mix."""
    name: str
    weight: float           # share of arrivals
    prefix_len: int         # shared cohort prefix (system prompt) tokens
    body_mu: float          # lognormal(log-mean) of per-session body len
    body_sigma: float       # lognormal log-std — the heavy tail
    out_mu: float           # lognormal(log-mean) of output tokens
    out_sigma: float
    mean_turns: float       # geometric mean turns before churn


# a chat-heavy mix with a long-tail batch cohort — sized for the tiny
# CPU bench models (lengths are clipped by the driver to the engine's
# feasible range)
DEFAULT_COHORTS = (
    Cohort("chat", weight=0.7, prefix_len=24, body_mu=2.2,
           body_sigma=0.6, out_mu=2.2, out_sigma=0.5, mean_turns=3.0),
    Cohort("api", weight=0.25, prefix_len=8, body_mu=2.8,
           body_sigma=0.4, out_mu=1.6, out_sigma=0.4, mean_turns=1.2),
    Cohort("batch", weight=0.05, prefix_len=4, body_mu=3.4,
           body_sigma=0.9, out_mu=2.9, out_sigma=0.7, mean_turns=1.0),
)


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    t: float                # arrival offset from run start (seconds)
    rid: object
    session: int
    cohort: str
    turn: int
    prompt: np.ndarray      # int32 tokens
    max_new: int


class TrafficModel:
    """Deterministic event-stream generator (same seed -> identical
    schedule, the property the A/B bench comparison rests on).

    Arrivals are an on/off modulated Poisson process: `base_rate`
    req/s during off (calm) phases, `burst_rate` during on phases,
    phases alternating every `off_s`/`on_s` seconds — the load shape
    that makes elastic scaling pay. `n_sessions` bounds the session
    id space; `reuse` is the probability an arrival continues a
    recent session (next turn, shared prefix grows) instead of
    starting a fresh one."""

    def __init__(self, *, cohorts=DEFAULT_COHORTS, seed: int = 0,
                 n_sessions: int = 1_000_000, vocab: int = 1000,
                 base_rate: float = 4.0, burst_rate: float = 20.0,
                 off_s: float = 4.0, on_s: float = 2.0,
                 reuse: float = 0.5, min_body: int = 4,
                 max_body: int = 96, min_out: int = 2,
                 max_out: int = 48, active_window: int = 512):
        self.cohorts = tuple(cohorts)
        self.seed = int(seed)
        self.n_sessions = int(n_sessions)
        self.vocab = int(vocab)
        self.base_rate = float(base_rate)
        self.burst_rate = float(burst_rate)
        self.off_s = float(off_s)
        self.on_s = float(on_s)
        self.reuse = float(reuse)
        self.min_body, self.max_body = int(min_body), int(max_body)
        self.min_out, self.max_out = int(min_out), int(max_out)
        self._active_cap = int(active_window)
        # host-side scheduling math, no device tensors involved
        w = np.asarray([c.weight for c in self.cohorts],
                       np.float64)
        self._cum_w = np.cumsum(w / w.sum())
        # cohort prefixes: derived once, shared by every member
        self._prefixes = [
            self._rng("prefix", i).integers(
                0, self.vocab, (c.prefix_len,)).astype(np.int32)
            for i, c in enumerate(self.cohorts)]

    def _rng(self, *key) -> np.random.Generator:
        # a distinct, deterministic stream per derivation key — the
        # stateless-session trick: nothing per-session is ever stored.
        # blake2s, NOT hash(): builtin string hashing is randomized
        # per process, and the A/B bench comparison needs the same
        # seed to mean the same schedule in every process
        digest = hashlib.blake2s(
            repr((self.seed,) + key).encode(), digest_size=8).digest()
        return np.random.default_rng(int.from_bytes(digest, "little"))

    def _lengths(self, ci: int, session: int, turn: int):
        c = self.cohorts[ci]
        r = self._rng("len", ci, session, turn)
        body = int(np.clip(r.lognormal(c.body_mu, c.body_sigma),
                           self.min_body, self.max_body))
        out = int(np.clip(r.lognormal(c.out_mu, c.out_sigma),
                          self.min_out, self.max_out))
        return body, out

    def prompt(self, ci: int, session: int, turn: int) -> np.ndarray:
        """The session's turn-`turn` prompt: cohort shared prefix +
        the session's stable context + per-turn tails of every turn
        so far — so turn t+1 extends turn t's tokens exactly, and
        affinity routing re-hits the whole conversation."""
        body, _out = self._lengths(ci, session, 0)
        stable = self._rng("body", ci, session).integers(
            0, self.vocab, (body,)).astype(np.int32)
        parts = [self._prefixes[ci], stable]
        for t in range(1, turn + 1):
            tb, _o = self._lengths(ci, session, t)
            parts.append(self._rng("turn", ci, session, t).integers(
                0, self.vocab, (max(2, tb // 4),)).astype(np.int32))
        return np.concatenate(parts)

    def events(self, n: int) -> Iterator[TrafficEvent]:
        """Yield `n` arrivals in time order."""
        rng = self._rng("arrivals")
        # active multi-turn sessions, LRU-bounded: session -> (ci, turn)
        active: "OrderedDict[int, tuple]" = OrderedDict()
        t = 0.0
        period = self.off_s + self.on_s
        for i in range(n):
            in_burst = (t % period) >= self.off_s
            rate = self.burst_rate if in_burst else self.base_rate
            t += rng.exponential(1.0 / rate)
            if active and rng.random() < self.reuse:
                # continue a recent conversation (most recent first —
                # the recency bias real session traffic has)
                k = min(len(active) - 1,
                        int(rng.geometric(0.5)) - 1)
                session = list(active)[-1 - k]
                ci, turn = active[session]
                turn += 1
                # churn: the conversation ends after ~mean_turns
                if turn + 1 >= self.cohorts[ci].mean_turns * 2 or \
                        rng.random() < 1.0 / max(
                            self.cohorts[ci].mean_turns, 1.0):
                    active.pop(session, None)
                else:
                    active[session] = (ci, turn)
                    active.move_to_end(session)
            else:
                ci = int(np.searchsorted(self._cum_w, rng.random(),
                                         side="left"))
                session = int(rng.integers(self.n_sessions))
                turn = 0
                if self.cohorts[ci].mean_turns > 1.0:
                    active[session] = (ci, turn)
                    while len(active) > self._active_cap:
                        active.popitem(last=False)
            _body, out = self._lengths(ci, session, turn)
            yield TrafficEvent(
                t=t, rid=f"r{i}", session=session,
                cohort=self.cohorts[ci].name, turn=turn,
                prompt=self.prompt(ci, session, turn), max_new=out)


def _pctl(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    # host-side latency lists, no device tensors involved
    return float(np.percentile(np.asarray(xs, np.float64), q))


def run_traffic(router, events, *, autoscaler=None,
                scan_every_s: float = 0.25,
                time_scale: float = 1.0,
                max_prompt: Optional[int] = None) -> dict:
    """Drive an event stream against a Router in wall-clock time:
    arrivals are submitted when their (time_scale-compressed)
    timestamps come due, the fleet steps continuously, and the
    optional autoscaler scans on its own cadence between steps.
    Returns the accounting report: per-cohort {submitted, ok, shed,
    hit/miss affinity tokens, e2e percentiles} + fleet totals.

    time_scale < 1 compresses the schedule (a 20s trace in 10s of
    wall time doubles every rate); max_prompt truncates prompts to
    the fleet's feasible context (clipping, not shedding — the tail
    stays heavy up to the cap)."""
    evs = list(events)
    evs.sort(key=lambda e: e.t)
    stats = router.stats
    per: Dict[str, dict] = {}

    def cohort_slot(name):
        s = per.get(name)
        if s is None:
            s = per[name] = dict(submitted=0, ok=0, shed=0, failed=0,
                                 hit_tokens=0, miss_tokens=0, e2e=[])
        return s

    inflight: Dict[object, tuple] = {}      # rid -> (cohort, t_submit)
    t0 = time.perf_counter()
    last_scan = 0.0
    i = 0
    steps = 0
    while i < len(evs) or router.has_unfinished or inflight:
        now = time.perf_counter() - t0
        while i < len(evs) and evs[i].t * time_scale <= now:
            ev = evs[i]
            i += 1
            prompt = ev.prompt
            if max_prompt is not None and len(prompt) > max_prompt:
                prompt = prompt[:max_prompt]
            s = cohort_slot(ev.cohort)
            s["submitted"] += 1
            h0 = stats["affinity_hit_tokens"]
            m0 = stats["affinity_miss_tokens"]
            router.submit(ev.rid, prompt, max_new_tokens=ev.max_new,
                          session_id=ev.session)
            # exact per-request affinity attribution: submit() routes
            # synchronously, so the counter delta is this request's
            # (failover re-routes happen inside step(), outside this
            # window, and cannot be misattributed here)
            s["hit_tokens"] += stats["affinity_hit_tokens"] - h0
            s["miss_tokens"] += stats["affinity_miss_tokens"] - m0
            inflight[ev.rid] = (ev.cohort, time.perf_counter())
        for r in router.step():
            rec = inflight.pop(r.request_id, None)
            if rec is None:
                continue
            cohort, t_sub = rec
            s = cohort_slot(cohort)
            if r.ok:
                s["ok"] += 1
                s["e2e"].append(time.perf_counter() - t_sub)
            elif r.finish_reason == "rejected":
                s["shed"] += 1
            else:
                s["failed"] += 1
        steps += 1
        now = time.perf_counter() - t0
        if autoscaler is not None and \
                now - last_scan >= scan_every_s:
            autoscaler.scan()
            last_scan = now
        if i < len(evs) and not router.has_unfinished:
            # idle until the next arrival (bounded nap so the
            # autoscaler cadence keeps running through lulls)
            wait = evs[i].t * time_scale - now
            if wait > 0:
                time.sleep(min(wait, scan_every_s))
    wall = time.perf_counter() - t0
    report = {
        "cohorts": {}, "wall_s": wall, "steps": steps,
        "submitted": 0, "ok": 0, "shed": 0, "failed": 0,
    }
    for name, s in sorted(per.items()):
        tok = s["hit_tokens"] + s["miss_tokens"]
        report["cohorts"][name] = {
            "submitted": s["submitted"], "ok": s["ok"],
            "shed": s["shed"], "failed": s["failed"],
            "shed_rate": s["shed"] / max(s["submitted"], 1),
            "hit_token_fraction": s["hit_tokens"] / tok if tok else 0.0,
            "e2e_p50_s": _pctl(s["e2e"], 50),
            "e2e_p95_s": _pctl(s["e2e"], 95),
        }
        for k in ("submitted", "ok", "shed", "failed"):
            report[k] += s[k]
    report["req_per_s"] = report["ok"] / wall if wall > 0 else 0.0
    report["shed_rate"] = report["shed"] / max(report["submitted"], 1)
    if hasattr(router, "replica_seconds"):
        report["replica_seconds"] = router.replica_seconds()
    if autoscaler is not None:
        report["decisions"] = [
            {k: d[k] for k in ("seq", "action", "replica",
                               "replicas_before", "replicas_after")}
            for d in autoscaler.decisions]
    return report
