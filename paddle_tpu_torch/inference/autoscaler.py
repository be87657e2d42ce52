"""SLO-driven elastic autoscaler for the replicated serving fleet
(counterpart of paddle_tpu/inference/autoscaler.py).

The supervisor-style controller that closes the fleet's loop:
the fleet's request telemetry (TTFT/TPOT/e2e histograms riding
FleetAgent bundles, merged per process by the aggregator) feeds
declarative fleet SLOs (`observability.slo_fleet.FleetSLOMonitor`),
and this controller turns the verdicts into replica-count changes —
growing through the Router's `add_replica()` (which invokes the same
`process_engine_factory` the launcher used, so a grown replica is a
real OS process on a process fleet) and retiring through
`retire_replica()` (drain + re-serve + process shutdown)::

    mon = slo_fleet.FleetSLOMonitor(agg, rules=[...])
    asc = Autoscaler(RouterActuator(router), mon,
                     min_replicas=1, max_replicas=4,
                     journal_path="scale.jsonl")
    ...
    asc.scan()          # on the serving loop's cadence

Design rules, each load-bearing:

* **Inputs are the observability plane only.** The policy reads the
  fleet SLO verdicts and the per-process capacity gauges
  (`paddle_tpu_fleet_capacity_req_per_s`) — never the router's
  internals. What the operator can see is exactly what the controller
  acts on, so every decision is explainable from the exported series.
* **Hysteresis + cooldown, so steady load means zero decisions.** A
  grow needs `grow_after` consecutive breached scans, a retire needs
  `retire_after` consecutive comfortable scans (every rule attained
  at least `retire_margin` above its objective, with real samples),
  and any decision opens a `cooldown_scans` window in which the
  controller only observes. A steady-state fleet meeting its SLOs
  produces no decisions, no journal entries, no bundles.
* **Journal pending-before-act** (the supervisor idiom): the
  decision record is appended to the journal with state="pending" and
  flushed BEFORE the actuator runs, then appended again as
  state="committed" — a controller crash mid-action leaves the intent
  on disk for the operator, never a silent half-scaled fleet.
* **One `autoscale_decision` flight bundle per committed decision**,
  its meta naming the triggering metric series, threshold and
  observed values — the postmortem artifact for "why did the fleet
  grow at 3am".
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from ..observability import metrics as _m

__all__ = ["Autoscaler", "RouterActuator", "SCALE_ACTIONS"]

# the closed action vocabulary (README "Serving SLO control plane"
# documents each)
SCALE_ACTIONS = ("grow", "retire")


class RouterActuator:
    """Actuator over a `Router` (in-process replicas or a
    process-backed fleet via `process_engine_factory` — the router's
    elastic surface is transport-agnostic)."""

    def __init__(self, router):
        self.router = router

    def grow(self) -> Optional[str]:
        return self.router.add_replica()

    def retire(self) -> Optional[str]:
        return self.router.retire_replica()

    def replicas(self) -> int:
        return len(self.router.replicas)


class Autoscaler:
    """The scan-driven policy loop. `actuator`: anything with the
    RouterActuator surface (grow/retire/replicas). `monitor`: a
    `FleetSLOMonitor` — its windowed verdicts are the breach signal
    and its registry hosts the capacity gauges and this controller's
    own series."""

    def __init__(self, actuator, monitor, *,
                 min_replicas: int = 1, max_replicas: int = 8,
                 grow_after: int = 1, retire_after: int = 3,
                 retire_margin: float = 0.02, cooldown_scans: int = 2,
                 journal_path: Optional[str] = None):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        self.actuator = actuator
        self.monitor = monitor
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.grow_after = max(1, int(grow_after))
        self.retire_after = max(1, int(retire_after))
        self.retire_margin = float(retire_margin)
        self.cooldown_scans = max(0, int(cooldown_scans))
        self.journal_path = journal_path
        self.decisions: List[dict] = []     # committed, in order
        self._lock = threading.Lock()
        self._breach_streak = 0
        self._calm_streak = 0
        self._cooldown_left = 0
        self._seq = 0
        r = monitor.registry
        self._h = {
            "replicas": r.gauge(
                "paddle_tpu_autoscaler_replicas",
                "replica count after the autoscaler's last scan — the "
                "fleet size the SLO-driven controller is holding"),
            "decisions": r.counter(
                "paddle_tpu_autoscaler_decisions_total",
                "committed scale decisions by action (grow = replica "
                "added through the router's engine factory, retire = "
                "replica drained and shut down); a steady-load run "
                "counts zero",
                ("action",)),
            "last": r.gauge(
                "paddle_tpu_autoscaler_last_decision",
                "one-hot marker on the most recently committed scale "
                "action (1 on the latest, 0 elsewhere) — the obs_top "
                "slo panel's 'last decision' readout",
                ("action",)),
        }

    # -- observability-plane reads ----------------------------------------
    def _capacity(self) -> dict:
        """{process: req/s} from the aggregator's capacity gauges —
        the per-role capacity input the policy and every decision
        record carry (empty on a registry with no fleet plane)."""
        g = self.monitor.registry.get(
            "paddle_tpu_fleet_capacity_req_per_s")
        if g is None:
            return {}
        return {key[0]: child._value for key, child in g._series()
                if child._value}

    # -- the scan ----------------------------------------------------------
    def scan(self) -> Optional[dict]:
        """One policy pass: evaluate the fleet SLOs, update the
        hysteresis streaks, and commit at most ONE scale decision.
        Returns the committed decision record (None when the scan
        only observed)."""
        results = self.monitor.evaluate()
        breached = [res for res in results if not res.ok]
        # "comfortable" needs real evidence: every rule ok, and at
        # least one with samples clearing the retire margin — an idle
        # window (all vacuous) is absence of load, which DOES justify
        # retiring, so vacuous-only windows count as calm too
        comfortable = not breached and all(
            res.attained is None
            or res.attained >= res.objective + self.retire_margin
            for res in results)
        with self._lock:
            if breached:
                self._breach_streak += 1
                self._calm_streak = 0
            elif comfortable:
                self._calm_streak += 1
                self._breach_streak = 0
            else:
                self._breach_streak = 0
                self._calm_streak = 0
            if self._cooldown_left > 0:
                self._cooldown_left -= 1
                self._publish()
                return None
            n = self.actuator.replicas()
            decision = None
            if breached and self._breach_streak >= self.grow_after \
                    and n < self.max_replicas:
                worst = min(breached,
                            key=lambda res: res.attained
                            if res.attained is not None else 0.0)
                decision = self._decide("grow", n, trigger={
                    "series": worst.metric, "slo": worst.name,
                    "threshold_s": worst.threshold_s,
                    "objective": worst.objective,
                    "attained": worst.attained,
                    "count": worst.count,
                    "per_process": dict(worst.per_process),
                    "worst_process": worst.worst_process})
            elif comfortable and \
                    self._calm_streak >= self.retire_after \
                    and n > self.min_replicas:
                decision = self._decide("retire", n, trigger={
                    "series": "paddle_tpu_slo_attained_fraction",
                    "retire_margin": self.retire_margin,
                    "attained": {res.name: res.attained
                                 for res in results},
                    "objective": {res.name: res.objective
                                  for res in results}})
            self._publish()
        if decision is not None:
            from ..observability import flight as _fl
            if _fl._ARMED:      # bundle I/O outside the lock
                _fl.trigger("autoscale_decision", detail=decision)
        return decision

    def _decide(self, action: str, n: int, trigger: dict
                ) -> Optional[dict]:
        """Journal (pending) -> actuate -> journal (committed). Holds
        the policy lock — decisions are strictly serialized."""
        self._seq += 1
        rec = {
            "seq": self._seq, "action": action, "t": time.time(),
            "replicas_before": n, "trigger": trigger,
            "capacity_req_per_s": self._capacity(),
        }
        self._journal(dict(rec, state="pending"))
        if action == "grow":
            # role-aware actuators (inference.disagg) expose grow_for
            # and route the decision by the breached series — TTFT
            # breaches grow the prefill pool, TPOT the decode pool
            grow_for = getattr(self.actuator, "grow_for", None)
            name = grow_for(trigger) if callable(grow_for) \
                else self.actuator.grow()
        else:
            name = self.actuator.retire()
        if name is None:
            # the actuator refused (e.g. retiring would strand the
            # last live replica) — journal the abort so the intent
            # and its fate both survive, but no decision committed
            self._journal(dict(rec, state="aborted"))
            return None
        rec["replica"] = name
        rec["replicas_after"] = self.actuator.replicas()
        self._journal(dict(rec, state="committed"))
        self.decisions.append(rec)
        self._breach_streak = 0
        self._calm_streak = 0
        self._cooldown_left = self.cooldown_scans
        # control-plane accounting bypasses the hot-path flag (the
        # supervisor/_bump precedent)
        self._h["decisions"].labels(action=action)._value += 1
        for a in SCALE_ACTIONS:
            self._h["last"].labels(action=a)._value = \
                1.0 if a == action else 0.0
        return rec

    def _publish(self) -> None:
        self._h["replicas"]._require_default()._value = \
            float(self.actuator.replicas())

    def _journal(self, rec: dict) -> None:
        if self.journal_path is None:
            return
        d = os.path.dirname(self.journal_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.journal_path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
