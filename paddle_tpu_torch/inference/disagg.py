"""Prefill/decode disaggregation: role-based replica pools with
cross-process KV-page migration (counterpart of
paddle_tpu/inference/disagg.py, the same policy).

A role-less fleet makes every replica pay both halves of the serving
workload on the same chips: the compute-bound ragged prefill and the
HBM-bandwidth-bound decode loop. Disaggregated serving (the
ragged-paged-attention paper's deployment shape) splits them — the
`DisaggRouter` partitions its ReplicaSet into a **prefill** pool and a
**decode** pool, admits every request to the prefill pool first, and
hands the sequence off once its prefix blocks are committed. Two
handoff rungs, tried in order:

* **KV-page migration** (the real rung): the committed
  content-addressed pages are serialized out of the prefill replica's
  `PagedKVCache` (`LLMEngine.export_kv_pages` — page bytes + chained
  hash + dtype/int8-scale metadata), shipped over the existing replica
  RPC in sequence-numbered chunks (`payload["start"]` is the chunk's
  block offset in the chain), registered under the SAME hashes in the
  decode replica's pool (`import_kv_pages`), and the request is
  re-admitted with `prefix_hashes=` so decode starts with a full cache
  hit — it re-prefills only the sub-page prompt tail.
* **Prefix-hash re-admission** (the degraded/fallback rung): when
  migration is disabled, skipped (the decode pool already holds the
  full chain), or fails mid-flight (source replica SIGKILLed, target
  pool under eviction pressure, metadata mismatch), the request is
  simply re-admitted against the decode pool — the decode replica
  re-prefills whatever tail its pool doesn't hold. Content-addressed
  pages make both rungs BIT-IDENTICAL under greedy decoding: the
  decode stage always re-derives token 1 from the same KV state a
  role-less engine would have built, whether that state was migrated,
  partially migrated, or re-prefilled from the original prompt.

Failover composes with the existing router machinery: a prefill
replica that vanishes mid-migration trips its breaker
(`ReplicaGone` -> `_fail_replica`) and the in-handoff request falls
back to re-admission — outputs stay bit-identical because the decode
replica rebuilds the prefix from the original prompt. The
`disagg.migrate` fault point fires once per shipped chunk (ctx:
`request`, `seq`, `pages`) so chaos tests can kill either end
mid-stream.

Role-aware elastic scaling: `DisaggActuator` plugs the
`Autoscaler` into the role pools — a TTFT-breach grow decision lands
on the prefill pool (admission latency is prefill-bound), a
TPOT-breach on the decode pool (inter-token latency is decode-bound),
and retirement drains the pool that can best spare a replica, never
stranding either role. Process-backed pools pass
`process_role="engine_prefill"` / `"engine_decode"`
(`process_engine_factory(role=...)`) so fleet telemetry and capacity
lines split per role for free.

Series: `paddle_tpu_disagg_handoffs_total{path=migrated|readmitted|
fallback}`, `paddle_tpu_disagg_migrated_bytes_total`,
`paddle_tpu_disagg_handoff_seconds`, `paddle_tpu_disagg_pool_replicas
{role}` — the obs_top "== disagg ==" panel reads all four.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..observability import metrics as _om
from ..observability import tracing as _ot
from ..resilience import faults
from .router import ReplicaGone, ReplicaHandle, Router, _RoutedRequest

__all__ = ["DisaggRouter", "DisaggActuator", "ROLES", "PROCESS_ROLES"]

# the closed pool-role vocabulary (README "Prefill/decode
# disaggregation" documents each). PROCESS_ROLES are the matching
# process_role values a process-backed pool passes to `process_engine_factory(role=...)` so
# the fleet plane splits telemetry and capacity lines per role.
ROLES = ("prefill", "decode")
PROCESS_ROLES = ("engine_prefill", "engine_decode")


def process_role(role: str) -> str:
    """Map a pool role to its fleet-telemetry process_role."""
    return PROCESS_ROLES[ROLES.index(role)]


_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        r = _om.registry()
        _METRICS = {
            "handoffs": r.counter(
                "paddle_tpu_disagg_handoffs_total",
                "prefill->decode handoffs by path: migrated = KV "
                "pages shipped to the decode replica (>= 1 page "
                "imported), readmitted = migration deliberately "
                "skipped (disabled, sub-page prompt, or the decode "
                "pool already held the full chain) and the request "
                "re-admitted by prefix hash, fallback = migration "
                "attempted but failed (source died, target pool "
                "full, metadata mismatch) and re-admission recovered",
                ("path",)),
            "migrated_bytes": r.counter(
                "paddle_tpu_disagg_migrated_bytes_total",
                "KV-page payload bytes shipped prefill->decode "
                "(key + value page bytes, pre-pickle)"),
            "handoff_seconds": r.histogram(
                "paddle_tpu_disagg_handoff_seconds",
                "wall time of one prefill->decode handoff: target "
                "probe + page export/import chunks + decode-pool "
                "re-admission"),
            "pool": r.gauge(
                "paddle_tpu_disagg_pool_replicas",
                "live replicas per role pool after a router step",
                ("role",)),
        }
    return _METRICS


class DisaggRouter(Router):
    """A Router whose ReplicaSet is partitioned into prefill and
    decode pools. The request lifecycle becomes two-stage:

      submit -> [prefill pool] ragged prefill, commit prefix blocks,
                sample token 1 (max_new pinned to 1)
             -> handoff (migrate pages / re-admit by hash)
             -> [decode pool] full cache hit (or tail re-prefill),
                re-derive token 1, decode to completion

    The decode stage's result is the request's result — greedy
    decoding makes it bit-identical to a role-less single engine. All
    Router policy (admission/shedding, affinity, breakers, failover,
    re-serve accounting) applies unchanged within each pool; an EMPTY
    pool degrades gracefully — `_route_candidates` falls back to every
    live replica, so a decode replica can run prefills (and vice
    versa) while the autoscaler repairs the pool.

    prefill_factory / decode_factory: per-role `engine_factory(i)`
    callables (decode defaults to prefill's — homogeneous pools). A
    replica keeps its role across crash-restart (`_role_of_idx` is
    keyed on the never-recycled replica index).
    migrate: False pins the re-admission-only rung.
    migrate_chunk_pages: KV pages per RPC chunk (bounds peak payload
    size; each chunk is one `disagg.migrate` fault-point firing).
    """

    def __init__(self, prefill_factory, decode_factory=None, *,
                 n_prefill: int = 1, n_decode: int = 1,
                 migrate: bool = True, migrate_chunk_pages: int = 8,
                 **router_kwargs):
        if n_prefill < 0 or n_decode < 0 or n_prefill + n_decode < 1:
            raise ValueError(
                f"need >= 1 replica across pools, got "
                f"{n_prefill} prefill + {n_decode} decode")
        decode_factory = decode_factory or prefill_factory
        self._factories = {"prefill": prefill_factory,
                           "decode": decode_factory}
        self.migrate = bool(migrate)
        self.migrate_chunk_pages = max(1, int(migrate_chunk_pages))
        # replica index -> role, the authoritative pool map: indices
        # are never recycled, and ReplicaHandle.restart() re-invokes
        # the dispatching factory below with the same index, so a
        # crash-restarted replica keeps its role
        self._role_of_idx: Dict[int, str] = {}
        for i in range(n_prefill):
            self._role_of_idx[i] = "prefill"
        for i in range(n_prefill, n_prefill + n_decode):
            self._role_of_idx[i] = "decode"

        def _factory(idx):
            return self._factories[self._role_of_idx[idx]](idx)

        # a two-stage request spends one serve attempt per stage, so
        # give the default attempt budget one more rung than Router's
        router_kwargs.setdefault("max_serve_attempts", 4)
        super().__init__(_factory, n_prefill + n_decode,
                         **router_kwargs)
        for h in self.replicas:
            h.role = self._role_of_idx[h.idx]
        self.stats.update(
            handoffs=0, handoff_migrated=0, handoff_readmitted=0,
            handoff_fallback=0, migrated_bytes=0)

    # -- pool plumbing -----------------------------------------------------
    def _role(self, h: ReplicaHandle) -> Optional[str]:
        return self._role_of_idx.get(h.idx)

    def pool(self, role: str) -> List[ReplicaHandle]:
        """Live replicas of one role."""
        return [h for h in self.replicas.live()
                if self._role(h) == role]

    def _route_candidates(self, req: _RoutedRequest
                          ) -> List[ReplicaHandle]:
        """Narrow routing (and therefore affinity probing) to the
        request's current pool; an empty pool degrades to the whole
        live set so serving survives losing a role entirely."""
        want = getattr(req, "pool", None)
        live = self.replicas.live()
        if want is None:
            return live
        cands = [h for h in live if self._role(h) == want]
        return cands or live

    def add_replica(self, engine_factory=None,
                    role: Optional[str] = None) -> str:
        """Grow one pool by one replica. `role=None` balances: the
        pool with fewer live members gets the replica."""
        if role is None:
            role = "prefill" if len(self.pool("prefill")) \
                < len(self.pool("decode")) else "decode"
        if role not in ROLES:
            raise ValueError(f"unknown pool role {role!r}")
        # recorded BEFORE the handle exists: the dispatching factory
        # reads it during engine construction, and _drain_pending
        # (inside super) must already see the new replica's pool
        self._role_of_idx[self.replicas._next_idx] = role
        name = super().add_replica(engine_factory)
        for h in self.replicas:
            if h.name == name:
                h.role = role
        return name

    def _update_gauges(self) -> None:
        super()._update_gauges()
        if not _om._ENABLED:
            return
        g = _metrics()["pool"]
        for role in ROLES:
            g.labels(role=role).set(float(len(self.pool(role))))

    # -- two-stage lifecycle -----------------------------------------------
    def _dispatch(self, req: _RoutedRequest) -> None:
        if not hasattr(req, "pool"):
            # first touch: stamp the stage plan on the request
            # (_RoutedRequest is a plain dataclass — re-serves and
            # re-routes carry the stage with them)
            req.final_max_new = req.max_new
            if req.max_new > 1 and self.pool("prefill"):
                req.pool = "prefill"
                req.max_new = 1     # prefill + first sampled token
            else:
                # single-token requests ARE pure prefill (no decode
                # phase to hand off); with no prefill pool the split
                # is pointless — serve one-stage on the decode pool
                req.pool = "prefill" if req.max_new <= 1 \
                    and self.pool("prefill") else "decode"
        super()._dispatch(req)

    def _collect(self, h: ReplicaHandle, results, finished) -> None:
        # handoff keys on the REQUEST's stage, not the handle's role:
        # in degraded mode a decode replica may have run the prefill
        # stage, and its completion must still hand off
        staged, through = [], []
        for r in results:
            req = h.inflight.get(r.request_id)
            if (req is not None and r.request_id not in h.drained
                    and getattr(req, "pool", None) == "prefill"
                    and r.ok and not req.cancelled
                    and req.final_max_new > req.max_new):
                staged.append((req, r))
            else:
                through.append(r)
        super()._collect(h, through, finished)
        for req, r in staged:
            # prefill stage done: consume the bookkeeping _collect
            # would have, then hand off instead of finishing — the
            # stage's sampled token is discarded, the decode stage
            # re-derives it from the same KV state (bit-identical
            # under greedy)
            h.inflight.pop(req.rid, None)
            self._owner.pop(req.rid, None)
            self._handoff(req, h)

    # -- handoff -----------------------------------------------------------
    def _handoff(self, req: _RoutedRequest, src: ReplicaHandle
                 ) -> None:
        t0 = time.perf_counter()
        req.pool = "decode"
        req.max_new = req.final_max_new
        path, nbytes = "readmitted", 0
        if self.migrate and req.hashes:
            path, nbytes = self._migrate(req, src)
        self.stats["handoffs"] += 1
        self.stats["handoff_" + path] += 1
        self.stats["migrated_bytes"] += nbytes
        dt = time.perf_counter() - t0
        if _om._ENABLED:
            m = _metrics()
            m["handoffs"].labels(path=path).inc()
            if nbytes:
                m["migrated_bytes"].inc(nbytes)
            m["handoff_seconds"].observe(dt)
        if _ot._ENABLED and req.trace_id is not None:
            _ot.add_event(
                "disagg.handoff", t0 * 1e6, dt * 1e6,
                trace=(req.trace_id, _ot.new_span_id(), req.root_span),
                args={"request_id": str(req.rid), "path": path,
                      "bytes": nbytes, "src": src.name})
        # normal pool routing: affinity lands the request on the
        # migration target (it now holds the longest chain) with
        # prefix_hashes= re-admission; obs_carry marks the re-serve so
        # the decode prefill charges to the affinity_miss TTFT budget
        self._dispatch(req)

    def _migrate(self, req: _RoutedRequest, src: ReplicaHandle):
        """Ship the request's committed KV chain src -> the best
        decode replica. Returns (path, bytes_shipped); never raises —
        every failure degrades to re-admission."""
        decode = self.pool("decode")
        if not decode or src.engine is None:
            return "readmitted", 0
        cached = self._probe_affinity(req, decode)
        target = max(decode,
                     key=lambda h: (cached.get(h, 0), -h.load, -h.idx))
        nbytes = shipped = 0
        at = src        # which end the next RPC talks to, for blame
        try:
            # the chunk offset starts past the blocks the target
            # already holds — match_prefix walks the chain in order,
            # so its matched page count IS the first missing block
            start = len(target.engine.cache.match_prefix(
                req.prompt, req.hashes)[1])
            total = len(req.hashes)
            if start >= total:  # full chain already on the target:
                return "readmitted", 0      # re-admission = full hit
            while start < total:
                at = src
                payload = src.engine.export_kv_pages(
                    req.hashes, start, self.migrate_chunk_pages)
                pages = payload.get("pages") or []
                faults.fault_point(
                    "disagg.migrate", request=str(req.rid),
                    seq=start, pages=len(pages))
                if not pages:
                    break   # chain truncated on src (LRU evicted the
                    # tail) — whatever shipped is still a valid prefix
                at = target
                n = target.engine.import_kv_pages(payload)
                shipped += n
                nbytes += sum(int(p["k"].nbytes) + int(p["v"].nbytes)
                              for p in pages)
                if n < len(pages):
                    break   # target pool under pressure — the partial
                    # chain is registered and valid; decode re-prefills
                    # the tail
                start += len(pages)
        except ReplicaGone as e:
            # one end's process vanished mid-stream: trip ITS breaker
            # (re-serving its inflight), and this request falls back
            # to re-admission from the original prompt
            self._fail_replica(at, e)
            return "fallback", nbytes
        except Exception:
            # metadata mismatch (heterogeneous pools), transport
            # hiccup — migration is an optimization, never a
            # correctness edge
            return "fallback", nbytes
        return ("migrated", nbytes) if shipped else ("fallback",
                                                     nbytes)


class DisaggActuator:
    """Role-aware actuator for the `Autoscaler`: grow decisions are
    routed by the breached series — TTFT breaches grow the prefill
    pool (admission latency is prefill-bound), TPOT breaches the
    decode pool (inter-token latency is decode-bound), anything else
    balances. Retirement drains the pool that can best spare a
    replica (more live members, lower total inflight on ties) and
    refuses rather than strand either role."""

    def __init__(self, router: DisaggRouter):
        self.router = router

    def grow_for(self, trigger: dict) -> Optional[str]:
        sig = (str(trigger.get("series", "")) + " "
               + str(trigger.get("slo", ""))).lower()
        if "ttft" in sig:
            role = "prefill"
        elif "tpot" in sig:
            role = "decode"
        else:
            role = None     # balance the pools
        return self.router.add_replica(role=role)

    def grow(self) -> Optional[str]:
        return self.router.add_replica(role=None)

    def retire(self) -> Optional[str]:
        pools = {role: self.router.pool(role) for role in ROLES}
        order = sorted(
            (role for role in ROLES if len(pools[role]) > 1),
            key=lambda role: (-len(pools[role]),
                              sum(h.load for h in pools[role])))
        for role in order:
            h = min(pools[role], key=lambda x: (x.load, -x.idx))
            name = self.router.retire_replica(h.name)
            if name is not None:
                return name
        return None     # both pools at 1 — never strand a role

    def replicas(self) -> int:
        return len(self.router.replicas)
