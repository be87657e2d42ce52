"""Process-backed serving replicas over the fleet RPC plane
(counterpart of paddle_tpu/inference/replica_proc.py).

The router (inference.router) speaks a 4-method transport contract —
`add_request` / `step` / `abort_request` / `has_unfinished`, with
`ReplicaGone` meaning "the peer vanished". This module moves a replica
into a real OS process: `start_replica_process` spawns (multiprocessing's
spawn context) a worker that builds its model + `LLMEngine` on the
device its caller names (the card by default: a worker asked for
`cuda` that finds no card raises, it never serves on the CPU),
optionally warm from the persistent kernel-library store
(`exec_cache_dir`), serves the contract over the HMAC RPC layer
(`distributed.rpc`) under a key only it and its parent hold (the
``PADDLE_RPC_TOKEN`` of the environment when one is set, else random
bytes the parent draws for this worker alone), and self-identifies to the fleet aggregator as
`process_role="engine"` so per-replica health/capacity/traces come
free. The parent gets back a `ReplicaProcessClient` that is a drop-in
router engine: any transport failure surfaces as `ReplicaGone`, and the
router's crash-restart factory (`process_engine_factory`) spawns a
REPLACEMENT process that takes its kernel libraries from the shared
store instead of running a compiler. Tensor-parallel replicas (`tp`,
`shard_param`) are not ported yet and raise NotImplementedError.

Worker functions are module-level because the RPC layer pickles
callables BY REFERENCE: the parent sends `_w_step` as a qualified
name, the worker imports this module and finds its process-global
engine in `_WORKER`. For the same reason the model builder must be a
module-level importable callable in a module that imports no JAX,
never a closure; it is called as ``model_builder(device=...,
**model_kwargs)``.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as _queue
import secrets
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .router import ReplicaGone

__all__ = [
    "start_replica_process", "process_engine_factory",
    "ReplicaProcessClient",
]

# worker-process state: populated once by _worker_main, read by the
# _w_* RPC handlers (the RPC layer imports this module to resolve them)
_WORKER: Dict[str, Any] = {}

# the RPC key of each worker process this process spawned, by its
# Process object (start_replica_process -> ReplicaProcessClient)
_SPAWN_KEYS: "weakref.WeakKeyDictionary[Any, bytes]" = \
    weakref.WeakKeyDictionary()


# ---------------------------------------------------------------------------
# worker-side RPC handlers (module-level: pickled by reference)
# ---------------------------------------------------------------------------
def _w_add_request(rid, prompt, max_new, deadline_s=None,
                   obs_carry=None, prefix_hashes=None):
    _WORKER["engine"].add_request(
        rid, prompt, max_new, deadline_s=deadline_s,
        obs_carry=obs_carry, prefix_hashes=prefix_hashes)
    return True


def _w_step():
    eng = _WORKER["engine"]
    results = eng.step()
    return results, len(eng._fns), bool(eng.has_unfinished)


def _w_abort_request(rid):
    return bool(_WORKER["engine"].abort_request(rid))


def _w_has_unfinished():
    return bool(_WORKER["engine"].has_unfinished)


def _w_cache_info():
    eng = _WORKER["engine"]
    return {
        "pid": os.getpid(),
        "enable_prefix_caching": bool(eng.enable_prefix_caching),
        "block_size": int(eng.block_size),
        "max_batch": int(eng.max_batch),
        "max_model_len": int(eng.max_model_len),
    }


def _w_block_hashes(tokens):
    return _WORKER["engine"].cache.block_hashes(tokens)


def _w_match_prefix(tokens, hashes=None):
    return _WORKER["engine"].cache.match_prefix(tokens, hashes)


def _w_compile_outcomes():
    """{(family, outcome): count} from the worker's own registry —
    lets the parent pin that a warm replacement reintegrated via
    disk_hit without scraping the aggregator. Kernel libraries report
    under their names (`observability.perf.note_build`)."""
    import json
    from ..observability import metrics as _om
    doc = json.loads(_om.registry().to_json())
    out = {}
    rec = doc.get("paddle_tpu_compile_total")
    for s in (rec or {}).get("series", ()):
        lbl = s.get("labels", {})
        out[(lbl.get("family", ""), lbl.get("outcome", ""))] = \
            s.get("value", 0)
    return out


def _w_exec_cache_stats():
    eng = _WORKER["engine"]
    store = getattr(eng, "_exec_cache", None)
    return store.stats() if store is not None else {}


def _w_compiler_runs():
    """{compiler: runs} this worker process ran (`utils.build`)."""
    from ..utils import build as _build
    return dict(_build.compiler_runs)


def _w_export_kv_pages(hashes, start=0, limit=None):
    return _WORKER["engine"].export_kv_pages(hashes, start=start,
                                             limit=limit)


def _w_import_kv_pages(payload):
    return int(_WORKER["engine"].import_kv_pages(payload))


def _w_shutdown():
    _WORKER["stop"].set()
    return True


# ---------------------------------------------------------------------------
# worker entrypoint
# ---------------------------------------------------------------------------
def _worker_main(model_builder, model_kwargs, engine_kwargs, tp,
                 shard_param, exec_cache_dir, bind, process_name,
                 aggregator_endpoint, ready_q, role=None, device=None,
                 trace=False, token=None):
    """Body of the replica process. Builds model + engine, serves the
    transport contract, ships fleet telemetry, then parks until
    _w_shutdown (or SIGKILL — the chaos path — in which case the
    parent's next RPC raises and becomes ReplicaGone). `role` is the
    fleet process_role this replica self-identifies as — "engine" by
    default; a disaggregated pool passes "engine_prefill" /
    "engine_decode" so telemetry, capacity lines and perf-ledger
    baselines split per role. `token`: the key its RPC server
    answers to (bytes its parent drew)."""
    from ..observability import fleet as _ofleet
    from ..observability import metrics as _om
    from ..distributed import rpc as _rpc

    try:
        _om.enable()
        if trace:
            # the parent traces: the worker's spans (its engine's, its
            # RPC server's) join the callers' trees through the frames
            from ..observability import tracing as _ot
            _ot.enable()
        if process_name:
            _ofleet.set_identity(process=process_name,
                                 role=role or "engine")
        else:
            _ofleet.suggest_role(role or "engine")

        from ..core.device import resolve_device
        dev = resolve_device(device)    # cuda without a card raises
        model = model_builder(device=dev, **(model_kwargs or {}))

        from .llm_engine import LLMEngine
        engine = LLMEngine(model, exec_cache_dir=exec_cache_dir,
                           device=dev, **(engine_kwargs or {}))

        stop = threading.Event()
        _WORKER.update(engine=engine, stop=stop)

        server, endpoint = _rpc._serve(bind=bind, port=0, token=token)
        agent = None
        if aggregator_endpoint:
            agent = _ofleet.FleetAgent(aggregator_endpoint)
            agent.start()
        ready_q.put(("ok", endpoint, os.getpid()))
    except BaseException as e:
        try:
            ready_q.put(("error", "%s: %s" % (type(e).__name__, e),
                         os.getpid()))
        except Exception:
            pass
        raise

    try:
        stop.wait()
    finally:
        if agent is not None:
            try:
                agent.stop()
            except Exception:
                pass
        try:
            server.shutdown()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# parent-side client
# ---------------------------------------------------------------------------
class _FnsView:
    """len()-able stand-in for the worker engine's `_fns` dict. The
    router samples len() around step() to exempt compile passes from
    the slow-step health check; the worker reports its true count on
    every step RPC, so the router sees executable growth exactly when
    it happened."""

    __slots__ = ("_client",)

    def __init__(self, client: "ReplicaProcessClient"):
        self._client = client

    def __len__(self) -> int:
        return self._client._n_fns


class _ProcCacheProxy:
    """The slice of PagedKVCache the router's affinity scorer touches,
    served over RPC. Affinity is an optimization, never a correctness
    edge: any transport hiccup degrades to 'nothing cached here' and
    the next step() RPC surfaces the real failure as ReplicaGone."""

    # the router's affinity scorer batches peeks of remote caches into
    # one concurrent RPC round per admission (a serial per-replica
    # probe would add one round-trip of routing latency per pool
    # member)
    remote = True

    def __init__(self, client: "ReplicaProcessClient",
                 enable_prefix_caching: bool, block_size: int):
        self._client = client
        self.enable_prefix_caching = enable_prefix_caching
        self.block_size = block_size

    def block_hashes(self, tokens) -> List[bytes]:
        try:
            return self._client._call(
                _w_block_hashes, np.asarray(tokens, np.int32))
        except Exception:
            return []

    def match_prefix(self, tokens, hashes=None) -> Tuple[int, list]:
        try:
            return self._client._call(
                _w_match_prefix, hashes=hashes,
                tokens=np.asarray(tokens, np.int32))
        except Exception:
            return 0, []


class ReplicaProcessClient:
    """Parent-side handle speaking the router's transport contract to
    one replica worker process. Transport failures (peer unreachable,
    connection reset, short frame — the signatures of a killed or
    wedged process) raise ReplicaGone; exceptions the worker's engine
    itself raised are shipped back by the RPC layer and re-raised
    as-is, so the router classifies them exactly like an in-process
    replica's."""

    # the router may step this replica from a worker thread alongside
    # its siblings: each RPC opens its own socket and the worker
    # computes in its own process, so concurrent steps of DIFFERENT
    # clients share nothing parent-side
    concurrent_step_safe = True

    def __init__(self, endpoint: str, proc=None,
                 step_timeout_s: float = 600.0):
        self.endpoint = endpoint
        self._proc = proc
        self._timeout = float(step_timeout_s)
        self._n_fns = 0
        self._has_unfinished = False
        self._dead = False
        # a worker start_replica_process spawned answers to its own key;
        # any other endpoint to the environment's (`distributed.rpc`)
        self._token = None if proc is None else _SPAWN_KEYS.get(proc)
        info = self._call(_w_cache_info)
        self.pid = info.get("pid")
        self.cache = _ProcCacheProxy(
            self, info.get("enable_prefix_caching", False),
            info.get("block_size", 0))
        self.enable_prefix_caching = self.cache.enable_prefix_caching
        self._fns = _FnsView(self)

    # -- transport ----------------------------------------------------
    def _call(self, fn, *args, **kwargs):
        from ..distributed import rpc as _rpc
        if self._dead:
            raise ReplicaGone(
                "replica process at %s already failed" % self.endpoint)
        ip, port = self.endpoint.rsplit(":", 1)
        try:
            return _rpc._call_endpoint(ip, int(port), fn, args, kwargs,
                                       self._timeout, token=self._token)
        except (ConnectionError, EOFError, OSError) as e:
            self._mark_dead()
            raise ReplicaGone(
                "replica process at %s vanished: %s: %s"
                % (self.endpoint, type(e).__name__, e)) from e

    def _mark_dead(self) -> None:
        self._dead = True
        if self._proc is not None:
            self._proc.join(timeout=5.0)

    @property
    def alive(self) -> bool:
        return not self._dead and (
            self._proc is None or self._proc.is_alive())

    # -- the 4-method contract ----------------------------------------
    def add_request(self, request_id, prompt_ids, max_new_tokens,
                    deadline_s=None, obs_carry=None,
                    prefix_hashes=None):
        out = self._call(
            _w_add_request, request_id,
            np.asarray(prompt_ids, np.int32),
            int(max_new_tokens),
            deadline_s=deadline_s, obs_carry=obs_carry,
            prefix_hashes=prefix_hashes)
        self._has_unfinished = True
        return out

    def step(self) -> List:
        results, n_fns, has_unfinished = self._call(_w_step)
        self._n_fns = int(n_fns)
        self._has_unfinished = bool(has_unfinished)
        return results

    def abort_request(self, request_id) -> bool:
        ok = bool(self._call(_w_abort_request, request_id))
        if ok:
            # the worker queues the aborted request's terminal result;
            # a step() must still drain it
            self._has_unfinished = True
        return ok

    @property
    def has_unfinished(self) -> bool:
        return self._has_unfinished

    # -- KV-page migration (disagg handoff) ---------------------------
    def export_kv_pages(self, hashes, start: int = 0,
                        limit: Optional[int] = None) -> dict:
        return self._call(_w_export_kv_pages, list(hashes),
                          start=int(start), limit=limit)

    def import_kv_pages(self, payload: dict) -> int:
        return int(self._call(_w_import_kv_pages, payload))

    # -- introspection / lifecycle ------------------------------------
    def compile_outcomes(self) -> Dict[Tuple[str, str], float]:
        return self._call(_w_compile_outcomes)

    def exec_cache_stats(self) -> Dict[str, int]:
        return self._call(_w_exec_cache_stats)

    def compiler_runs(self) -> Dict[str, int]:
        """{compiler: runs} the worker process ran."""
        return self._call(_w_compiler_runs)

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Clean stop: best-effort shutdown RPC, then join; escalate
        to terminate if the worker doesn't exit."""
        try:
            if not self._dead:
                self._call(_w_shutdown)
        except Exception:
            pass
        self._dead = True
        if self._proc is not None:
            self._proc.join(timeout=timeout_s)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=5.0)


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------
def start_replica_process(model_builder, model_kwargs=None,
                          engine_kwargs=None, *, tp: Optional[int] = None,
                          shard_param=None,
                          exec_cache_dir: Optional[str] = None,
                          aggregator_endpoint: Optional[str] = None,
                          process_name: Optional[str] = None,
                          role: Optional[str] = None,
                          bind: str = "127.0.0.1",
                          start_timeout_s: float = 600.0,
                          step_timeout_s: float = 600.0,
                          ctx=None, device=None) -> ReplicaProcessClient:
    """Spawn one replica worker and block until it serves the
    transport contract. `model_builder` must be a module-level
    importable callable of a module that imports no JAX (the spawn
    context and the RPC layer both pickle by reference). `device`:
    where the worker builds its model and engine, None = the card
    ("cpu" by request). `role`: the fleet process_role the worker
    identifies as (default "engine"; a disaggregated pool uses
    "engine_prefill" / "engine_decode"). The worker records metrics, and
    traces too when this process traces. Its RPC server answers only
    to ``PADDLE_RPC_TOKEN`` when that is set, else to 32 random bytes
    drawn here, which the worker and the returned client alone hold.
    `tp` and `shard_param` (tensor-parallel replicas) are not ported
    yet."""
    if tp or shard_param is not None:
        raise NotImplementedError(
            "tensor-parallel replicas (tp / shard_param) are not ported "
            "yet")
    from ..observability import tracing as _ot
    ctx = ctx or multiprocessing.get_context("spawn")
    ready_q = ctx.Queue()
    token = (os.environ.get("PADDLE_RPC_TOKEN", "").encode()
             or secrets.token_bytes(32))
    proc = ctx.Process(
        target=_worker_main,
        args=(model_builder, model_kwargs, engine_kwargs, tp,
              shard_param, exec_cache_dir, bind, process_name,
              aggregator_endpoint, ready_q, role,
              None if device is None else str(device), _ot.enabled(),
              token),
        daemon=True)
    _SPAWN_KEYS[proc] = token
    proc.start()
    deadline = time.monotonic() + start_timeout_s
    while True:
        try:
            status, payload, pid = ready_q.get(timeout=1.0)
            break
        except _queue.Empty:
            if not proc.is_alive():
                raise RuntimeError(
                    "replica worker died during startup (exitcode "
                    "%s)" % proc.exitcode)
            if time.monotonic() > deadline:
                proc.terminate()
                raise RuntimeError(
                    "replica worker failed to start within %.0fs"
                    % start_timeout_s)
    if status != "ok":
        proc.join(timeout=5.0)
        raise RuntimeError("replica worker failed: %s" % payload)
    return ReplicaProcessClient(payload, proc=proc,
                                step_timeout_s=step_timeout_s)


def process_engine_factory(model_builder, model_kwargs=None,
                           engine_kwargs=None, *, tp=None,
                           shard_param=None, exec_cache_dir=None,
                           aggregator_endpoint=None,
                           name_prefix: str = "engine",
                           role: Optional[str] = None,
                           device=None, **spawn_kwargs):
    """An `engine_factory` for Router(...) whose replicas are worker
    PROCESSES. The router's breaker calls factory(i) again after a
    crash; the replacement keeps the replica's stable fleet name (the
    aggregator's pid-change detection counts the restart) and — when
    `exec_cache_dir` is shared — reintegrates WARM from disk instead
    of recompiling. `role` names the pool for a disaggregated fleet
    (see `inference.disagg`): every replica this factory spawns ships
    telemetry and capacity lines under that process_role. `device`:
    where the replicas build (None = the card)."""
    def factory(idx: int) -> ReplicaProcessClient:
        return start_replica_process(
            model_builder, model_kwargs, engine_kwargs, tp=tp,
            shard_param=shard_param, exec_cache_dir=exec_cache_dir,
            aggregator_endpoint=aggregator_endpoint,
            process_name="%s-%d" % (name_prefix, idx),
            role=role, device=device,
            **spawn_kwargs)
    return factory
