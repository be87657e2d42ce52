"""Process-backed replicas of paddle_tpu_torch (inference/replica_proc.py)
on the CPU: a Router over one replica PROCESS (spawned, gpt_tiny built by
tests/torch_fleet_cases.py, which imports no JAX) that is SIGKILLed
mid-decode. The router sees `ReplicaGone`, fails over, and the factory
spawns a replacement that takes its kernel library from the shared
exec-cache store (outcome disk_hit, no compiler run). Every request
finishes with the tokens of one in-process engine; the aggregator holds
bundles of both incarnations under process_role "engine"; a failed-over
request's trace is one connected tree across the processes. Each
replica process answers only to the RPC key its parent drew for it: a
frame signed with the key derived from the environment is refused.

Two processes are spawned in all (the replica and its replacement), and
every socket and queue wait has a timeout."""
import os
import signal
import time

import numpy as np
import pytest

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.inference import LLMEngine, ReplicaGone, Router
from paddle_tpu_torch.inference.replica_proc import (
    ReplicaProcessClient, process_engine_factory, start_replica_process)
from paddle_tpu_torch.observability import fleet, tracing
from torch_fleet_cases import ENGINE_KW, rejected_frames, serve, tiny_gpt


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    tracing.clear()
    yield
    if fleet._AGGREGATOR is not None:
        fleet._AGGREGATOR.close()
    obs.disable()
    obs.reset()


def _connected(evs, trace_id):
    """The events of one trace form one tree: every parent is a span of
    the trace, and exactly one root ("request") event."""
    mine = [e for e in evs if e.get("trace_id") == trace_id]
    spans = {e["span_id"] for e in mine}
    roots = [e for e in mine if e["name"] == "request"]
    return (len(roots) == 1 and all(e.get("parent_id") in spans
                                    for e in mine if e is not roots[0]),
            {e["pid"] for e in mine})


def test_tp_and_shard_param_raise():
    with pytest.raises(NotImplementedError):
        start_replica_process(tiny_gpt, tp=2)
    with pytest.raises(NotImplementedError):
        start_replica_process(tiny_gpt, shard_param=len)


def test_kill9_failover_and_warm_replacement(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_RPC_TOKEN", raising=False)
    obs.enable()
    agg = fleet.serve_aggregator()
    store = str(tmp_path / "exec_cache")
    factory = process_engine_factory(
        tiny_gpt, dict(seed=0), ENGINE_KW, exec_cache_dir=store,
        aggregator_endpoint=agg.endpoint, device="cpu",
        start_timeout_s=240.0, step_timeout_s=60.0)
    router = Router(factory, n_replicas=1, cooldown_s=0.0)
    (h,) = router.replicas
    first = h.engine
    assert isinstance(first, ReplicaProcessClient) and first.alive
    # the first incarnation's agent ships once (2 s interval) before
    # the kill, so the aggregator knows its pid
    deadline = time.monotonic() + 60
    while "engine-0" not in agg.processes():
        assert time.monotonic() < deadline, "no bundle from engine-0"
        time.sleep(0.05)
    # the replica answers only to its own key: a frame signed with the
    # environment's is refused before it is unpickled, and counted
    with pytest.raises(ConnectionError):
        rpc.call_endpoint(first.endpoint, os.getpid, timeout=10)
    assert first._call(rejected_frames) == {"bad_mac": 1}
    assert len(first._token) == 32 and first._token != rpc._rpc_token()
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 1024, (33,)).astype(np.int32)
    ps = [np.concatenate([prefix, rng.integers(0, 1024, (n,))]).astype(
        np.int32) for n in (3, 7, 5, 9)]
    for i, p in enumerate(ps):
        router.submit(i, p, max_new_tokens=10)
    done = {}
    steps = 0
    killed = False
    deadline = time.monotonic() + 300
    while router.has_unfinished:
        assert time.monotonic() < deadline, "fleet wedged"
        for r in router.step():
            done[r.request_id] = r
        steps += 1
        if steps == 2 and not killed:
            os.kill(first.pid, signal.SIGKILL)     # mid-decode
            first._proc.join(timeout=30)
            killed = True
    assert killed and router.stats["failovers"] == 1
    assert router.stats["reroutes"] >= 1
    second = h.engine
    assert second is not first and second.pid != first.pid
    assert second._token not in (first._token, rpc._rpc_token())
    with pytest.raises(ReplicaGone):
        first.step()
    want = serve(LLMEngine(tiny_gpt(), device="cpu", **ENGINE_KW), ps, 10)
    assert {i: tuple(int(t) for t in r.output_ids)
            for i, r in done.items()} == want
    # warm: the allocator library came from the store, no compiler ran
    outcomes = second.compile_outcomes()
    assert outcomes.get(("paged_block_allocator", "disk_hit")) == 1
    assert not [k for k in outcomes if k[1] == "compile"]
    assert second.compiler_runs() == {}
    assert second.exec_cache_stats()["hits"] >= 1
    second.shutdown()                   # its agent ships its farewell
    procs = agg.processes()
    assert procs["engine-0"]["role"] == "engine"
    assert procs["engine-0"]["pid"] == second.pid
    snap = agg.registry.snapshot()
    assert snap["paddle_tpu_fleet_process_restarts_total"]["series"][
        ("engine-0",)] == 1
    evs = tracing.events()
    trees = [_connected(evs, e["trace_id"]) for e in evs
             if e["name"] == "router.reroute"]
    assert trees and all(ok for ok, _pids in trees)
    assert any(second.pid in pids for _ok, pids in trees)
