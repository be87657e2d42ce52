"""The port's DataLoader observability against the reference's, on the
same datasets (tests/torch_io_cases.py; numpy samples both loaders
take): the consumer's batch-wait histogram in the buffered, thread and
process tiers, and in the spawned-worker tier with two workers the
workers' own series and trace events merged into the parent from their
farewell bundles, the SharedMemory byte counters and the restart
counter. Counts, label sets and the merged trace events' structure are
equal; durations are never compared. With observability off the
workers ship nothing and nothing is recorded."""
import fcntl
import os

import pytest

import torch_io_cases as C
from paddle_tpu import observability as jobs
from paddle_tpu.io import DataLoader as JLoader
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.io import DataLoader as TLoader
from paddle_tpu_torch.resilience import faults as tfaults
from torch_port_helpers import cpu_place

SIDES = {"ref": (jobs, JLoader, jfaults), "port": (tobs, TLoader, tfaults)}
IO_SERIES = ("paddle_tpu_dataloader_batch_wait_seconds",
             "paddle_tpu_dataloader_worker_restarts_total",
             "paddle_tpu_dataloader_shm_bytes_total",
             "paddle_tpu_dataloader_shm_bytes_in_flight",
             "paddle_tpu_dataloader_worker_batch_seconds",
             "paddle_tpu_dataloader_worker_batches_total")


@pytest.fixture(autouse=True)
def _clean():
    for obs, _l, faults in SIDES.values():
        obs.disable()
        obs.reset()
        faults.clear_all()
    with cpu_place():
        yield
    for obs, _l, faults in SIDES.values():
        obs.disable()
        obs.reset()
        faults.clear_all()


def _io_counts(obs):
    """{series: {labels: value or observation count}} of the loader's
    series, non-zero ones (earlier tests' registrations of the
    process-global registry read 0 after a reset)."""
    snap = obs.snapshot()
    out = {}
    for n in IO_SERIES:
        for k, v in snap.get(n, {"series": {}})["series"].items():
            v = v["count"] if isinstance(v, dict) else v
            if v:
                out.setdefault(n, {})[k] = v
    return out


def _run(side, ds, metrics=True, tracing=True, **kw):
    obs, Loader, _f = SIDES[side]
    if metrics:
        obs.metrics.enable()
    if tracing:
        obs.tracing.enable()
    n = len(list(Loader(ds, batch_size=4, **kw)))
    obs.disable()
    evs = [e for e in obs.trace_events() if e["name"] == "io.worker.batch"]
    return n, _io_counts(obs), evs


def test_spawned_workers_farewell_merges_into_the_parent():
    out = {}
    for side in SIDES:
        n, counts, evs = _run(side, C.ObsShmDs(n=12), num_workers=2)
        out[side] = (n, counts, sorted(
            (e["args"]["wid"], e["args"]["bi"], e["args"]["attempt"],
             e.get("ingested", False)) for e in evs),
            all(e["pid"] != os.getpid() for e in evs))
    assert out["port"] == out["ref"]
    n, counts, evs, foreign = out["port"]
    assert n == 3 and foreign
    assert counts["paddle_tpu_dataloader_worker_batches_total"] == {(): 3}
    assert counts["paddle_tpu_dataloader_worker_batch_seconds"] == {(): 3}
    assert counts["paddle_tpu_dataloader_batch_wait_seconds"] == {(): 3}
    assert counts["paddle_tpu_dataloader_shm_bytes_total"] == {
        (): 3 * 4 * 64 * 1024 * 4}           # 3 batches x [4, 64Ki] f32
    assert "paddle_tpu_dataloader_shm_bytes_in_flight" not in counts  # 0
    assert evs == [(0, 0, 0, True), (0, 2, 0, True), (1, 1, 0, True)]


@pytest.fixture(scope="session")
def reference_native_queue(tmp_path_factory):
    """Whether the reference's native queue is loaded in this process.
    Its g++ build writes one temporary file name for every process
    (paddle_tpu/io/native/__init__.py:36-39), so two processes that
    build it at once can fail, and the reference keeps that failure for
    the life of the process; its thread tier then runs the buffered
    fallback. The first use here builds it under a lock that every test
    process of the run shares."""
    from paddle_tpu.io import native as jnative
    lock = tmp_path_factory.getbasetemp().parent / "ptio_build.lock"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return jnative.available()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.mark.parametrize("tier", ["direct", "buffered", "threads"])
def test_batch_wait_in_each_tier(tier, request):
    kw = {"direct": dict(use_buffer_reader=False), "buffered": {},
          "threads": dict(num_workers=2, use_shared_memory=False)}[tier]
    if tier == "threads" and not request.getfixturevalue(
            "reference_native_queue"):
        pytest.skip("the reference's native queue did not build in this "
                    "process (a concurrent build by another test process "
                    "fails it, and the failure is kept), so the reference "
                    "would run its buffered tier, not the thread tier")
    out = {side: _run(side, C.ObsSmallDs(n=8), **kw)[:2]
           for side in SIDES}
    assert out["port"] == out["ref"]
    waits = out["port"][1].get(
        "paddle_tpu_dataloader_batch_wait_seconds", {}).get((), 0)
    # one wait a batch, and the buffered tier's end-of-epoch sentinel;
    # the direct tier waits for nothing
    assert waits == {"direct": 0, "buffered": 3, "threads": 2}[tier]


def test_spawned_worker_traces_without_metrics():
    """Tracing alone: the workers record their trace events and no
    metric (the reference's TestSpawnBoundaryTraces, metrics off)."""
    out = {}
    for side in SIDES:
        n, counts, evs = _run(side, C.ObsSmallDs(n=12), metrics=False,
                              num_workers=2)
        out[side] = (n, counts, sorted(e["args"]["bi"] for e in evs))
    assert out["port"] == out["ref"]
    assert out["port"][2] == [0, 1, 2]
    assert not out["port"][1].get(
        "paddle_tpu_dataloader_worker_batches_total", {}).get((), 0)


def test_worker_restart_counter():
    out = {}
    for side in SIDES:
        obs, Loader, faults = SIDES[side]
        obs.enable()
        with faults.inject("io.worker.batch", exit_code=1, times=1,
                           match={"bi": 2, "attempt": 0}):
            with pytest.warns(UserWarning, match="respawning at batch"):
                n = len(list(Loader(C.ObsSmallDs(n=12), batch_size=2,
                                    num_workers=2)))
        obs.disable()
        out[side] = (n, _io_counts(obs)[
            "paddle_tpu_dataloader_worker_restarts_total"])
    assert out["port"] == out["ref"] == (6, {(): 1.0})


def test_observability_off_ships_and_records_nothing():
    for side in SIDES:
        n, counts, evs = _run(side, C.ObsSmallDs(n=8), metrics=False,
                              tracing=False, num_workers=2)
        assert n == 2 and evs == []
        assert all(not v for c in counts.values() for v in c.values())
