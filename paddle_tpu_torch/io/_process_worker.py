"""Multiprocess DataLoader worker (counterpart of
paddle_tpu/io/_process_worker.py; ref: python/paddle/io/reader.py:216,
whose default workers are processes because Python transforms hold the
GIL, so thread workers serialize).

Design: spawned processes (never fork: the parent owns a live CUDA
context, which a forked child cannot use) and SharedMemory array
transport. Workers are compute-only: the dataset, collate and init
objects cross the spawn boundary as an opaque pickle bytes blob, so
`worker_main` hides the card before those bytes are unpickled: it sets
``CUDA_VISIBLE_DEVICES=""`` and the port's default place to the CPU, so
no import- or unpickle-time code of the dataset's modules can create a
CUDA context. (Plain Process args would not do: with the spawn start
method the child unpickles its args in `spawn_main`, before the target
runs.) A worker's `Tensor`s are CPU Tensors; their pickle is
device-neutral, so they arrive on the parent's default place. The
default collate produces numpy batches; the parent turns them into
Tensors, on the card through one pinned copy a batch
(``io/_device_feed.py``). Large arrays travel through
multiprocessing.shared_memory (one copy into the segment, one copy out
in the parent, no pickle of the payload bytes); small leaves ride the
queue pickle. Segments are named ``pttio_<parent pid>_<epoch
token>w<worker>a<attempt>_<token>``, so a process can count its own
loaders' segments in /dev/shm and a loader can find those of one worker
incarnation.

Self-healing contract: a worker that dies without reporting (OOM kill,
segfault, the chaos fault `io.worker.batch`) is detected by the
parent's queue-wait loop and respawned with `resume_from` pointing at
the first batch the parent still needs; on every soft exit path
(orderly stop, early consumer exit, error) SharedMemory payloads that
never reached the parent are unlinked (worker-side for unplaced ones,
parent-side `discard()` after join for in-flight ones), so /dev/shm
does not leak. A hard kill can land between segment creation in
`_pack` and the payload reaching the parent's queue (the queue's feeder
thread dies with the process before it flushes); those segments are
unregistered from the resource tracker so ownership can pass to the
consumer, so the parent unlinks them by name (`sweep`): a dead
incarnation's after draining its queue, and the whole epoch's when the
iterator ends.

Observability: a worker takes the parent's flags at spawn
(`obs_enabled`); with them on it records its produce latency and batch
count (``paddle_tpu_dataloader_worker_batch_seconds``,
``paddle_tpu_dataloader_worker_batches_total``) and an "io.worker.batch"
trace event a batch, and ships them in its "done" farewell as a fleet
bundle (`observability.fleet.worker_farewell`, None when observability
is off), which the parent merges. A worker killed before its farewell
loses its partial series; its replacement recounts the recomputed
batches."""
from __future__ import annotations

import os
import secrets
import time
import traceback

import numpy as np

# arrays below this ride the regular queue pickle (a SharedMemory
# segment costs two syscalls + mmap; not worth it for scalars)
_SHM_THRESHOLD = 1 << 16

# the names of the port's SharedMemory segments start with this
SHM_PREFIX = "pttio_"

# set inside a spawned worker process (io.get_worker_info reads it)
_WORKER_INFO = None


def shm_prefix(parent_pid: int) -> str:
    """The name prefix of the segments a loader in process `parent_pid`
    receives."""
    return f"{SHM_PREFIX}{parent_pid}_"


def np_collate(batch):
    """Default collate producing numpy leaves (worker-side twin of
    io.default_collate_fn: the parent wraps leaves into Tensors)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if hasattr(sample, "numpy") and hasattr(sample, "_data"):
        # the port's Tensor samples (duck-typed) -> stacked numpy; the
        # parent re-wraps them into one batched Tensor like the thread
        # tier
        return np.stack([np.asarray(s.numpy()) for s in batch])
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [np_collate(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: np_collate([d[k] for d in batch]) for k in sample}
    return batch


def _pack(obj, segments, prefix=SHM_PREFIX):
    """Replace large ndarray leaves with shared-memory markers."""
    if isinstance(obj, np.ndarray) and obj.nbytes >= _SHM_THRESHOLD:
        from multiprocessing import shared_memory
        seg = shared_memory.SharedMemory(
            name=prefix + secrets.token_hex(8), create=True,
            size=obj.nbytes)
        # ownership passes to the consumer: unregister from this
        # process's resource tracker, or the tracker would unlink the
        # segment when this (short-lived) worker exits, before the
        # parent has copied it out
        from multiprocessing import resource_tracker
        resource_tracker.unregister(seg._name, "shared_memory")
        np.ndarray(obj.shape, obj.dtype, buffer=seg.buf)[...] = obj
        segments.append(seg)
        return ("__shm__", seg.name, str(obj.dtype), obj.shape)
    if isinstance(obj, list):
        return ["__list__"] + [_pack(x, segments, prefix) for x in obj]
    if isinstance(obj, tuple):
        return ("__tuple__",) + tuple(_pack(x, segments, prefix)
                                      for x in obj)
    if isinstance(obj, dict):
        return {k: _pack(v, segments, prefix) for k, v in obj.items()}
    return obj


def _strip_ndarrays(obj):
    """Replace ndarray leaves with None: what is left is what a batch
    payload would pickle onto the queue. Used by the parent's
    collate-output picklability probe."""
    if isinstance(obj, np.ndarray):
        return None
    if isinstance(obj, list):
        return [_strip_ndarrays(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_strip_ndarrays(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _strip_ndarrays(v) for k, v in obj.items()}
    return obj


def shm_payload_bytes(obj) -> int:
    """Total SharedMemory bytes a packed payload references (from the
    markers alone: no segment is attached)."""
    if isinstance(obj, tuple) and obj[:1] == ("__shm__",):
        _, _, dtype, shape = obj
        n = np.dtype(dtype).itemsize
        for d in shape:
            n *= d
        return n
    if isinstance(obj, (list, tuple)):
        return sum(shm_payload_bytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(shm_payload_bytes(v) for v in obj.values())
    return 0


def discard(obj):
    """Unlink every SharedMemory segment a packed payload references
    without copying it out: the parent's cleanup path for batches nobody
    will consume."""
    from multiprocessing import shared_memory
    if isinstance(obj, tuple) and obj[:1] == ("__shm__",):
        try:
            seg = shared_memory.SharedMemory(name=obj[1])
        except FileNotFoundError:
            return
        release([seg])
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            discard(x)
    elif isinstance(obj, dict):
        for v in obj.values():
            discard(v)


def sweep(prefix):
    """Unlink every /dev/shm segment whose name starts with `prefix`:
    those of worker incarnations that died before their payloads
    reached the parent."""
    try:
        names = os.listdir("/dev/shm")
    except FileNotFoundError:
        return
    for name in names:
        if name.startswith(prefix):
            try:
                os.unlink(os.path.join("/dev/shm", name))
            except FileNotFoundError:
                pass


def attach(obj, segments):
    """The payload with each shared-memory marker replaced by a numpy
    view of its attached segment (no copy); the segments are appended to
    `segments`, for `release` once nothing views them any more."""
    from multiprocessing import shared_memory
    if isinstance(obj, tuple) and obj[:1] == ("__shm__",):
        _, name, dtype, shape = obj
        seg = shared_memory.SharedMemory(name=name)
        segments.append(seg)
        return np.ndarray(shape, np.dtype(dtype), buffer=seg.buf)
    if isinstance(obj, list) and obj[:1] == ["__list__"]:
        return [attach(x, segments) for x in obj[1:]]
    if isinstance(obj, tuple) and obj[:1] == ("__tuple__",):
        return tuple(attach(x, segments) for x in obj[1:])
    if isinstance(obj, dict):
        return {k: attach(v, segments) for k, v in obj.items()}
    return obj


def release(segments):
    """Unlink and close the segments `attach` attached. A view still
    alive (in the traceback of an error raised while it was read) keeps
    its mapping until it dies; the name is gone either way."""
    for seg in segments:
        try:
            seg.unlink()
        except FileNotFoundError:
            pass
        try:
            seg.close()
        except BufferError:
            pass


def unpack(obj):
    """Parent-side inverse of _pack: attach, copy out, release."""
    segments = []
    try:
        return _copy_leaves(attach(obj, segments))
    finally:
        release(segments)


def _copy_leaves(obj):
    if isinstance(obj, np.ndarray):
        return np.array(obj)
    if isinstance(obj, list):
        return [_copy_leaves(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_copy_leaves(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _copy_leaves(v) for k, v in obj.items()}
    return obj


def _hide_the_card():
    """The env guard: no CUDA device visible, the port's default place
    the CPU. Runs before any user code of the worker."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from ..core import device
    device.set_device("cpu")


def worker_main(wid, num_workers, payload_bytes, idx_batches, out_queue,
                stop_event, resume_from=0, fault_specs=None, attempt=0,
                obs_enabled=False, shm_name_prefix=SHM_PREFIX):
    """Entry point of a spawned worker process. Round-robin ownership:
    worker w produces batches w, w+W, w+2W, ... in order into its own
    bounded queue (deterministic reassembly, per-worker backpressure,
    the same protocol as the in-process thread tier).

    payload_bytes: pickle of (dataset, collate_fn_or_None,
    worker_init_fn_or_None), deserialized here, after the env guard.
    resume_from: first batch index the parent still needs; a worker
    respawned to replace a dead one skips its stripe's earlier batches.
    fault_specs: a faults.snapshot() from the parent, re-armed in this
    process so `io.*` fault points work across the spawn boundary.
    attempt: this worker slot's incarnation number (0 = original spawn),
    in the fault context so a chaos kill can target only the first life
    (match={"bi": 2, "attempt": 0}) and let the respawn survive.
    obs_enabled: the parent's observability flags at spawn time, a
    (metrics, tracing) pair (a bare bool means metrics only).
    shm_name_prefix: the prefix of this worker's segment names."""
    import pickle
    import queue as _q
    # a spawned child must never touch the parent's card: the env guard
    # runs before any user code (dataset unpickle / init fn) executes
    _hide_the_card()
    try:
        dataset, collate_fn, worker_init_fn = pickle.loads(payload_bytes)
        from ..resilience import faults
        faults.install(fault_specs)
        metrics_on, tracing_on = (
            obs_enabled if isinstance(obs_enabled, tuple)
            else (obs_enabled, False))
        wm = wt = None
        if metrics_on or tracing_on:
            from ..observability import metrics as _om
            from ..observability import tracing as _otr
            if tracing_on:
                _otr.enable()
                wt = _otr
            if metrics_on:
                _om.enable()
                r = _om.registry()
                wm = {
                    "produce": r.histogram(
                        "paddle_tpu_dataloader_worker_batch_seconds",
                        "worker-side dataset load + collate + shm pack "
                        "time per batch"),
                    "batches": r.counter(
                        "paddle_tpu_dataloader_worker_batches_total",
                        "batches produced by spawned DataLoader "
                        "workers"),
                }
        global _WORKER_INFO
        import types
        _WORKER_INFO = types.SimpleNamespace(
            id=wid, num_workers=num_workers, dataset=dataset)
        if worker_init_fn is not None:
            worker_init_fn(wid)
        collate = collate_fn if collate_fn is not None else np_collate
        for bi in range(wid, len(idx_batches), num_workers):
            if bi < resume_from:
                continue        # the parent already consumed this one
            if stop_event.is_set():
                return
            faults.fault_point("io.worker.batch", wid=wid, bi=bi,
                               attempt=attempt)
            t_produce = time.perf_counter() if (wm or wt) else 0.0
            samples = [dataset[i] for i in idx_batches[bi]]
            batch = collate(samples)
            segments = []
            try:
                payload = _pack(batch, segments, shm_name_prefix)
            except BaseException:
                # mid-pack failure (e.g. ENOSPC on /dev/shm): the
                # segments created so far are unregistered from the
                # tracker, so this worker must unlink them
                release(segments)
                raise
            if wm:
                wm["produce"].observe(time.perf_counter() - t_produce)
                wm["batches"].inc()
            if wt:
                # one trace event a produced batch, recorded in this
                # process (its pid); it ships with the farewell
                t_done = time.perf_counter()
                wt.add_event("io.worker.batch", t_produce * 1e6,
                             (t_done - t_produce) * 1e6,
                             args={"wid": wid, "bi": bi,
                                   "attempt": attempt})
            placed = False
            while not stop_event.is_set():
                try:
                    out_queue.put(("batch", bi, payload), timeout=0.2)
                    placed = True
                    break
                except _q.Full:
                    continue
            for seg in segments:
                seg.close()
            if not placed:      # consumer went away: free the payload
                discard(payload)
                return
        # the farewell carries this worker's observability as a fleet
        # bundle (None when observability is off). Stop-aware like the
        # batch puts, but always attempted at least once (the parent
        # sets stop the instant it consumes the last batch; its
        # post-join drain reads this)
        snap = None
        if wm is not None or wt is not None:
            from ..observability import fleet as _ofleet
            _ofleet.set_identity(process=f"io-worker-{wid}",
                                 role="io-worker")
            snap = _ofleet.worker_farewell(metrics=wm is not None,
                                           trace=wt is not None)
        while True:
            try:
                out_queue.put(("done", wid, snap), timeout=0.2)
                break
            except _q.Full:
                if stop_event.is_set():
                    break
    except BaseException:
        try:
            out_queue.put(("error", wid, traceback.format_exc()),
                          timeout=1.0)
        except Exception:       # the parent reports the dead worker
            pass
