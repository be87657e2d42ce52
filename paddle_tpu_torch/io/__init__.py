"""Data loading (counterpart of paddle_tpu/io/__init__.py; ref:
python/paddle/io/reader.py:216 DataLoader,
io/dataloader/batch_sampler.py).

The host logic is the reference's: the datasets, the samplers (numpy
``RandomState`` seeded as the reference seeds it, so the same seeds give
the same indices in both packages), the collates, and the DataLoader's
four tiers:

- direct (``use_buffer_reader=False``): load and collate in the
  consumer;
- the buffered prefetch thread (``num_workers=0``, the default), in
  which the batch's host-to-device copy overlaps the consumer's work;
- native-queue thread workers (``num_workers > 0`` with
  ``use_shared_memory=False``, or a dataset that does not pickle),
  which feed the C++ blocking queue of ``io/native/queue.cc``;
- spawned process workers (``num_workers > 0``), with batches in
  SharedMemory segments, ordered reassembly and self-healing (a dead
  worker is respawned with bounded backoff, resuming at the first batch
  still needed; stale batches are discarded).

The device step is the port's (``io/_device_feed.py``): with the
default collate, a batch's numpy leaves become Tensors on the default
place, on the card through one pinned host-to-device copy a batch on a
copy stream of the loader's own, which the consumer's stream waits on.
In the buffered tier that copy is issued from the prefetch thread.

Observability (the reference's series, recorded only while enabled):
``paddle_tpu_dataloader_batch_wait_seconds``, the consumer's wait for
its next batch in the buffered, thread-worker and process tiers (the
direct tier waits for nothing, as in the reference); in the process
tier ``paddle_tpu_dataloader_worker_restarts_total``,
``paddle_tpu_dataloader_shm_bytes_total`` and
``paddle_tpu_dataloader_shm_bytes_in_flight`` (counted where the
receiving thread takes a payload), and the spawned workers' own
``paddle_tpu_dataloader_worker_batch_seconds`` /
``paddle_tpu_dataloader_worker_batches_total`` and "io.worker.batch"
trace events, shipped back in each worker's farewell bundle and merged
into this process (`observability.fleet.merge_bundle_local`).

Departure: a native library that does not build raises (the reference
falls back to the buffered thread)."""
from __future__ import annotations

import os
import queue
import secrets
import threading
import time

import numpy as np
import torch

from ..core.device import default_torch_device
from ..observability import metrics as _om
from ..observability import tracing as _ot
from ..core.generator import default_generator
from ..core.tensor import Tensor
from ._device_feed import DeviceFeed

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "DataLoader", "get_worker_info"]


# process-global DataLoader metrics (handles cached: the disabled path
# through any of them is one module-flag check inside inc/observe)
_IO_METRICS = None


def _io_metrics():
    global _IO_METRICS
    if _IO_METRICS is None:
        r = _om.registry()
        _IO_METRICS = {
            "wait": r.histogram(
                "paddle_tpu_dataloader_batch_wait_seconds",
                "consumer-side wait for the next batch (all tiers)"),
            "restarts": r.counter(
                "paddle_tpu_dataloader_worker_restarts_total",
                "spawned workers respawned after dying without "
                "reporting (OOM kill, segfault)"),
            "shm_bytes": r.counter(
                "paddle_tpu_dataloader_shm_bytes_total",
                "bytes transported worker->parent via SharedMemory "
                "segments"),
            "shm_inflight": r.gauge(
                "paddle_tpu_dataloader_shm_bytes_in_flight",
                "SharedMemory payload bytes received but not yet "
                "copied out of /dev/shm"),
        }
    return _IO_METRICS


def _merge_farewell(payload) -> None:
    """Fold a spawned worker's farewell bundle into this process: its
    metric snapshot merges additively, its trace events append to the
    ring verbatim (their pid tells them apart; perf_counter is
    CLOCK_MONOTONIC on Linux, so the timestamps interleave)."""
    from ..observability import fleet as _ofleet
    _ofleet.merge_bundle_local(payload)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of `lengths` (counts, or fractions of the whole) over a
    permutation drawn from numpy seeded with the default generator's
    seed (a seed of 0 draws from the OS, as in the reference)."""
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(l * total) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    perm = np.random.RandomState(
        default_generator().seed() or None).permutation(total)
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l].tolist()))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState()
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """(ref: io/dataloader/batch_sampler.py DistributedBatchSampler):
    shards sample indices across data-parallel ranks. The port has no
    ``distributed.get_world_size`` / ``get_rank`` yet, so `num_replicas`
    and `rank` must be given."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            raise NotImplementedError(
                "DistributedBatchSampler: pass num_replicas and rank "
                "(paddle_tpu_torch.distributed has no get_world_size / "
                "get_rank yet)")
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


_WORKER_ERROR = object()


def _put_while(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put `item` on the bounded `q` unless `stop` is set first (checked
    every 0.2 s); whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _collate(batch):
    """The default collate up to its Tensors: numpy leaves (the native
    parallel stack for ndarray samples, ``np.asarray`` for numbers),
    ``torch.stack`` for Tensor samples (as Tensors on their device)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        from .native import collate_stack
        return collate_stack(batch)
    if isinstance(sample, Tensor):
        return Tensor._wrap(torch.stack([s._data for s in batch]),
                            stop_gradient=True)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [_collate(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _collate([d[k] for d in batch]) for k in sample}
    return batch


def _to_tensors(obj):
    if isinstance(obj, np.ndarray):
        return Tensor(obj)
    if isinstance(obj, list):
        return [_to_tensors(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_tensors(v) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    """Stack a list of samples into a batch: ndarray and number leaves
    become Tensors on the default place (64-bit types as their 32-bit
    ones, as the reference's arrays without x64), Tensor samples are
    stacked; lists, tuples (as lists) and dicts recurse."""
    return _to_tensors(_collate(batch))


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, max_worker_restarts=2):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        # self-healing: how many times each spawned worker may be
        # respawned after dying without reporting (OOM kill, segfault)
        self.max_worker_restarts = max(0, int(max_worker_restarts))
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        # the device step: one feed (pinned staging ring, copy stream)
        # per loader and place, made at the first epoch
        self._feed = None

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    @property
    def h2d_copies(self) -> int:
        """Host-to-device copies this loader has issued (one a batch on
        the card with the default collate)."""
        return 0 if self._feed is None else self._feed.h2d_copies

    def _device_feed(self):
        """The feed for this epoch's place (the default place at the
        start of the epoch), or None with a custom collate, whose output
        the loader hands over as it is."""
        if self.collate_fn is not default_collate_fn:
            return None
        device = default_torch_device()
        if self._feed is None or self._feed.device != device:
            self._feed = DeviceFeed(device)
        return self._feed

    def _collated(self, samples, feed):
        if feed is None:
            return self.collate_fn(samples)
        return feed.put(_collate(samples))

    def _batches(self, feed):
        """Collated batches in order: each an `Arrival` when `feed`,
        else the custom collate's output."""
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self._collated(batch, feed)
                    batch = []
            if batch and not self.drop_last:
                yield self._collated(batch, feed)
        else:
            for idx_batch in self.batch_sampler:
                samples = [self.dataset[i] for i in idx_batch]
                yield self._collated(samples, feed)

    @staticmethod
    def _take(item, feed):
        return item.take() if feed is not None else item

    def __iter__(self):
        feed = self._device_feed()
        if not self.use_buffer_reader:
            for item in self._batches(feed):
                yield self._take(item, feed)
            return
        if self.num_workers > 0 and not self._iterable_mode:
            # process workers by default (ref: reader.py:216: Python
            # transforms hold the GIL, so thread workers serialize);
            # unpicklable datasets/collates fall back to the in-process
            # thread tier with a warning (the reference's contract)
            if self.use_shared_memory and self._spawn_picklable():
                yield from self._iter_process_workers(feed)
            else:
                yield from self._iter_workers(feed)
            return
        yield from self._iter_buffered(feed)

    def _spawn_picklable(self) -> bool:
        import pickle
        import warnings
        cached = self.__dict__.get("_spawn_picklable_result")
        if cached is not None:      # probe once, not per epoch: pickling
            return cached           # a large in-memory dataset is not free

        def fallback(detail):
            warnings.warn(
                f"DataLoader(num_workers={self.num_workers}): {detail} "
                "— falling back to in-process thread workers (GIL-bound "
                "for python transforms). Define the dataset and "
                "collate_fn at module level to enable process workers.",
                UserWarning, stacklevel=4)
            self._spawn_picklable_result = False
            return False

        custom = (None if self.collate_fn is default_collate_fn
                  else self.collate_fn)
        try:
            pickle.dumps((self.dataset, custom, self.worker_init_fn))
        except Exception as e:
            return fallback(
                "dataset/collate_fn is not picklable for spawned worker "
                f"processes ({type(e).__name__}: {e})")
        if custom is not None:
            # the collate output must survive the queue pickle too;
            # Tensors do (Tensor.__reduce__: a device-neutral payload
            # that lands on the parent's default place)
            from . import _process_worker as PW
            sample_out = None
            try:
                # only draw the probe index from a sampler chain known
                # to re-iterate (our own classes over their own index
                # sources): a user-supplied one may be a one-shot
                # iterable whose first batch must not be consumed by a
                # probe (WeightedRandomSampler draws from the global
                # numpy RNG, so probing it would shift seeded runs)
                bs = self.batch_sampler
                reiterable = isinstance(
                    bs, DistributedBatchSampler) or (
                    isinstance(bs, BatchSampler) and isinstance(
                        getattr(bs, "sampler", None),
                        (SequenceSampler, RandomSampler)))
                first = next(iter(bs), None) if reiterable else None
                if first:
                    sample_out = custom([self.dataset[first[0]]])
            except Exception:
                pass    # dataset errors surface in the worker, with a
                        # real traceback: not the probe's business
            if sample_out is not None:
                try:
                    pickle.dumps(PW._strip_ndarrays(sample_out))
                except Exception as e:
                    return fallback(
                        "collate_fn output is not picklable for the "
                        "worker->parent queue "
                        f"({type(e).__name__}: {e})")
        self._spawn_picklable_result = True
        return True

    def _iter_process_workers(self, feed):
        """num_workers > 0 process tier: spawned workers (never fork:
        the parent owns a live CUDA context) load and collate into
        numpy, batches travel through SharedMemory segments, and the
        parent reassembles them round-robin. One bounded queue per
        worker: deterministic order, per-worker backpressure, W *
        prefetch_factor batches of memory cap.

        A receiving thread of the parent takes the batches in order and
        makes the Tensors (on the card: straight from each segment into
        the pinned staging buffer, then one copy to the device), up to
        prefetch_factor batches ahead of the consumer: the copy out of
        /dev/shm and the segment's release (~0.2 s for a 154 MB
        ResNet-50 batch on an H100 machine's host, chip_smoke.py phase
        23) overlap the consumer's step instead of lengthening it.

        Self-healing: a worker that dies without reporting an error
        (OOM kill, segfault) is respawned, with bounded exponential
        backoff retries per worker, resuming at the first batch of its
        stripe the parent still needs; stale re-produced batches are
        discarded (their segments unlinked). On exit the parent stops
        the receiving thread, joins the workers and only then drains, so
        in-flight SharedMemory payloads are always unlinked."""
        import multiprocessing as mp
        import pickle
        import queue as _q
        import warnings
        from . import _process_worker as PW
        from ..resilience import faults

        idx_batches = list(self.batch_sampler)
        if not idx_batches:
            return
        ctx = mp.get_context("spawn")
        W = min(self.num_workers, len(idx_batches))
        queues = [ctx.Queue(maxsize=self.prefetch_factor)
                  for _ in range(W)]
        stop = ctx.Event()
        custom = (None if self.collate_fn is default_collate_fn
                  else self.collate_fn)
        # re-pickled every epoch (only the picklability verdict is
        # cached): a dataset mutated between epochs must reach the
        # workers, as it does in the other tiers. The child unpickles it
        # only after its env guard (see _process_worker)
        payload_bytes = pickle.dumps(
            (self.dataset, custom, self.worker_init_fn))
        # io.* faults cross the spawn boundary via snapshot/install
        specs = faults.snapshot()
        # this epoch's segments, by worker incarnation: a dead one's are
        # swept by name (_process_worker's docstring says why)
        prefix = PW.shm_prefix(os.getpid()) + secrets.token_hex(4)

        def seg_prefix(w, attempt):
            return f"{prefix}w{w}a{attempt}_"

        # workers take this process's observability flags at spawn time
        # and ship their metric snapshots and trace events back with
        # their "done" farewell
        obs_on = (_om._ENABLED, _ot._ENABLED)

        def spawn(w, resume_from=0, attempt=0):
            p = ctx.Process(
                target=PW.worker_main,
                args=(w, W, payload_bytes, idx_batches, queues[w], stop,
                      resume_from, specs, attempt, obs_on,
                      seg_prefix(w, attempt)),
                daemon=True)
            p.start()
            return p

        procs = [spawn(w) for w in range(W)]
        restarts = [0] * W
        done = threading.Event()        # the consumer has gone

        def payload_of(bi):
            """Batch `bi`'s packed payload from its worker, respawning
            the worker if it died; None once the consumer has gone."""
            w = bi % W
            q = queues[w]
            waited = 0.0
            while not done.is_set():
                try:
                    kind, tag, payload = q.get(timeout=0.5)
                except _q.Empty:
                    waited += 0.5
                    if not procs[w].is_alive():
                        if restarts[w] >= self.max_worker_restarts:
                            raise RuntimeError(
                                f"DataLoader worker {w} died without "
                                "reporting an error (OOM-killed?) and "
                                f"exhausted its {self.max_worker_restarts}"
                                " restarts") from None
                        restarts[w] += 1
                        _io_metrics()["restarts"].inc()
                        backoff = min(0.05 * (1 << (restarts[w] - 1)), 2.0)
                        warnings.warn(
                            f"DataLoader worker {w} died without "
                            f"reporting an error — respawning at batch "
                            f"{bi} (restart {restarts[w]}/"
                            f"{self.max_worker_restarts})", UserWarning)
                        time.sleep(backoff)
                        # a hard kill can land mid-pipe-write, leaving
                        # the queue's shared write-lock held by the
                        # corpse: drain what did arrive, then hand the
                        # replacement a fresh queue
                        while True:
                            try:
                                kind, _, payload = q.get_nowait()
                            except _q.Empty:
                                break
                            if kind == "batch":
                                PW.discard(payload)
                            elif kind == "done":
                                _merge_farewell(payload)
                        PW.sweep(seg_prefix(w, restarts[w] - 1))
                        queues[w] = ctx.Queue(maxsize=self.prefetch_factor)
                        q = queues[w]
                        procs[w] = spawn(w, resume_from=bi,
                                         attempt=restarts[w])
                        # re-arm the batch deadline: the respawned
                        # worker re-loads the batch from scratch
                        waited = 0.0
                    if self.timeout and waited >= self.timeout:
                        raise TimeoutError(
                            f"DataLoader worker {w} produced no batch "
                            f"within timeout={self.timeout}s")
                    continue
                if kind == "error":
                    raise RuntimeError(
                        f"DataLoader worker {tag} failed:\n{payload}")
                if kind == "done":
                    # a finished worker's farewell (its successor may
                    # still owe batches): merge its metrics and trace
                    _merge_farewell(payload)
                    continue
                if kind != "batch":
                    raise RuntimeError(f"DataLoader: unexpected message "
                                       f"{kind!r} from worker {tag}")
                if tag < bi:        # stale duplicate after a restart
                    PW.discard(payload)
                    continue
                if tag != bi:
                    raise RuntimeError(f"DataLoader: worker {w} sent "
                                       f"batch {tag} where batch {bi} "
                                       "was due")
                return payload
            return None

        def receive(payload):
            shm_bytes = 0
            if _om._ENABLED:
                shm_bytes = PW.shm_payload_bytes(payload)
                if shm_bytes:
                    iom = _io_metrics()
                    iom["shm_bytes"].inc(shm_bytes)
                    iom["shm_inflight"].inc(shm_bytes)
            try:
                return copy_out(payload)
            finally:
                if shm_bytes:
                    _io_metrics()["shm_inflight"].dec(shm_bytes)

        def copy_out(payload):
            if custom is not None:
                return PW.unpack(payload)
            if feed.device.type != "cuda":
                return feed.put(PW.unpack(payload))
            segments = []
            try:
                # each segment is read once, into the pinned buffer
                return feed.put(PW.attach(payload, segments))
            finally:
                PW.release(segments)

        out: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        err = []

        def receiver():
            try:
                for bi in range(len(idx_batches)):
                    payload = payload_of(bi)
                    if payload is None or not _put_while(
                            out, receive(payload), done):
                        return
            except BaseException as e:  # propagate to the consumer
                err.append(e)
            finally:
                _put_while(out, sentinel, done)

        thread = threading.Thread(target=receiver, daemon=True)
        thread.start()
        try:
            while True:
                # one wait a batch, as the reference's tier observes it
                # (the end-of-epoch sentinel's wait is not a batch's)
                obs = _om._ENABLED
                t0 = time.perf_counter() if obs else 0.0
                item = out.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    break
                if obs:
                    _io_metrics()["wait"].observe(time.perf_counter() - t0)
                yield self._take(item, feed)
        finally:
            done.set()
            thread.join()           # it sees `done` within ~0.5 s
            stop.set()
            # join the workers first: they observe stop within ~0.2 s,
            # unlink unplaced payloads and flush their queue feeders on
            # exit; after the join no new batch can arrive behind the
            # drain
            for p in procs:
                p.join(timeout=5.0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=1.0)
            for q in queues:
                while True:
                    try:
                        kind, _, payload = q.get_nowait()
                    except (_q.Empty, OSError, EOFError):
                        break
                    if kind == "batch":
                        PW.discard(payload)
                    elif kind == "done":
                        # the common race: the farewell lands after the
                        # last batch was consumed; merge it here
                        _merge_farewell(payload)
            PW.sweep(prefix)

    def _iter_buffered(self, feed):
        """One prefetch thread loads, collates and (with the default
        collate) issues the batch's copy to the device, up to
        prefetch_factor batches ahead of the consumer."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        stop = threading.Event()
        err = []

        def worker():
            try:
                for b in self._batches(feed):
                    if not _put_while(q, b, stop):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                _put_while(q, sentinel, stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                # the end-of-epoch sentinel's wait counts too, as in the
                # reference's buffered tier
                if _om._ENABLED:
                    t0 = time.perf_counter()
                    item = q.get()
                    _io_metrics()["wait"].observe(time.perf_counter() - t0)
                else:
                    item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    break
                yield self._take(item, feed)
        finally:
            # an early consumer exit: stop the thread, which may be
            # blocked on a full queue
            stop.set()
            t.join(timeout=5.0)

    def _iter_workers(self, feed):
        """num_workers > 0 in-process tier: worker threads load and
        collate batches into native C++ blocking queues (ref: the reader
        BlockingQueue under paddle's DataLoader workers,
        operators/reader/blocking_queue.h). One bounded queue per worker
        with round-robin consumption: batch i comes from queue i % W, so
        ordering is deterministic, memory stays capped at W *
        prefetch_factor batches, and a slow worker backpressures only
        itself. The native library must build (``native.load`` raises
        otherwise)."""
        from .native import NativeQueue
        idx_batches = list(self.batch_sampler)
        W = self.num_workers
        queues = [NativeQueue(max(self.prefetch_factor, 1))
                  for _ in range(W)]
        stop = threading.Event()
        errs = []

        def worker(wid):
            nq = queues[wid]
            try:
                for bi in range(wid, len(idx_batches), W):
                    if stop.is_set():
                        return
                    samples = [self.dataset[i] for i in idx_batches[bi]]
                    batch = self._collated(samples, feed)
                    while not stop.is_set():
                        if nq.push(batch, timeout_ms=200):
                            break
            except BaseException as e:
                if not stop.is_set():   # else the consumer closed it
                    errs.append(e)
                try:
                    nq.push(_WORKER_ERROR, timeout_ms=0)
                except RuntimeError:
                    pass        # closed: the consumer has gone

        threads = [threading.Thread(target=worker, args=(w,),
                                    daemon=True)
                   for w in range(W)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(idx_batches)):
                obs = _om._ENABLED
                t0 = time.perf_counter() if obs else 0.0
                while True:
                    if errs:
                        raise errs[0]
                    try:
                        batch = queues[bi % W].pop(timeout_ms=500)
                        break
                    except TimeoutError:
                        continue
                if obs:
                    _io_metrics()["wait"].observe(time.perf_counter() - t0)
                if batch is _WORKER_ERROR:
                    raise errs[0] if errs else RuntimeError(
                        "dataloader worker failed")
                yield self._take(batch, feed)
        finally:
            stop.set()
            for nq in queues:
                nq.close()


def get_worker_info():
    """ref: io/dataloader/worker.py get_worker_info. The worker context
    (id, num_workers, dataset) inside a spawned DataLoader worker
    process; None in the main process (and in the in-process thread
    tiers, as the reference outside a worker)."""
    from . import _process_worker
    return _process_worker._WORKER_INFO
