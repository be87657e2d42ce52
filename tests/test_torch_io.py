"""paddle_tpu_torch.io against paddle_tpu.io on the CPU.

On the port's copy it runs every case of tests/test_process_dataloader.py
and tests/test_native_io.py, tests/test_resilience.py's self-healing
loader (the healed epoch, the exhausted restart budget, and the
/dev/shm leak count over the port's own segment names only, which carry
this process's id: other test processes' segments are not counted), and
get_worker_info. Against the reference it holds, exactly: the indices of
SequenceSampler, BatchSampler and DistributedBatchSampler (shuffled with
a fixed epoch), random_split after both default generators are seeded
alike, WeightedRandomSampler after np.random.seed, and every collate
(values and dtypes, 64-bit types as their 32-bit ones). Then the two
repairs: TrainStep takes the port's Tensors as a batch, and a pickled
Tensor carries no device.

The module-level datasets live in tests/torch_io_cases.py (no JAX), so
the spawned workers import neither JAX nor the reference."""
import pickle
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_io_cases as C
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import DataLoader, get_worker_info
from paddle_tpu_torch.io import _process_worker as PW
from paddle_tpu_torch.io.native import NativeQueue, collate_stack
from paddle_tpu_torch.resilience import faults
from torch_port_helpers import cpu_place


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _collect(loader):
    return [(np.asarray(x.numpy()), np.asarray(y.numpy()))
            for x, y in loader]


def _own_segments():
    """The /dev/shm segments of this process's loaders."""
    import os
    prefix = PW.shm_prefix(os.getpid())
    return {f for f in os.listdir("/dev/shm") if f.startswith(prefix)}


# ---------------------------------------------------------------------------
# tests/test_process_dataloader.py on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("big", [False, True])
def test_process_workers_match_serial(big):
    ds = C.ArrayDs(n=13, big=big)
    serial = _collect(DataLoader(ds, batch_size=4, num_workers=0))
    procs = _collect(DataLoader(ds, batch_size=4, num_workers=2))
    assert len(serial) == len(procs) == 4
    for (sx, sy), (px, py) in zip(serial, procs):
        np.testing.assert_array_equal(sx, px)
        np.testing.assert_array_equal(sy, py)
        assert py.dtype == np.int32


def test_process_worker_error_propagates():
    with pytest.raises(RuntimeError, match="boom at 5"):
        _collect(DataLoader(C.BoomDs(n=16), batch_size=4, num_workers=2))
    assert not _own_segments()


def test_worker_info_inside_process():
    out = _collect(DataLoader(C.InfoDs(n=8), batch_size=2, num_workers=2))
    ids = {float(x[0, 0]) for x, _ in out}
    assert ids <= {0.0, 1.0} and len(ids) == 2
    # the main process sees no worker context
    assert get_worker_info() is None


def test_unpicklable_falls_back_to_threads():
    class LocalDs(C.ArrayDs):    # a class defined in a function: unpicklable
        pass

    loader = DataLoader(LocalDs(n=8), batch_size=4, num_workers=2)
    with pytest.warns(UserWarning, match="not picklable"):
        out = _collect(loader)
    assert len(out) == 2
    assert loader._spawn_picklable_result is False


def test_early_break_cleans_up():
    loader = DataLoader(C.ArrayDs(n=64, big=True), batch_size=4,
                        num_workers=2, prefetch_factor=2)
    it = iter(loader)
    next(it)
    next(it)
    it.close()      # generator finally: stop, join, drain, unlink
    assert not _own_segments()
    # a fresh epoch over the same loader still works
    assert len(_collect(loader)) == 16


# ---------------------------------------------------------------------------
# tests/test_native_io.py on the port
# ---------------------------------------------------------------------------
class TestNativeQueue:
    def test_fifo_through_threads(self):
        q = NativeQueue(4)
        got = []

        def consumer():
            while True:
                try:
                    got.append(q.pop(timeout_ms=5000))
                except StopIteration:
                    return

        t = threading.Thread(target=consumer)
        t.start()
        for i in range(32):
            q.push(i)
        q.close()
        t.join(timeout=10)
        assert not t.is_alive()
        assert got == list(range(32))

    def test_capacity_blocks_and_timeout(self):
        q = NativeQueue(2)
        assert q.push(1, timeout_ms=100)
        assert q.push(2, timeout_ms=100)
        assert not q.push(3, timeout_ms=50)   # full -> timeout
        assert q.pop() == 1
        assert q.push(3, timeout_ms=100)

    def test_pop_timeout_raises(self):
        with pytest.raises(TimeoutError):
            NativeQueue(2).pop(timeout_ms=50)

    def test_close_drains_then_stops(self):
        q = NativeQueue(4)
        q.push("a")
        q.close()
        assert q.pop(timeout_ms=100) == "a"
        with pytest.raises(StopIteration):
            q.pop(timeout_ms=100)
        with pytest.raises(RuntimeError, match="closed"):
            q.push("b")


class TestNativeCollate:
    def test_matches_np_stack(self):
        arrs = [np.random.default_rng(i).standard_normal(
            (64, 257)).astype(np.float32) for i in range(7)]
        np.testing.assert_array_equal(collate_stack(arrs), np.stack(arrs))

    def test_mixed_shapes_fall_back(self):
        arrs = [np.zeros((4, 4), np.float32), np.zeros((4,), np.float32)]
        with pytest.raises(ValueError):
            collate_stack(arrs)  # np.stack raises identically

    def test_object_dtype_collate_safe(self):
        import gc
        objs = [np.array([{"k": i}] * 9000, dtype=object)
                for i in range(3)]
        out = collate_stack(objs)
        del objs
        gc.collect()
        assert out[0][0]["k"] == 0  # no dangling PyObject pointers

    def test_a_failed_build_raises(self, monkeypatch):
        """The reference returns None and its loader falls back to the
        buffered thread; the port raises (no silent fallback)."""
        from paddle_tpu_torch.io import native
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_FLAGS", ("-no-such-flag",))
        with pytest.raises(RuntimeError, match="building ptio failed"):
            native.load()
        with pytest.raises(RuntimeError, match="building ptio failed"):
            list(DataLoader(C.SlowDs(n=8), batch_size=4, num_workers=2,
                            use_shared_memory=False))


class TestWorkerDataLoader:
    """The in-process tier (native queues, thread workers), chosen with
    use_shared_memory=False."""

    def test_worker_loader_matches_serial(self):
        ds = C.SlowDs()
        serial = [b.numpy() for b in DataLoader(
            ds, batch_size=8, num_workers=0, shuffle=False)]
        parallel = [b.numpy() for b in DataLoader(
            ds, batch_size=8, num_workers=4, shuffle=False,
            use_shared_memory=False)]
        assert len(serial) == len(parallel) == 8
        for a, b in zip(serial, parallel):
            np.testing.assert_array_equal(a, b)

    def test_worker_error_propagates(self):
        loader = DataLoader(C.BadSlowDs(), batch_size=8, num_workers=2,
                            use_shared_memory=False)
        with pytest.raises(ValueError, match="corrupt sample"):
            list(loader)

    def test_workers_actually_concurrent(self):
        # structural overlap check (wall-clock ratios flake on loaded
        # boxes): observe more than one __getitem__ in flight at once
        lock = threading.Lock()
        live = {"now": 0, "peak": 0}

        class Probe(C.SlowDs):
            def __getitem__(self, i):
                with lock:
                    live["now"] += 1
                    live["peak"] = max(live["peak"], live["now"])
                try:
                    time.sleep(0.002)
                    return C.SlowDs.__getitem__(self, i)
                finally:
                    with lock:
                        live["now"] -= 1

        list(DataLoader(Probe(n=96), batch_size=8, num_workers=4,
                        use_shared_memory=False))
        assert live["peak"] > 1, live

    def test_early_break_no_thread_spew(self):
        before = threading.active_count()
        loader = DataLoader(C.SlowDs(n=64), batch_size=8, num_workers=3,
                            use_shared_memory=False)
        it = iter(loader)
        next(it)
        it.close()  # consumer abandons mid-epoch; workers must exit
        deadline = time.time() + 5
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.02)
        assert threading.active_count() <= before

    def test_buffered_early_break_stops_its_thread(self):
        before = threading.active_count()
        it = iter(DataLoader(C.SlowDs(n=64), batch_size=2,
                             prefetch_factor=1))
        next(it)
        it.close()
        assert threading.active_count() <= before


# ---------------------------------------------------------------------------
# tests/test_resilience.py::TestSelfHealingDataLoader on the port
# ---------------------------------------------------------------------------
class TestSelfHealingDataLoader:
    def test_worker_killed_mid_epoch_heals(self):
        # hard-exit worker 0 (no error report, no cleanup) the first
        # time it reaches batch 2: the epoch comes out whole and in order
        ds = C.ShmDs(n=24)
        serial = _collect(DataLoader(ds, batch_size=4, num_workers=0))
        with faults.inject("io.worker.batch", exit_code=1, times=1,
                           match={"bi": 2, "attempt": 0}):
            with pytest.warns(UserWarning, match="respawning at batch"):
                healed = _collect(DataLoader(ds, batch_size=4,
                                             num_workers=2))
        assert len(healed) == len(serial) == 6
        for (sx, sy), (px, py) in zip(serial, healed):
            np.testing.assert_array_equal(sx, px)
            np.testing.assert_array_equal(sy, py)

    def test_restart_budget_exhausts(self):
        # kill every incarnation at batch 2: bounded restarts, then a
        # clear error (not a hang)
        with faults.inject("io.worker.batch", exit_code=1,
                           match={"bi": 2}):
            with pytest.raises(RuntimeError, match="exhausted"), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _collect(DataLoader(C.ShmDs(n=24), batch_size=4,
                                    num_workers=2, max_worker_restarts=1))

    @pytest.mark.parametrize("stop_after", [2, None])
    def test_no_segment_of_this_process_left(self, stop_after):
        # an early consumer exit and a whole epoch: every segment this
        # process's loader received or was sent is unlinked
        loader = DataLoader(C.ShmDs(n=64), batch_size=4, num_workers=2,
                            prefetch_factor=2)
        it = iter(loader)
        got = [next(it) for _ in range(stop_after)] if stop_after \
            else list(it)
        it.close()
        assert len(got) == (stop_after or 16)
        assert not _own_segments(), \
            "the loader left /dev/shm segments of its own"
        # the loader is reusable afterwards
        assert len(_collect(loader)) == 16

    def test_env_guard_precedes_unpickle(self):
        # the dataset's __setstate__ passes only if worker_main hid the
        # card and set the CPU place before unpickling it
        out = _collect(DataLoader(C.EnvGuardDs(n=8), batch_size=4,
                                  num_workers=2))
        assert len(out) == 2

    def test_tensor_collate_stays_on_process_tier(self):
        """Tensor-returning collates keep the process tier (their output
        pickles through Tensor.__reduce__) and round-trip exactly."""
        ds = C.ShmDs(n=8)
        loader = DataLoader(ds, batch_size=4, num_workers=2,
                            collate_fn=C.tensor_collate)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = _collect(loader)
        assert not [w for w in caught
                    if "falling back" in str(w.message)], \
            "Tensor collate demoted to the thread tier"
        assert loader._spawn_picklable_result is True
        assert len(out) == 2
        serial = _collect(DataLoader(ds, batch_size=4, num_workers=0,
                                     collate_fn=C.tensor_collate))
        for (sx, sy), (px, py) in zip(serial, out):
            np.testing.assert_array_equal(sx, px)
            np.testing.assert_array_equal(sy, py)


def test_sweep_unlinks_a_dead_incarnations_segments():
    """A worker hard-killed after packing a batch, before its queue's
    feeder flushed it, leaves segments no message names: the parent
    unlinks them by their incarnation's prefix, and nothing else."""
    import os
    base = PW.shm_prefix(os.getpid()) + "feed"
    big = np.zeros((300, 70))
    dead, live = [], []
    PW._pack({"x": big}, dead, base + "w0a0_")
    PW._pack({"x": big}, live, base + "w1a0_")
    for seg in dead + live:
        seg.close()
    PW.sweep(base + "w0a0_")
    assert _own_segments() == {live[0].name}
    PW.sweep(base)
    assert not _own_segments()


def test_pack_unpack_round_trip():
    """A packed batch: big leaves in segments named with the loader's
    prefix, their bytes counted from the markers alone, the rest
    pickled; unpack gives the batch back and unlinks every segment."""
    import os
    big = np.random.RandomState(0).standard_normal((300, 70))
    batch = {"x": big, "y": [np.arange(3), (big[:1].astype(np.float32),
                                            "tag")]}
    segments = []
    payload = PW._pack(batch, segments, PW.shm_prefix(os.getpid()))
    for seg in segments:
        seg.close()
    assert len(segments) == 1 and _own_segments() == {segments[0].name}
    assert PW.shm_payload_bytes(payload) == big.nbytes
    assert PW._strip_ndarrays(batch) == {"x": None,
                                         "y": [None, (None, "tag")]}
    back = PW.unpack(payload)
    np.testing.assert_array_equal(back["x"], big)
    np.testing.assert_array_equal(back["y"][0], np.arange(3))
    assert back["y"][1][1] == "tag" and isinstance(back["y"][1], tuple)
    assert not _own_segments()


def test_worker_sees_no_card_and_the_cpu_place():
    out = [b.numpy() for b in DataLoader(C.CardProbeDs(n=4), batch_size=2,
                                         num_workers=2)]
    rows = np.concatenate(out)
    assert (rows[:, 0] == 0).all()      # no CUDA context made
    assert (rows[:, 1] == 0).all()      # no device visible
    assert (rows[:, 2] == 1).all()      # the port's place is the CPU
    assert len(set(rows[:, 3].tolist())) == 2


# ---------------------------------------------------------------------------
# against the reference on the CPU
# ---------------------------------------------------------------------------
class _Len:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,bs,drop_last", [(10, 3, False), (10, 3, True),
                                            (12, 4, False), (1, 5, False)])
def test_sequence_and_batch_samplers_equal_the_reference(n, bs, drop_last):
    ds = _Len(n)
    assert list(tio.SequenceSampler(ds)) == list(pt.io.SequenceSampler(ds))
    want = pt.io.BatchSampler(ds, batch_size=bs, drop_last=drop_last)
    got = tio.BatchSampler(ds, batch_size=bs, drop_last=drop_last)
    assert list(got) == list(want) and len(got) == len(want)
    seq = pt.io.SequenceSampler(ds)
    assert list(tio.BatchSampler(sampler=tio.SequenceSampler(ds),
                                 batch_size=bs)) == \
        list(pt.io.BatchSampler(sampler=seq, batch_size=bs))


@pytest.mark.parametrize("n,bs,replicas,shuffle,drop_last,epoch", [
    (10, 2, 3, False, False, 0), (10, 2, 3, True, False, 5),
    (17, 4, 2, True, True, 3), (8, 3, 4, True, False, 0)])
def test_distributed_batch_sampler_equals_the_reference(
        n, bs, replicas, shuffle, drop_last, epoch):
    ds = _Len(n)
    for rank in range(replicas):
        kw = dict(batch_size=bs, num_replicas=replicas, rank=rank,
                  shuffle=shuffle, drop_last=drop_last)
        want = pt.io.DistributedBatchSampler(ds, **kw)
        got = tio.DistributedBatchSampler(ds, **kw)
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        assert list(got) == list(want) and len(got) == len(want)


def test_distributed_batch_sampler_needs_replicas_and_rank():
    """Without num_replicas and rank the sampler takes
    distributed.get_world_size() and get_rank(), as the reference's
    does: the world of 8 CPU ranks here (the reference's 8 host devices,
    the port's rule for the CPU world), rank 0."""
    from paddle_tpu_torch import distributed as tdist
    want = pt.io.DistributedBatchSampler(_Len(20), 2)
    got = tio.DistributedBatchSampler(_Len(20), 2)
    assert (got.nranks, got.local_rank) == (want.nranks, want.local_rank) \
        == (tdist.get_world_size(), tdist.get_rank()) == (8, 0)
    assert list(got) == list(want) and len(got) == len(want)


@pytest.mark.parametrize("lengths", [[3, 7], [0.5, 0.3, 0.2]])
def test_random_split_equals_the_reference(lengths):
    ds = list(range(10))
    pt.seed(1234)
    ptt.seed(1234)
    want = pt.io.random_split(ds, lengths)
    got = tio.random_split(ds, lengths)
    assert [s.indices for s in got] == [s.indices for s in want]
    assert [list(s) for s in got] == [[ds[i] for i in s.indices]
                                      for s in want]


@pytest.mark.parametrize("replacement", [True, False])
def test_weighted_random_sampler_equals_the_reference(replacement):
    w = [0.1, 0.4, 0.2, 0.3, 1.0]
    np.random.seed(7)
    want = list(pt.io.WeightedRandomSampler(w, 4, replacement))
    np.random.seed(7)
    got = list(tio.WeightedRandomSampler(w, 4, replacement))
    assert got == want and len(tio.WeightedRandomSampler(w, 4)) == 4


def test_random_sampler_draws_from_numpy():
    ds = _Len(9)
    assert sorted(tio.RandomSampler(ds)) == list(range(9))
    draws = list(tio.RandomSampler(ds, replacement=True, num_samples=20))
    assert len(draws) == 20 and all(0 <= d < 9 for d in draws)


def _to_numpy(obj):
    if isinstance(obj, (pt.Tensor, ptt.Tensor)):
        return obj.numpy()
    if isinstance(obj, (list, tuple)):
        return [_to_numpy(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    return obj


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


COLLATE_CASES = {
    "f32 arrays": lambda i: np.full((3, 4), i, np.float32),
    "f64 arrays": lambda i: np.arange(6, dtype=np.float64) * i,
    "int64 arrays": lambda i: np.arange(5) + i,
    "bool arrays": lambda i: np.arange(4) % (i + 2) == 0,
    "big f32 arrays (native stack)": lambda i: np.random.RandomState(
        i).standard_normal(64 * 1024 // 4 + 7).astype(np.float32),
    "python ints": lambda i: 3 * i,
    "python floats": lambda i: i / 7,
    "python bools": lambda i: i % 2 == 0,
    "numpy scalars": lambda i: np.int16(i),
    "mixed sample": lambda i: C.MixedDs(8)[i],
}


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_default_collate_equals_the_reference(case):
    batch = [COLLATE_CASES[case](i) for i in range(5)]
    want = _to_numpy(pt.io.default_collate_fn(batch))
    got = tio.default_collate_fn(batch)
    _assert_same(_to_numpy(got), want)
    # the loader's own path (the device feed) gives the same batch
    loader = DataLoader(batch, batch_size=5, use_buffer_reader=False)
    _assert_same(_to_numpy(next(iter(loader))), want)


def test_tensor_samples_collate_with_stack():
    xs = [np.random.RandomState(i).standard_normal(3).astype(np.float32)
          for i in range(4)]
    want = pt.io.default_collate_fn([pt.to_tensor(x) for x in xs])
    got = tio.default_collate_fn([ptt.to_tensor(x) for x in xs])
    assert isinstance(got, ptt.Tensor)
    _assert_same(got.numpy(), want.numpy())


@pytest.mark.parametrize("tier", ["direct", "buffered", "threads",
                                  "processes"])
def test_every_tier_gives_the_reference_batches(tier):
    """The mixed samples through each tier equal the reference loader's
    batches (num_workers=0)."""
    ds = C.MixedDs(10)
    kw = {"direct": dict(use_buffer_reader=False),
          "buffered": dict(),
          "threads": dict(num_workers=2, use_shared_memory=False),
          "processes": dict(num_workers=2)}[tier]
    want = [_to_numpy(b) for b in pt.io.DataLoader(ds, batch_size=4)]
    got = [_to_numpy(b) for b in DataLoader(ds, batch_size=4, **kw)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_datasets_equal_the_reference():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6)
    for P in (pt, ptt):
        ds = P.io.TensorDataset([a, b])
        assert len(ds) == 6 and int(ds[3][1]) == 3
        np.testing.assert_array_equal(np.asarray(ds[3][0]), [6, 7])
        comp = P.io.ComposeDataset([ds, P.io.TensorDataset([b])])
        assert len(comp) == 6 and len(comp[2]) == 3
        sub = P.io.Subset(ds, [5, 0])
        assert len(sub) == 2 and int(sub[0][1]) == 5

    class It(tio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(np.full(2, i, np.float32) for i in range(self.n))

    chained = tio.ChainDataset([It(3), It(2)])
    assert [float(x[0]) for x in chained] == [0, 1, 2, 0, 1]
    loader = DataLoader(chained, batch_size=2)
    got = [b.numpy() for b in loader]
    assert [g.shape for g in got] == [(2, 2), (2, 2), (1, 2)]
    with pytest.raises(TypeError):
        len(loader)
    assert [b.shape for b in DataLoader(chained, batch_size=2,
                                        drop_last=True)] == [[2, 2]] * 2


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------
def _train_step_run(feed_tensors):
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 3))
    step = TrainStep(model, AdamW(learning_rate=1e-2,
                                  parameters=model.parameters()),
                     lambda m, x, y: F.cross_entropy(m(x), y))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(4):
        x = rng.standard_normal((5, 6)).astype(np.float32)
        y = rng.integers(0, 3, (5,)).astype(np.int32)
        if feed_tensors:
            x, y = ptt.to_tensor(x), ptt.to_tensor(y)
        losses.append(float(step(x, y)))
    return losses, [p.detach().clone() for p in model.parameters()]


def test_train_step_takes_tensor_batches():
    """A DataLoader yields the port's Tensors: TrainStep steps on them
    as on the same numpy arrays (the parent raised TypeError)."""
    want_losses, want_params = _train_step_run(False)
    losses, params = _train_step_run(True)
    assert losses == want_losses
    for a, b in zip(params, want_params):
        assert torch.equal(a, b)


def test_tensor_pickle_is_device_neutral():
    """The payload carries the array, the dtype, stop_gradient and the
    name, and no device: it unpickles onto the default place of the
    loading process (here the card, which this box lacks, so it raises
    where the parent loaded it back onto the CPU it left)."""
    from paddle_tpu_torch.core import device as tdevice
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for dtype in ("float32", "bfloat16", "int32", "bool"):
        t = ptt.to_tensor(x, dtype=dtype)
        fn, args = t.__reduce__()
        assert not any(isinstance(a, (str, torch.device)) and str(a)
                       .split(":")[0] in ("cpu", "cuda") for a in args)
        back = pickle.loads(pickle.dumps(t))
        assert back.dtype == t.dtype and back.name == t.name
        assert torch.equal(back._data, t._data)
    t = ptt.to_tensor(x, stop_gradient=False)
    assert not pickle.loads(pickle.dumps(t)).stop_gradient
    if not torch.cuda.is_available():
        data = pickle.dumps(t)
        saved = tdevice._current_place
        tdevice._current_place = None       # the default: the card
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pickle.loads(data)
        finally:
            tdevice._current_place = saved
