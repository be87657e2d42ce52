"""The port's DataLoader on the card: the pinned copy on its own stream,
the loader's Tensors in TrainStep's graph, and spawned workers that
never touch the card. Every test here is marked `cuda` and skips
without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_io_cuda.py

Every comparison is exact: a batch is copied, not computed, and the
graph steps replay the eager step's kernels on the same values."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
import torch_io_cases as C
from paddle_tpu_torch import TrainStep
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.io._device_feed import DeviceFeed
from paddle_tpu_torch.jit import cuda_graph
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum

pytestmark = pytest.mark.cuda

TIERS = {"direct": dict(use_buffer_reader=False), "buffered": dict(),
         "threads": dict(num_workers=2, use_shared_memory=False),
         "processes": dict(num_workers=2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the loader's copy goes to the "
                    "card)")
    return torch.device("cuda", torch.cuda.current_device())


def _leaves(obj):
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in _leaves(o)]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k])]
    return [obj]


def test_pinned_copy_on_its_stream_equals_the_host_batch(cuda_device):
    feed = DeviceFeed(cuda_device)
    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((5, 7)),
             "ids": rng.integers(0, 9, (5, 3)),
             "m": rng.random(5) > 0.5},
            rng.standard_normal((4, 1000)).astype(np.float16),
            "a string leaf stays"]
    pinned = []
    for k in range(3):
        arrival = feed.put(host)
        assert arrival.event is not None
        assert feed.h2d_copies == k + 1
        slot = feed._ring[k % 2]
        assert slot.pinned.is_pinned()
        pinned.append(slot.pinned.data_ptr())
        assert feed._stream != torch.cuda.current_stream()
        got = arrival.take()
        assert got[2] == "a string leaf stays"
        base = arrival.buffer.data_ptr()
        end = base + arrival.buffer.numel()
        for t, want in zip(_leaves(got[:2]), _leaves(host[:2])):
            assert isinstance(t, ptt.Tensor) and t._data.is_cuda
            assert base <= t._data.data_ptr() < end     # one buffer
            want = want.astype({np.dtype(np.int64): np.int32,
                                np.dtype(np.float64): np.float32}.get(
                                    want.dtype, want.dtype))
            assert t.numpy().dtype == want.dtype
            np.testing.assert_array_equal(t.numpy(), want)
    assert pinned[2] == pinned[0]       # a ring of two, reused


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_every_tier_copies_each_batch_to_the_card_once(cuda_device, tier):
    ds = C.ArrayDs(n=13, big=True)
    loader = DataLoader(ds, batch_size=4, **TIERS[tier])
    got = [(x, y) for x, y in loader]
    assert loader.h2d_copies == len(got) == 4
    for i, (x, y) in enumerate(got):
        assert x._data.is_cuda and y._data.is_cuda
        want = [ds[j] for j in range(4 * i, min(4 * i + 4, 13))]
        np.testing.assert_array_equal(x.numpy(), np.stack(
            [w[0] for w in want]))
        np.testing.assert_array_equal(y.numpy(), np.asarray(
            [w[1] for w in want], np.int32))


def _mlp_step(device, seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(),
                                torch.nn.Linear(64, 10)).to(device)
    opt = Momentum(learning_rate=0.05, momentum=0.9,
                   parameters=model.parameters())
    return model, TrainStep(model, opt,
                            lambda m, x, y: F.cross_entropy(m(x), y))


def test_train_step_replays_fresh_tensor_batches(cuda_device):
    """Ten calls with fresh Tensor batches of one shape: one capture and
    nine replays, the same losses as the same numpy arrays."""
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((16, 32)).astype(np.float32),
                rng.integers(0, 10, (16,)).astype(np.int32))
               for _ in range(10)]
    runs = {}
    for fed in ("tensors", "arrays"):
        _, step = _mlp_step(cuda_device)
        cap0 = cuda_graph.captures["train_step"]
        rep0 = cuda_graph.replays["train_step"]
        losses = []
        for x, y in batches:
            if fed == "tensors":
                x, y = ptt.to_tensor(x), ptt.to_tensor(y)
            losses.append(float(step(x, y)))
        runs[fed] = (losses, cuda_graph.captures["train_step"] - cap0,
                     cuda_graph.replays["train_step"] - rep0)
    assert runs["tensors"][1:] == (1, 9)
    assert runs["tensors"] == runs["arrays"]


@pytest.mark.parametrize("tier", ["buffered", "processes"])
def test_one_capture_over_a_loaders_epoch(cuda_device, tier):
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((48, 32)).astype(np.float32)
    ys = rng.integers(0, 10, (48,)).astype(np.int32)
    loader = DataLoader(C.ArraysDs(xs, ys), batch_size=8, **TIERS[tier])
    model, step = _mlp_step(cuda_device)
    cap0 = cuda_graph.captures["train_step"]
    rep0 = cuda_graph.replays["train_step"]
    losses = [float(step(x, y)) for x, y in loader]
    assert (cuda_graph.captures["train_step"] - cap0,
            cuda_graph.replays["train_step"] - rep0) == (1, 5)
    _, ref = _mlp_step(cuda_device)
    want = [float(ref(torch.from_numpy(xs[i:i + 8]).to(cuda_device),
                      torch.from_numpy(ys[i:i + 8]).to(cuda_device)))
            for i in range(0, 48, 8)]
    assert losses == want


def test_workers_make_no_cuda_context(cuda_device):
    torch.zeros(1, device=cuda_device)      # the parent's context
    rows = np.concatenate([b.numpy() for b in DataLoader(
        C.CardProbeDs(n=4), batch_size=2, num_workers=2)])
    assert (rows[:, 0] == 0).all()      # no CUDA context in a worker
    assert (rows[:, 1] == 0).all()      # no device visible there
    assert (rows[:, 2] == 1).all()      # the port's place is the CPU
    assert torch.cuda.is_initialized()


def test_worker_tensors_land_on_the_parents_card(cuda_device):
    """A custom collate's Tensors, made on a worker's CPU, unpickle onto
    the parent's default place: the card."""
    loader = DataLoader(C.ShmDs(n=8), batch_size=4, num_workers=2,
                        collate_fn=C.tensor_collate)
    out = list(loader)
    assert len(out) == 2
    for x, y in out:
        assert x.place == ptt.CUDAPlace(cuda_device.index)
        assert y.place == ptt.CUDAPlace(cuda_device.index)
