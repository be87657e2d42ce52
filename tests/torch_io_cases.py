"""Datasets and collates for the port's DataLoader, at module level so
that spawned workers can unpickle them. The module imports numpy and the
port, never JAX (the card's machine has none): chip_smoke.py's phase 23
feeds its models from the datasets here, as tests/test_torch_io.py and
tests/test_torch_io_cuda.py run them on the CPU and on the card."""
import os
import time

import numpy as np

from paddle_tpu_torch.io import Dataset


class _Base(Dataset):
    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n


class ArrayDs(_Base):
    """tests/test_process_dataloader.py's ArrayDs: a seeded sample and
    its index; `big` samples (256 KiB) take the SharedMemory path."""

    def __init__(self, n=16, big=False):
        super().__init__(n)
        self.big = big

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        size = 64 * 1024 if self.big else 8
        x = rng.standard_normal(size).astype(np.float32) * 2.0
        return x, np.int64(i)


class BoomDs(ArrayDs):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return super().__getitem__(i)


class InfoDs(ArrayDs):
    """Each sample filled with the id of the worker that loaded it."""

    def __getitem__(self, i):
        from paddle_tpu_torch.io import get_worker_info
        info = get_worker_info()
        assert info is not None and info.num_workers == 2
        return np.full((4,), float(info.id), np.float32), np.int64(i)


class ShmDs(_Base):
    """tests/test_resilience.py's ShmDs: big samples force the
    SharedMemory transport."""

    def __init__(self, n=24):
        super().__init__(n)

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.standard_normal(64 * 1024).astype(np.float32), \
            np.int64(i)


class EnvGuardDs(ShmDs):
    """Asserts the spawn-env contract: the card is hidden
    (``CUDA_VISIBLE_DEVICES=""``) and the port's default place is the
    CPU when the dataset is unpickled in the worker, i.e. the env guard
    runs before any user code."""

    def __setstate__(self, state):
        from paddle_tpu_torch.core import device
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == "", \
            "dataset unpickled before the worker's env guard"
        assert device._current_place is not None \
            and device._current_place.is_cpu_place(), \
            "dataset unpickled before the worker's place was the CPU"
        self.__dict__.update(state)


class CardProbeDs(_Base):
    """Each sample reports, from the process that loaded it: whether
    torch made a CUDA context there, how many devices it sees, whether
    the port's default place is the CPU, and the process id."""

    def __getitem__(self, i):
        import torch

        import paddle_tpu_torch as ptt
        return np.array([int(torch.cuda.is_initialized()),
                         torch.cuda.device_count(),
                         int(ptt.get_place().is_cpu_place()),
                         os.getpid()], np.int64)


class ModulesProbeDs(_Base):
    """Each sample reports, from the process that loaded it, whether JAX
    or the reference package is loaded there and whether torch made a
    CUDA context."""

    def __getitem__(self, i):
        import sys

        import torch
        loaded = [k for k in sys.modules if k.split(".")[0] in
                  ("jax", "jaxlib", "paddle_tpu")]
        return np.array([len(loaded), int(torch.cuda.is_initialized())],
                        np.int64)


class SlowDs(_Base):
    """tests/test_native_io.py's dataset: rows of an arange, with a
    simulated decode cost."""

    def __init__(self, n=64, d=128):
        super().__init__(n)
        self.data = np.arange(n * d, dtype=np.float32).reshape(n, d)

    def __getitem__(self, i):
        time.sleep(0.001)
        return self.data[i]


class BadSlowDs(SlowDs):
    def __getitem__(self, i):
        if i == 19:
            raise ValueError("corrupt sample")
        return super().__getitem__(i)


class MixedDs(_Base):
    """Samples of every kind the default collate handles: arrays of
    several dtypes, Python and numpy scalars, a nested tuple and a
    dict."""

    def __getitem__(self, i):
        rng = np.random.RandomState(100 + i)
        return {"x": rng.standard_normal((3, 5)),            # float64
                "ids": rng.randint(0, 50, (7,)),              # int64
                "mask": rng.rand(4) > 0.5,
                "h": rng.standard_normal(6).astype(np.float16)}, \
            (i, float(i) / 3, np.float32(i) * 2, bool(i % 2)), \
            [np.uint8(i), rng.standard_normal(2).astype(np.float32)]


def tensor_collate(batch):
    """A collate returning the port's Tensors (made on the default
    place, the CPU inside a worker): Tensor.__reduce__ makes its output
    picklable, so the loader keeps the process tier, and the Tensors
    land on the parent's default place."""
    import paddle_tpu_torch as ptt
    xs, ys = zip(*batch)
    return (ptt.to_tensor(np.stack(xs)), ptt.to_tensor(np.asarray(ys)))


class ArraysDs(_Base):
    """Samples `i` of fixed arrays: (xs[i], ys[i])."""

    def __init__(self, xs, ys):
        super().__init__(len(xs))
        self.xs, self.ys = xs, ys

    def __getitem__(self, i):
        return self.xs[i], self.ys[i]


class ImagePool(_Base):
    """`n` samples of a pool of `pool` f32 NHWC images (hw x hw x 3,
    standard normal) and int32 labels of `classes` classes, made from a
    numpy seed in each process that reads them (the pickle sent to a
    worker carries the seed, not the pool), indexed modulo the pool."""

    def __init__(self, n, pool=512, hw=224, classes=1000, seed=0):
        super().__init__(n)
        self.pool, self.hw, self.classes, self.seed = pool, hw, classes, seed
        self._images = self._labels = None

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_images", "_labels")}

    def __setstate__(self, state):
        self.__dict__.update(state, _images=None, _labels=None)

    def arrays(self):
        if self._images is None:
            rng = np.random.default_rng(self.seed)
            self._images = rng.standard_normal(
                (self.pool, self.hw, self.hw, 3), dtype=np.float32)
            self._labels = rng.integers(
                0, self.classes, (self.pool,)).astype(np.int32)
        return self._images, self._labels

    def __getitem__(self, i):
        images, labels = self.arrays()
        j = i % self.pool
        return images[j], labels[j]


class RowsDs(_Base):
    """Rows of (ids, labels) batches ([b, s] int arrays each), one
    sample a row, in order: a loader of batch size b gives the batches
    back."""

    def __init__(self, batches):
        self.ids = np.concatenate([np.asarray(i, np.int32)
                                   for i, _ in batches])
        self.labels = np.concatenate([np.asarray(l, np.int32)
                                      for _, l in batches])
        super().__init__(len(self.ids))

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


def write_image_folder(root, classes=10, per_class=128, hw=256, seed=0):
    """`classes` directories of `per_class` uint8 hw x hw x 3 ``.npy``
    images from a numpy seed under `root`: an ImageNet-style folder for
    ``vision.datasets.DatasetFolder``."""
    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = os.path.join(root, f"class_{c:03d}")
        os.makedirs(d, exist_ok=True)
        for k in range(per_class):
            np.save(os.path.join(d, f"img_{k:05d}.npy"),
                    rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8))
    return classes * per_class


class ObsShmDs(_Base):
    """tests/test_observability.py's ObsShmDs: 256 KiB samples take the
    SharedMemory transport. Plain numpy samples: the reference's
    DataLoader takes it too (tests/test_torch_io_obs.py runs both)."""

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.standard_normal(64 * 1024).astype(np.float32), \
            np.int64(i)


class ObsSmallDs(_Base):
    """tests/test_request_tracing.py's SpawnTraceDs: tiny samples that
    ride the queue pickle."""

    def __getitem__(self, i):
        return np.full((4,), i, np.float32)
