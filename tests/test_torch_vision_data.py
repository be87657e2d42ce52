"""paddle_tpu_torch.vision.transforms and .datasets against the
reference's on the CPU.

Each transform runs on the same input in both packages: the crops and
flips after ``random.seed`` in both, exactly equal; ``Resize`` (its
bilinear weights) and ``Normalize`` (a float subtraction and division)
within an absolute and relative 1e-6 (both run the same numpy
arithmetic on the same values, so they agree to the last bit here; the
tolerance leaves room for a numpy whose ufuncs take another SIMD path).
``MNIST`` and ``Cifar10`` read small idx/gzip and pickle-tar files
written to `tmp_path`, equal in both packages; the synthetic fallback
warns, and raises under ``allow_synthetic=False``."""
import gzip
import io
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_io_cases as C
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tT
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _np(x):
    return x.numpy() if isinstance(x, (pt.Tensor, ptt.Tensor)) \
        else np.asarray(x)


def _image(h=37, w=53, c=3, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return rng.standard_normal((h, w, c)).astype(dtype)


def _both(make, img, seed=None):
    """make(T)(img) in the reference and in the port, each after
    random.seed(seed) when a seed is given."""
    out = []
    for T in (jT, tT):
        if seed is not None:
            random.seed(seed)
        out.append(_np(make(T)(img)))
    return out


EXACT = {
    "CenterCrop": lambda T: T.CenterCrop(20),
    "CenterCrop (h, w)": lambda T: T.CenterCrop((10, 30)),
    "RandomCrop": lambda T: T.RandomCrop(24),
    "RandomCrop padded": lambda T: T.RandomCrop((30, 40), padding=4),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(0.7),
    "Transpose": lambda T: T.Transpose(),
    "hflip": lambda T: T.hflip,
    "vflip": lambda T: T.vflip,
    "center_crop": lambda T: lambda im: T.center_crop(im, 16),
}


@pytest.mark.parametrize("name", sorted(EXACT))
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_crops_and_flips_equal_the_reference(name, seed):
    want, got = _both(EXACT[name], _image(seed=seed), seed=seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("size", [24, (16, 20)])
def test_random_resized_crop_equals_the_reference(seed, size):
    want, got = _both(lambda T: T.RandomResizedCrop(size, scale=(0.3, 1.0)),
                      _image(64, 48, seed=seed), seed=seed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


RESIZE = {
    "shorter side": (lambda T: T.Resize(24), np.uint8),
    "(h, w)": (lambda T: T.Resize((17, 70)), np.uint8),
    "upscale f32": (lambda T: T.Resize((80, 90)), np.float32),
    "functional": (lambda T: lambda im: T.resize(im, 31), np.float32),
    "gray": (lambda T: T.Resize(12), "gray"),
}


@pytest.mark.parametrize("name", sorted(RESIZE))
def test_resize_equals_the_reference(name):
    make, dtype = RESIZE[name]
    img = _image(c=1)[:, :, 0] if dtype == "gray" else _image(dtype=dtype)
    want, got = _both(make, img)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


NORMALIZE = {
    "CHW": lambda T: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3]),
    "HWC": lambda T: T.Normalize([0.485, 0.456, 0.406],
                                 [0.229, 0.224, 0.225], data_format="HWC"),
    "scalars": lambda T: T.Normalize(0.5, 2.0),
    "functional": lambda T: lambda im: T.normalize(im, [1.0, 2.0, 3.0],
                                                   [2.0, 2.0, 2.0], "HWC"),
}


@pytest.mark.parametrize("name", sorted(NORMALIZE))
def test_normalize_equals_the_reference(name):
    img = _image(dtype=np.float32)
    if name in ("CHW", "scalars"):
        img = img.transpose(2, 0, 1)
    want, got = _both(NORMALIZE[name], img)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_tensor_equals_the_reference(fmt, dtype):
    img = _image(dtype=dtype)
    want, got = _both(lambda T: T.ToTensor(fmt), img)
    t = tT.to_tensor(img, fmt)
    assert isinstance(t, ptt.Tensor) and t.place == ptt.CPUPlace()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(t.numpy(), got)


def test_compose_of_a_tensor_normalizes_its_array():
    """Normalize takes a Tensor (ToTensor's output) through numpy, as
    the reference does; Compose chains."""
    img = _image(40, 40)

    def pipeline(T):
        return T.Compose([T.CenterCrop(32), T.ToTensor(),
                          T.Normalize([0.5] * 3, [0.5] * 3)])

    want, got = _both(pipeline, img)
    assert got.shape == want.shape == (3, 32, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_image_net_pipeline_equals_the_reference():
    """chip_smoke.py phase 23c's transform on one of its images."""
    img = _image(256, 256)

    def pipeline(T):
        return T.Compose([
            T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
            T.Normalize([123.675, 116.28, 103.53], [58.395, 57.12, 57.375],
                        data_format="HWC")])

    for seed in range(3):
        want, got = _both(pipeline, img, seed=seed)
        assert got.shape == (224, 224, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
def _write_mnist(tmp_path, n=9, h=5, w=4, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    labels = rng.integers(0, 10, (n,), dtype=np.uint8)
    ip, lp = tmp_path / "images.gz", tmp_path / "labels.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, h, w) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(ip), str(lp), images, labels


def _write_cifar(tmp_path, per_batch=4, seed=0):
    rng = np.random.default_rng(seed)
    path = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name in ("cifar-10-batches-py/data_batch_1",
                     "cifar-10-batches-py/data_batch_2",
                     "cifar-10-batches-py/test_batch"):
            d = {b"data": rng.integers(0, 256, (per_batch, 3 * 32 * 32),
                                       dtype=np.uint8),
                 b"labels": rng.integers(0, 10, per_batch).tolist()}
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))
    return str(path)


def _items(ds):
    return [(_np(img), label) for img, label in
            (ds[i] for i in range(len(ds)))]


def _same_items(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gl == wl and type(gl) is type(wl)
        assert gi.dtype == wi.dtype
        np.testing.assert_allclose(gi, wi, **TOL)


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_reads_idx_files_as_the_reference(tmp_path, cls):
    ip, lp, images, labels = _write_mnist(tmp_path)
    want = getattr(jds, cls)(image_path=ip, label_path=lp)
    got = getattr(tds, cls)(image_path=ip, label_path=lp)
    np.testing.assert_array_equal(got.images, images)
    np.testing.assert_array_equal(got.labels, labels.astype(np.int64))
    _same_items(_items(got), _items(want))
    # with a transform
    t_want = getattr(jds, cls)(image_path=ip, label_path=lp,
                               transform=jT.ToTensor())
    t_got = getattr(tds, cls)(image_path=ip, label_path=lp,
                              transform=tT.ToTensor())
    _same_items(_items(t_got), _items(t_want))


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("cls", ["Cifar10", "Cifar100"])
def test_cifar_reads_the_pickle_tar_as_the_reference(tmp_path, mode, cls):
    path = _write_cifar(tmp_path)
    want = getattr(jds, cls)(data_file=path, mode=mode)
    got = getattr(tds, cls)(data_file=path, mode=mode)
    assert len(got) == (8 if mode == "train" else 4)
    assert got.images.shape[1:] == (32, 32, 3)
    _same_items(_items(got), _items(want))


@pytest.mark.parametrize("cls,kw", [
    ("MNIST", {}), ("Cifar10", {}), ("Cifar100", {"mode": "test"}),
    ("Flowers", {})])
def test_synthetic_fallback_warns_and_refuses(cls, kw):
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = getattr(tds, cls)(**kw)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        want = getattr(jds, cls)(**kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(np.asarray(got[3][0]),
                                  np.asarray(want[3][0]))
    with pytest.raises(FileNotFoundError, match="allow_synthetic=False"):
        getattr(tds, cls)(allow_synthetic=False, **kw)


def test_dataset_folder_equals_the_reference(tmp_path):
    n = C.write_image_folder(str(tmp_path), classes=3, per_class=4, hw=8)
    (tmp_path / "not_a_class.txt").write_text("x")
    (tmp_path / "class_000" / "notes.txt").write_text("x")
    want = jds.DatasetFolder(str(tmp_path))
    got = tds.ImageFolder(str(tmp_path))
    assert len(got) == n == 12
    assert got.class_to_idx == want.class_to_idx
    assert [p for p, _ in got.samples] == [p for p, _ in want.samples]
    _same_items(_items(got), _items(want))
    random.seed(0)
    flip = tds.DatasetFolder(str(tmp_path),
                             transform=tT.RandomHorizontalFlip(1.0))
    np.testing.assert_array_equal(flip[5][0], got[5][0][:, ::-1])
    with pytest.raises(RuntimeError, match="no image decoder"):
        tds.DatasetFolder(str(tmp_path), extensions=(".txt",))[0]
