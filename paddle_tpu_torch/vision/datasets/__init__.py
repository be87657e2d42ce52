"""Vision datasets (counterpart of paddle_tpu/vision/datasets; ref:
python/paddle/vision/datasets/).

They read local files only (no downloads). Where the files are missing
they fall back to deterministic synthetic data with a loud warning, or
raise under ``allow_synthetic=False``."""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
import warnings

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "DatasetFolder", "ImageFolder"]


def _synthetic_fallback(name: str, reason: str, allow: bool):
    """Never hand the user fake data silently: warn loudly on the
    synthetic fallback; raise when allow_synthetic=False."""
    msg = (f"{name}: {reason} — falling back to DETERMINISTIC SYNTHETIC "
           f"data (random pixels/labels). This is NOT the real dataset; "
           f"metrics trained on it are meaningless. Pass the local "
           f"dataset files (zero-egress environment: no downloads), or "
           f"allow_synthetic=False to make this an error.")
    if not allow:
        raise FileNotFoundError(f"{name}: {reason} (allow_synthetic=False)")
    warnings.warn(msg, UserWarning, stacklevel=3)


class _SyntheticImages(Dataset):
    def __init__(self, n, shape, num_classes, transform=None, seed=0):
        self.n = n
        self.shape = shape
        self.num_classes = num_classes
        self.transform = transform
        self.rng = np.random.RandomState(seed)
        self.images = self.rng.randint(
            0, 256, size=(n,) + shape, dtype=np.uint8)
        self.labels = self.rng.randint(0, num_classes, size=(n,),
                                       dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return self.n


class MNIST(Dataset):
    """(ref: python/paddle/dataset/mnist.py) — local idx files or synthetic."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None,
                 allow_synthetic=True):
        self.transform = transform
        if (image_path and os.path.exists(image_path)
                and label_path and os.path.exists(label_path)):
            with gzip.open(image_path, "rb") as f:
                _, n, h, w = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), np.uint8).reshape(
                    n, h, w)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), np.uint8).astype(
                    np.int64)
        else:
            _synthetic_fallback(
                type(self).__name__,
                "no local idx files" if not (image_path and label_path)
                else f"image_path/label_path ({image_path!r}, "
                     f"{label_path!r}) not both present",
                allow_synthetic)
            synth = _SyntheticImages(1024 if mode == "train" else 256,
                                     (28, 28), 10)
            self.images, self.labels = synth.images, synth.labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None, allow_synthetic=True):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            images, labels = [], []
            with tarfile.open(data_file) as tf:
                names = [n for n in tf.getnames()
                         if ("data_batch" in n if mode == "train"
                             else "test_batch" in n)]
                for n in sorted(names):
                    d = pickle.load(tf.extractfile(n), encoding="bytes")
                    images.append(d[b"data"].reshape(-1, 3, 32, 32))
                    labels.extend(d[b"labels"])
            self.images = np.concatenate(images).transpose(0, 2, 3, 1)
            self.labels = np.asarray(labels, np.int64)
        else:
            _synthetic_fallback(
                type(self).__name__,
                "no local data_file" if not data_file
                else f"data_file {data_file!r} does not exist",
                allow_synthetic)
            synth = _SyntheticImages(1024 if mode == "train" else 256,
                                     (32, 32, 3), 10)
            self.images, self.labels = synth.images, synth.labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    pass


class Flowers(_SyntheticImages):
    """Flowers-102. Real files (102flowers.tgz jpgs) need a jpg decoder
    per image; supply them via DatasetFolder with a decoding `loader`.
    This class is synthetic-shape-only and says so."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None, allow_synthetic=True):
        _synthetic_fallback(
            "Flowers", "jpg-archive parsing is not implemented "
            "(use DatasetFolder with a decoding loader= for the real "
            "files)",
            allow_synthetic)
        super().__init__(512, (224, 224, 3), 102, transform)


class DatasetFolder(Dataset):
    """(ref: python/paddle/vision/datasets/folder.py) — directory-of-class
    -subdirs image dataset; requires a local image decoder."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        exts = extensions or (".png", ".jpg", ".jpeg", ".npy")
        for c in classes:
            d = os.path.join(root, c)
            for fname in sorted(os.listdir(d)):
                if fname.lower().endswith(tuple(exts)):
                    self.samples.append((os.path.join(d, fname),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        raise RuntimeError(
            "no image decoder baked in; supply loader= or use .npy files")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder
