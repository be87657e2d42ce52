"""Vision transforms (counterpart of paddle_tpu/vision/transforms; ref:
python/paddle/vision/transforms/): host-side preprocessing in numpy and
Python's ``random``, with the reference's arithmetic, run in the
DataLoader's workers. ``ToTensor`` makes a Tensor on the default place,
which is the CPU inside a spawned worker (and the card, or the CPU
after ``set_device("cpu")``, in the main process)."""
from __future__ import annotations

import numbers
import random

import numpy as np

from ...core.tensor import Tensor

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "RandomResizedCrop", "Transpose",
           "to_tensor", "normalize", "resize", "hflip", "vflip",
           "center_crop"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        img = _as_hwc(img).astype(np.float32)
        if img.dtype == np.uint8 or img.max() > 1.5:
            img = img / 255.0
        if self.data_format == "CHW":
            img = img.transpose(2, 0, 1)
        return Tensor(img)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        if isinstance(img, Tensor):
            img = img.numpy()
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m = self.mean
            s = self.std
        return (img - m) / s


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        if isinstance(self.size, int):
            if h < w:
                nh, nw = self.size, int(w * self.size / h)
            else:
                nh, nw = int(h * self.size / w), self.size
        else:
            nh, nw = self.size
        ys = (np.arange(nh) + 0.5) * h / nh - 0.5
        xs = (np.arange(nw) + 0.5) * w / nw - 0.5
        ys = np.clip(ys, 0, h - 1)
        xs = np.clip(xs, 0, w - 1)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        img = img.astype(np.float32)
        out = (img[y0][:, x0] * (1 - wy) * (1 - wx)
               + img[y0][:, x1] * (1 - wy) * wx
               + img[y1][:, x0] * wy * (1 - wx)
               + img[y1][:, x1] * wy * wx)
        return out


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, int) else size

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, keys=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding:
            p = self.padding
            img = np.pad(img, [(p, p), (p, p), (0, 0)])
        h, w = img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return _as_hwc(img)[:, ::-1]
        return _as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return _as_hwc(img)[::-1]
        return _as_hwc(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size)

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return self._resize(img[i:i + th, j:j + tw])
        return self._resize(CenterCrop(min(h, w))(img))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size)(img)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)
