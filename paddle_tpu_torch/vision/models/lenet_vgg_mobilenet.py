"""LeNet, AlexNet, VGG and MobileNetV2 (counterpart of
paddle_tpu/vision/models/lenet_vgg_mobilenet.py). Module and parameter
names, shapes and buffers are the reference's, so its state_dict loads
name for name (``convert.vision_params_from_numpy``).

As the ResNets, each model is a ``Layer`` of the port's
layers, built on `device` (None: the CUDA card, raising without one) in
`dtype`, its weights drawn by the reference's initializers from a
``torch.Generator`` seeded with `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import functional as F
from ...nn.layer import Layer
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                          Linear, MaxPool2D, ReLU, ReLU6, Sequential)
from ...nn.layers.common import _factory

__all__ = ["LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16",
           "vgg19", "MobileNetV2", "mobilenet_v2"]


def _keywords(device, dtype, seed):
    """The factory keywords and weight generator every layer of a model
    takes."""
    fk = _factory(device, dtype)
    gen = torch.Generator(device=fk["device"])
    gen.manual_seed(seed)
    return dict(fk, init_generator=gen)


class LeNet(Layer):
    def __init__(self, num_classes=10, *, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **fk), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **fk), ReLU(),
            MaxPool2D(2, 2))
        self.fc = Sequential(
            Linear(400, 120, **fk), Linear(120, 84, **fk),
            Linear(84, num_classes, **fk))

    def forward(self, x):
        x = self.features(x)
        return self.fc(F.flatten(x, 1))


class AlexNet(Layer):
    def __init__(self, num_classes=1000, *, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **fk), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, **fk), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, **fk), ReLU(),
            Conv2D(384, 256, 3, padding=1, **fk), ReLU(),
            Conv2D(256, 256, 3, padding=1, **fk), ReLU(),
            MaxPool2D(3, 2))
        self.classifier = Sequential(
            Dropout(0.5), Linear(256 * 6 * 6, 4096, **fk), ReLU(),
            Dropout(0.5), Linear(4096, 4096, **fk), ReLU(),
            Linear(4096, num_classes, **fk))

    def forward(self, x):
        x = self.features(x)
        x = F.adaptive_avg_pool2d(x, (6, 6))
        return self.classifier(F.flatten(x, 1))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


_VGG_CFG = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Layer):
    """`features` a Sequential of the convolutions (``_make_vgg_layers``
    builds the four configurations); the classifier draws from `seed`
    after it."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, dtype="float32", seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        self.classifier = Sequential(
            Linear(512 * 7 * 7, 4096, **fk), ReLU(), Dropout(),
            Linear(4096, 4096, **fk), ReLU(), Dropout(),
            Linear(4096, num_classes, **fk))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        return self.classifier(F.flatten(x, 1))


def _make_vgg_layers(cfg, batch_norm=False, **fk):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1, **fk))
            if batch_norm:
                layers.append(BatchNorm2D(v, **fk))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


def _vgg(cfg, pretrained, batch_norm, device=None, dtype="float32", seed=0,
         **kwargs):
    _no_pretrained(pretrained)
    features = _make_vgg_layers(_VGG_CFG[cfg], batch_norm,
                                **_keywords(device, dtype, seed + 1))
    return VGG(features, device=device, dtype=dtype, seed=seed, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, **kwargs)


class _InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, **fk):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [Conv2D(inp, hidden, 1, bias_attr=False, **fk),
                       BatchNorm2D(hidden, **fk), ReLU6()]
        layers += [
            Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                   groups=hidden, bias_attr=False, **fk),
            BatchNorm2D(hidden, **fk), ReLU6(),
            Conv2D(hidden, oup, 1, bias_attr=False, **fk),
            BatchNorm2D(oup, **fk)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        if self.use_res:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype="float32", seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = int(32 * scale)
        features = [Conv2D(3, in_c, 3, stride=2, padding=1, bias_attr=False,
                           **fk),
                    BatchNorm2D(in_c, **fk), ReLU6()]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(_InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t, **fk))
                in_c = out_c
        last = int(1280 * max(1.0, scale))
        features += [Conv2D(in_c, last, 1, bias_attr=False, **fk),
                     BatchNorm2D(last, **fk), ReLU6()]
        self.features = Sequential(*features)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(Dropout(0.2),
                                         Linear(last, num_classes, **fk))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def _no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require network access; load a local "
            "state_dict with load_state_dict instead")
