"""The ResNet family (counterpart of paddle_tpu/vision/models/resnet.py,
BASELINE config 1). Module and parameter names, shapes and buffers are
the reference's, so its state_dict loads name for name
(``convert.resnet_params_from_numpy``): conv weights [out, in/groups,
kh, kw], the fc weight [in, out], the batch norms' ``_mean`` and
``_variance``.

``data_format="NHWC"`` takes and computes [N, H, W, C] activations, as
the reference does: each convolution views them channels-first without
a copy, so cuDNN computes in the channels-last layout; the weights keep
their standard (contiguous [out, in, kh, kw]) layout.
``space_to_depth_stem`` (NHWC only) computes the 7x7/s2 stem as the
identical 4x4/s1 convolution of the image's 2x2 pixel blocks over 12
channels, transforming the standard [64, 3, 7, 7] ``conv1.weight`` at
every call, so gradients reach that weight.

Each model is a ``Layer``. Entry points build the model on `device` (None: the CUDA card, raising
without one) in `dtype`, drawing every weight from a
``torch.Generator`` seeded with `seed` by the reference's initializers
(the conv layers' KaimingUniform, batch norm 1 and 0, the fc's
XavierUniform and zero bias)."""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...nn.layer import Layer
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                          MaxPool2D, ReLU, Sequential)
from ...nn.layers.common import _factory

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "resnext50_32x4d"]


def _norm(norm_layer, ch, df, fk):
    """The block's norm layer: BatchNorm2D in `df` built with the
    factory keywords `fk` by default; a custom `norm_layer` callable gets
    data_format only (and nothing in the default NCHW layout if it takes
    no data_format), as the reference passes it."""
    if norm_layer is None:
        return BatchNorm2D(ch, data_format=df, **fk)
    if df == "NCHW":
        try:
            return norm_layer(ch, data_format=df)
        except TypeError:
            return norm_layer(ch)
    return norm_layer(ch, data_format=df)


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", **fk):
        super().__init__()
        df = data_format
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, data_format=df, **fk)
        self.bn1 = _norm(norm_layer, planes, df, fk)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            data_format=df, **fk)
        self.bn2 = _norm(norm_layer, planes, df, fk)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", **fk):
        super().__init__()
        df = data_format
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            data_format=df, **fk)
        self.bn1 = _norm(norm_layer, width, df, fk)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation,
                            bias_attr=False, data_format=df, **fk)
        self.bn2 = _norm(norm_layer, width, df, fk)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, data_format=df, **fk)
        self.bn3 = _norm(norm_layer, planes * self.expansion, df, fk)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW",
                 space_to_depth_stem=False, *, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        if space_to_depth_stem and data_format != "NHWC":
            raise ValueError("space_to_depth_stem requires "
                             "data_format='NHWC'")
        fk = _factory(device, dtype)
        gen = torch.Generator(device=fk["device"])
        gen.manual_seed(seed)
        bfk = dict(fk, init_generator=gen)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.data_format = df = data_format
        self.space_to_depth_stem = space_to_depth_stem
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, data_format=df, **bfk)
        self.bn1 = BatchNorm2D(self.inplanes, data_format=df, **bfk)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1, data_format=df)
        self.layer1 = self._make_layer(block, 64, layers[0], bfk)
        self.layer2 = self._make_layer(block, 128, layers[1], bfk, stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], bfk, stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], bfk, stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=df)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             init_generator=gen, **fk)

    def _make_layer(self, block, planes, blocks, fk, stride=1):
        """`fk`: the factory keywords and generator the layers take."""
        df = self.data_format
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, data_format=df,
                       **fk),
                BatchNorm2D(planes * block.expansion, data_format=df, **fk))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, data_format=df, **fk)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, data_format=df,
                                **fk))
        return Sequential(*layers)

    def _stem_conv(self, x):
        if not self.space_to_depth_stem:
            return self.conv1(x)
        # x [N, H, W, 3] -> [N, H/2, W/2, 12], channel index (ph, pw, c)
        n, h, w, c = x.shape
        y = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        # the [O, 3, 7, 7] weight padded to 8 at the front, so tap
        # dh + 1 = 2 * jh + ph splits into (block tap jh, parity ph)
        wt = self.conv1.weight._data
        o = wt.shape[0]
        w8 = F.pad(wt, [0, 0, 0, 0, 1, 0, 1, 0])
        w8 = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        w2 = w8.reshape(o, 4 * c, 4, 4)
        # the 7x7 taps at rows 2 * ho + [-3..3] land on blocks
        # ho + [-2..1]: padding 2 before, 1 after
        return F.conv2d(y, w2, stride=1, padding=[(2, 1), (2, 1)],
                        data_format="NHWC")

    def forward(self, x):
        x = self.relu(self.bn1(self._stem_conv(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require network access; load a local "
            "state_dict with load_state_dict instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)
