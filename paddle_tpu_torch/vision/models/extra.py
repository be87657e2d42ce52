"""DenseNet, SqueezeNet, MobileNetV1, MobileNetV3, ShuffleNetV2,
GoogLeNet and InceptionV3 (counterpart of
paddle_tpu/vision/models/extra.py). Names follow the reference so its
state_dicts load name for name (``convert.vision_params_from_numpy``);
every model is NCHW, a torch ``nn.Module`` of the port's layers built
on `device` (None: the CUDA card) in `dtype`, its weights drawn from a
``torch.Generator`` seeded with `seed`."""
from __future__ import annotations

from torch import nn

from ... import ops
from ...nn import functional as F
from ...nn.layers import (BatchNorm2D, Conv2D, Dropout, Hardswish, Linear,
                          MaxPool2D, ReLU, Sequential)
from .lenet_vgg_mobilenet import _keywords, _no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
           "MobileNetV1", "mobilenet_v1", "MobileNetV3",
           "mobilenet_v3_small", "mobilenet_v3_large", "ShuffleNetV2",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x2_0",
           "GoogLeNet", "googlenet", "InceptionV3", "inception_v3"]


def _conv_bn(cin, cout, k, stride=1, padding=0, groups=1, act="relu", **fk):
    layers = [Conv2D(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, **fk),
              BatchNorm2D(cout, **fk)]
    if act == "relu":
        layers.append(ReLU())
    elif act == "hardswish":
        layers.append(Hardswish())
    return Sequential(*layers)


# ======================= DenseNet =======================
class _DenseLayer(nn.Module):
    def __init__(self, cin, growth_rate, bn_size, dropout, **fk):
        super().__init__()
        self.norm1 = BatchNorm2D(cin, **fk)
        self.conv1 = Conv2D(cin, bn_size * growth_rate, 1, bias_attr=False,
                            **fk)
        self.norm2 = BatchNorm2D(bn_size * growth_rate, **fk)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3,
                            padding=1, bias_attr=False, **fk)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return ops.concat([x, self.dropout(out)], axis=1)


class _Transition(nn.Module):
    def __init__(self, cin, cout, **fk):
        super().__init__()
        self.norm = BatchNorm2D(cin, **fk)
        self.conv = Conv2D(cin, cout, 1, bias_attr=False, **fk)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """The 121 / 161 / 169 / 201 / 264 configurations."""

    _cfgs = {121: (64, 32, (6, 12, 24, 16)),
             161: (96, 48, (6, 12, 36, 24)),
             169: (64, 32, (6, 12, 32, 32)),
             201: (64, 32, (6, 12, 48, 32)),
             264: (64, 32, (6, 12, 64, 48))}

    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True, *, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        init_c, growth, blocks = self._cfgs[layers]
        self.stem = Sequential(
            Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False, **fk),
            BatchNorm2D(init_c, **fk), ReLU(),
            MaxPool2D(3, stride=2, padding=1))
        c = init_c
        feats = []
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, dropout, **fk))
                c += growth
            if i < len(blocks) - 1:
                feats.append(_Transition(c, c // 2, **fk))
                c //= 2
        self.features = Sequential(*feats)
        self.final_norm = BatchNorm2D(c, **fk)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = Linear(c, num_classes, **fk)

    def forward(self, x):
        x = F.relu(self.final_norm(self.features(self.stem(x))))
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def densenet121(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(201, **kw)


# ======================= SqueezeNet =======================
class _Fire(nn.Module):
    def __init__(self, cin, squeeze, e1, e3, **fk):
        super().__init__()
        self.squeeze = Conv2D(cin, squeeze, 1, **fk)
        self.expand1 = Conv2D(squeeze, e1, 1, **fk)
        self.expand3 = Conv2D(squeeze, e3, 3, padding=1, **fk)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return ops.concat([F.relu(self.expand1(s)),
                           F.relu(self.expand3(s))], axis=1)


class SqueezeNet(nn.Module):
    """The 1.0 and 1.1 variants."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None, dtype="float32", seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **fk), ReLU(),
                MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64, **fk), _Fire(128, 16, 64, 64, **fk),
                _Fire(128, 32, 128, 128, **fk), MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128, **fk),
                _Fire(256, 48, 192, 192, **fk),
                _Fire(384, 48, 192, 192, **fk),
                _Fire(384, 64, 256, 256, **fk),
                MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256, **fk))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, **fk), ReLU(),
                MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64, **fk), _Fire(128, 16, 64, 64, **fk),
                MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128, **fk),
                _Fire(256, 32, 128, 128, **fk),
                MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192, **fk),
                _Fire(384, 48, 192, 192, **fk),
                _Fire(384, 64, 256, 256, **fk),
                _Fire(512, 64, 256, 256, **fk))
        self.classifier_conv = Conv2D(512, num_classes, 1, **fk)
        self.dropout = Dropout(0.5)

    def forward(self, x):
        x = self.features(x)
        x = F.relu(self.classifier_conv(self.dropout(x)))
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        return F.flatten(x, 1)


def squeezenet1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kw)


# ======================= MobileNetV1 =======================
class MobileNetV1(nn.Module):
    """Depthwise-separable stacks."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype="float32", seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + [
               (512, 1024, 2), (1024, 1024, 1)]
        layers = [_conv_bn(3, c(32), 3, stride=2, padding=1, **fk)]
        for cin, cout, stride in cfg:
            layers.append(_conv_bn(c(cin), c(cin), 3, stride=stride,
                                   padding=1, groups=c(cin), **fk))
            layers.append(_conv_bn(c(cin), c(cout), 1, **fk))
        self.features = Sequential(*layers)
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes, **fk)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kw)


# ======================= MobileNetV3 =======================
class _SqueezeExcite(nn.Module):
    def __init__(self, ch, rd=4, **fk):
        super().__init__()
        self.fc1 = Conv2D(ch, ch // rd, 1, **fk)
        self.fc2 = Conv2D(ch // rd, ch, 1, **fk)

    def forward(self, x):
        s = F.adaptive_avg_pool2d(x, 1)
        s = F.relu(self.fc1(s))
        s = F.hardsigmoid(self.fc2(s))
        return x * s


class _MBV3Block(nn.Module):
    def __init__(self, cin, exp, cout, k, stride, use_se, act, **fk):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        layers = []
        if exp != cin:
            layers.append(_conv_bn(cin, exp, 1, act=act, **fk))
        layers.append(_conv_bn(exp, exp, k, stride=stride, padding=k // 2,
                               groups=exp, act=act, **fk))
        if use_se:
            layers.append(_SqueezeExcite(exp, **fk))
        layers.append(_conv_bn(exp, cout, 1, act="none", **fk))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV3(nn.Module):
    """The small and large configurations."""

    _small = [  # k, exp, cout, se, act, stride
        (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
        (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
        (5, 240, 40, True, "hardswish", 1),
        (5, 240, 40, True, "hardswish", 1),
        (5, 120, 48, True, "hardswish", 1),
        (5, 144, 48, True, "hardswish", 1),
        (5, 288, 96, True, "hardswish", 2),
        (5, 576, 96, True, "hardswish", 1),
        (5, 576, 96, True, "hardswish", 1)]
    _large = [
        (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "hardswish", 2),
        (3, 200, 80, False, "hardswish", 1),
        (3, 184, 80, False, "hardswish", 1),
        (3, 184, 80, False, "hardswish", 1),
        (3, 480, 112, True, "hardswish", 1),
        (3, 672, 112, True, "hardswish", 1),
        (5, 672, 160, True, "hardswish", 2),
        (5, 960, 160, True, "hardswish", 1),
        (5, 960, 160, True, "hardswish", 1)]

    def __init__(self, config="small", scale=1.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = self._small if config == "small" else self._large
        last_exp = 576 if config == "small" else 960

        def c(ch):
            # round to a multiple of 8, never below 90 % of the width
            v = ch * scale
            new = max(8, int(v + 4) // 8 * 8)
            if new < 0.9 * v:
                new += 8
            return new

        layers = [_conv_bn(3, c(16), 3, stride=2, padding=1,
                           act="hardswish", **fk)]
        cin = c(16)
        for k, exp, cout, se, act, stride in cfg:
            layers.append(_MBV3Block(cin, c(exp), c(cout), k, stride, se,
                                     act, **fk))
            cin = c(cout)
        layers.append(_conv_bn(cin, c(last_exp), 1, act="hardswish", **fk))
        self.features = Sequential(*layers)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(c(last_exp), 1280, **fk), Hardswish(),
                Dropout(0.2), Linear(1280, num_classes, **fk))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV3("small", scale=scale, **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV3("large", scale=scale, **kw)


# ======================= ShuffleNetV2 =======================
def _channel_shuffle(x, groups):
    return F.channel_shuffle(x, groups)


class _ShuffleUnit(nn.Module):
    def __init__(self, cin, cout, stride, **fk):
        super().__init__()
        self.stride = stride
        branch = cout // 2
        if stride == 1:
            in_b = cin // 2
        else:
            in_b = cin
            self.branch1 = Sequential(
                _conv_bn(in_b, in_b, 3, stride=stride, padding=1,
                         groups=in_b, act="none", **fk),
                _conv_bn(in_b, branch, 1, **fk))
        self.branch2 = Sequential(
            _conv_bn(in_b if stride > 1 else branch, branch, 1, **fk),
            _conv_bn(branch, branch, 3, stride=stride, padding=1,
                     groups=branch, act="none", **fk),
            _conv_bn(branch, branch, 1, **fk))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = ops.split(x, 2, axis=1)
            out = ops.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = ops.concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    _stage_out = {0.25: (24, 24, 48, 96, 512),
                  0.33: (24, 32, 64, 128, 512),
                  0.5: (24, 48, 96, 192, 1024),
                  1.0: (24, 116, 232, 464, 1024),
                  1.5: (24, 176, 352, 704, 1024),
                  2.0: (24, 244, 488, 976, 2048)}

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        c0, c1, c2, c3, c4 = self._stage_out[scale]
        self.stem = Sequential(_conv_bn(3, c0, 3, stride=2, padding=1, **fk),
                               MaxPool2D(3, stride=2, padding=1))
        stages = []
        cin = c0
        for cout, repeat in zip((c1, c2, c3), (4, 8, 4)):
            stages.append(_ShuffleUnit(cin, cout, 2, **fk))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(cout, cout, 1, **fk))
            cin = cout
        self.stages = Sequential(*stages)
        self.conv_last = _conv_bn(cin, c4, 1, **fk)
        if num_classes > 0:
            self.fc = Linear(c4, num_classes, **fk)

    def forward(self, x):
        x = self.conv_last(self.stages(self.stem(x)))
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def shufflenet_v2_x1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(2.0, **kw)


# ======================= GoogLeNet / InceptionV3 =======================
class _InceptionA(nn.Module):
    """GoogLeNet's inception block (1x1, 3x3, 5x5 and pool branches)."""

    def __init__(self, cin, c1, c3r, c3, c5r, c5, cp, **fk):
        super().__init__()
        self.b1 = _conv_bn(cin, c1, 1, **fk)
        self.b3 = Sequential(_conv_bn(cin, c3r, 1, **fk),
                             _conv_bn(c3r, c3, 3, padding=1, **fk))
        self.b5 = Sequential(_conv_bn(cin, c5r, 1, **fk),
                             _conv_bn(c5r, c5, 5, padding=2, **fk))
        self.bp = _conv_bn(cin, cp, 1, **fk)

    def forward(self, x):
        pooled = F.max_pool2d(x, 3, stride=1, padding=1)
        return ops.concat([self.b1(x), self.b3(x), self.b5(x),
                           self.bp(pooled)], axis=1)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _conv_bn(3, 64, 7, stride=2, padding=3, **fk),
            MaxPool2D(3, stride=2, padding=1),
            _conv_bn(64, 64, 1, **fk), _conv_bn(64, 192, 3, padding=1, **fk),
            MaxPool2D(3, stride=2, padding=1))
        self.inc3 = Sequential(
            _InceptionA(192, 64, 96, 128, 16, 32, 32, **fk),
            _InceptionA(256, 128, 128, 192, 32, 96, 64, **fk))
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.inc4 = Sequential(
            _InceptionA(480, 192, 96, 208, 16, 48, 64, **fk),
            _InceptionA(512, 160, 112, 224, 24, 64, 64, **fk),
            _InceptionA(512, 128, 128, 256, 24, 64, 64, **fk),
            _InceptionA(512, 112, 144, 288, 32, 64, 64, **fk),
            _InceptionA(528, 256, 160, 320, 32, 128, 128, **fk))
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.inc5 = Sequential(
            _InceptionA(832, 256, 160, 320, 32, 128, 128, **fk),
            _InceptionA(832, 384, 192, 384, 48, 128, 128, **fk))
        self.dropout = Dropout(0.2)
        if num_classes > 0:
            self.fc = Linear(1024, num_classes, **fk)

    def forward(self, x):
        x = self.inc5(self.pool4(self.inc4(self.pool3(self.inc3(
            self.stem(x))))))
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        if self.num_classes > 0:
            x = self.fc(self.dropout(F.flatten(x, 1)))
        return x


def googlenet(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return GoogLeNet(**kw)


class _InceptionV3A(nn.Module):
    def __init__(self, cin, pool_feat, **fk):
        super().__init__()
        self.b1 = _conv_bn(cin, 64, 1, **fk)
        self.b5 = Sequential(_conv_bn(cin, 48, 1, **fk),
                             _conv_bn(48, 64, 5, padding=2, **fk))
        self.b3 = Sequential(_conv_bn(cin, 64, 1, **fk),
                             _conv_bn(64, 96, 3, padding=1, **fk),
                             _conv_bn(96, 96, 3, padding=1, **fk))
        self.bp = _conv_bn(cin, pool_feat, 1, **fk)

    def forward(self, x):
        p = F.avg_pool2d(x, 3, stride=1, padding=1)
        return ops.concat([self.b1(x), self.b5(x), self.b3(x),
                           self.bp(p)], axis=1)


class _InceptionV3Reduce(nn.Module):
    def __init__(self, cin, **fk):
        super().__init__()
        self.b3 = _conv_bn(cin, 384, 3, stride=2, **fk)
        self.b3d = Sequential(_conv_bn(cin, 64, 1, **fk),
                              _conv_bn(64, 96, 3, padding=1, **fk),
                              _conv_bn(96, 96, 3, stride=2, **fk))

    def forward(self, x):
        p = F.max_pool2d(x, 3, stride=2)
        return ops.concat([self.b3(x), self.b3d(x), p], axis=1)


class _InceptionV3C(nn.Module):
    def __init__(self, cin, c7, **fk):
        super().__init__()
        self.b1 = _conv_bn(cin, 192, 1, **fk)
        self.b7 = Sequential(
            _conv_bn(cin, c7, 1, **fk),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3), **fk),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0), **fk))
        self.b7d = Sequential(
            _conv_bn(cin, c7, 1, **fk),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0), **fk),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3), **fk),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0), **fk),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3), **fk))
        self.bp = _conv_bn(cin, 192, 1, **fk)

    def forward(self, x):
        p = F.avg_pool2d(x, 3, stride=1, padding=1)
        return ops.concat([self.b1(x), self.b7(x), self.b7d(x),
                           self.bp(p)], axis=1)


class InceptionV3(nn.Module):
    """The 299x299 v3 trunk: the A (35x35), reduction and C (17x17)
    stages and the reference's simplified final stage (dense 3x3s)."""

    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        fk = _keywords(device, dtype, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _conv_bn(3, 32, 3, stride=2, **fk), _conv_bn(32, 32, 3, **fk),
            _conv_bn(32, 64, 3, padding=1, **fk), MaxPool2D(3, stride=2),
            _conv_bn(64, 80, 1, **fk), _conv_bn(80, 192, 3, **fk),
            MaxPool2D(3, stride=2))
        self.inc_a = Sequential(
            _InceptionV3A(192, 32, **fk), _InceptionV3A(256, 64, **fk),
            _InceptionV3A(288, 64, **fk))
        self.reduce1 = _InceptionV3Reduce(288, **fk)
        self.inc_c = Sequential(
            _InceptionV3C(768, 128, **fk), _InceptionV3C(768, 160, **fk),
            _InceptionV3C(768, 160, **fk), _InceptionV3C(768, 192, **fk))
        self.tail = Sequential(
            _conv_bn(768, 1280, 3, stride=2, **fk),
            _conv_bn(1280, 2048, 1, **fk))
        self.dropout = Dropout(0.5)
        if num_classes > 0:
            self.fc = Linear(2048, num_classes, **fk)

    def forward(self, x):
        x = self.tail(self.inc_c(self.reduce1(self.inc_a(self.stem(x)))))
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, 1)
        if self.num_classes > 0:
            x = self.fc(self.dropout(F.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return InceptionV3(**kw)
