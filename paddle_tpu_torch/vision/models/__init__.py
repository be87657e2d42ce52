"""Vision models (counterpart of paddle_tpu/vision/models): the ResNet
family so far."""
from . import resnet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2)

__all__ = ["resnet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "wide_resnet50_2"]
