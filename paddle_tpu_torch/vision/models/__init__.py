"""Vision models (counterpart of paddle_tpu/vision/models): the ResNets,
LeNet, AlexNet, VGG, MobileNetV1-3, DenseNet, SqueezeNet, ShuffleNetV2,
GoogLeNet and InceptionV3."""
from . import extra, lenet_vgg_mobilenet, resnet
from .extra import (DenseNet, GoogLeNet, InceptionV3, MobileNetV1,
                    MobileNetV3, ShuffleNetV2, SqueezeNet, densenet121,
                    densenet161, densenet169, densenet201, googlenet,
                    inception_v3, mobilenet_v1, mobilenet_v3_large,
                    mobilenet_v3_small, shufflenet_v2_x0_5,
                    shufflenet_v2_x1_0, shufflenet_v2_x2_0, squeezenet1_0,
                    squeezenet1_1)
from .lenet_vgg_mobilenet import (VGG, AlexNet, LeNet, MobileNetV2, alexnet,
                                  mobilenet_v2, vgg11, vgg13, vgg16, vgg19)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2)

__all__ = ["extra", "lenet_vgg_mobilenet", "resnet", "BasicBlock",
           "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnext50_32x4d", "wide_resnet50_2",
           "LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16",
           "vgg19", "MobileNetV2", "mobilenet_v2", "DenseNet", "densenet121",
           "densenet161", "densenet169", "densenet201", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "MobileNetV1", "mobilenet_v1",
           "MobileNetV3", "mobilenet_v3_small", "mobilenet_v3_large",
           "ShuffleNetV2", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x2_0", "GoogLeNet", "googlenet", "InceptionV3",
           "inception_v3"]
