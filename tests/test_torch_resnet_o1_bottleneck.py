"""tests/test_torch_resnet_o1.py's bf16 O1 comparison for the Bottleneck
ResNet (BottleneckBlock at resnet18's block counts), with
FLAGS_fast_bn_stats off and on, in bench_resnet50's layout (NHWC with
the space-to-depth stem; resnet18 takes NCHW too, in
tests/test_torch_resnet_o1.py, and tests/test_torch_resnet.py every
layout of both in f32). That file's docstring gives the tolerances. A
file of its own, so that one test worker takes each half, each within
a minute on the CPU."""
import pytest

from torch_port_helpers import check_resnet_o1, fast_bn_flag


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_o1_loss_logits_statistics_and_gradients(fast):
    restore = fast_bn_flag(fast)
    try:
        check_resnet_o1("BottleneckBlock", "nhwc_s2d")
    finally:
        restore()
