"""paddle_tpu_torch's ResNets under bf16 O1 against paddle_tpu's, with
FLAGS_fast_bn_stats off and on, on the CPU: resnet18 and a Bottleneck
ResNet (BottleneckBlock at resnet18's block counts, in
tests/test_torch_resnet_o1_bottleneck.py, in NHWC with the s2d stem
only), resnet18 in NCHW and in NHWC with the space-to-depth stem
(NHWC with the plain stem differs from it only in the stem, held in
f32 by tests/test_torch_resnet.py), batch 2 x 64 x 64
(tests/test_torch_resnet.py says why 64^2), the reference's weights.

bf16 O1 as bench_resnet50 runs it: convolutions and the fc in bf16
(white), batch norm in f32 (black), ReLU, pools and residual adds in
the dtype they are given (f32 after a batch norm), the loss in f32.

In bf16 the two packages round a convolution's f32 sums to bf16 at
places an ulp apart, and a batch norm turns such an ulp into a ReLU
landing on the other side of 0, amplified by every batch norm before
it: both packages' whole bf16 gradients stand 0.36-0.84 of their norm
from the exact ones (the port's f64 run of the same step), and a larger
batch does not bring them near (resnet18 in NCHW: 0.40 at batch 2, 0.34
at batch 16). So the step is also held stage by stage (the stem, each
residual block, the head: tests/torch_port_helpers.py's
stage_distances), each stage run on the reference's input to it and
differentiated against the reference's cotangent of its output. There
both packages make the same bf16 roundings: each package's stem and
block gradients stand 0.07-0.16 of their norm from the f64 ones (the
head's 0.003), and the port's from the reference's as stated below
(tests/torch_resnet_parity_report.py prints these readings).

Held here, with what was measured over the six cases:
- every sublayer's output dtype, call by call, the reference's;
- each stage's output within 1e-2 of its largest (<= 6.5e-3), and its
  parameters' and its input's gradients within 2.5e-2 of the
  reference's norm for resnet18 (<= 1.6e-2) and 5e-2 for the
  Bottleneck model (<= 3.6e-2);
- the whole step: the loss within 3e-2 relative (<= 1.1e-2); eval
  logits within 5e-2 of their largest (<= 1.9e-2); the running
  statistics the forward wrote within 2e-2 absolute (statistics of
  order 1; <= 3.7e-3); the output dtypes; and the whole gradients no
  farther from the exact ones than the reference's are, times 1.3
  (ratio <= 1.02)."""
import pytest

from torch_port_helpers import check_resnet_o1, fast_bn_flag


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc_s2d"])
def test_o1_loss_logits_statistics_and_gradients(layout, fast):
    restore = fast_bn_flag(fast)
    try:
        check_resnet_o1("BasicBlock", layout)
    finally:
        restore()
