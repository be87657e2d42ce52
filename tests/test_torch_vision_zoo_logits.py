"""Eval logits of the vision zoo against paddle_tpu's on the CPU: the
port's weights (torch_port_helpers.twin_models) in both, batch 2 from a
numpy seed, logits within 1e-5 of the largest (f32 convolutions summed
in other orders), for the cheap architectures (MobileNetV2 at scale
0.25, MobileNetV1 at 0.25, MobileNetV3 small, ShuffleNetV2 x0.5,
SqueezeNet 1.1 and VGG11 with batch norm at 32^2, LeNet at 28^2). The
reference runs each model as one program (jit.to_static). The logits of
DenseNet, GoogLeNet, InceptionV3 and AlexNet are marked slow, as the
reference's own zoo test (tests/test_vision_models.py) is: compiling
those graphs takes 1.5-5 s each on the CPU, which the tier-1 run's time
budget leaves no room for."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from torch_port_helpers import twin_models, zero_filled_reference_init


# (name, constructor keywords, image side, in channels); LeNet's fc
# takes 28^2 inputs
CHEAP = [("mobilenet_v2", {"scale": 0.25}, 32, 3),
         ("mobilenet_v1", {"scale": 0.25}, 32, 3),
         ("mobilenet_v3_small", {}, 32, 3),
         ("shufflenet_v2_x0_5", {}, 32, 3), ("squeezenet1_1", {}, 32, 3),
         ("LeNet", {}, 28, 1), ("vgg11", {"batch_norm": True}, 32, 3)]
SLOW = [pytest.param("densenet121", {}, 32, 3, marks=pytest.mark.slow),
        pytest.param("googlenet", {}, 32, 3, marks=pytest.mark.slow),
        pytest.param("inception_v3", {}, 75, 3, marks=pytest.mark.slow),
        pytest.param("alexnet", {}, 64, 3, marks=pytest.mark.slow)]


@pytest.mark.parametrize("name,kw,hw,cin", CHEAP + SLOW)
def test_eval_logits_match_reference(name, kw, hw, cin, monkeypatch):
    zero_filled_reference_init(monkeypatch)
    ref, port = twin_models(name, kw)
    ref.eval()
    port.eval()
    x = np.random.default_rng(0).standard_normal(
        (2, cin, hw, hw)).astype(np.float32)
    # one compiled program: the reference's eager forward compiles each
    # op on its own, several times slower on the CPU
    want = np.asarray(pt.jit.to_static(ref)(pt.to_tensor(x))._data)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
