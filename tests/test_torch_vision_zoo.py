"""The vision model zoo (paddle_tpu_torch.vision.models: LeNet,
AlexNet, VGG, MobileNetV1-3, DenseNet, SqueezeNet, ShuffleNetV2,
GoogLeNet, InceptionV3) against paddle_tpu's, on the CPU: every
constructor's state_dict names, shapes and dtypes and its parameter
count equal to the reference's; the constructors' keywords. The eval
logits are in tests/test_torch_vision_zoo_logits.py, MobileNetV2's
training in tests/test_torch_mobilenet.py.

The reference's models are built with their parameters zero-filled
(torch_port_helpers.zero_filled_reference_init): their initializers
compile a JAX program per shape (about 250 s for the whole zoo) and
neither names nor shapes depend on them.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.vision import models as jm
from paddle_tpu_torch.vision import models as tm
from torch_port_helpers import zero_filled_reference_init

CONSTRUCTORS = [
    ("LeNet", {}), ("alexnet", {}), ("vgg11", {}), ("vgg13", {}),
    ("vgg16", {}), ("vgg19", {}), ("vgg11", {"batch_norm": True}),
    ("vgg13", {"batch_norm": True}), ("vgg16", {"batch_norm": True}),
    ("vgg19", {"batch_norm": True}), ("mobilenet_v2", {}),
    ("mobilenet_v2", {"scale": 0.5}), ("densenet121", {}),
    ("densenet161", {}), ("densenet169", {}), ("densenet201", {}),
    ("squeezenet1_0", {}), ("squeezenet1_1", {}), ("mobilenet_v1", {}),
    ("mobilenet_v3_small", {}), ("mobilenet_v3_large", {}),
    ("shufflenet_v2_x0_5", {}), ("shufflenet_v2_x1_0", {}),
    ("shufflenet_v2_x2_0", {}), ("googlenet", {}), ("inception_v3", {}),
    ("MobileNetV2", {"num_classes": 0, "with_pool": False})]


@pytest.fixture
def fast_reference_init(monkeypatch):
    zero_filled_reference_init(monkeypatch)


def _ref_state(model):
    return {k: (tuple(v.shape), str(v._data.dtype))
            for k, v in model.state_dict().items()}


def _port_state(model):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name,kw", CONSTRUCTORS,
                         ids=[f"{n}{''.join(f'-{k}{v}' for k, v in kw.items())}"
                              for n, kw in CONSTRUCTORS])
def test_state_dict_names_shapes_and_count(name, kw, fast_reference_init):
    ref = getattr(jm, name)(**kw)
    port = getattr(tm, name)(device="cpu", **kw)
    want, got = _ref_state(ref), _port_state(port)
    assert got == want
    count = sum(p.numel() for p in port.parameters())
    assert count == sum(int(np.prod(p.shape)) for p in ref.parameters())
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]


def test_constructors_take_device_dtype_and_seed():
    """Keyword-only device / dtype / seed: one seed, one set of weights;
    another seed, others; bf16 parameters and f32 batch-norm buffers;
    pretrained weights raise (no network), as the ResNets do."""
    a = tm.mobilenet_v3_small(device="cpu", seed=3)
    b = tm.mobilenet_v3_small(device="cpu", seed=3)
    c = tm.mobilenet_v3_small(device="cpu", seed=4)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
    assert not all(torch.equal(p, r) for p, r in zip(a.parameters(),
                                                     c.parameters()))
    h = tm.shufflenet_v2_x0_5(device="cpu", dtype="bfloat16")
    assert {p.dtype for p in h.parameters()} == {torch.bfloat16}
    assert {v.dtype for v in h.buffers()} == {torch.float32}
    with pytest.raises(NotImplementedError):
        tm.vgg11(pretrained=True, device="cpu")
    with pytest.raises(TypeError):
        tm.LeNet(10, "cpu")
