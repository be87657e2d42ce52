"""Utilities (counterpart of paddle_tpu/utils/__init__.py; ref:
python/paddle/utils/). dlpack goes through torch's; ``run_check``
trains a tiny Linear on the default place (the card unless the CPU was
asked for); ``flops`` counts a forward's FLOPs by the reference's
per-layer formulas through forward post-hooks."""
from __future__ import annotations

import contextlib

import numpy as np

from . import fs  # noqa: F401  (the reference's utils carries it too)

__all__ = ["try_import", "unique_name_guard", "to_dlpack", "from_dlpack",
           "dlpack", "run_check", "flops", "deprecated", "cpp_extension"]


def __getattr__(name):
    # cpp_extension (g++ host ops) resolved at first use: it imports the
    # eager Tensor, which the kernels' build helper here must not need
    if name == "cpp_extension":
        import importlib
        return importlib.import_module(".cpp_extension", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def try_import(module_name, err_msg=None):
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg or f"cannot import {module_name}")


@contextlib.contextmanager
def unique_name_guard(prefix=""):
    yield


def to_dlpack(tensor):
    from torch.utils.dlpack import to_dlpack as _to
    return _to(tensor._data)


def from_dlpack(capsule):
    from torch.utils.dlpack import from_dlpack as _from

    from ..core.tensor import Tensor
    return Tensor._wrap(_from(capsule))


dlpack = type("dlpack", (), {"to_dlpack": staticmethod(to_dlpack),
                             "from_dlpack": staticmethod(from_dlpack)})


def run_check():
    """paddle.utils.run_check analog: one forward and backward of a
    Linear's product on the default place, which checks the device (the
    card: it raises without one, unless set_device chose the CPU)."""
    from .. import ops
    from ..core.device import get_device
    from ..core.tensor import to_tensor
    x = to_tensor(np.random.randn(8, 4).astype(np.float32),
                  stop_gradient=False)
    w = to_tensor(np.random.randn(4, 4).astype(np.float32),
                  stop_gradient=False)
    y = ops.matmul(x, w).sum()
    y.backward()
    assert w.grad is not None
    print(f"paddle_tpu_torch is installed successfully! device = "
          f"{get_device()}")
    return True


def _layer_flops(layer, inputs, output):
    """Per-layer FLOP formulas (ref: python/paddle/utils/flops.py:27 /
    hapi/dynamic_flops.py count_* registry). Returns None for layers
    with no registered counter."""
    from .. import nn as _nn

    def prod(s):
        return int(np.prod(s))

    if isinstance(layer, _nn.Linear):
        rows = prod(inputs[0].shape) // inputs[0].shape[-1]
        return 2 * rows * layer.weight.shape[0] * layer.weight.shape[1]
    if isinstance(layer, (_nn.Conv1D, _nn.Conv2D, _nn.Conv3D)):
        k = prod(layer.kernel_size) if hasattr(layer, "kernel_size") \
            else 1
        return (2 * prod(output.shape)
                * layer.in_channels // layer.groups * k)
    if isinstance(layer, (_nn.BatchNorm1D, _nn.BatchNorm2D,
                          _nn.BatchNorm3D, _nn.BatchNorm,
                          _nn.LayerNorm, _nn.GroupNorm,
                          _nn.InstanceNorm2D)):
        return 2 * prod(output.shape)
    if isinstance(layer, (_nn.ReLU, _nn.GELU, _nn.Sigmoid, _nn.Tanh,
                          _nn.Softmax)):
        return prod(output.shape)
    if isinstance(layer, (_nn.AvgPool2D, _nn.MaxPool2D,
                          _nn.AdaptiveAvgPool2D)):
        return prod(output.shape)
    return None


def _count_flops(net, inputs, custom_ops=None, print_detail=False):
    """FLOPs of one eval forward of `net` on `inputs`, counted by a
    post-hook on every module (the net's own too)."""
    total = [0]
    rows = []
    custom_ops = custom_ops or {}

    def hook(layer, inputs, output):
        fn = None
        for cls, f in custom_ops.items():
            if isinstance(layer, cls):
                fn = f
                break
        n = fn(layer, inputs, output) if fn else \
            _layer_flops(layer, inputs, output)
        if n:
            total[0] += int(n)
            rows.append((type(layer).__name__,
                         tuple(getattr(output, "shape", ())), int(n)))

    handles = [m.register_forward_hook(hook) for m in net.modules()]
    was_training = net.training
    net.eval()
    try:
        from ..autograd import no_grad
        with no_grad():
            net(*inputs)
    finally:
        if was_training:
            net.train()
        for h in handles:
            h.remove()
    if print_detail:
        print(f"{'layer':<24} {'output shape':<24} {'FLOPs':>16}")
        for name, shape, n in rows:
            print(f"{name:<24} {str(shape):<24} {n:>16,}")
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]


def flops(net, input_size, custom_ops=None, print_detail=False):
    """FLOPs counter over a forward pass on zeros of `input_size` (ref:
    python/paddle/utils/flops.py:27 via hapi/dynamic_flops.py
    paddle.flops). custom_ops: {LayerType: fn(layer, inputs, output) ->
    flops}."""
    from ..ops import zeros
    return _count_flops(net, [zeros(input_size)], custom_ops, print_detail)


class deprecated:
    def __init__(self, update_to="", since="", reason=""):
        self.update_to = update_to

    def __call__(self, fn):
        return fn
