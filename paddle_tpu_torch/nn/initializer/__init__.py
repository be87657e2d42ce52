"""Weight initializers (counterpart of paddle_tpu/nn/initializer/).

Each initializer is a callable ``(shape, dtype) -> tensor``, as in the
reference. The reference draws its keys from its package's global JAX
generator (set by its ``seed()``); the port has no global generator, so
a call takes the ``torch.Generator`` to draw from and the device to
draw on:
``init(shape, dtype, device=..., generator=...)``. ``device`` None is the
generator's device, or the CUDA card when no generator is given (raises
without one); ``generator`` None draws from torch's default generator of
that device. The draws are torch's, not jax.random's: the two packages
agree in distribution (bounds, moments, support), never draw for draw.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import resolve_device
from ...core.dtype import to_dtype

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "get_initializer", "calculate_gain", "set_global_initializer"]


def _empty(shape, dtype, device, generator):
    """An uninitialised tensor of `shape` and `dtype` on the device the
    call resolves to (the generator's, else `device` or the card)."""
    if device is None and generator is not None:
        device = generator.device
    return torch.empty(tuple(int(s) for s in shape), dtype=to_dtype(dtype),
                       device=resolve_device(device))


class Initializer:
    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        return _empty(shape, dtype, device, generator).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        return _empty(shape, dtype, device, generator).normal_(
            self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """A standard normal truncated to [a, b], then scaled by std and
    shifted by mean: a and b are in units of std, as jax.random's
    truncated_normal takes them."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        t = torch.nn.init.trunc_normal_(
            _empty(shape, dtype, device, generator), 0.0, 1.0, self.a,
            self.b, generator=generator)
        return t.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        return _empty(shape, dtype, device, generator).uniform_(
            self.low, self.high, generator=generator)


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out, in, *k] (paddle layout)
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device=device,
                                generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device=device,
                                      generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(
            shape, dtype, device=device, generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device=device,
                                      generator=generator)


class Assign(Initializer):
    """The given value (a tensor, an array or nested lists), reshaped to
    `shape` and cast to `dtype`; nothing is drawn."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        v = self.value
        v = v.detach() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))
        out = _empty(shape, dtype, device, generator)
        return out.copy_(v.reshape(out.shape))


class Orthogonal(Initializer):
    """jax.nn.initializers.orthogonal(gain) (column axis -1): the columns
    (or, with fewer rows than columns, the rows) of the flattened
    [prod(shape[:-1]), shape[-1]] matrix are orthonormal, times gain.
    The QR factor is taken in f32 and its signs fixed by R's diagonal,
    as jax does."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        out = _empty(shape, dtype, device, generator)
        n_cols = out.shape[-1]
        n_rows = out.numel() // n_cols
        a = torch.empty((max(n_rows, n_cols), min(n_rows, n_cols)),
                        dtype=torch.float32, device=out.device)
        a.normal_(generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return out.copy_((self.gain * q).reshape(out.shape))


class Dirac(Initializer):
    """Identity conv kernels [out, in, *k]: 1 at the centre tap of
    channel (i, i % in) for i < min(out, in * groups), 0 elsewhere."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        k = [s // 2 for s in shape[2:]]
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + tuple(k)] = 1.0
        return _empty(shape, dtype, device, generator).copy_(
            torch.from_numpy(out))


def get_initializer(spec):
    if spec is None:
        return None
    if isinstance(spec, Initializer):
        return spec
    if callable(spec):
        return spec
    raise TypeError(f"cannot interpret initializer {spec!r}")


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    return 1.0


def set_global_initializer(weight_init, bias_init=None):
    """Records the initializers, as the reference does (informational:
    layers read their own arguments)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


_global_weight_init = None
_global_bias_init = None
