"""Elementwise and scalar math ops (counterpart of paddle_tpu/ops/math.py).

Binary ops promote two tensors of different dtypes as jnp does
(``_util.promote``); integer inputs to a float function compute in
float32, as jnp's do. ``tanh``, ``sigmoid`` and ``logsigmoid`` are the
nn functional's registered ops."""
from __future__ import annotations

import torch

from ..nn.functional import logsigmoid, sigmoid, tanh
from ._util import as_tensor, floatlike, pair as _pair, promote
from .registry import register_op

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "maximum", "minimum", "fmax", "fmin", "atan2",
    "hypot", "logaddexp", "heaviside", "copysign", "nextafter", "gcd", "lcm",
    "ldexp", "abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p",
    "sqrt", "rsqrt", "square", "reciprocal", "sign", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "ceil", "floor", "round", "trunc", "frac", "erf", "erfinv",
    "lgamma", "digamma", "polygamma", "i0", "i0e", "i1", "i1e", "sigmoid",
    "logit", "logsigmoid", "rad2deg", "deg2rad", "angle", "conj", "real",
    "imag", "clip", "isnan", "isinf", "isfinite", "nan_to_num", "stanh",
    "multiplex", "lerp", "scale", "increment", "trapezoid", "diff",
    "logcumsumexp", "clip_by_norm", "renorm", "add_n", "elementwise_pow"]


def _is_bool(t):
    return isinstance(t, torch.Tensor) and t.dtype == torch.bool


# ---- binary ----
@register_op("add")
def add(x, y):
    x, y = promote(x, y)
    return x + y


@register_op("subtract")
def subtract(x, y):
    if _is_bool(x) or _is_bool(y):
        # a Python int takes a bool tensor to int32, as jnp's weak int
        # does (torch refuses to subtract from a bool)
        x, y = _pair(x, y)
    x, y = promote(x, y)
    return x - y


@register_op("multiply")
def multiply(x, y):
    x, y = promote(x, y)
    return x * y


@register_op("divide")
def divide(x, y):
    x, y = promote(x, y)
    return x / y


@register_op("floor_divide")
def floor_divide(x, y):
    x, y = _pair(x, y)
    return torch.floor_divide(x, y)


@register_op("mod")
def mod(x, y):
    x, y = _pair(x, y)
    return torch.remainder(x, y)


remainder = mod


@register_op("pow")
def pow(x, y):
    x, y = promote(x, y)
    return x ** y


@register_op("maximum")
def maximum(x, y):
    x, y = _pair(x, y)
    return torch.maximum(x, y)


@register_op("minimum")
def minimum(x, y):
    x, y = _pair(x, y)
    return torch.minimum(x, y)


@register_op("fmax")
def fmax(x, y):
    x, y = _pair(x, y)
    return torch.fmax(x, y)


@register_op("fmin")
def fmin(x, y):
    x, y = _pair(x, y)
    return torch.fmin(x, y)


@register_op("atan2")
def atan2(x, y):
    x, y = _pair(x, y)
    return torch.atan2(floatlike(x), floatlike(y))


@register_op("hypot")
def hypot(x, y):
    x, y = _pair(x, y)
    return torch.hypot(floatlike(x), floatlike(y))


@register_op("logaddexp")
def logaddexp(x, y):
    x, y = _pair(x, y)
    return torch.logaddexp(floatlike(x), floatlike(y))


@register_op("heaviside")
def heaviside(x, y):
    """Integer inputs compute in float32, as jnp.heaviside promotes
    them."""
    x, y = _pair(x, y)
    return torch.heaviside(floatlike(x), floatlike(y))


@register_op("copysign")
def copysign(x, y):
    x, y = _pair(x, y)
    return torch.copysign(x, y)


@register_op("nextafter")
def nextafter(x, y):
    x, y = _pair(x, y)
    return torch.nextafter(x, y)


@register_op("gcd")
def gcd(x, y):
    x, y = _pair(x, y)
    return torch.gcd(x, y)


@register_op("lcm")
def lcm(x, y):
    x, y = _pair(x, y)
    return torch.lcm(x, y)


@register_op("ldexp")
def ldexp(x, y):
    x, y = _pair(x, y)
    return torch.ldexp(floatlike(x), y).to(floatlike(x).dtype)


# ---- unary ----
@register_op("abs")
def abs(x):
    return x if x.dtype == torch.bool else torch.abs(x)


@register_op("neg")
def neg(x):
    return torch.neg(x)


@register_op("exp")
def exp(x):
    return torch.exp(x)


@register_op("expm1")
def expm1(x):
    return torch.expm1(x)


@register_op("log")
def log(x):
    return torch.log(x)


@register_op("log2")
def log2(x):
    return torch.log2(x)


@register_op("log10")
def log10(x):
    return torch.log10(x)


@register_op("log1p")
def log1p(x):
    return torch.log1p(x)


@register_op("sqrt")
def sqrt(x):
    return torch.sqrt(x)


@register_op("rsqrt")
def rsqrt(x):
    return torch.rsqrt(x)


@register_op("square")
def square(x):
    return torch.square(x)


@register_op("reciprocal")
def reciprocal(x):
    return torch.reciprocal(x)


@register_op("sign")
def sign(x):
    return torch.sign(x)


@register_op("sin")
def sin(x):
    return torch.sin(x)


@register_op("cos")
def cos(x):
    return torch.cos(x)


@register_op("tan")
def tan(x):
    return torch.tan(x)


@register_op("asin")
def asin(x):
    return torch.asin(x)


@register_op("acos")
def acos(x):
    return torch.acos(x)


@register_op("atan")
def atan(x):
    return torch.atan(x)


@register_op("sinh")
def sinh(x):
    return torch.sinh(x)


@register_op("cosh")
def cosh(x):
    return torch.cosh(x)


@register_op("asinh")
def asinh(x):
    return torch.asinh(x)


@register_op("acosh")
def acosh(x):
    return torch.acosh(x)


@register_op("atanh")
def atanh(x):
    return torch.atanh(x)


@register_op("ceil")
def ceil(x):
    # a bool (or integer) tensor is its own ceil, as in jnp
    return x if not (x.is_floating_point() or x.is_complex()) \
        else torch.ceil(x)


@register_op("floor")
def floor(x):
    # a bool (or integer) tensor is its own floor, as in jnp
    return x if not (x.is_floating_point() or x.is_complex()) \
        else torch.floor(x)


@register_op("round")
def round(x, decimals=0):
    return torch.round(x, decimals=decimals)


@register_op("trunc")
def trunc(x):
    # a bool (or integer) tensor is its own trunc, as in jnp
    return x if not (x.is_floating_point() or x.is_complex()) \
        else torch.trunc(x)


@register_op("frac")
def frac(x):
    return x - torch.trunc(x)


@register_op("erf")
def erf(x):
    return torch.erf(x)


@register_op("erfinv")
def erfinv(x):
    return torch.erfinv(x)


@register_op("lgamma")
def lgamma(x):
    return torch.lgamma(x)


@register_op("digamma")
def digamma(x):
    return torch.digamma(x)


@register_op("polygamma")
def polygamma(x, n):
    return torch.polygamma(int(n), x)


@register_op("i0")
def i0(x):
    return torch.special.i0(x)


@register_op("i0e")
def i0e(x):
    return torch.special.i0e(x)


@register_op("i1")
def i1(x):
    return torch.special.i1(x)


@register_op("i1e")
def i1e(x):
    return torch.special.i1e(x)


@register_op("logit")
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1 - x))


@register_op("rad2deg")
def rad2deg(x):
    return torch.rad2deg(floatlike(x))


@register_op("deg2rad")
def deg2rad(x):
    return torch.deg2rad(floatlike(x))


@register_op("angle")
def angle(x):
    return torch.angle(x)


@register_op("conj")
def conj(x):
    return torch.conj(x).resolve_conj() if x.is_complex() else x


@register_op("real")
def real(x):
    return torch.real(x) if x.is_complex() else x


@register_op("imag")
def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@register_op("clip")
def clip(x, min=None, max=None):
    if min is None and max is None:
        return x
    if isinstance(min, torch.Tensor) or isinstance(max, torch.Tensor):
        return torch.clamp(x, None if min is None else as_tensor(min, x),
                           None if max is None else as_tensor(max, x))
    return torch.clamp(x, min, max)


@register_op("isnan")
def isnan(x):
    return torch.isnan(x)


@register_op("isinf")
def isinf(x):
    return torch.isinf(x)


@register_op("isfinite")
def isfinite(x):
    return torch.isfinite(x)


@register_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register_op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_op("multiplex")
def multiplex(inputs, index):
    stacked = torch.stack(list(inputs), dim=0)      # [n, batch, ...]
    idx = index.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


@register_op("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


@register_op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@register_op("increment")
def increment(x, value=1.0):
    return x + value


@register_op("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@register_op("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


@register_op("logcumsumexp")
def logcumsumexp(x, axis=None):
    """Running logsumexp along `axis` (None flattens), in f32."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.logcumsumexp(x.float(), dim=axis).to(x.dtype)


@register_op("clip_by_norm")
def clip_by_norm(x, max_norm):
    n = torch.sqrt(torch.sum(torch.square(x.float())))
    factor = torch.where(n > max_norm, max_norm / torch.clamp_min(n, 1e-12),
                         1.0)
    return (x.float() * factor).to(x.dtype)


@register_op("renorm")
def renorm(x, p, axis, max_norm):
    """Each slice along `axis` scaled to a p-norm of at most max_norm."""
    xf = x.float()
    dims = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(xf) ** p, dim=dims, keepdim=True) \
        ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp_min(norms, 1e-12), 1.0)
    return (xf * factor).to(x.dtype)


@register_op("add_n")
def add_n(inputs):
    """The sum of a list of same-shaped tensors."""
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


def elementwise_pow(x, y):
    """Alias kept for reference-API parity (legacy_ops.yaml)."""
    return pow(x, y)

