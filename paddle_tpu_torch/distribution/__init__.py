"""Probability distributions (counterpart of
paddle_tpu/distribution/__init__.py).

The reference's classes, transforms and KL rules with the same formulas
in torch; ``torch.special`` / ``torch.lgamma`` / ``torch.digamma`` only
where they compute the same function. Parameters given as Python numbers
or numpy arrays become float32 tensors on the eager default place (the
card unless ``set_device("cpu")``); a Tensor parameter stays on its
device. Every result is a Tensor.

Sampling draws from the port's generator of the parameters' device
(``core.generator.torch_generator``) where the reference draws from
``next_key``, so only the moments of draws compare across the packages.
Gradients come from torch.autograd: ``rsample``, ``log_prob``,
``entropy`` and ``kl_divergence`` differentiate through the parameters
(a reparameterised draw: loc + scale * z). ``Binomial`` samples as the
reference does, a sum of Bernoulli draws up to the largest count.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import default_torch_device
from ..core.generator import torch_generator
from ..core.tensor import Tensor

__all__ = [
    "Distribution", "Normal", "Uniform", "Categorical", "Bernoulli", "Beta",
    "Gamma", "Dirichlet", "Multinomial", "ExponentialFamily", "Laplace",
    "Cauchy", "Geometric", "Gumbel", "LogNormal", "Independent", "Binomial",
    "TransformedDistribution", "Transform", "Type", "AffineTransform",
    "ExpTransform", "PowerTransform", "SigmoidTransform", "TanhTransform",
    "AbsTransform", "ChainTransform", "IndependentTransform",
    "ReshapeTransform", "SoftmaxTransform", "StackTransform",
    "StickBreakingTransform", "register_kl", "kl_divergence"]


def _arr(x, like=None):
    """x as a torch tensor: a Tensor's own, else float32 on `like`'s
    device (or the eager default place)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if like is not None else default_torch_device()
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _params(*xs):
    """The parameters as torch tensors on one device: the first Tensor's
    (or torch tensor's), else the default place."""
    like = next((x._data if isinstance(x, Tensor) else x for x in xs
                 if isinstance(x, (Tensor, torch.Tensor))), None)
    return [_arr(x, like) for x in xs]


def _wrap(a):
    return Tensor._wrap(a)


def _shape(*ts):
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


def _gen(t):
    return torch_generator(t.device)


def _uniform(shape, ref, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=_gen(ref), device=ref.device,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


class Distribution:
    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        return self.sample(shape)

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return _wrap(torch.exp(_arr(self.log_prob(value))))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_shape(self.loc, self.scale))

    @property
    def mean(self):
        return _wrap(self.loc.expand(self.batch_shape))

    @property
    def variance(self):
        return _wrap(torch.square(self.scale).expand(self.batch_shape))

    @property
    def stddev(self):
        return _wrap(self.scale.expand(self.batch_shape))

    def sample(self, shape=()):
        shape = tuple(shape) + self.batch_shape
        z = torch.randn(shape, generator=_gen(self.loc),
                        device=self.loc.device, dtype=torch.float32)
        return _wrap(self.loc + self.scale * z)

    def log_prob(self, value):
        v = _arr(value, self.loc)
        var = torch.square(self.scale)
        return _wrap(-((v - self.loc) ** 2) / (2 * var)
                     - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return _wrap(0.5 + 0.5 * math.log(2 * math.pi)
                     + torch.log(self.scale)
                     + self.loc.new_zeros(self.batch_shape))

    def cdf(self, value):
        return _wrap(0.5 * (1 + torch.erf(
            (_arr(value, self.loc) - self.loc)
            / (self.scale * math.sqrt(2)))))


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low, self.high = _params(low, high)
        super().__init__(_shape(self.low, self.high))

    def sample(self, shape=()):
        u = _uniform(tuple(shape) + self.batch_shape, self.low)
        return _wrap(self.low + (self.high - self.low) * u)

    def log_prob(self, value):
        v = _arr(value, self.low)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return _wrap(torch.where(inside, lp, torch.full_like(lp, -math.inf)))

    def entropy(self):
        return _wrap(torch.log(self.high - self.low)
                     + self.low.new_zeros(self.batch_shape))


def _flat_draws(probs, n):
    """n categorical draws per row of probs [..., k]: [n, ...] int64."""
    k = probs.shape[-1]
    flat = probs.reshape(-1, k)
    idx = torch.multinomial(flat, n, replacement=True,
                            generator=_gen(probs))      # [rows, n]
    return idx.t().reshape((n,) + tuple(probs.shape[:-1]))


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None, name=None):
        if logits is None and probs is None:
            raise ValueError("need logits or probs")
        if logits is not None:
            self.logits = _arr(logits)
        else:
            self.logits = torch.log(torch.clamp(_arr(probs), min=1e-30))
        super().__init__(self.logits.shape[:-1])

    @property
    def probs(self):
        return _wrap(torch.softmax(self.logits, dim=-1))

    def sample(self, shape=()):
        shape = tuple(shape)
        n = int(np.prod(shape)) if shape else 1
        draws = _flat_draws(torch.softmax(self.logits.detach().float(), -1),
                            n)
        return _wrap(draws.reshape(shape + self.batch_shape).to(
            torch.int32))

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        idx = _arr(value, self.logits).long()
        return _wrap(torch.gather(logp.expand(idx.shape + logp.shape[-1:]),
                                  -1, idx[..., None])[..., 0])

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return _wrap(-torch.sum(torch.exp(logp) * logp, dim=-1))


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.probs_arr = _arr(probs)
        super().__init__(self.probs_arr.shape)

    def sample(self, shape=()):
        shape = tuple(shape) + self.batch_shape
        u = _uniform(shape, self.probs_arr)
        return _wrap((u < self.probs_arr).to(torch.float32))

    def log_prob(self, value):
        v = _arr(value, self.probs_arr)
        p = self.probs_arr
        return _wrap(v * torch.log(torch.clamp(p, min=1e-30)) +
                     (1 - v) * torch.log(torch.clamp(1 - p, min=1e-30)))

    def entropy(self):
        p = self.probs_arr
        return _wrap(-(p * torch.log(torch.clamp(p, min=1e-30)) +
                       (1 - p) * torch.log(torch.clamp(1 - p, min=1e-30))))


def _std_gamma(conc, shape):
    """Gamma(conc, 1) draws of `shape` (conc broadcast to it),
    differentiable through conc."""
    a = conc.float().expand(shape).contiguous()
    return torch._standard_gamma(a, generator=_gen(conc))


class Beta(Distribution):
    def __init__(self, alpha, beta):
        self.alpha, self.beta = _params(alpha, beta)
        super().__init__(_shape(self.alpha, self.beta))

    def sample(self, shape=()):
        shape = tuple(shape) + self.batch_shape
        x = _std_gamma(self.alpha, shape)
        y = _std_gamma(self.beta, shape)
        return _wrap(x / (x + y))

    def log_prob(self, value):
        v = _arr(value, self.alpha)
        a, b = self.alpha, self.beta
        lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return _wrap((a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
                     - lbeta)


class Gamma(Distribution):
    def __init__(self, concentration, rate):
        self.concentration, self.rate = _params(concentration, rate)
        super().__init__(_shape(self.concentration, self.rate))

    def sample(self, shape=()):
        shape = tuple(shape) + self.batch_shape
        return _wrap(_std_gamma(self.concentration, shape) / self.rate)

    def log_prob(self, value):
        v = _arr(value, self.concentration)
        a, r = self.concentration, self.rate
        return _wrap(a * torch.log(r) + (a - 1) * torch.log(v) - r * v
                     - torch.lgamma(a))


class Dirichlet(Distribution):
    def __init__(self, concentration):
        self.concentration = _arr(concentration)
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    def sample(self, shape=()):
        shape = tuple(shape) + self.batch_shape + self.event_shape
        g = _std_gamma(self.concentration, shape)
        return _wrap(g / g.sum(-1, keepdim=True))

    def log_prob(self, value):
        v = _arr(value, self.concentration)
        a = self.concentration
        lognorm = torch.sum(torch.lgamma(a), -1) - torch.lgamma(a.sum(-1))
        return _wrap(torch.sum((a - 1) * torch.log(v), -1) - lognorm)


class Multinomial(Distribution):
    def __init__(self, total_count, probs):
        self.total_count = total_count
        self.probs_arr = _arr(probs)
        super().__init__(self.probs_arr.shape[:-1],
                         self.probs_arr.shape[-1:])

    def sample(self, shape=()):
        n = int(self.total_count)
        k = self.probs_arr.shape[-1]
        shape = tuple(shape)
        m = int(np.prod(shape)) if shape else 1
        p = torch.clamp(self.probs_arr.detach().float(), min=1e-30)
        draws = _flat_draws(p / p.sum(-1, keepdim=True), m * n)
        counts = F.one_hot(draws.reshape((m, n) + self.batch_shape),
                           k).sum(1)
        return _wrap(counts.reshape(shape + self.batch_shape + (k,))
                     .to(torch.float32))

    def log_prob(self, value):
        v = _arr(value, self.probs_arr)
        logp = torch.log(torch.clamp(self.probs_arr, min=1e-30))
        return _wrap(torch.lgamma(v.sum(-1) + 1)
                     - torch.sum(torch.lgamma(v + 1), -1)
                     + torch.sum(v * logp, -1))


class ExponentialFamily(Distribution):
    """The natural-parameter base: entropy by the Bregman identity where
    a subclass opts in."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_shape(self.loc, self.scale))

    @property
    def mean(self):
        return _wrap(self.loc.expand(self.batch_shape))

    @property
    def variance(self):
        return _wrap((2 * torch.square(self.scale)).expand(self.batch_shape))

    @property
    def stddev(self):
        return _wrap((math.sqrt(2.0) * self.scale).expand(self.batch_shape))

    def sample(self, shape=()):
        u = _uniform(tuple(shape) + self.batch_shape, self.loc,
                     -0.5 + 1e-7, 0.5 - 1e-7)
        return _wrap(self.loc - self.scale * torch.sign(u)
                     * torch.log1p(-2 * torch.abs(u)))

    rsample = sample

    def log_prob(self, value):
        v = _arr(value, self.loc)
        return _wrap(-torch.log(2 * self.scale)
                     - torch.abs(v - self.loc) / self.scale)

    def entropy(self):
        return _wrap((1 + torch.log(2 * self.scale)).expand(
            self.batch_shape))

    def cdf(self, value):
        z = (_arr(value, self.loc) - self.loc) / self.scale
        return _wrap(0.5 - 0.5 * torch.sign(z) * torch.expm1(-torch.abs(z)))

    def icdf(self, q):
        t = _arr(q, self.loc) - 0.5
        return _wrap(self.loc - self.scale * torch.sign(t)
                     * torch.log1p(-2 * torch.abs(t)))


class Cauchy(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_shape(self.loc, self.scale))

    def sample(self, shape=()):
        u = _uniform(tuple(shape) + self.batch_shape, self.loc, 1e-7,
                     1 - 1e-7)
        return _wrap(self.loc + self.scale * torch.tan(math.pi * (u - 0.5)))

    rsample = sample

    def log_prob(self, value):
        z = (_arr(value, self.loc) - self.loc) / self.scale
        return _wrap(-math.log(math.pi) - torch.log(self.scale)
                     - torch.log1p(torch.square(z)))

    def entropy(self):
        return _wrap(torch.log(4 * math.pi * self.scale).expand(
            self.batch_shape))

    def cdf(self, value):
        z = (_arr(value, self.loc) - self.loc) / self.scale
        return _wrap(torch.arctan(z) / math.pi + 0.5)


class Geometric(Distribution):
    """The number of failures before the first success, support {0, 1,
    ...}."""

    def __init__(self, probs=None, logits=None, name=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs/logits")
        if probs is None:
            self.probs_arr = torch.sigmoid(_arr(logits))
        else:
            self.probs_arr = _arr(probs)
        super().__init__(self.probs_arr.shape)

    @property
    def mean(self):
        return _wrap((1 - self.probs_arr) / self.probs_arr)

    @property
    def variance(self):
        return _wrap((1 - self.probs_arr) / torch.square(self.probs_arr))

    def sample(self, shape=()):
        u = _uniform(tuple(shape) + self.batch_shape, self.probs_arr, 1e-7,
                     1 - 1e-7)
        return _wrap(torch.floor(torch.log(u)
                                 / torch.log1p(-self.probs_arr)))

    def log_prob(self, value):
        v = _arr(value, self.probs_arr)
        return _wrap(v * torch.log1p(-self.probs_arr)
                     + torch.log(self.probs_arr))

    def entropy(self):
        p = self.probs_arr
        return _wrap(-((1 - p) * torch.log1p(-p) + p * torch.log(p)) / p)

    def cdf(self, value):
        v = _arr(value, self.probs_arr)
        return _wrap(1 - torch.pow(1 - self.probs_arr, torch.floor(v) + 1))


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_shape(self.loc, self.scale))

    _EULER = 0.57721566490153286060

    @property
    def mean(self):
        return _wrap((self.loc + self._EULER * self.scale).expand(
            self.batch_shape))

    @property
    def variance(self):
        return _wrap(((math.pi ** 2 / 6) * torch.square(self.scale)).expand(
            self.batch_shape))

    @property
    def stddev(self):
        return _wrap(torch.sqrt(_arr(self.variance)))

    def sample(self, shape=()):
        u = _uniform(tuple(shape) + self.batch_shape, self.loc, 1e-7,
                     1 - 1e-7)
        return _wrap(self.loc - self.scale * torch.log(-torch.log(u)))

    rsample = sample

    def log_prob(self, value):
        z = (_arr(value, self.loc) - self.loc) / self.scale
        return _wrap(-(z + torch.exp(-z)) - torch.log(self.scale))

    def entropy(self):
        return _wrap((torch.log(self.scale) + 1 + self._EULER).expand(
            self.batch_shape))

    def cdf(self, value):
        z = (_arr(value, self.loc) - self.loc) / self.scale
        return _wrap(torch.exp(-torch.exp(-z)))


class LogNormal(Distribution):
    """exp of a Normal, in closed forms."""

    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_shape(self.loc, self.scale))

    @property
    def mean(self):
        return _wrap(torch.exp(self.loc + torch.square(self.scale) / 2))

    @property
    def variance(self):
        s2 = torch.square(self.scale)
        return _wrap(torch.expm1(s2) * torch.exp(2 * self.loc + s2))

    def sample(self, shape=()):
        z = torch.randn(tuple(shape) + self.batch_shape,
                        generator=_gen(self.loc), device=self.loc.device,
                        dtype=torch.float32)
        return _wrap(torch.exp(self.loc + self.scale * z))

    rsample = sample

    def log_prob(self, value):
        logv = torch.log(_arr(value, self.loc))
        return _wrap(-torch.square((logv - self.loc) / self.scale) / 2
                     - torch.log(self.scale) - logv
                     - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return _wrap((0.5 + 0.5 * math.log(2 * math.pi)
                      + torch.log(self.scale) + self.loc).expand(
            self.batch_shape))


def _sum_last(t, rank):
    return t.sum(dim=tuple(range(t.dim() - rank, t.dim()))) if rank else t


class Independent(Distribution):
    """Reinterprets the base's last `reinterpreted_batch_rank` batch
    dims as event dims."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self._rank = int(reinterpreted_batch_rank)
        shape = base.batch_shape
        super().__init__(shape[:len(shape) - self._rank],
                         shape[len(shape) - self._rank:]
                         + base.event_shape)

    def sample(self, shape=()):
        return self.base.sample(shape)

    rsample = sample

    def log_prob(self, value):
        return _wrap(_sum_last(_arr(self.base.log_prob(value)), self._rank))

    def entropy(self):
        return _wrap(_sum_last(_arr(self.base.entropy()), self._rank))


# ------------------------------- transforms -------------------------------
class Type:
    BIJECTION = "bijection"
    INJECTION = "injection"
    SURJECTION = "surjection"
    OTHER = "other"


class Transform:
    _type = Type.INJECTION

    def forward(self, x):
        return _wrap(self._forward(_arr(x)))

    def inverse(self, y):
        return _wrap(self._inverse(_arr(y)))

    def forward_log_det_jacobian(self, x):
        return _wrap(self._fldj(_arr(x)))

    def inverse_log_det_jacobian(self, y):
        return _wrap(-self._fldj(self._inverse(_arr(y))))

    def __call__(self, x):
        return self.forward(x)


class AffineTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def _forward(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def _fldj(self, x):
        return torch.log(torch.abs(self.scale)).expand(x.shape)


class ExpTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _fldj(self, x):
        return x


class PowerTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, power):
        self.power = _arr(power)

    def _forward(self, x):
        return torch.pow(x, self.power)

    def _inverse(self, y):
        return torch.pow(y, 1.0 / self.power)

    def _fldj(self, x):
        return torch.log(torch.abs(self.power
                                   * torch.pow(x, self.power - 1)))


class SigmoidTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _fldj(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.arctanh(y)

    def _fldj(self, x):
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class AbsTransform(Transform):
    _type = Type.SURJECTION

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y  # the positive branch, as in the reference


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _fldj(self, x):
        total = 0.0
        for t in self.transforms:
            total = total + t._fldj(x)
            x = t._forward(x)
        return total


class IndependentTransform(Transform):
    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self._rank = int(reinterpreted_batch_rank)

    def _forward(self, x):
        return self.base._forward(x)

    def _inverse(self, y):
        return self.base._inverse(y)

    def _fldj(self, x):
        ld = self.base._fldj(x)
        return ld.sum(dim=tuple(range(ld.dim() - self._rank, ld.dim())))


class ReshapeTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)

    def _forward(self, x):
        lead = tuple(x.shape[:x.dim() - len(self.in_event_shape)])
        return x.reshape(lead + self.out_event_shape)

    def _inverse(self, y):
        lead = tuple(y.shape[:y.dim() - len(self.out_event_shape)])
        return y.reshape(lead + self.in_event_shape)

    def _fldj(self, x):
        lead = tuple(x.shape[:x.dim() - len(self.in_event_shape)])
        return x.new_zeros(lead)


class SoftmaxTransform(Transform):
    _type = Type.OTHER

    def _forward(self, x):
        return torch.softmax(x, dim=-1)

    def _inverse(self, y):
        return torch.log(y)


class StackTransform(Transform):
    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = axis

    def _apply(self, x, method):
        parts = [getattr(t, method)(xi) for t, xi in zip(
            self.transforms, torch.movedim(x, self.axis, 0))]
        return torch.stack(parts, dim=self.axis)

    def _forward(self, x):
        return self._apply(x, "_forward")

    def _inverse(self, y):
        return self._apply(y, "_inverse")

    def _fldj(self, x):
        return self._apply(x, "_fldj")


class StickBreakingTransform(Transform):
    """The simplex parameterization."""
    _type = Type.BIJECTION

    def _forward(self, x):
        k = x.shape[-1]
        offset = (k + 1 - torch.arange(1, k + 1, device=x.device)).to(
            x.dtype)
        z = torch.sigmoid(x - torch.log(offset))
        one = z.new_ones(z.shape[:-1] + (1,))
        zpad = torch.cat([z, one], -1)
        cum = torch.cat([one, torch.cumprod(1 - z, -1)], -1)
        return zpad * cum

    def _inverse(self, y):
        ycum = torch.cumsum(y[..., :-1], -1)
        rem = 1 - torch.cat([y.new_zeros(y.shape[:-1] + (1,)),
                             ycum[..., :-1]], -1)
        z = y[..., :-1] / rem
        k = y.shape[-1] - 1
        offset = (k - torch.arange(k, device=y.device)).to(y.dtype)
        return torch.log(z) - torch.log1p(-z) + torch.log(offset)

    def _fldj(self, x):
        k = x.shape[-1]
        offset = (k + 1 - torch.arange(1, k + 1, device=x.device)).to(
            x.dtype)
        x_off = x - torch.log(offset)
        y = self._forward(x)
        return torch.sum(-x_off + F.logsigmoid(x_off)
                         + torch.log(y[..., :-1]), -1)


class TransformedDistribution(Distribution):
    def __init__(self, base, transforms):
        self.base = base
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.transforms = list(transforms)
        super().__init__(base.batch_shape, base.event_shape)

    def sample(self, shape=()):
        x = _arr(self.base.sample(shape))
        for t in self.transforms:
            x = t._forward(x)
        return _wrap(x)

    def rsample(self, shape=()):
        x = _arr(self.base.rsample(shape))
        for t in self.transforms:
            x = t._forward(x)
        return _wrap(x)

    def log_prob(self, value):
        y = _arr(value)
        lp = 0.0
        for t in reversed(self.transforms):
            x = t._inverse(y)
            lp = lp - t._fldj(x)
            y = x
        return _wrap(lp + _arr(self.base.log_prob(_wrap(y))))


class Binomial(Distribution):
    """Binomial(total_count, probs): total_count a number or a
    per-element tensor. A draw is n_max Bernoulli trials per element,
    the trials past the element's own count masked out."""

    def __init__(self, total_count, probs):
        self.probs_arr = _arr(probs)
        if np.ndim(total_count) == 0 and not isinstance(
                total_count, (Tensor, torch.Tensor)):
            self.n_max = int(total_count)
            self.n_arr = torch.tensor(float(total_count),
                                      device=self.probs_arr.device)
        else:
            tc = _arr(total_count, self.probs_arr)
            self.n_arr = tc.to(torch.float32)
            self.n_max = int(tc.max())
        super().__init__(_shape(self.n_arr, self.probs_arr))

    @property
    def mean(self):
        return _wrap(self.n_arr * self.probs_arr)

    @property
    def variance(self):
        return _wrap(self.n_arr * self.probs_arr * (1 - self.probs_arr))

    def sample(self, shape=()):
        shape = tuple(shape) + self.batch_shape
        p = self.probs_arr.detach()
        draws = _uniform((self.n_max,) + shape, p) < p
        trial = torch.arange(self.n_max, dtype=torch.float32,
                             device=p.device).reshape(
            (self.n_max,) + (1,) * len(shape))
        live = trial < self.n_arr.expand(shape)
        return _wrap(torch.sum(draws & live, dim=0).to(torch.float32))

    def _log_prob(self, v):
        n, p = self.n_arr, self.probs_arr
        logc = (torch.lgamma(n + 1.0) - torch.lgamma(v + 1.0)
                - torch.lgamma(n - v + 1.0))
        return (logc + v * torch.log(torch.clamp(p, min=1e-30))
                + (n - v) * torch.log(torch.clamp(1 - p, min=1e-30)))

    def log_prob(self, value):
        return _wrap(self._log_prob(_arr(value, self.probs_arr)))

    def entropy(self):
        # the exact sum over the largest support; each element's terms
        # past its own count masked out
        kb = torch.arange(self.n_max + 1, dtype=torch.float32,
                          device=self.probs_arr.device).reshape(
            (self.n_max + 1,) + (1,) * len(self.batch_shape))
        lp = self._log_prob(kb)
        live = kb <= self.n_arr.expand(self.batch_shape)
        return _wrap(-torch.sum(torch.where(live, torch.exp(lp) * lp,
                                            torch.zeros_like(lp)), dim=0))


# ------------------------------ KL registry -------------------------------
_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    """Decorator registering fn(p, q) as the KL rule of a pair of
    classes."""
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return deco


def kl_divergence(p, q):
    """KL(p || q) by the most derived registered rule."""
    best, best_fn = None, None
    for (pc, qc), fn in _KL_REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            score = (len(type(p).__mro__) - len(pc.__mro__)) + \
                (len(type(q).__mro__) - len(qc.__mro__))
            if best is None or score < best:
                best, best_fn = score, fn
    if best_fn is None:
        raise NotImplementedError(
            f"kl_divergence({type(p).__name__}, {type(q).__name__})")
    return best_fn(p, q)


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    var_ratio = torch.square(p.scale / q.scale)
    t1 = torch.square((p.loc - q.loc) / q.scale)
    return _wrap(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    logp = torch.log_softmax(p.logits, -1)
    logq = torch.log_softmax(q.logits, -1)
    return _wrap(torch.sum(torch.exp(logp) * (logp - logq), -1))


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    # +inf unless p's support lies inside q's
    inside = (q.low <= p.low) & (p.high <= q.high)
    val = torch.log((q.high - q.low) / (p.high - p.low))
    return _wrap(torch.where(inside, val, torch.full_like(val, math.inf)))


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    pp, qq = p.probs_arr, q.probs_arr
    t1 = pp * (torch.log(torch.clamp(pp, min=1e-30))
               - torch.log(torch.clamp(qq, min=1e-30)))
    t2 = (1 - pp) * (torch.log(torch.clamp(1 - pp, min=1e-30))
                     - torch.log(torch.clamp(1 - qq, min=1e-30)))
    return _wrap(t1 + t2)


@register_kl(Laplace, Laplace)
def _kl_laplace(p, q):
    r = p.scale / q.scale
    t = torch.abs(p.loc - q.loc) / q.scale
    return _wrap(-torch.log(r) + r * torch.exp(-torch.abs(p.loc - q.loc)
                                               / p.scale) + t - 1)


@register_kl(Geometric, Geometric)
def _kl_geometric(p, q):
    pp, qq = p.probs_arr, q.probs_arr
    return _wrap(torch.log(pp) - torch.log(qq)
                 + (1 - pp) / pp * (torch.log1p(-pp) - torch.log1p(-qq)))


@register_kl(Gamma, Gamma)
def _kl_gamma(p, q):
    a1, b1 = p.concentration, p.rate
    a2, b2 = q.concentration, q.rate
    return _wrap((a1 - a2) * torch.digamma(a1) - torch.lgamma(a1)
                 + torch.lgamma(a2) + a2 * (torch.log(b1) - torch.log(b2))
                 + a1 * (b2 / b1 - 1))


@register_kl(Beta, Beta)
def _kl_beta(p, q):
    a1, b1 = p.alpha, p.beta
    a2, b2 = q.alpha, q.beta
    s1, s2 = a1 + b1, a2 + b2
    lg, dg = torch.lgamma, torch.digamma
    return _wrap(lg(s1) - lg(a1) - lg(b1) - lg(s2) + lg(a2) + lg(b2)
                 + (a1 - a2) * (dg(a1) - dg(s1))
                 + (b1 - b2) * (dg(b1) - dg(s1)))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet(p, q):
    a, b = p.concentration, q.concentration
    sa = a.sum(-1, keepdim=True)
    t = ((a - b) * (torch.digamma(a) - torch.digamma(sa))).sum(-1)
    return _wrap(torch.lgamma(a.sum(-1)) - torch.lgamma(b.sum(-1))
                 + (torch.lgamma(b) - torch.lgamma(a)).sum(-1) + t)


@register_kl(LogNormal, LogNormal)
def _kl_lognormal(p, q):
    return _kl_normal(p, q)  # invariant under the shared exp bijection


@register_kl(Gumbel, Gumbel)
def _kl_gumbel(p, q):
    # log(b2 / b1) + g (b1 / b2 - 1) + exp((u2 - u1) / b2
    #   + lgamma(1 + b1 / b2)) - 1 + (u1 - u2) / b2
    g = Gumbel._EULER
    r = p.scale / q.scale
    d = (p.loc - q.loc) / q.scale
    return _wrap(torch.log(q.scale / p.scale) + g * (r - 1)
                 + torch.exp(-d + torch.lgamma(1 + r)) - 1 + d)
