"""Random ops (counterpart of paddle_tpu/ops/random.py).

Every draw comes from the eager generator of the output's device
(``core.generator.torch_generator``): ``seed(n)`` makes a run's draws
the same, run after run, on each device. The draws are torch's, not
``jax.random``'s, so the reference's values are not reproduced, only
its distributions, shapes and dtypes. The ops with a shape argument
draw on the default place; the rest on their input's device. A
``seed`` argument other than 0 draws from a generator of its own seeded
with it, as the reference's ``PRNGKey(seed)``."""
from __future__ import annotations

import torch

from ..core.device import default_torch_device
from ..core.generator import torch_generator
from ..core.tensor import NARROW, Tensor
from ._util import dt, new_tensor as _new, shape_arg

__all__ = ["rand", "uniform", "randn", "normal", "gaussian",
           "standard_normal", "randint", "randint_like", "randperm",
           "multinomial", "bernoulli", "poisson", "exponential_",
           "rand_like", "randn_like", "normal_like", "binomial",
           "dirichlet", "standard_gamma", "truncated_normal"]


def _gen(device, seed=0):
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return torch_generator(device)


def _data(x) -> torch.Tensor:
    if isinstance(x, Tensor):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    t = torch.as_tensor(x, device=default_torch_device())
    return t.to(NARROW.get(t.dtype, t.dtype))


def rand(shape, dtype=None):
    dev = default_torch_device()
    return _new(torch.rand(shape_arg(shape), dtype=dt(dtype), device=dev,
                           generator=_gen(dev)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    dev = default_torch_device()
    u = torch.rand(shape_arg(shape), dtype=dt(dtype), device=dev,
                   generator=_gen(dev, seed))
    return _new(u * (max - min) + min)


def randn(shape, dtype=None):
    dev = default_torch_device()
    return _new(torch.randn(shape_arg(shape), dtype=dt(dtype), device=dev,
                            generator=_gen(dev)))


def normal(mean=0.0, std=1.0, shape=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = _data(mean) if isinstance(mean, Tensor) else mean
        s = _data(std) if isinstance(std, Tensor) else std
        like = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(
            *[t.shape for t in (m, s) if isinstance(t, torch.Tensor)])
        z = torch.randn(shp, device=like.device,
                        generator=_gen(like.device))
        return _new(z * s + m)
    dev = default_torch_device()
    return _new(torch.randn(shape_arg(shape or [1]), device=dev,
                            generator=_gen(dev)) * std + mean)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None):
    dev = default_torch_device()
    z = torch.randn(shape_arg(shape), dtype=dt(dtype), device=dev,
                    generator=_gen(dev, seed))
    return _new(z * std + mean)


def standard_normal(shape, dtype=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype=None):
    if high is None:
        low, high = 0, low
    dev = default_torch_device()
    return _new(torch.randint(int(low), int(high), shape_arg(shape),
                              dtype=dt(dtype, torch.int32), device=dev,
                              generator=_gen(dev)))


def randint_like(x, low=0, high=None, dtype=None):
    if high is None:
        low, high = 0, low
    d = _data(x)
    return _new(torch.randint(int(low), int(high), tuple(d.shape),
                              dtype=dt(dtype, d.dtype), device=d.device,
                              generator=_gen(d.device)))


def randperm(n, dtype=None):
    dev = default_torch_device()
    return _new(torch.randperm(int(n), device=dev, generator=_gen(dev))
                .to(dt(dtype, torch.int32)))


def multinomial(x, num_samples=1, replacement=False):
    d = _data(x).float()
    return _new(torch.multinomial(d, int(num_samples),
                                  replacement=replacement,
                                  generator=_gen(d.device)))


def bernoulli(x):
    d = _data(x)
    return _new(torch.bernoulli(d.float(), generator=_gen(d.device))
                .to(d.dtype))


def poisson(x):
    d = _data(x)
    return _new(torch.poisson(d.float(), generator=_gen(d.device))
                .to(d.dtype))


def exponential_(x, lam=1.0):
    """Fill x with exponential draws of rate `lam` (rebinding it as the
    reference does); a non-Tensor gives a new Tensor."""
    d = _data(x)
    out = torch.empty_like(d).exponential_(lam, generator=_gen(d.device))
    if isinstance(x, Tensor):
        x._set_data(out)
        return x
    return _new(out)


def rand_like(x, dtype=None):
    d = _data(x)
    return _new(torch.rand(tuple(d.shape), dtype=dt(dtype, d.dtype),
                           device=d.device, generator=_gen(d.device)))


def randn_like(x, dtype=None):
    d = _data(x)
    return _new(torch.randn(tuple(d.shape), dtype=dt(dtype, d.dtype),
                            device=d.device, generator=_gen(d.device)))


def normal_like(x, mean=0.0, std=1.0):
    d = _data(x)
    return _new(torch.randn(tuple(d.shape), dtype=d.dtype, device=d.device,
                            generator=_gen(d.device)) * std + mean)


def binomial(count, prob):
    """Counts of successes in `count` trials of probability `prob`
    (int32, as the reference gives them)."""
    c, p = _data(count).float(), _data(prob).float()
    shape = torch.broadcast_shapes(c.shape, p.shape)
    out = torch.binomial(c.expand(shape).contiguous(),
                         p.expand(shape).contiguous(),
                         generator=_gen(c.device))
    return _new(out.to(torch.int32))


def dirichlet(concentration):
    a = _data(concentration)
    g = torch._standard_gamma(a.float(), generator=_gen(a.device))
    return _new((g / g.sum(-1, keepdim=True)).to(a.dtype))


def standard_gamma(alpha):
    a = _data(alpha)
    return _new(torch._standard_gamma(a.float(), generator=_gen(a.device))
                .to(a.dtype))


def truncated_normal(shape, mean=0.0, std=1.0, a=-2.0, b=2.0, dtype=None):
    """Normal draws on [a, b] (in standard deviations), by the inverse
    CDF of uniform draws between the bounds' CDFs, then scaled."""
    dev = default_torch_device()
    shape = shape_arg(shape)
    u = torch.rand(shape, dtype=torch.float32, device=dev,
                   generator=_gen(dev))
    cdf = lambda v: 0.5 * (1 + torch.erf(torch.tensor(v / 2 ** 0.5)))  # noqa
    lo, hi = cdf(a), cdf(b)
    z = torch.erfinv(2 * (lo + u * (hi - lo)) - 1) * 2 ** 0.5
    z = torch.clamp(z, a, b)
    return _new((z * std + mean).to(dt(dtype)))
