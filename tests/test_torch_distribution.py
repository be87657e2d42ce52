"""paddle_tpu_torch.distribution against paddle_tpu.distribution on the
CPU, f32: log_prob, prob, entropy, cdf, icdf and the moments of every
class, the 11 registered KL pairs, the 12 transforms and their log-det
Jacobians, within rtol 1e-5 (atol 1e-6): the same formulas through XLA's
and torch's f32 special functions (lgamma, digamma, erf), a few ulps
apart. Gradients: the port's torch.autograd against the reference's
jax.grad of the same function; rsample's through draws made equal by
handing the reference the port's (jax.random patched to return them).
Draws are compared only by their moments: 2e5 draws a distribution,
each mean within 6 standard errors of the analytic mean, each variance
within 6 standard errors of the analytic variance (the fourth moment's
estimate)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import distribution as JD
from paddle_tpu_torch import distribution as TD
from paddle_tpu_torch.core.generator import torch_generator
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-5, atol=1e-6)
R = np.random.default_rng(0)
LOC = R.standard_normal((2, 3)).astype(np.float32)
SCALE = (R.uniform(0.5, 2.0, (2, 3))).astype(np.float32)
P01 = R.uniform(0.1, 0.9, (2, 3)).astype(np.float32)
POS = R.uniform(0.5, 3.0, (2, 3)).astype(np.float32)
V = R.standard_normal((2, 3)).astype(np.float32)
VPOS = R.uniform(0.2, 4.0, (2, 3)).astype(np.float32)
V01 = R.uniform(0.05, 0.95, (2, 3)).astype(np.float32)
CONC = R.uniform(0.5, 3.0, (2, 4)).astype(np.float32)
SIMPLEX = (lambda a: (a / a.sum(-1, keepdims=True)).astype(np.float32))(
    R.uniform(0.1, 1.0, (2, 4)))
LOGITS = R.standard_normal((2, 5)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _both(name, *args):
    """The class `name` on both packages from the same numpy args."""
    return (getattr(TD, name)(*[ptt.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args]),
            getattr(JD, name)(*[pt.to_tensor(a) if isinstance(
                a, np.ndarray) else a for a in args]))


# (class, constructor args, value, methods)
CASES = [
    ("Normal", (LOC, SCALE), V, ("log_prob", "prob", "entropy", "cdf",
                                 "mean", "variance", "stddev")),
    ("Uniform", (LOC, LOC + SCALE), LOC + 0.5 * SCALE,
     ("log_prob", "entropy")),
    ("Bernoulli", (P01,), (V > 0).astype(np.float32),
     ("log_prob", "entropy")),
    ("Beta", (POS, SCALE), V01, ("log_prob",)),
    ("Gamma", (POS, SCALE), VPOS, ("log_prob",)),
    ("Dirichlet", (CONC,), SIMPLEX, ("log_prob",)),
    ("Multinomial", (6, SIMPLEX), np.array([[1, 2, 0, 3], [0, 0, 6, 0]],
                                           np.float32), ("log_prob",)),
    ("Categorical", (LOGITS,), np.array([0, 4], np.int32),
     ("log_prob", "entropy", "probs")),
    ("Laplace", (LOC, SCALE), V, ("log_prob", "entropy", "cdf", "icdf",
                                  "mean", "variance", "stddev")),
    ("Cauchy", (LOC, SCALE), V, ("log_prob", "entropy", "cdf")),
    ("Geometric", (P01,), np.array([[0, 1, 4], [2, 0, 7]], np.float32),
     ("log_prob", "entropy", "cdf", "mean", "variance")),
    ("Gumbel", (LOC, SCALE), V, ("log_prob", "entropy", "cdf", "mean",
                                 "variance", "stddev")),
    ("LogNormal", (LOC, SCALE), VPOS, ("log_prob", "entropy", "mean",
                                       "variance")),
    ("Binomial", (np.array([[3, 5, 9], [1, 4, 9]], np.float32), P01),
     np.array([[1, 5, 2], [0, 3, 9]], np.float32),
     ("log_prob", "entropy", "mean", "variance")),
    ("Binomial", (7, P01), np.array([[1, 5, 2], [0, 3, 7]], np.float32),
     ("log_prob", "entropy", "mean", "variance")),
]


def _value(d, method, v, P):
    attr = getattr(d, method)
    if not callable(attr):
        return attr
    if method == "icdf":
        return attr(P.to_tensor(V01))
    return attr() if method == "entropy" else attr(P.to_tensor(v))


@pytest.mark.parametrize("name,args,v,methods", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_methods_match_reference(name, args, v, methods):
    ours, ref = _both(name, *args)
    assert ours.batch_shape == ref.batch_shape
    assert ours.event_shape == ref.event_shape
    for m in methods:
        got = _value(ours, m, v, ptt).numpy()
        want = _value(ref, m, v, pt).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, m
        np.testing.assert_allclose(got, want, err_msg=m, **TOL)


def test_categorical_from_probs_geometric_from_logits_independent():
    ours, ref = _both("Categorical", None, SIMPLEX)
    np.testing.assert_allclose(ours.entropy().numpy(),
                               ref.entropy().numpy(), **TOL)
    ours = TD.Geometric(logits=ptt.to_tensor(V))
    ref = JD.Geometric(logits=pt.to_tensor(V))
    np.testing.assert_allclose(ours.mean.numpy(), ref.mean.numpy(), **TOL)
    ti = TD.Independent(TD.Normal(ptt.to_tensor(LOC), ptt.to_tensor(SCALE)),
                        1)
    ji = JD.Independent(JD.Normal(pt.to_tensor(LOC), pt.to_tensor(SCALE)),
                        1)
    assert ti.batch_shape == ji.batch_shape == (2,)
    assert ti.event_shape == ji.event_shape == (3,)
    for m in ("log_prob", "entropy"):
        np.testing.assert_allclose(_value(ti, m, V, ptt).numpy(),
                                   _value(ji, m, V, pt).numpy(), **TOL)


KL = [("Normal", (LOC, SCALE), (V, POS)),
      ("Categorical", (LOGITS,), (LOGITS[::-1].copy(),)),
      ("Uniform", (LOC, LOC + SCALE), (LOC - 1.0, LOC + SCALE + 1.0)),
      ("Uniform", (LOC, LOC + SCALE), (LOC + 0.1, LOC + SCALE)),
      ("Bernoulli", (P01,), (P01[::-1].copy(),)),
      ("Laplace", (LOC, SCALE), (V, POS)),
      ("Geometric", (P01,), (P01[::-1].copy(),)),
      ("Gamma", (POS, SCALE), (SCALE, POS)),
      ("Beta", (POS, SCALE), (SCALE, POS)),
      ("Dirichlet", (CONC,), (CONC[::-1].copy(),)),
      ("LogNormal", (LOC, SCALE), (V, POS)),
      ("Gumbel", (LOC, SCALE), (V, POS))]


@pytest.mark.parametrize("name,pa,qa", KL,
                         ids=[f"{k[0]}-{i}" for i, k in enumerate(KL)])
def test_kl_matches_reference(name, pa, qa):
    tp, jp = _both(name, *pa)
    tq, jq = _both(name, *qa)
    got = TD.kl_divergence(tp, tq).numpy()
    np.testing.assert_allclose(got, JD.kl_divergence(jp, jq).numpy(),
                               **TOL)
    np.testing.assert_allclose(tp.kl_divergence(tq).numpy(), got)
    assert len(TD._KL_REGISTRY) == len(JD._KL_REGISTRY) == 11


def test_kl_registry_rules():
    with pytest.raises(NotImplementedError):
        TD.kl_divergence(TD.Cauchy(0.0, 1.0), TD.Normal(0.0, 1.0))

    class MyNormal(TD.Normal):
        pass

    @TD.register_kl(MyNormal, TD.Normal)
    def _mine(p, q):
        return ptt.to_tensor(np.float32(7.0))

    try:
        assert float(TD.kl_divergence(MyNormal(0.0, 1.0),
                                      TD.Normal(0.0, 1.0))) == 7.0
        assert float(TD.kl_divergence(TD.Normal(0.0, 1.0),
                                      TD.Normal(0.0, 1.0))) == 0.0
    finally:
        TD._KL_REGISTRY.pop((MyNormal, TD.Normal))


def _transforms(M, P):
    return [M.AffineTransform(P.to_tensor(LOC), P.to_tensor(SCALE)),
            M.ExpTransform(), M.PowerTransform(P.to_tensor(np.float32(1.5))),
            M.SigmoidTransform(), M.TanhTransform(), M.AbsTransform(),
            M.ChainTransform([M.AffineTransform(0.5, 2.0),
                              M.SigmoidTransform()]),
            M.IndependentTransform(M.ExpTransform(), 1),
            M.ReshapeTransform((3,), (3, 1)), M.SoftmaxTransform(),
            M.StackTransform([M.ExpTransform(), M.TanhTransform()], 0),
            M.StickBreakingTransform()]


@pytest.mark.parametrize("i", range(12))
def test_transforms_match_reference(i):
    t, j = _transforms(TD, ptt)[i], _transforms(JD, pt)[i]
    x = V01 if i in (2,) else V * 0.8
    y = V01 if i in (3, 4) else np.abs(V) + 0.1
    assert t._type == j._type
    for m, a in (("forward", x), ("inverse", y),
                 ("forward_log_det_jacobian", x),
                 ("inverse_log_det_jacobian", y)):
        if m.endswith("jacobian") and i in (5, 9):
            continue      # the reference defines no log-det for these
        if i == 11 and m in ("inverse", "inverse_log_det_jacobian"):
            a = SIMPLEX
        if i == 8 and m.startswith("inverse"):
            a = a[..., None]          # the out event shape (3, 1)
        got = getattr(t, m)(ptt.to_tensor(a)).numpy()
        want = getattr(j, m)(pt.to_tensor(a)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6,
                                   err_msg=m)
    np.testing.assert_allclose(t(ptt.to_tensor(x)).numpy(),
                               j(pt.to_tensor(x)).numpy(), rtol=2e-5,
                               atol=2e-6)


def test_transformed_distribution():
    tt = TD.TransformedDistribution(
        TD.Normal(ptt.to_tensor(LOC), ptt.to_tensor(SCALE)),
        [TD.AffineTransform(1.0, 2.0), TD.ExpTransform()])
    jt = JD.TransformedDistribution(
        JD.Normal(pt.to_tensor(LOC), pt.to_tensor(SCALE)),
        [JD.AffineTransform(1.0, 2.0), JD.ExpTransform()])
    np.testing.assert_allclose(tt.log_prob(ptt.to_tensor(VPOS)).numpy(),
                               jt.log_prob(pt.to_tensor(VPOS)).numpy(),
                               **TOL)
    assert tt.sample((4,)).shape == [4, 2, 3]


def _grad_ref(name, args, fn):
    """jax.grad of fn(the reference's distribution of args) by args."""
    def f(*a):
        return jnp.sum(fn(getattr(JD, name)(*a))._data)
    return jax.grad(f, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])


def _grad_port(name, args, fn):
    ts = [ptt.to_tensor(a, stop_gradient=False) for a in args]
    fn(getattr(TD, name)(*ts)).sum().backward()
    # an input the result does not reach has no grad (jax.grad: zeros)
    return [np.zeros_like(a) if t.grad is None else t.grad.numpy()
            for a, t in zip(args, ts)]


GRADS = [
    ("Normal", (LOC, SCALE), lambda d, P: d.log_prob(P.to_tensor(V))),
    ("Normal", (LOC, SCALE), lambda d, P: d.entropy()),
    ("Laplace", (LOC, SCALE), lambda d, P: d.cdf(P.to_tensor(V))),
    ("Gamma", (POS, SCALE), lambda d, P: d.log_prob(P.to_tensor(VPOS))),
    ("Beta", (POS, SCALE), lambda d, P: d.log_prob(P.to_tensor(V01))),
    ("Dirichlet", (CONC,), lambda d, P: d.log_prob(P.to_tensor(SIMPLEX))),
    ("Categorical", (LOGITS,), lambda d, P: d.entropy()),
    ("Gumbel", (LOC, SCALE), lambda d, P: d.log_prob(P.to_tensor(V))),
]


@pytest.mark.parametrize("name,args,fn", GRADS,
                         ids=[f"{g[0]}-{i}" for i, g in enumerate(GRADS)])
def test_gradients_match_jax_grad(name, args, fn):
    want = _grad_ref(name, args, lambda d: fn(d, pt))
    got = _grad_port(name, args, lambda d: fn(d, ptt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,draw", [
    ("Normal", "normal"), ("LogNormal", "normal"), ("Laplace", "uniform"),
    ("Cauchy", "uniform"), ("Gumbel", "uniform")])
def test_rsample_and_its_gradient_on_equal_draws(name, draw, monkeypatch):
    """The reference is handed the port's draws (jax.random.normal /
    uniform patched to return them): the samples agree, and so do the
    gradients of their sum by loc and scale (torch.autograd against
    jax.grad)."""
    shape = (4, 2, 3)
    ptt.seed(11)
    g = torch_generator(torch.device("cpu"))
    z = (torch.randn(shape, generator=g) if draw == "normal"
         else torch.rand(shape, generator=g)).numpy()

    def fake(key, shape_, *a, minval=0.0, maxval=1.0, **kw):
        zz = jnp.asarray(z)
        return zz if draw == "normal" else minval + (maxval - minval) * zz

    monkeypatch.setattr(jax.random, draw, fake)
    ptt.seed(11)
    ts = [ptt.to_tensor(a, stop_gradient=False) for a in (LOC, SCALE)]
    s = getattr(TD, name)(*ts).rsample((4,))
    s.sum().backward()
    want_s = JD.__dict__[name](pt.to_tensor(LOC), pt.to_tensor(SCALE)) \
        .rsample((4,)).numpy()
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-5, atol=1e-6)
    want_g = _grad_ref(name, (LOC, SCALE), lambda d: d.rsample((4,)))
    for t, w in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


N = 200_000


def _moments_ok(x, mean, var):
    """x [N, ...] of draws; each mean and variance within 6 standard
    errors of the analytic ones."""
    x = np.asarray(x, np.float64)
    m, v = x.mean(0), x.var(0)
    m4 = ((x - mean) ** 4).mean(0)
    se_m = np.sqrt(var / len(x))
    se_v = np.sqrt(np.maximum(m4 - var ** 2, 1e-12) / len(x))
    return (np.abs(m - mean) <= 6 * se_m + 1e-9).all() and \
        (np.abs(v - var) <= 6 * se_v + 1e-9).all(), (m, v, mean, var)


def _gamma_mv(a, b):
    return a / b, a / b ** 2


MOMENTS = [
    ("Normal", (np.float32(1.0), np.float32(2.0)), (1.0, 4.0)),
    ("Uniform", (np.float32(-1.0), np.float32(3.0)), (1.0, 16 / 12)),
    ("Bernoulli", (np.float32(0.3),), (0.3, 0.21)),
    ("Gamma", (np.float32(2.5), np.float32(1.5)), _gamma_mv(2.5, 1.5)),
    ("Beta", (np.float32(2.0), np.float32(5.0)),
     (2 / 7, 10 / (49 * 8))),
    ("Laplace", (np.float32(0.5), np.float32(1.5)), (0.5, 2 * 1.5 ** 2)),
    ("Gumbel", (np.float32(0.5), np.float32(2.0)),
     (0.5 + 0.5772156649 * 2, np.pi ** 2 / 6 * 4)),
    ("LogNormal", (np.float32(0.0), np.float32(0.5)),
     (np.exp(0.125), (np.exp(0.25) - 1) * np.exp(0.25))),
    ("Geometric", (np.float32(0.3),), (0.7 / 0.3, 0.7 / 0.09)),
    ("Binomial", (10, np.float32(0.3)), (3.0, 2.1)),
]


@pytest.mark.parametrize("name,args,mv", MOMENTS,
                         ids=[m[0] for m in MOMENTS])
def test_sample_moments(name, args, mv):
    ptt.seed(5)
    d = getattr(TD, name)(*[ptt.to_tensor(a) if isinstance(a, np.floating)
                            else a for a in args])
    x = d.sample((N,)).numpy()
    assert x.shape == (N,)
    ok, info = _moments_ok(x, *mv)
    assert ok, info


def test_vector_sample_moments():
    ptt.seed(6)
    a = np.array([1.0, 2.0, 3.5], np.float32)
    x = TD.Dirichlet(ptt.to_tensor(a)).sample((N,)).numpy()
    a0 = a.sum()
    ok, info = _moments_ok(x, a / a0, a * (a0 - a) / (a0 ** 2 * (a0 + 1)))
    assert ok and x.shape == (N, 3), info
    p = np.array([0.2, 0.5, 0.3], np.float32)
    x = TD.Multinomial(8, ptt.to_tensor(p)).sample((N,)).numpy()
    ok, info = _moments_ok(x, 8 * p, 8 * p * (1 - p))
    assert ok and (x.sum(-1) == 8).all(), info
    logits = np.log(np.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]],
                             np.float32))
    x = TD.Categorical(ptt.to_tensor(logits)).sample((N,)).numpy()
    assert x.shape == (N, 2) and x.dtype == np.int32
    freq = np.stack([(x == k).mean(0) for k in range(3)], -1)
    np.testing.assert_allclose(freq, np.exp(logits), atol=6 * 0.5 / N ** 0.5)
    # a per-element count: no draw exceeds its own count
    n = ptt.to_tensor(np.array([2.0, 7.0], np.float32))
    x = TD.Binomial(n, ptt.to_tensor(np.array([0.9, 0.9], np.float32))) \
        .sample((1000,)).numpy()
    assert x[:, 0].max() == 2 and x[:, 1].max() <= 7


def test_parameters_on_the_default_place_and_seeded_draws():
    d = TD.Normal(0.0, 1.0)
    assert d.loc.device.type == "cpu"
    ptt.seed(3)
    a = d.sample((5,)).numpy()
    ptt.seed(3)
    np.testing.assert_array_equal(a, d.sample((5,)).numpy())
