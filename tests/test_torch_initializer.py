"""paddle_tpu_torch.nn.initializer against paddle_tpu.nn.initializer.

The two packages draw from different generators (jax.random keys and
torch's Philox), so no draw is compared with a draw. What is compared:
the fans, gains, bounds and standard deviations each initializer
computes, exactly (both in Python floats); the deterministic
initializers (Constant, Assign, Dirac) element for element; and each
random one's moments and support on large draws, each side against the
distribution and against the other within sampling error."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import initializer as J
from paddle_tpu_torch.nn import initializer as T

N = 200_000
SHAPES = [(64,), (48, 80), (16, 8, 3, 3)]


def _draw_ref(init, shape):
    return np.asarray(init(shape))


def _draw_port(init, shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init(shape, torch.float32, generator=gen).numpy()


@pytest.mark.parametrize("shape", SHAPES + [(5, 7, 2)])
def test_fans_equal_reference(shape):
    assert T._fans(shape) == J._fans(shape)


@pytest.mark.parametrize("args", [("tanh",), ("relu",), ("leaky_relu",),
                                  ("leaky_relu", 0.2), ("selu",),
                                  ("linear",), ("sigmoid",)])
def test_calculate_gain_equals_reference(args):
    assert T.calculate_gain(*args) == J.calculate_gain(*args)


def _port_asks(monkeypatch, kind):
    """Record what the port's Xavier/Kaiming classes ask of the Normal
    or Uniform they build: [(mean, std)] or [(low, high)]."""
    got = []
    real = {"normal": T.Normal, "uniform": T.Uniform}[kind]

    class Rec(real):
        def __call__(self, shape, *a, **kw):
            got.append((self.mean, self.std) if kind == "normal"
                       else (self.low, self.high))
            return real.__call__(self, shape, *a, **kw)

    monkeypatch.setattr(T, real.__name__, Rec)
    return got


def _ref_asks(monkeypatch, kind):
    """Record what the reference's classes ask of jax.random: the bounds
    passed to uniform, or the std a normal draw is multiplied by (the
    draw is replaced by an object that records its multiplier)."""
    import jax
    got = []

    class Draw:
        def __init__(self, shape):
            self.shape = shape

        def __mul__(self, std):
            got.append((0.0, std))
            return np.zeros(self.shape, np.float32)

    def normal(key, shape, dtype=None):
        return Draw(shape)

    def uniform(key, shape, dtype=None, minval=0.0, maxval=1.0):
        got.append((minval, maxval))
        return np.zeros(shape, np.float32)

    monkeypatch.setattr(jax.random, kind,
                        normal if kind == "normal" else uniform)
    return got


CASES = {
    "XavierNormal": dict(),
    "XavierNormal_gain_fans": dict(fan_in=10, fan_out=30, gain=2.0),
    "XavierUniform": dict(),
    "XavierUniform_gain": dict(gain=5.0 / 3.0),
    "KaimingNormal": dict(),
    "KaimingNormal_slope_fan": dict(negative_slope=0.2, fan_in=7),
    "KaimingUniform": dict(),
    "KaimingUniform_slope": dict(negative_slope=0.1),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_xavier_kaiming_bounds_and_stds_equal_reference(case, shape,
                                                        monkeypatch):
    """The std (normal forms) or the bound (uniform forms) each class
    derives from the shape, gain, fans and slope: the same Python float
    in both packages."""
    name, kw = case.split("_")[0], CASES[case]
    kind = "normal" if name.endswith("Normal") else "uniform"
    port_asks = _port_asks(monkeypatch, kind)
    got = getattr(T, name)(**kw)(shape, generator=torch.Generator())
    ref_asks = _ref_asks(monkeypatch, kind)
    getattr(J, name)(**kw)(shape)
    assert port_asks == ref_asks and len(port_asks) == 1
    assert got.shape == tuple(shape)
    if kind == "uniform":
        low, high = port_asks[0]
        assert low == -high and float(got.abs().max()) <= high


def _moments_close(a, b, what):
    """Means within 6 standard errors and stds within 2 %, between two
    samples of N."""
    se = max(a.std(), b.std()) / math.sqrt(a.size)
    assert abs(a.mean() - b.mean()) <= 6 * math.sqrt(2) * se, what
    assert abs(a.std() / b.std() - 1) < 0.02, what


DISTRIBUTIONS = {
    "normal": (lambda m: m.Normal(0.5, 2.0), (-math.inf, math.inf)),
    "truncated_normal": (lambda m: m.TruncatedNormal(1.0, 0.5, -2.0, 2.0),
                         (0.0, 2.0)),
    "truncated_normal_skew": (lambda m: m.TruncatedNormal(0.0, 1.0, -1.0,
                                                          3.0), (-1.0, 3.0)),
    "uniform": (lambda m: m.Uniform(-0.3, 0.7), (-0.3, 0.7)),
    "xavier_uniform": (lambda m: m.XavierUniform(),
                       (-math.sqrt(6 / 900), math.sqrt(6 / 900))),
    "xavier_normal": (lambda m: m.XavierNormal(), (-math.inf, math.inf)),
    "kaiming_uniform": (lambda m: m.KaimingUniform(),
                        (-math.sqrt(6 / 400), math.sqrt(6 / 400))),
    "kaiming_normal": (lambda m: m.KaimingNormal(), (-math.inf, math.inf)),
}


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_distribution_moments_and_support_match_reference(name):
    make, (lo, hi) = DISTRIBUTIONS[name]
    # fans (400, 500): the bounds above; N draws either way
    shape = (400, N // 400) if "xavier" in name or "kaiming" in name \
        else (N,)
    pt.seed(0)
    want = _draw_ref(make(J), shape)
    got = _draw_port(make(T), shape)
    assert got.shape == want.shape and got.dtype == np.float32
    for x in (got, want):
        assert x.min() >= lo and x.max() <= hi
        if math.isfinite(lo):
            # the support is filled: draws reach within 1 % of both ends
            assert x.min() < lo + 0.01 * (hi - lo)
            assert x.max() > hi - 0.01 * (hi - lo)
    _moments_close(got, want, name)


def test_deterministic_initializers_equal_reference():
    for shape in [(3, 4), (6, 3, 3, 3), (4, 8, 3)]:
        for groups in (1, 2):
            np.testing.assert_array_equal(
                _draw_port(T.Dirac(groups), shape),
                _draw_ref(J.Dirac(groups), shape))
    np.testing.assert_array_equal(_draw_port(T.Constant(0.25), (3, 5)),
                                  _draw_ref(J.Constant(0.25), (3, 5)))
    vals = np.arange(12, dtype=np.float32)
    for v in (vals, vals.tolist(), torch.as_tensor(vals)):
        np.testing.assert_array_equal(
            _draw_port(T.Assign(v), (3, 4)),
            _draw_ref(J.Assign(vals), (3, 4)))
    got = T.Constant(1.5)((2, 2), "bfloat16", device="cpu")
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"


@pytest.mark.parametrize("shape", [(64, 16), (16, 64), (8, 4, 6)])
@pytest.mark.parametrize("gain", [1.0, 0.5])
def test_orthogonal_like_reference(shape, gain):
    """Both packages' draws are orthogonal along the same axes: the
    flattened [prod(shape[:-1]), shape[-1]] matrix has orthonormal
    columns (rows when it is wide), times the gain."""
    pt.seed(0)
    for x in (_draw_port(T.Orthogonal(gain), shape),
              _draw_ref(J.Orthogonal(gain), shape)):
        assert x.shape == shape
        m = x.reshape(-1, shape[-1]).astype(np.float64)
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(gram, gain ** 2 * np.eye(len(gram)),
                                   atol=1e-5)


def test_get_and_global_initializer_like_reference():
    init = T.Normal()
    assert T.get_initializer(None) is None
    assert T.get_initializer(init) is init
    assert T.get_initializer(len) is len
    with pytest.raises(TypeError):
        T.get_initializer(3)
    with pytest.raises(TypeError):
        J.get_initializer(3)
    T.set_global_initializer(init, T.Constant(0.0))
    assert T._global_weight_init is init
    T.set_global_initializer(None)
    assert T._global_weight_init is None and T._global_bias_init is None


def test_draws_follow_the_generator_and_device():
    a = T.Normal()((4, 4), generator=torch.Generator().manual_seed(3))
    b = T.Normal()((4, 4), generator=torch.Generator().manual_seed(3))
    c = T.Normal()((4, 4), generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.Normal()((4, 4))
    assert T.Uniform()((3,), device="cpu").device.type == "cpu"
