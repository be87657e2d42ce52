"""The port's generators and random ops on the CPU: the same draws under
the same seed (and other draws under another), one torch.Generator per
device seeded together, rng_scope, FLAGS_seed, and each random op's
shape and dtype against the reference's and its moments against the
distribution's. No test compares a draw across the packages: torch's
generators are not jax.random.

Moment limits (eager_op_cases.moments_ok): n = 200,000 draws, the mean
within 6 standard errors (sd / 447) of the distribution's, the standard
deviation within 2 % of its (its own standard error is under 0.5 %)."""
import numpy as np
import pytest
import torch

import eager_op_cases as C
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import generator as G
from torch_port_helpers import cpu_place

N = 200_000


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


_draws = C.random_draws


def _arrays(ts):
    return [np.asarray(t.numpy()) for t in ts]


def test_same_seed_same_draws_other_seed_other_draws():
    ptt.seed(11)
    a = _arrays(_draws(ptt))
    ptt.seed(11)
    b = _arrays(_draws(ptt))
    ptt.seed(12)
    c = _arrays(_draws(ptt))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert sum(not np.array_equal(x, z) for x, z in zip(a, c)) >= 18


def test_random_ops_shapes_and_dtypes_match_reference():
    pt.seed(0)
    want = _draws(pt)
    ptt.seed(0)
    got = _draws(ptt)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        assert g.stop_gradient


def test_generator_state_and_devices():
    g = G.Generator(5)
    t1 = torch.rand(4, generator=g.torch_generator("cpu"))
    st = g.get_state()
    t2 = torch.rand(4, generator=g.torch_generator("cpu"))
    g.set_state(st)
    np.testing.assert_array_equal(
        torch.rand(4, generator=g.torch_generator("cpu")), t2)
    g.manual_seed(5)
    np.testing.assert_array_equal(
        torch.rand(4, generator=g.torch_generator("cpu")), t1)
    assert g.seed() == 5
    assert G.default_generator() is G.default_generator()
    assert ptt.seed(3) is G.default_generator()
    assert G.default_generator().seed() == 3
    assert ptt.get_flags("FLAGS_seed") == {"FLAGS_seed": 0}


def test_rng_scope_draws_from_its_own_generator():
    ptt.seed(1)
    a = ptt.rand([4]).numpy()
    ptt.seed(1)
    with G.rng_scope(99):
        s1 = ptt.rand([4]).numpy()
    b = ptt.rand([4]).numpy()
    with G.rng_scope(99):
        s2 = ptt.rand([4]).numpy()
    np.testing.assert_array_equal(a, b)         # the scope took no draw
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(a, s1)


def test_dropout_op_draws_from_the_eager_generator():
    x = ptt.to_tensor(np.ones((64, 64), np.float32))
    ptt.seed(4)
    a = ptt.nn.functional.dropout(x, 0.5).numpy()
    ptt.seed(4)
    b = ptt.nn.functional.dropout(x, 0.5).numpy()
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) == {0.0, 2.0}
    assert abs((a == 0).mean() - 0.5) < 0.05


@pytest.mark.parametrize("name,draw,mean,sd", C.RANDOM_MOMENTS,
                         ids=[m[0] for m in C.RANDOM_MOMENTS])
def test_random_op_moments(name, draw, mean, sd):
    ptt.seed(2024)
    ok, m, s = C.moments_ok(draw(ptt, N).numpy(), mean, sd)
    assert ok, (m, mean, s, sd)


def test_permutation_multinomial_dirichlet_structure():
    ptt.seed(0)
    assert sorted(ptt.randperm(50).tolist()) == list(range(50))
    probs = ptt.to_tensor(np.array([0.1, 0.2, 0.7], np.float32))
    draws = ptt.multinomial(probs, N, replacement=True).numpy()
    freq = np.bincount(draws, minlength=3) / N
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.01)
    no_rep = ptt.multinomial(ptt.to_tensor(np.ones((5, 6), np.float32)),
                             6).numpy()
    assert all(sorted(r) == list(range(6)) for r in no_rep)
    d = ptt.dirichlet(ptt.to_tensor(np.ones((N // 10, 3), np.float32)))
    np.testing.assert_allclose(d.numpy().sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(d.numpy().mean(0), [1 / 3] * 3, atol=0.01)
    t = ptt.truncated_normal([N], mean=1.0, std=2.0).numpy()
    assert t.min() >= -3.0 and t.max() <= 5.0


def test_building_a_model_leaves_the_eager_generator_alone():
    """The port's models draw each weight once, from their own seeded
    generator: building one neither draws from nor advances the
    port's default generator."""
    from paddle_tpu_torch.models import gpt, llama
    ptt.seed(5)
    want = _arrays(_draws(ptt))
    ptt.seed(5)
    gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu", seed=1)
    llama.LlamaForCausalLM(llama.llama_tiny(), device="cpu", seed=1)
    for a, b in zip(_arrays(_draws(ptt)), want):
        np.testing.assert_array_equal(a, b)
