"""optimizer.LBFGS (paddle_tpu_torch/optimizer/lbfgs.py) against the
reference's on the CPU: the reference's cases of
tests/test_parity_gaps_r4.py (a quadratic that converges, Rosenbrock
that descends) on both packages, both line searches on a least-squares
Linear layer (the losses of 3 steps and the parameters while the loss
still falls within 1e-5, rtol = atol, and the same count of closure
calls: the same algorithm on the same f32 flat vectors, torch and XLA
summing the dot products in other orders), the history bound, the
tolerances, max_eval, and the weight_decay coercion (an L1 regularizer
raises). Parameters may be Tensors, a Layer's
Parameters or torch tensors; those that do not require a gradient are
left alone."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _np(t):
    return np.asarray(t.numpy())


@pytest.mark.parametrize("P", [pt, ptt], ids=["reference", "port"])
def test_lbfgs_quadratic_converges(P):
    w = P.to_tensor(np.array([5.0, -3.0], np.float32))
    w.stop_gradient = False
    opt = P.optimizer.LBFGS(learning_rate=1.0, max_iter=30,
                            line_search_fn="strong_wolfe", parameters=[w])
    target = np.array([1.0, 2.0], np.float32)

    def closure():
        opt.clear_grad()
        d = w - P.to_tensor(target)
        loss = (d * d).sum()
        loss.backward()
        return loss

    opt.step(closure)
    np.testing.assert_allclose(_np(w), target, atol=1e-4)


def _rosenbrock(P, line_search):
    w = P.to_tensor(np.array([-1.2, 1.0], np.float32))
    w.stop_gradient = False
    opt = P.optimizer.LBFGS(learning_rate=1.0, max_iter=15,
                            line_search_fn=line_search, parameters=[w])
    calls = [0]

    def rosen():
        a = w[1] - w[0] * w[0]
        b = 1.0 - w[0]
        return 100.0 * (a * a) + b * b

    def closure():
        calls[0] += 1
        opt.clear_grad()
        loss = rosen()
        loss.backward()
        return loss

    f0 = float(rosen().numpy())
    steps = [float(opt.step(closure)) for _ in range(3)]
    return f0, float(rosen().numpy()), _np(w), calls[0], steps


def test_lbfgs_rosenbrock_descends_as_the_reference():
    """The reference's case on both packages: 3 steps take the loss
    below 5 % of its start; with the strong-Wolfe search both reach the
    minimum (1, 1). Rosenbrock's valley parts the two packages' f32
    roundings within the first steps (the closure counts differ by a
    few), so their points are held to the minimum, not to each other."""
    for P in (pt, ptt):
        f0, f1, w, _, _ = _rosenbrock(P, "strong_wolfe")
        assert f1 < f0 * 0.05, (P.__name__, f0, f1)
        np.testing.assert_allclose(w, [1.0, 1.0], atol=1e-4)
        f0, f1, _, _, _ = _rosenbrock(P, None)
        assert f1 < f0 * 0.05, (P.__name__, f0, f1)


def _lsq(P, line_search, steps=3, history=100, max_iter=4, wd=None,
         **kw):
    """LBFGS on mean((x W + b - y)^2) for a Linear(6, 3) from the same
    weights: (parameters after each step, closure calls, the losses
    step() returned, the optimizer)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = rng.standard_normal((16, 3)).astype(np.float32)
    w0 = rng.standard_normal((6, 3)).astype(np.float32) * 0.3
    lin = P.nn.Linear(6, 3)
    lin.set_state_dict({"weight": w0, "bias": np.zeros(3, np.float32)})
    opt = P.optimizer.LBFGS(learning_rate=1.0, max_iter=max_iter,
                            history_size=history,
                            line_search_fn=line_search,
                            parameters=lin.parameters(), weight_decay=wd,
                            **kw)
    xt, yt = P.to_tensor(x), P.to_tensor(y)
    calls = [0]

    def closure():
        calls[0] += 1
        opt.clear_grad()
        d = lin(xt) - yt
        loss = (d * d).mean()
        loss.backward()
        return loss

    trail, losses = [], []
    for _ in range(steps):
        losses.append(float(opt.step(closure)))
        trail.append([_np(p).copy() for p in lin.parameters()])
    return trail, calls[0], losses, opt


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
@pytest.mark.parametrize("wd", [None, 0.05], ids=["no_decay", "l2"])
def test_lbfgs_steps_match_reference(line_search, wd):
    """Three steps: the losses step() returns and the closure calls. The
    parameters are held after the first two, while the loss still
    falls by 1e-3 a step: by the third it has converged to 1e-7, and the
    direction then comes from differences of nearly equal f32 gradients
    (y = g_k - g_(k-1)), where the two packages' roundings enter at
    order one."""
    got, gcalls, glosses, gopt = _lsq(ptt, line_search, wd=wd)
    want, wcalls, wlosses, wopt = _lsq(pt, line_search, wd=wd)
    assert gcalls == wcalls
    np.testing.assert_allclose(glosses, wlosses, **TOL)
    for g_step, w_step in zip(got[:2], want[:2]):
        for g, w in zip(g_step, w_step):
            np.testing.assert_allclose(g, w, **TOL)
    assert len(gopt._s_hist) == len(wopt._s_hist)
    assert glosses[-1] < glosses[0]


def test_lbfgs_history_bound():
    """At most history_size (s, y) pairs are kept, as in the
    reference."""
    got, _, _, opt = _lsq(ptt, "strong_wolfe", steps=4, history=2,
                          max_iter=5)
    _, _, _, ref = _lsq(pt, "strong_wolfe", steps=4, history=2,
                        max_iter=5)
    assert len(opt._s_hist) == len(ref._s_hist) == 2
    assert len(opt._y_hist) == len(opt._rho) == 2


def test_lbfgs_tolerances():
    """A gradient within tolerance_grad returns after one evaluation
    with the parameters untouched; a change within tolerance_change
    stops after one iteration; max_eval stops at the first iteration
    boundary it reaches, as the reference's."""
    before = _lsq(ptt, None, steps=0)[3]
    trail, calls, _, _ = _lsq(ptt, None, steps=1, tolerance_grad=1e3)
    assert calls == 1
    w0 = [p.detach().numpy() for p in before._parameter_list]
    for a, b in zip(trail[0], w0):
        np.testing.assert_array_equal(a, b)
    for kw in ({"tolerance_change": 1e3}, {"max_eval": 2}):
        got = _lsq(ptt, "strong_wolfe", steps=1, max_iter=10, **kw)
        want = _lsq(pt, "strong_wolfe", steps=1, max_iter=10, **kw)
        assert got[1] == want[1] and got[1] < 10
        for g, w in zip(got[0][0], want[0][0]):
            np.testing.assert_allclose(g, w, **TOL)


def test_lbfgs_max_eval_default():
    opt = ptt.optimizer.LBFGS(max_iter=8, parameters=[torch.zeros(
        2, requires_grad=True)])
    assert opt.max_eval == 10


class L2Decay:
    def __init__(self, c):
        self._coeff = c


class L1Decay(L2Decay):
    pass


def test_lbfgs_weight_decay_coercion():
    """A float or an L2 regularizer becomes a float coefficient; an L1
    regularizer or a non-number raises TypeError, in both packages."""
    p = torch.zeros(2, requires_grad=True)
    assert ptt.optimizer.LBFGS(parameters=[p],
                               weight_decay=L2Decay(0.3)).weight_decay == 0.3
    assert ptt.optimizer.LBFGS(parameters=[p],
                               weight_decay="0.5").weight_decay == 0.5
    for bad in (L1Decay(0.1), "heavy", [0.1]):
        with pytest.raises(TypeError):
            ptt.optimizer.LBFGS(parameters=[p], weight_decay=bad)
        with pytest.raises(TypeError):
            pt.optimizer.LBFGS(parameters=[pt.to_tensor(
                np.zeros(2, np.float32))], weight_decay=bad)
    got = _lsq(ptt, None, steps=1, wd=L2Decay(0.05))
    want = _lsq(ptt, None, steps=1, wd=0.05)
    for g, w in zip(got[0][0], want[0][0]):
        np.testing.assert_array_equal(g, w)


def test_lbfgs_refusals():
    p = torch.zeros(2, requires_grad=True)
    with pytest.raises(ValueError, match="line_search_fn"):
        ptt.optimizer.LBFGS(parameters=[p], line_search_fn="backtracking")
    with pytest.raises(ValueError, match="closure"):
        ptt.optimizer.LBFGS(parameters=[p]).step()


def test_lbfgs_on_torch_parameters_skips_frozen():
    """torch parameters step in place; one that does not require a
    gradient is left out of the flat vectors, as a stop_gradient one is
    in the reference."""
    w = torch.tensor([5.0, -3.0], requires_grad=True)
    frozen = torch.tensor([7.0], requires_grad=False)
    opt = ptt.optimizer.LBFGS(max_iter=20, line_search_fn="strong_wolfe",
                              parameters=[w, frozen])
    ptr = w.data_ptr()

    def closure():
        opt.clear_grad()
        loss = ((w - torch.tensor([1.0, 2.0])) ** 2).sum() + frozen.sum()
        loss.backward()
        return loss

    out = opt.step(closure)
    assert isinstance(out, ptt.Tensor)
    np.testing.assert_allclose(w.detach().numpy(), [1.0, 2.0], atol=1e-4)
    assert float(frozen) == 7.0 and w.data_ptr() == ptr
