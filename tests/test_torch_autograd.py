"""The port's autograd (paddle_tpu_torch.autograd over torch.autograd)
against the reference's tape on the CPU: the cases of
tests/test_autograd.py, each written once against the API both packages
share and run on both from the same numpy inputs, and
test_backward_dispatch.py's check that gradients are equal across the
three backward dispatch modes. Values and gradients agree within 1e-5
(rtol = atol: f32, a few ulps apart between XLA and torch); results
within one package across dispatch modes are bit-equal."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


TOL = dict(rtol=1e-5, atol=1e-5)


def _t(P, x, sg=False):
    return P.to_tensor(np.asarray(x, np.float32), stop_gradient=sg)


def _np(t):
    return None if t is None else np.asarray(t.numpy())


# ---- each case: P -> {name: array or None or bool} ----
def simple_chain(P):
    x = _t(P, [2.0])
    (x * x + 3.0 * x).backward()
    return {"gx": _np(x.grad)}


def fan_out_accumulation(P):
    x = _t(P, [3.0])
    y = x * x
    (y + y + x).backward()
    return {"gx": _np(x.grad)}


def deep_graph(P):
    x = _t(P, [[1.0, 2.0], [3.0, 4.0]])
    w = _t(P, [[0.5, 0.1], [0.2, 0.3]])
    h = P.tanh(P.matmul(x, w))
    (h * h).sum().backward()
    return {"gx": _np(x.grad), "gw": _np(w.grad)}


def grad_accumulates_across_backwards(P):
    x = _t(P, [1.0])
    (x * 2).backward()
    (x * 3).backward()
    return {"gx": _np(x.grad)}


def clear_grad(P):
    x = _t(P, [1.0])
    (x * 2).backward()
    x.clear_grad()
    return {"cleared": x.grad is None}


def stop_gradient(P):
    x, y = _t(P, [1.0], sg=True), _t(P, [1.0])
    (x * y).backward()
    return {"gx_none": x.grad is None, "gy": _np(y.grad)}


def detach(P):
    x = _t(P, [2.0])
    y = (x * x).detach()
    (y * x).backward()
    return {"gx": _np(x.grad), "y_sg": y.stop_gradient}


def non_scalar_backward_with_grad(P):
    x = _t(P, [[1.0, 2.0]])
    (x * 2).backward(P.to_tensor(np.ones((1, 2), np.float32)))
    return {"gx": _np(x.grad)}


def backward_non_scalar_raises(P):
    x = _t(P, [[1.0, 2.0]])
    try:
        (x * 2).backward()
    except RuntimeError:
        return {"raised": True}
    return {"raised": False}


def multi_output_op(P):
    x = _t(P, [[3.0, 1.0], [2.0, 4.0]])
    vals, idx = P.topk(x, k=1, axis=1)
    vals.sum().backward()
    return {"gx": _np(x.grad), "idx": _np(idx), "idx_sg": idx.stop_gradient}


def retain_graph(P):
    x = _t(P, [2.0])
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    return {"gx": _np(x.grad)}


def no_grad_context(P):
    x = _t(P, [1.0])
    with P.no_grad():
        y = x * 2
    was = P.is_grad_enabled()
    old = P.set_grad_enabled(False)
    z = x * 3
    P.set_grad_enabled(old)
    with P.no_grad():
        with P.enable_grad():
            w = x * 4
    return {"y_sg": y.stop_gradient, "z_sg": z.stop_gradient,
            "w_sg": w.stop_gradient, "enabled": was, "old": old}


def hooks(P):
    x = _t(P, [1.0])
    seen = []

    def hook(g):
        seen.append(g.numpy().copy())
        return g * 2

    h = x.register_hook(hook)
    (x * 3).backward()
    g1 = _np(x.grad)
    h.remove()
    (x * 3).backward()
    return {"seen": np.asarray(seen), "g1": g1, "g2": _np(x.grad)}


def retain_grads(P):
    x = _t(P, [1.0, 2.0])
    y = x * 3
    y.retain_grads()
    z = y * y
    z.sum().backward()
    return {"gy": _np(y.grad), "gx": _np(x.grad)}


def grad_basic(P):
    x = _t(P, [3.0])
    (gx,) = P.grad(x * x, x)
    return {"gx": _np(gx), "untouched": x.grad is None}


def grad_intermediate(P):
    x = _t(P, [2.0])
    y = x * x
    (gy,) = P.grad(y * 3, y)
    return {"gy": _np(gy)}


def grad_unused(P):
    x, u = _t(P, [1.0]), _t(P, [1.0])
    res = P.grad(x * 2, [x, u], allow_unused=True)
    try:
        P.grad(x * 2, [x, u])
        raised = False
    except RuntimeError:
        raised = True
    return {"g0": _np(res[0]), "unused_none": res[1] is None,
            "raised": raised}


def double_backward_via_retain(P):
    x = _t(P, [2.0])
    (g1,) = P.grad(x * x * x, x, create_graph=True)
    return {"g1": _np(g1)}


def create_graph_returns_differentiable(P):
    x = _t(P, [2.0, 3.0])
    (g,) = P.grad((x * x * x).sum(), [x], create_graph=True)
    (g2,) = P.grad(g.sum(), [x])
    return {"g_sg": g.stop_gradient, "g2": _np(g2)}


def third_order(P):
    x = _t(P, [2.0])
    y = x * x * x * x
    (g1,) = P.grad(y.sum(), [x], create_graph=True)
    (g2,) = P.grad(g1.sum(), [x], create_graph=True)
    (g3,) = P.grad(g2.sum(), [x])
    return {"g3": _np(g3)}


def double_backward_through_matmul(P):
    rng = np.random.RandomState(0)
    x, w = _t(P, rng.randn(3, 4)), _t(P, rng.randn(4, 2))
    y = P.matmul(x, w)
    (gw,) = P.grad((y * y).sum(), [w], create_graph=True)
    (g2,) = P.grad((gw * gw).sum(), [w])
    return {"gw": _np(gw), "g2": _np(g2)}


def gradient_penalty_training_step(P):
    rng = np.random.RandomState(1)
    w = _t(P, rng.randn(4, 1) * 0.1)
    x = _t(P, rng.randn(8, 4))
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=[w])
    d_out = P.matmul(x, w).sum()
    (gx,) = P.grad(d_out, [x], create_graph=True)
    loss = d_out + 10.0 * (gx * gx).sum()
    loss.backward()
    g = _np(w.grad)
    opt.step()
    return {"gw": g, "w": _np(w)}


class _Cube:
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x * x

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensor()
        return dy * 3.0 * x * x


def _layer(P, body):
    return type("L", (P.autograd.PyLayer,), dict(
        forward=staticmethod(body.forward),
        backward=staticmethod(body.backward)))


def create_graph_through_pylayer(P):
    x = _t(P, [2.0])
    y = _layer(P, _Cube).apply(x)
    (g,) = P.grad(y.sum(), [x], create_graph=True)
    (g2,) = P.grad(g.sum(), [x])
    return {"g": _np(g), "g2": _np(g2)}


def jacobian(P):
    xa = np.random.RandomState(0).randn(3).astype(np.float32)
    xt = _t(P, xa)
    J = P.autograd.jacobian(P.sin(xt) * 2.0, xt)
    return {"J": np.asarray(J), "shape": np.asarray(J.shape)}


def jacobian_batch_axis(P):
    rng = np.random.RandomState(2)
    xa, w = rng.randn(4, 3), rng.randn(3, 2).astype(np.float32)
    xt = _t(P, xa)
    J = P.autograd.jacobian(P.matmul(xt, P.to_tensor(w)), xt, batch_axis=0)
    return {"J": np.asarray(J), "shape": np.asarray(J.shape)}


def jacobian_two_inputs(P):
    rng = np.random.RandomState(6)
    a, b = _t(P, rng.randn(3)), _t(P, rng.randn(3))
    ja, jb = P.autograd.jacobian(a * b + P.exp(a), [a, b])
    return {"ja": np.asarray(ja), "jb": np.asarray(jb)}


def hessian(P):
    xa = np.array([1.0, 2.0, 3.0], np.float32)
    xt = _t(P, xa)
    H = P.autograd.hessian((xt ** 3).sum(), xt)
    return {"H": np.asarray(H)}


def grad_does_not_pollute_other_leaf_grads(P):
    rng = np.random.RandomState(4)
    w, x = _t(P, rng.randn(3, 2)), _t(P, rng.randn(2, 3))
    J = P.autograd.jacobian(P.matmul(x, w), x)
    return {"w_none": w.grad is None, "x_none": x.grad is None,
            "J": np.asarray(J)}


def hessian_batch_axis(P):
    xa = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    xt = _t(P, xa)
    H = P.autograd.hessian((xt ** 3).sum(axis=1), xt, batch_axis=0)
    return {"H": np.asarray(H)}


def hessian_quadratic_form(P):
    rng = np.random.RandomState(3)
    A = rng.randn(4, 4).astype(np.float32)
    A = A + A.T
    xt = _t(P, rng.randn(4))
    y = (xt.reshape([1, 4]) @ P.to_tensor(A) @ xt.reshape([4, 1])).sum() \
        * 0.5
    return {"H": np.asarray(P.autograd.hessian(y, xt))}


def hessian_linear_is_zero(P):
    xt = _t(P, [1.0, 2.0])
    return {"H": np.asarray(P.autograd.hessian((xt * 3.0).sum(), xt))}


class _Double:
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * 2

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensor()
        return dy * 2


class _StraightThrough:
    @staticmethod
    def forward(ctx, x):
        return x.sign()

    @staticmethod
    def backward(ctx, dy):
        return dy


class _TwoInTwoOut:
    @staticmethod
    def forward(ctx, x, y, scale=1.0):
        ctx.save_for_backward(x, y)
        return x * y * scale, x + y

    @staticmethod
    def backward(ctx, da, db):
        x, y = ctx.saved_tensor()
        return da * y + db, da * x + db


def pylayer_custom_forward_backward(P):
    x = _t(P, [1.0, 2.0])
    _layer(P, _Double).apply(x).sum().backward()
    return {"gx": _np(x.grad)}


def pylayer_nonstandard_grad(P):
    x = _t(P, [0.5, -0.5])
    y = _layer(P, _StraightThrough).apply(x)
    y.sum().backward()
    return {"gx": _np(x.grad), "y": _np(y)}


def pylayer_two_outputs(P):
    x, y = _t(P, [1.0, 2.0]), _t(P, [3.0, -1.0])
    a, b = _layer(P, _TwoInTwoOut).apply(x, y, scale=1.0)
    (a.sum() + 2.0 * b.sum()).backward()
    return {"gx": _np(x.grad), "gy": _np(y.grad)}


def pylayer_without_grad_inputs(P):
    x = _t(P, [1.0, 2.0], sg=True)
    y = _layer(P, _Double).apply(x)
    return {"y": _np(y), "y_sg": y.stop_gradient}


def autocast_matmul_bf16(P):
    rng = np.random.RandomState(0)
    x, w = _t(P, rng.randn(4, 4)), _t(P, rng.randn(4, 4))
    with P.amp.auto_cast(level="O1"):
        y = P.matmul(x, w)
    y.astype("float32").sum().backward()
    return {"y_bf16": y.dtype == P.bfloat16,
            "gw_f32": w.grad.dtype == P.float32,
            "gw": _np(w.grad).astype(np.float32)}


CASES = [simple_chain, fan_out_accumulation, deep_graph,
         grad_accumulates_across_backwards, clear_grad, stop_gradient,
         detach, non_scalar_backward_with_grad, backward_non_scalar_raises,
         multi_output_op, retain_graph, no_grad_context, hooks, retain_grads,
         grad_basic, grad_intermediate, grad_unused,
         double_backward_via_retain, create_graph_returns_differentiable,
         third_order, double_backward_through_matmul,
         gradient_penalty_training_step, create_graph_through_pylayer,
         jacobian, jacobian_batch_axis, jacobian_two_inputs, hessian,
         grad_does_not_pollute_other_leaf_grads, hessian_batch_axis,
         hessian_quadratic_form, hessian_linear_is_zero,
         pylayer_custom_forward_backward, pylayer_nonstandard_grad,
         pylayer_two_outputs, pylayer_without_grad_inputs,
         autocast_matmul_bf16]


def _same(got, want, exact=False):
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k], want[k]
        if isinstance(w, (bool, np.bool_)) or w is None:
            assert g == w, k
        elif exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_autograd_matches_reference(case):
    _same(case(ptt), case(pt))


_MODES = ("whole_graph", "batched", "per_node")


@pytest.mark.parametrize("case", [deep_graph, fan_out_accumulation,
                                  double_backward_through_matmul,
                                  multi_output_op,
                                  pylayer_two_outputs],
                         ids=lambda c: c.__name__)
def test_gradients_equal_across_dispatch_modes(case):
    """tests/test_backward_dispatch.py's rule: gradients bit-equal in
    every mode, in each package; the two packages within TOL."""
    per_mode = {}
    for P in (ptt, pt):
        res = []
        for mode in _MODES:
            with P.autograd.backward_dispatch_mode(mode):
                assert P.autograd.dispatch_mode() == mode
                res.append(case(P))
        for r in res[1:]:
            _same(r, res[0], exact=True)
        per_mode[P.__name__] = res[0]
    _same(per_mode["paddle_tpu_torch"], per_mode["paddle_tpu"])


def test_set_dispatch_mode_rejects_unknown():
    for P in (ptt, pt):
        with pytest.raises(ValueError):
            P.autograd.set_dispatch_mode("fused")
        old = P.autograd.set_dispatch_mode("per_node")
        assert P.autograd.set_dispatch_mode(old) == "per_node"


def test_no_grad_decorator_and_torch_grad_mode():
    @ptt.no_grad()
    def f(x):
        return x * 2

    x = _t(ptt, [1.0])
    assert f(x).stop_gradient
    assert torch.is_grad_enabled()
    assert not (x * 2).stop_gradient


def test_run_backward_targets():
    """grad() touches no .grad; backward() with targets returns them."""
    from paddle_tpu_torch.autograd import run_backward
    x = _t(ptt, [2.0])
    y = x * x
    (gx,) = run_backward([y], grad_targets=[x], accumulate_leaf_grads=False,
                         retain_graph=True)
    assert x.grad is None and float(gx) == 4.0
    run_backward([y])
    assert float(x.grad) == 4.0
