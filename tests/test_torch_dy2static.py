"""paddle_tpu_torch.jit's to_static, its dy2static conversion and the
graph-break fallback against paddle_tpu's.

Mirrors tests/test_dy2static.py, tests/test_graph_break.py, the
to_static cases of tests/test_summary_sourceless.py and
tests/test_engine.py::TestToStaticLimitationDetection: each function is
written once against the package ``P`` and run through both packages on
the same numpy inputs (a layer's weights carried from the reference by
``set_state_dict``). Values and gradients agree within ``TOL`` (f32:
the same elementwise ops in both; measured 0 to 9.5e-7, the largest a
gradient through sin), a layer's
within ``LIN_TOL`` (its Linear's product sums in another order in XLA
and in torch: measured 1.7e-6), and the
reference's errors are raised with its texts. On the port a traced
``if`` / ``while`` becomes torch's ``cond`` / ``while_loop`` (the probe's
graph holds them), and calls run eagerly."""
import functools
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place

PKGS = [pytest.param(pt, id="ref"), pytest.param(ptt, id="port")]
TOL = dict(rtol=1e-6, atol=1e-6)
LIN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def t(P, x):
    return P.to_tensor(np.asarray(x, np.float32))


def _np(x):
    return np.asarray(x.numpy(), np.float32)


def _both(make, *inputs, full_graph=True):
    """make(P) -> function; its to_static on each package, called on
    each of `inputs` (tuples of arrays): ([ref outputs], [port outputs])."""
    outs = []
    for P in (pt, ptt):
        sf = P.jit.to_static(make(P), full_graph=full_graph)
        outs.append([_np(sf(*[t(P, a) for a in args])) for args in inputs])
    return outs


def _assert_same(make, *inputs, full_graph=True):
    want, got = _both(make, *inputs, full_graph=full_graph)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)
    return got


def _ops_of(graph_module):
    """Every call target of a traced graph and of its subgraphs."""
    out = set()
    for m in graph_module.modules():
        if isinstance(m, torch.fx.GraphModule):
            out |= {str(n.target) for n in m.graph.nodes
                    if n.op == "call_function"}
    return out


# ---------------------------------------------------------------------------
# if conversion (test_dy2static.py::TestIfConversion)
# ---------------------------------------------------------------------------
def _if_fn(P):
    def f(x):
        if P.ops.sum(x) > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y + 1.0
    return f


def test_tensor_if_stages_and_matches_eager():
    got = _assert_same(_if_fn, ([1.0, 2.0],), ([-5.0, 1.0],))
    np.testing.assert_allclose(got[0], [3.0, 5.0])
    sf = ptt.jit.to_static(_if_fn(ptt))
    sf(t(ptt, [1.0, 2.0]))
    (program,) = sf.concrete_programs
    assert "cond" in _ops_of(program)


def test_elif_chain():
    def make(P):
        def f(x):
            s = P.ops.sum(x)
            if s > 10.0:
                r = x * 3.0
            elif s > 0.0:
                r = x * 2.0
            else:
                r = x * 0.0
            return r
        return f
    _assert_same(make, ([20.0],), ([1.0],), ([-3.0],))


def test_nested_if():
    def make(P):
        def f(x):
            if P.ops.sum(x) > 0:
                if P.ops.max(x) > 5.0:
                    y = x * 10.0
                else:
                    y = x * 2.0
            else:
                y = -x
            return y
        return f
    _assert_same(make, ([6.0],), ([1.0],), ([-1.0],))


def test_python_bool_branch_untouched():
    def make(P):
        def f(x, flag=True):
            if flag:             # plain python predicate stays python
                y = x + 1.0
            else:
                y = x - 1.0
            return y
        return f
    got = _assert_same(make, ([1.0],))
    np.testing.assert_allclose(got[0], [2.0])


@pytest.mark.parametrize("data", [[1.0, 2.0], [-1.0, -2.0]])
def test_grad_flows_through_staged_branch(data):
    grads = []
    for P in (pt, ptt):
        def f(x):
            if P.ops.sum(x) > 0:
                y = x * 3.0
            else:
                y = x * 5.0
            return P.ops.sum(y)
        x = t(P, data)
        x.stop_gradient = False
        P.jit.to_static(f)(x).backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)
    np.testing.assert_allclose(grads[1], [3.0 if data[0] > 0 else 5.0] * 2)


@pytest.mark.parametrize("P", PKGS)
def test_one_sided_assignment_raises_clearly(P):
    def g(x):
        if P.ops.sum(x) > 0:
            y = x * 2.0
        else:
            pass
        return y  # noqa: F821

    with pytest.raises(RuntimeError, match="Initialize"):
        P.jit.to_static(g)(t(P, [1.0]))


# ---------------------------------------------------------------------------
# while conversion (TestWhileConversion)
# ---------------------------------------------------------------------------
def test_tensor_while_stages():
    def make(P):
        def f(x):
            total = P.ops.zeros_like(x)
            while P.ops.sum(total) < 10.0:
                total = total + x
            return total
        return f
    got = _assert_same(make, ([3.0],))
    np.testing.assert_allclose(got[0], [12.0])  # 4 iterations of +3
    sf = ptt.jit.to_static(make(ptt))
    sf(t(ptt, [3.0]))
    assert "while_loop" in _ops_of(sf.concrete_programs[0])


def test_while_matches_eager_loop():
    def make(P):
        def f(x, n):
            i = t(P, 0.0)
            acc = x
            while i < n:
                acc = acc * 2.0
                i = i + 1.0
            return acc
        return f
    got = _assert_same(make, ([1.5], 3.0))
    np.testing.assert_allclose(got[0], [12.0])


def test_while_grad():
    grads = []
    for P in (pt, ptt):
        def f(x):
            i = t(P, 0.0)
            y = x
            while i < 3.0:
                y = y * 2.0
                i = i + 1.0
            return P.ops.sum(y)
        x = t(P, [1.0])
        x.stop_gradient = False
        P.jit.to_static(f)(x).backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)
    np.testing.assert_allclose(grads[1], [8.0])


# ---------------------------------------------------------------------------
# fallbacks and bail-outs (TestFallbacks, TestConversionBailouts)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", PKGS)
def test_return_in_branch_falls_back_with_clear_error(P):
    def f(x):
        if P.ops.sum(x) > 0:
            return x * 2.0
        return x - 1.0

    with pytest.raises(RuntimeError, match="data-dependent"):
        P.jit.to_static(f)(t(P, [1.0]))


@pytest.mark.parametrize("P", PKGS)
def test_no_source_falls_back_silently(P):
    ns = {}
    exec("def f(x):\n    return x + 1.0\n", ns)
    assert P.jit.dy2static.ast_transform(ns["f"]) is None


def test_eager_concrete_tensor_predicate():
    outs = []
    for P in (pt, ptt):
        def f(x):
            if P.ops.sum(x) > 0:
                return_val = x * 2.0
            else:
                return_val = -x
            return return_val
        conv = P.jit.dy2static.ast_transform(f)
        assert conv is not None
        outs.append([_np(conv(t(P, [2.0]))), _np(conv(t(P, [-2.0])))])
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], [[4.0], [2.0]])


def test_import_inside_branch_survives():
    def make(P):
        def f(x):
            if P.ops.sum(x) > 0:
                import math
                y = x * math.e
            else:
                import math
                y = x * math.pi
            return y
        return f
    got = _assert_same(make, ([1.0],), ([-1.0],))
    np.testing.assert_allclose(got, [[np.e], [-np.pi]], rtol=1e-6)


@pytest.mark.parametrize("P", PKGS)
def test_functools_wrapped_bails_out(P):
    def deco(g):
        @functools.wraps(g)
        def inner(*a, **k):
            return g(*a, **k) + 100.0
        return inner

    @deco
    def f(x):
        if P.ops.sum(x) > 0:
            y = x
        else:
            y = -x
        return P.ops.sum(y)

    assert P.jit.dy2static.ast_transform(f) is None


@pytest.mark.parametrize("P", PKGS)
def test_zero_arg_super_bails_out(P):
    class Base(P.nn.Layer):
        def forward(self, x):
            return x + 1.0

    class Child(Base):
        def forward(self, x):
            h = super().forward(x)
            if P.ops.sum(h) > 1e9:
                h = h * 0.0
            else:
                h = h * 1.0
            return h

    c = Child()
    assert P.jit.dy2static.ast_transform(c.forward) is None
    np.testing.assert_allclose(_np(c(t(P, [1.0]))), [2.0])


# ---------------------------------------------------------------------------
# layers (TestLayerIntegration)
# ---------------------------------------------------------------------------
def _gate(P):
    class Gate(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = P.nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            if P.ops.mean(h) > 0:
                out = h * 2.0
            else:
                out = h * 0.5
            return out
    return Gate()


def _twin_gates(seed=0):
    pt.seed(seed)
    ref = _gate(pt)
    port = _gate(ptt)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_layer_forward_with_control_flow(sign):
    ref, port = _twin_gates()
    x = np.ones((2, 4), np.float32) * sign
    outs = [_np(P.jit.to_static(m)(t(P, x))) for P, m in ((pt, ref),
                                                            (ptt, port))]
    np.testing.assert_allclose(outs[1], outs[0], **LIN_TOL)
    h = port.lin(t(ptt, x))
    factor = 2.0 if float(ptt.ops.mean(h).numpy()) > 0 else 0.5
    np.testing.assert_allclose(outs[1], _np(h) * factor, rtol=1e-6)


def test_saved_layer_keeps_both_branches(tmp_path):
    """jit.save of a to_static layer with a tensor `if` exports torch's
    cond: the loaded program takes the branch of each input, as the
    layer does eagerly."""
    _, port = _twin_gates()
    m = ptt.jit.to_static(port)
    path = str(tmp_path / "gate")
    ptt.jit.save(m, path, input_spec=[ptt.jit.InputSpec([None, 4])])
    loaded = ptt.jit.load(path)
    for x in (np.ones((2, 4)), -5 * np.ones((3, 4))):
        np.testing.assert_array_equal(_np(loaded(t(ptt, x))),
                                      _np(m(t(ptt, x))))


# ---------------------------------------------------------------------------
# full_graph=True limitation detection (test_engine.py,
# test_summary_sourceless.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", PKGS)
def test_data_dependent_branch_reports_and_refires(P):
    @P.jit.to_static
    def f(x):
        if x.sum() > 0:   # data-dependent python branch
            return x * 2
        return x - 1

    for _ in range(2):  # the second call must detect it again
        with pytest.raises(RuntimeError,
                           match="data-dependent Python control flow"):
            f(t(P, np.ones(4)))


def test_value_branch_free_code_stages_fine():
    def make(P):
        def g(x):
            return P.ops.where(x > 0, x * 2, x - 1)
        return g
    got = _assert_same(make, ([-1.0, 2.0],))
    np.testing.assert_allclose(got[0], [-2.0, 4.0])


def test_full_graph_false_keeps_eager_branching():
    def make(P):
        def f(x):
            if float(x.sum()) > 0:
                return x * 2
            return x - 1
        return f
    got = _assert_same(make, ([1.0, 1.0],), full_graph=False)
    np.testing.assert_allclose(got[0], [2.0, 2.0])


@pytest.mark.parametrize("P", PKGS)
def test_sourceless_straightline_stages(P):
    ns = {}
    exec("def f(x):\n    return x * 2 + 1\n", {"__builtins__": {}}, ns)
    with pytest.warns(UserWarning, match="unretrievable"):
        sf = P.jit.to_static(ns["f"])
    np.testing.assert_allclose(_np(sf(t(P, [1.0, 2.0]))), [3.0, 5.0])


@pytest.mark.parametrize("P", PKGS)
def test_sourceless_control_flow_reports_clearly(P):
    ns = {}
    exec("def g(x):\n"
         "    if (x.sum() > 0):\n"
         "        return x\n"
         "    return -x\n", {"__builtins__": __builtins__}, ns)
    with pytest.warns(UserWarning, match="unretrievable"):
        sf = P.jit.to_static(ns["g"])
    with pytest.raises(RuntimeError, match="source is unretrievable"):
        sf(t(P, [1.0]))


@pytest.mark.parametrize("P", PKGS)
def test_sourced_function_does_not_warn(P):
    def h(x):
        return x + 1

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sf = P.jit.to_static(h)
    np.testing.assert_allclose(_np(sf(t(P, [1.0]))), [2.0])


# ---------------------------------------------------------------------------
# graph breaks (test_graph_break.py)
# ---------------------------------------------------------------------------
def _return_in_branch(P):
    @P.jit.to_static(full_graph=False)
    def fn_return_in_branch(x):
        y = P.ops.sin(x) * 2.0          # region 0 (staged)
        z = y + 1.0
        if float(z.sum().numpy()) > 0:  # eager break (return-in-branch)
            return z * 10.0
        w = P.ops.tanh(z)               # region 1 (staged)
        w = w - 3.0
        return w
    return fn_return_in_branch


def _tensor_predicate(P):
    @P.jit.to_static(full_graph=False)
    def fn_tensor_predicate(x):
        s = (x * x).sum()             # region 0
        if s > 3.0:                   # eager tensor-bool per call
            out = s * 2.0
        else:
            out = s - 1.0
        return out
    return fn_tensor_predicate


def test_return_in_branch_runs_correctly_and_counts_regions():
    fns = {P: _return_in_branch(P) for P in (pt, ptt)}
    for P, fn in fns.items():
        assert isinstance(fn, P.jit.GraphBreakFunction)
        # two simple-statement runs around the eager `if`
        assert fn.region_count == 2
    for data in (np.ones(4), -2 * np.ones(4)):
        want, got = (_np(fns[P](t(P, data))) for P in (pt, ptt))
        np.testing.assert_allclose(got, want, **TOL)
    for P, fn in fns.items():
        r0, r1 = fn.regions
        assert r0.staged_calls > 0 and r1.staged_calls > 0, P.__name__
    z = np.sin(np.ones(4)) * 2 + 1
    np.testing.assert_allclose(_np(fns[ptt](t(ptt, np.ones(4)))), z * 10,
                               atol=1e-5)


def test_tensor_predicate_branches_per_call():
    for data, want in ((np.ones(2), 1.0), (np.ones(8), 16.0)):
        got = [float(_tensor_predicate(P)(t(P, data)).numpy())
               for P in (pt, ptt)]
        np.testing.assert_allclose(got, [want, want], atol=1e-5)
    assert _tensor_predicate(ptt).region_count >= 1


def test_gradients_flow_through_staged_regions():
    grads = []
    for P in (pt, ptt):
        x = P.to_tensor(np.ones((4,), np.float32), stop_gradient=False)
        _return_in_branch(P)(x).sum().backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)
    np.testing.assert_allclose(grads[1], 10 * 2 * np.cos(np.ones(4)),
                               atol=1e-4)


def _two_region_layer(P):
    class M(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = P.nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)          # region (self.lin params train)
            h = h * 2.0
            if float(h.sum().numpy()) > 1e9:  # eager break
                return h
            out = P.ops.tanh(h)        # region
            return out
    return M()


def test_layer_params_train_through_regions():
    pt.seed(0)
    ref = _two_region_layer(pt)
    port = _two_region_layer(ptt)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    grads = []
    for P, m in ((pt, ref), (ptt, port)):
        sf = P.jit.to_static(m.forward, full_graph=False)
        assert sf.region_count == 2
        (sf(t(P, x)) ** 2).sum().backward()
        grads.append(_np(m.lin.weight.grad))
    np.testing.assert_allclose(grads[1], grads[0], **LIN_TOL)


def test_break_inside_helper_degrades_to_eager():
    outs = []
    for P in (pt, ptt):
        def helper(z):
            # data-dependent python branch INSIDE a call — not stageable
            if float(z.sum().numpy()) > 0:
                return z * 2.0
            return z * 3.0

        def f(x):
            y = x + 1.0
            w = helper(y)       # breaks the region's trace probe
            return w

        sf = P.jit.to_static(f, full_graph=False)
        outs.append(_np(sf(t(P, np.ones(3)))))
        assert all(r.staged_calls == 0 for r in sf.regions) or \
            any(r.eager_calls > 0 for r in sf.regions)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], 4.0 * np.ones(3), atol=1e-6)


def test_loops_execute_eagerly():
    outs = []
    for P in (pt, ptt):
        @P.jit.to_static(full_graph=False)
        def f(x, n):
            acc = x * 0.0                 # region
            for _ in range(n):            # eager python loop
                acc = acc + x
            out = acc * 2.0               # region
            return out

        outs.append(_np(f(t(P, np.ones(3)), 3)))
        assert f.region_count == 2
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], 6 * np.ones(3), atol=1e-6)


def test_not_to_static_and_ignore_module():
    for P in (pt, ptt):
        def f(x):
            return x
        assert P.jit.not_to_static(f) is f and f._not_to_static
        assert P.jit.ignore_module([np]) is None
