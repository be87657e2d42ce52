"""paddle_tpu_torch.static against paddle_tpu.static: the control-flow
sugar on concrete predicates (the same values on both sides), traced
through make_fx (torch's cond / while_loop, which the reference's
jax.lax forms correspond to: the traced program gives the eager answer
for every input), the Executor running a callable, gradients, the
parity objects and the static-mode switches. save_inference_model /
load_inference_model raise in the reference; the port's go through
jit.save / jit.load and round-trip a layer."""
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import static as jstatic
from paddle_tpu_torch import static as tstatic
from torch_port_helpers import cpu_place

SIDES = {"ref": (pt, jstatic), "port": (ptt, tstatic)}


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield
    ptt.disable_static()


def _np(x):
    return np.asarray(x.numpy())


def _flow(P, S, v):
    """Each form of control flow on the scalar v."""
    x = P.to_tensor(np.array(v, np.float32))
    c = S.nn.cond(x > 2, lambda: x * 2, lambda: x - 1)
    pair = S.nn.cond(x > 2, lambda: (x, x + 1), lambda: (x - 1, x))
    i, s = S.nn.while_loop(lambda i, s: i < x, lambda i, s: (i + 1, s + i),
                           [P.to_tensor(np.array(0.0, np.float32)),
                            P.to_tensor(np.array(0.0, np.float32))])
    k = S.nn.case([(x < 0, lambda: x * 0), (x < 5, lambda: x + 1)],
                  default=lambda: x - 1)
    sw = S.nn.switch_case(P.to_tensor(np.array(int(v) % 3, np.int64)),
                          {0: lambda: x + 100, 1: lambda: x * 10},
                          default=lambda: x - 7)
    return [_np(t) for t in (c, *pair, i, s, k, sw)]


@pytest.mark.parametrize("v", [-2.0, 1.0, 3.0, 7.0])
def test_control_flow_equals_the_reference(v):
    got, want = (_flow(P, S, v) for P, S in (SIDES["port"], SIDES["ref"]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_case_and_switch_case_without_a_match():
    x = ptt.to_tensor(np.array(9.0, np.float32))
    with pytest.raises(ValueError, match="no predicate matched"):
        tstatic.nn.case([(x < 0, lambda: x)])
    with pytest.raises(ValueError, match="no branch for index 5"):
        tstatic.nn.switch_case(ptt.to_tensor(np.array(5)), {0: lambda: x})
    assert tstatic.nn.cond(x < 0, lambda: x) is None


def test_traced_control_flow_stages_into_torch_ops():
    """Under make_fx (a fake-tensor trace) each form stages into torch's
    cond / while_loop, so the traced program answers every input as the
    eager form does."""
    def flow(a):
        t = ptt.Tensor._wrap(a)
        c = tstatic.nn.cond(t > 2, lambda: t * 2, lambda: t - 1)
        _i, s = tstatic.nn.while_loop(lambda i, s: i < t,
                                      lambda i, s: (i + 1, s + i),
                                      [t * 0, t * 0])
        k = tstatic.nn.case([(t < 0, lambda: t * 0), (t < 5, lambda: t + 1)],
                            default=lambda: t - 1)
        sw = tstatic.nn.switch_case(t.astype("int64"),
                                    {0: lambda: t + 100, 1: lambda: t * 10,
                                     3: lambda: t - 7})
        return [r._data for r in (c, s, k, sw)]

    g = make_fx(flow, tracing_mode="fake")(torch.zeros(()))
    ops = {str(n.target) for n in g.graph.nodes if n.op == "call_function"}
    assert any("cond" in o for o in ops) and any("while_loop" in o
                                                 for o in ops)
    for v in (-2.0, 0.0, 1.0, 2.0, 3.0, 6.0):
        got = [float(r) for r in g(torch.tensor(v))]
        want = [float(r._data) for r in (
            tstatic.nn.cond(ptt.to_tensor(v) > 2, lambda: ptt.to_tensor(v) * 2,
                            lambda: ptt.to_tensor(v) - 1),)]
        assert got[0] == want[0]
        n = max(int(np.ceil(v)), 0)
        assert got[1] == sum(range(n))
        assert got[2] == (0.0 if v < 0 else v + 1 if v < 5 else v - 1)
        idx = int(v)
        assert got[3] == {0: v + 100, 1: v * 10}.get(idx, v - 7)


def test_executor_runs_a_callable_on_both():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    out = {}
    for name, (P, S) in SIDES.items():
        main, startup = S.Program(), S.Program()
        with S.program_guard(main, startup):
            spec = S.data("x", [None, 4], "float32")
        assert spec.name == "x" and list(spec.shape) == [None, 4]
        assert S.default_main_program() is S.default_main_program()
        assert main.global_block() is main and main.clone() is not main

        def prog(x, P=P):
            return P.tanh(x) * 2, x.sum()
        res = S.Executor().run(prog, feed={"x": P.to_tensor(a)})
        out[name] = [_np(r) for r in res]
        with pytest.raises(NotImplementedError):
            S.Executor().run(main)
    for x, y in zip(out["port"], out["ref"]):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_gradients_equal_the_reference():
    a = np.array([1.0, -2.0, 3.0], np.float32)
    out = {}
    for name, (P, S) in SIDES.items():
        x = P.to_tensor(a, stop_gradient=False)
        y = (x * x * x).sum()
        (g,) = S.gradients([y], [x])
        out[name] = _np(g)
    np.testing.assert_allclose(out["port"], out["ref"], rtol=1e-6)


def test_static_mode_switches():
    for P, _S in (SIDES["ref"], SIDES["port"]):
        assert P.in_dynamic_mode()
    ptt.enable_static()
    assert not ptt.in_dynamic_mode()
    ptt.disable_static()
    assert ptt.in_dynamic_mode()
    with tstatic.name_scope("block"):
        pass


def test_inference_model_round_trip(tmp_path):
    """The reference raises; the port exports the layer through jit.save
    and runs the loaded program through the Executor by feed name."""
    with pytest.raises(NotImplementedError):
        jstatic.save_inference_model(str(tmp_path / "j"), [], [])
    rng = np.random.default_rng(1)
    lin = ptt.nn.Linear(4, 3)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    want = lin(ptt.to_tensor(x)).numpy()
    prefix = str(tmp_path / "m")
    tstatic.save_inference_model(
        prefix, [tstatic.data("x", [None, 4], "float32")], None,
        program=lin)
    program, feeds, fetches = tstatic.load_inference_model(prefix)
    assert feeds == ["x"] and fetches == []
    (got,) = tstatic.Executor().run(program, feed={"x": x})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(KeyError):
        program(y=x)
    with pytest.raises(ValueError, match="program="):
        tstatic.save_inference_model(prefix, [], None)
