"""paddle_tpu_torch.quantization against paddle_tpu.quantization on the
CPU: the fake-quant op (a case of tests/eager_op_cases.py's
``OPSURF_CASES``) and its straight-through gradient, quantize /
dequantize equal, the abs-max observers' scales within 1e-6, QAT over a
model whose weights cross through numpy state_dicts (the quanters'
scales too): three SGD steps' losses and gradients within 1e-5, the
converted model's outputs equal, TrainStep leaving the observers where
the eager calls left them, and the walk into the port's torch-module
models."""
import numpy as np
import pytest
import torch

import eager_op_cases as C
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import quantization as JQ
from paddle_tpu_torch import quantization as TQ
from test_torch_ops import check_case
from torch_port_helpers import cpu_place

CASES = [c for c in C.CASES if c[0] in set(C.OPSURF_CASES)
         and c[0].startswith("fake_quantize")]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.mark.parametrize("name,fn,opts", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(name, fn, opts):
    check_case(name, fn, opts)


def test_straight_through_gradient():
    x = np.linspace(-2, 2, 11).astype(np.float32)
    for P, Q in ((ptt, TQ), (pt, JQ)):
        t = P.to_tensor(x, stop_gradient=False)
        s = P.to_tensor(np.float32(1.0), stop_gradient=False)
        Q._fake_quant_op(t, s).sum().backward()
        assert t.grad.numpy().tolist() == (np.abs(x) <= 1.0).astype(
            np.float32).tolist()
        assert float(s.grad.numpy()) == 0.0


@pytest.mark.parametrize("bits", [8, 4, 16])
def test_quantize_dequantize_equal(bits):
    w = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    scale = float(np.abs(w).max()) * 0.8
    got = TQ.quantize_linear(w, scale=scale, bit_length=bits)
    want = JQ.quantize_linear(w, scale=scale, bit_length=bits)
    assert got.numpy().dtype == want.numpy().dtype == (
        np.int8 if bits <= 8 else np.int32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(
        TQ.dequantize_linear(got, scale=scale, bit_length=bits).numpy(),
        JQ.dequantize_linear(want, scale=scale, bit_length=bits).numpy(),
        rtol=1e-6)


def test_observer_moving_average_and_eval_mode():
    rng = np.random.default_rng(1)
    tq = TQ.FakeQuanterWithAbsMaxObserverLayer(moving_rate=0.8)
    jq = JQ.FakeQuanterWithAbsMaxObserverLayer(moving_rate=0.8)
    for i in range(4):
        x = (rng.standard_normal(32) * (i + 1)).astype(np.float32)
        got = tq(ptt.to_tensor(x)).numpy()
        want = jq(pt.to_tensor(x)).numpy()
        np.testing.assert_allclose(tq.scale.numpy(), jq.scale.numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    tq.eval()
    before = tq.scale.numpy().copy()
    tq(ptt.to_tensor(x * 10))
    np.testing.assert_array_equal(tq.scale.numpy(), before)
    assert tq.scales() is tq.scale and tq.bit_length() == 8


def _model(P):
    return P.nn.Sequential(P.nn.Linear(6, 8), P.nn.ReLU(),
                           P.nn.Linear(8, 3))


def _qat(P, Q, weights):
    m = _model(P)
    m.set_state_dict(weights)
    q = Q.FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
    qat = Q.QAT(Q.QuantConfig(activation=q, weight=q))
    return qat, qat.quantize(m)


def test_qat_steps_scales_and_convert_match_reference():
    rng = np.random.default_rng(2)
    weights = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
               for k, v in _model(ptt).state_dict().items()}
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = rng.standard_normal((16, 3)).astype(np.float32)
    runs = {}
    for P, Q in ((ptt, TQ), (pt, JQ)):
        qat, qm = _qat(P, Q, weights)
        qm.train()
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=qm.parameters())
        losses = []
        for _ in range(3):
            loss = ((qm(P.to_tensor(x)) - P.to_tensor(y)) ** 2).mean()
            loss.backward()
            grads = [p.grad.numpy().copy() for p in qm.parameters()
                     if p.grad is not None]
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        state = {k: v.numpy() for k, v in qm.state_dict().items()}
        conv = qat.convert(qm)
        runs[P.__name__] = (losses, grads, state, conv,
                            conv(P.to_tensor(x)).numpy())
    (tl, tg, ts, tconv, tout), (jl, jg, js, _, jout) = \
        runs["paddle_tpu_torch"], runs["paddle_tpu"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # the quanters' scales cross by name with the weights
    assert sorted(ts) == sorted(js)
    assert any(k.endswith("weight_quanter.scale") for k in ts)
    for k in ts:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    assert not any(isinstance(m, TQ.QuantedLayer)
                   for m in tconv.sublayers())
    for lin in (tconv[0], tconv[2]):
        assert len(np.unique(lin.weight.numpy())) <= 255


def test_state_dict_with_scales_crosses_from_the_reference():
    rng = np.random.default_rng(3)
    weights = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in _model(ptt).state_dict().items()}
    _, jm = _qat(pt, JQ, weights)
    jm.train()
    jm(pt.to_tensor(rng.standard_normal((4, 6)).astype(np.float32)))
    _, tm = _qat(ptt, TQ, weights)
    missing, unexpected = tm.set_state_dict(
        {k: v.numpy() for k, v in jm.state_dict().items()})
    assert missing == [] and unexpected == []
    tm.eval()
    jm.eval()
    x = rng.standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_allclose(tm(ptt.to_tensor(x)).numpy(),
                               jm(pt.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_ptq_calibrates():
    weights = {k: np.ones(v.shape, np.float32) * 0.1
               for k, v in _model(ptt).state_dict().items()}
    m = _model(ptt)
    m.set_state_dict(weights)
    ptq = TQ.PTQ(TQ.QuantConfig(
        activation=TQ.FakeQuanterWithAbsMaxObserver(), weight=None))
    m = ptq.quantize(m)
    x = ptt.to_tensor(np.full((2, 6), 3.0, np.float32))
    for _ in range(3):
        m(x)
    assert float(m[0].activation_quanter.scale.numpy()[0]) == 3.0


def test_train_step_leaves_the_observers_where_eager_calls_left_them():
    """The reference's observers update only eagerly, never under its
    traced TrainStep; the port's never inside TrainStep's step either
    (on the CPU every step runs the step body eagerly)."""
    rng = np.random.default_rng(4)
    weights = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in _model(ptt).state_dict().items()}
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)
    for P, Q in ((ptt, TQ), (pt, JQ)):
        _, qm = _qat(P, Q, weights)
        qm.train()
        qm(P.to_tensor(x))
        scales = [q.scale.numpy().copy() for q in qm.sublayers()
                  if isinstance(q, Q.FakeQuanterWithAbsMaxObserverLayer)]
        step = P.jit.TrainStep(
            qm, P.optimizer.SGD(learning_rate=0.1,
                                parameters=qm.parameters()),
            lambda m, a, b: ((m(a) - b) ** 2).mean())
        for _ in range(2):
            step(x * 5, y)
        step.sync()
        after = [q.scale.numpy() for q in qm.sublayers()
                 if isinstance(q, Q.FakeQuanterWithAbsMaxObserverLayer)]
        for a, b in zip(scales, after):
            np.testing.assert_array_equal(a, b)


def test_fake_tensors_and_jit_save_do_not_update(tmp_path):
    from paddle_tpu_torch.quantization import _observing
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = torch.ones(3)
    assert not _observing(fake) and _observing(torch.ones(3))
    q = TQ.FakeQuanterWithAbsMaxObserverLayer()
    q.train()
    q(torch.ones(4))
    before = q.scale.numpy().copy()
    ptt.jit.save(q, str(tmp_path / "q"),
                 input_spec=[ptt.jit.InputSpec([4], "float32")])
    np.testing.assert_array_equal(q.scale.numpy(), before)


def test_walk_reaches_the_layers_of_torch_module_models():
    """MobileNetV2 is a torch nn.Module whose children are Layers: QAT
    wraps every Conv2D and Linear in it, forward and backward run, and a
    conv's weight gets its gradient through the straight-through
    estimator."""
    from paddle_tpu_torch.nn.layers import Conv2D, Linear
    from paddle_tpu_torch.vision.models import mobilenet_v2
    ptt.seed(0)
    m = mobilenet_v2(scale=0.25, num_classes=10, device="cpu")
    n = sum(isinstance(s, (Conv2D, Linear)) for s in m.modules())
    q = TQ.FakeQuanterWithAbsMaxObserver()
    qm = TQ.QAT(TQ.QuantConfig(activation=q, weight=q)).quantize(m)
    wrapped = [s for s in qm.modules() if isinstance(s, TQ.QuantedLayer)]
    assert len(wrapped) == n > 50
    qm.train()
    out = qm(torch.randn(2, 3, 32, 32))
    out.sum().backward()
    w = wrapped[0]._inner._parameters["weight"]
    assert w.grad is not None and w.grad.abs().sum() > 0


def test_quanters_follow_the_layer_they_quantize():
    """A quanter's scale is made beside its layer's parameters (a CPU
    model quantized while the default place is elsewhere stays whole);
    without a layer it goes to `device` or the default place."""
    from paddle_tpu_torch.core import device as tdevice
    lin = ptt.nn.Linear(4, 4, device="cpu")
    q = TQ.FakeQuanterWithAbsMaxObserver().instance(lin)
    assert q.scale.place.is_cpu_place()
    saved = tdevice._current_place
    tdevice._current_place = ptt.CUDAPlace(0)   # a card default, unused
    try:
        qm = TQ.QAT(TQ.QuantConfig(
            activation=TQ.FakeQuanterWithAbsMaxObserver(),
            weight=TQ.FakeQuanterWithAbsMaxObserver())).quantize(
            ptt.nn.Sequential(lin))
        assert {p.device.type for p in torch.nn.Module.parameters(qm)} \
            == {"cpu"}
    finally:
        tdevice._current_place = saved
    assert TQ.FakeQuanterWithAbsMaxObserverLayer(device="cpu").scale \
        .place.is_cpu_place()
