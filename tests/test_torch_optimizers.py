"""paddle_tpu_torch's SGD, Momentum, Adamax, Adagrad, RMSProp, Lamb,
Adadelta and AdamW8bitStub against paddle_tpu's
(optimizer/optimizers.py:11-326), on the same numpy values, on the CPU:
five Optimizer.step calls with weight decay (coupled L2 through
``_apply_decay``, Lamb's own decay), the parameters and every
accumulator; ``multi_precision`` (bf16 parameters, f32 masters) where
the reference takes it; the state_dict carried from a reference run
into the port and the run continued; three TrainStep calls on a small
model against the reference's TrainStep.

Tolerance: the same f32 op sequence on both sides; XLA may contract
a*b+c into one FMA or rewrite x/sqrt(y), and Lamb's norms sum in other
orders: within 1e-5 relative, 1e-6 absolute (values of order 1 after
a few f32 roundings each step; AdamW measured 3.5e-7 apart). bf16
parameters: within one bf16 ulp of the reference's (the cast of f32
masters a few f32 ulps apart)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import optimizer_state_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
LR = 0.05

# name -> (class name, keywords)
OPTS = {
    "sgd": ("SGD", dict(weight_decay=0.01)),
    "momentum": ("Momentum", dict(momentum=0.9, weight_decay=1e-4)),
    "momentum_nesterov": ("Momentum", dict(momentum=0.8, use_nesterov=True,
                                           weight_decay=0.01)),
    "adamax": ("Adamax", dict(beta1=0.8, weight_decay=0.01)),
    "adagrad": ("Adagrad", dict(weight_decay=0.01,
                                initial_accumulator_value=0.1)),
    "rmsprop": ("RMSProp", dict(weight_decay=0.01)),
    "rmsprop_centered": ("RMSProp", dict(centered=True, momentum=0.5,
                                         rho=0.9, weight_decay=0.01)),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.02)),
    "adadelta": ("Adadelta", dict(rho=0.9, weight_decay=0.01)),
    "adamw8bit_stub": ("AdamW8bitStub", dict(weight_decay=0.05)),
}
# the reference's optimizer.optimizers has the stub; its package root
# does not export it
REF_CLASSES = {"AdamW8bitStub": jopt.optimizers.AdamW8bitStub}


def _classes(name):
    cls, kw = OPTS[name]
    return REF_CLASSES.get(cls, getattr(jopt, cls, None)) or \
        getattr(jopt.optimizers, cls), getattr(topt.optimizers, cls), kw


def _values(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    shapes = [(16, 8), (8,), (3, 5, 4)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    return ps, grads


def _step_both(jo, to, jp, tp, gs, cast=None):
    for p, g in zip(jp, gs):
        p._grad = pt.to_tensor(g if cast is None else g.astype(cast[0]))
    for p, g in zip(tp, gs):
        t = torch.from_numpy(g.copy())
        p.grad = t if cast is None else t.to(cast[1])
    jo.step()
    to.step()
    jo.clear_grad()
    to.clear_grad()


def _check_states(jo, to, jp, tp, tol=TOL):
    for a, b in zip(tp, jp):
        ta = to._accumulators.get(id(a), {})
        jb = jo._accumulators.get(id(b), {})
        assert sorted(ta) == sorted(jb) == sorted(to._state_names())
        for k in ta:
            np.testing.assert_allclose(ta[k].float().numpy(),
                                       np.asarray(jb[k], np.float32), **tol)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_five_steps_match_reference(name):
    jcls, tcls, kw = _classes(name)
    ps, grads = _values()
    jp = [pt.to_tensor(p, stop_gradient=False) for p in ps]
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in ps]
    jo = jcls(learning_rate=LR, parameters=jp, **kw)
    to = tcls(learning_rate=LR, parameters=tp, **kw)
    for gs in grads:
        _step_both(jo, to, jp, tp, gs)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._data),
                                   **TOL)
    _check_states(jo, to, jp, tp)
    # the parameters moved
    assert max(np.abs(a.detach().numpy() - p).max()
               for a, p in zip(tp, ps)) > 1e-3


@pytest.mark.parametrize("name", ["sgd", "momentum", "lamb"])
def test_multi_precision_matches_reference(name):
    """bf16 parameters with f32 masters: the rule runs on the master,
    its bf16 cast is written into the parameter."""
    import ml_dtypes
    jcls, tcls, kw = _classes(name)
    ps, grads = _values(1)
    bf = ml_dtypes.bfloat16
    jp = [pt.to_tensor(p.astype(bf), stop_gradient=False) for p in ps]
    tp = [torch.from_numpy(p.copy()).bfloat16().requires_grad_()
          for p in ps]
    jo = jcls(learning_rate=LR, parameters=jp, multi_precision=True, **kw)
    to = tcls(learning_rate=LR, parameters=tp, multi_precision=True, **kw)
    for gs in grads:
        _step_both(jo, to, jp, tp, gs, cast=(bf, torch.bfloat16))
    for a, b in zip(tp, jp):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b._data, np.float32),
                                   rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(to._master_weights[id(a)].numpy(),
                                   np.asarray(jo._master_weights[id(b)]),
                                   **TOL)
    _check_states(jo, to, jp, tp)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_state_dict_carried_from_the_reference(name):
    """Two reference steps, its state_dict carried into the port
    (optimizer_state_from_numpy, parameters by name), then three steps
    on both: the same parameters and accumulators."""
    jcls, tcls, kw = _classes(name)
    ps, grads = _values(2)
    jp = [pt.to_tensor(p, stop_gradient=False) for p in ps]
    jo = jcls(learning_rate=LR, parameters=jp, **kw)
    for gs in grads[:2]:
        for p, g in zip(jp, gs):
            p._grad = pt.to_tensor(g)
        jo.step()
        jo.clear_grad()
    tp = [torch.from_numpy(np.asarray(p._data).copy()).requires_grad_()
          for p in jp]
    to = tcls(learning_rate=LR, parameters=[(f"w{i}", t) for i, t in
                                            enumerate(tp)], **kw)
    state = {k: (v if k in ("LR_Scheduler", "global_step")
                 else np.asarray(v._data)) for k, v in
             jo.state_dict().items()}
    to.set_state_dict(optimizer_state_from_numpy(
        state, {p.name: f"w{i}" for i, p in enumerate(jp)}))
    assert to._step_count == jo._step_count == 2
    _check_states(jo, to, jp, tp, dict(rtol=0, atol=0))
    # a port round trip keeps every value
    again = tcls(learning_rate=LR, parameters=[(f"w{i}", t) for i, t in
                                               enumerate(tp)], **kw)
    again.set_state_dict(to.state_dict())
    for t in tp:
        for k, v in to._accumulators.get(id(t), {}).items():
            assert torch.equal(again._accumulators[id(t)][k], v)
    for gs in grads[2:]:
        _step_both(jo, to, jp, tp, gs)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._data),
                                   **TOL)
    _check_states(jo, to, jp, tp)


def _mlps(seed=0):
    """A Linear-ReLU-Linear classifier in both packages, the port's
    loaded from the reference's weights."""
    pt.seed(seed)
    jm = jnn.Sequential(jnn.Linear(12, 16), jnn.ReLU(), jnn.Linear(16, 5))
    tm = tnn.Sequential(tnn.Linear(12, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 5, device="cpu"))
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v._data).copy())
                        for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.mark.parametrize("name", sorted(OPTS))
def test_train_step_matches_reference_train_step(name):
    jcls, tcls, kw = _classes(name)
    jm, tm = _mlps()
    jstep = JTrainStep(jm, jcls(learning_rate=LR,
                                parameters=jm.parameters(), **kw),
                       lambda m, x, y: JF.cross_entropy(m(x), y))
    tstep = ptt.TrainStep(tm, tcls(learning_rate=LR,
                                   parameters=tm.parameters(), **kw),
                          lambda m, x, y: TF.cross_entropy(m(x), y))
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = rng.standard_normal((8, 12)).astype(np.float32)
        y = rng.integers(0, 5, (8,)).astype(np.int32)
        np.testing.assert_allclose(float(tstep(x, y)),
                                   float(jstep(x, y).numpy()), rtol=1e-5)
    jstep.sync()
    want = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5,
                                   atol=1e-6)
