"""MobileNetV2 (paddle_tpu_torch.vision.models.mobilenet_v2) trained
against paddle_tpu's on the CPU: scale 0.25, 10 classes, batch 2 x 64^2
(MobileNetV2 downsamples by 32, so its last stage is 2 x 2 and each
batch norm there normalises a channel over 8 values), the port's
weights in both (torch_port_helpers.twin_models), the classifier's
dropout set to 0 in both (the two packages draw other masks).

Held: the train-mode loss within 1e-5 relative; the running statistics
the forward wrote within 5e-5 (variances relative, means over their
channel's deviation: a mean behind a batch norm with bias 0 is 0 up to
rounding; measured <= 1.04e-5); stage by stage (the stem, each inverted
residual block, the last 1x1 convolution, the head), each stage run on
the reference's input to it and differentiated against the reference's
cotangent of its output (torch_port_helpers.stage_grads): each stage's
output within 1e-5 of its largest and each gradient within 1e-5 of the
stage's largest reference gradient norm (measured <= 9.1e-7; a
gradient that is 0 in exact arithmetic, as a batch-norm scale ahead of
another batch norm at init, is rounding in both packages, so it is
measured against the stage's scale), in every stage but at most one
(within 2e-2), where a ReLU6 input within f32 rounding of 0 or 6 would
land on the other side in the two packages (the reason ResNet is held
so, test_torch_resnet.py's docstring); and three TrainStep calls with
Momentum (bench_resnet50's optimizer at a small lr) against the
reference's TrainStep, each from the reference's state, the batch-norm
buffers unchanged in both."""
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as topt
from torch_port_helpers import (reference_stages, stage_grads, twin_models,
                                zero_filled_reference_init)
from torch_port_helpers import tbuffers, tnamed, tnamed_buffers, tparams

CLASSES, BATCH, HW = 10, 2, 64


def mobilenet_stages(m, flatten):
    """MobileNetV2's forward (either package's) cut into stages: the stem
    (conv, bn, ReLU6), each inverted residual block, the last 1x1 conv
    with its bn and ReLU6, and the head (pool, flatten, classifier)."""
    f = m.features
    n = len(f)
    out = [("stem", lambda v: f[2](f[1](f[0](v))))]
    out += [(f"features.{i}", f[i]) for i in range(3, n - 3)]
    out.append(("last", lambda v: f[n - 1](f[n - 2](f[n - 3](v)))))
    out.append(("head", lambda v: m.classifier(flatten(m.pool2d_avg(v), 1))))
    return out


def mobilenet_stage_of(name, n=23):
    head = name.split(".")
    if head[0] == "classifier":
        return "head"
    i = int(head[1])
    if i < 3:
        return "stem"
    if i >= n - 3:
        return "last"
    return f"features.{i}"


@pytest.fixture
def twins(monkeypatch):
    zero_filled_reference_init(monkeypatch)

    def make(seed=0):
        jm, tm = twin_models("mobilenet_v2", {"scale": 0.25}, seed=seed,
                             classes=CLASSES)
        jm.classifier[0].p = 0.0
        tm.classifier[0].p = 0.0
        jm.train()
        tm.train()
        return jm, tm
    return make


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, 3, HW, HW)).astype(np.float32),
            rng.integers(0, CLASSES, (BATCH,)).astype(np.int32))


def _buffers(m, port):
    if port:
        return {n: b.double().numpy() for n, b in tnamed_buffers(m)}
    return {n: np.asarray(b._data, np.float64) for n, b in m.named_buffers()}


def test_train_loss_statistics_and_stage_gradients(twins):
    jm, tm = twins()
    x, y = _batch()
    start = [b.clone() for b in tbuffers(tm)]
    jl, ref_stages, jg = reference_stages(jm, x, y,
                                          stages_of=mobilenet_stages)
    tl = TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    jb, tb = _buffers(jm, False), _buffers(tm, True)
    assert sorted(jb) == sorted(tb) and len(tb) == 2 * 52
    for n in tb:
        if n.endswith("_variance"):
            err = np.abs(tb[n] / jb[n] - 1).max()
        else:
            # a running mean's scale is its channel's deviation (a mean
            # behind a batch norm with bias 0 is 0 up to rounding)
            sd = np.sqrt(jb[n.replace("_mean", "_variance")].max())
            err = np.abs(tb[n] - jb[n]).max() / sd
        assert err <= 5e-5, (n, err)
    with torch.no_grad():
        for b, b0 in zip(tbuffers(tm), start):
            b.copy_(b0)
    names = [n for n, _ in tnamed(tm)]
    got = stage_grads(tm, ref_stages, y, stages_of=mobilenet_stages,
                      stage_of=mobilenet_stage_of)
    assert sum(len(g) for _, g in got.values()) == len(names) + len(got)
    far = {}
    for name, (out, grads) in got.items():
        want = ref_stages[name][1].astype(np.float64)
        assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max(), name
        refs = dict(jg, **{f"{name} input": ref_stages[name][3]})
        scale = max(np.linalg.norm(refs[n]) for n in grads)
        far[name] = max(np.linalg.norm(g - refs[n]) / scale
                        for n, g in grads.items())
    apart = {k: v for k, v in far.items() if v > 1e-5}
    assert len(apart) <= 1 and max(apart.values(), default=0) <= 2e-2, \
        apart


def _momentum(params, port):
    cls = topt.Momentum if port else jopt.Momentum
    return cls(learning_rate=0.01, momentum=0.9, parameters=params,
               weight_decay=1e-4)


def test_train_step_momentum_matches_reference(twins):
    """Each of three steps from the reference's state (parameters and
    velocities copied into the port before steps 2 and 3): the loss
    within 1e-5 relative; the whole update within 5e-3 of the
    reference's update's norm (measured <= 2.2e-4), and each tensor's
    within 2e-2 of its norm or of 1e-2 of the largest tensor update's
    norm, whichever is larger (measured <= 7.6e-3, the stem's batch-norm
    scale in step 3: the whole model's gradients amplify f32 rounding
    through its 52 batch norms, as ResNet's do; stage by stage they
    agree within 1e-6, the test above). The floor takes the biases of
    the batch norms ahead of another batch norm, whose gradient is 0 in
    exact arithmetic and whose updates are rounding in both packages
    (~1e-9). Every buffer as it was in both."""
    jm, tm = twins()
    before = _buffers(tm, True)

    def jloss(m, x, y):
        return JF.cross_entropy(m(x), y)

    def tloss(m, x, y):
        return TF.cross_entropy(m(x), y)

    jstep = JTrainStep(jm, _momentum(jm.parameters(), False), jloss)
    topt_ = _momentum(tparams(tm), True)
    tstep = ptt.TrainStep(tm, topt_, tloss)
    assert jstep._pnames == [n for n, _ in tnamed(tm)]
    for seed in range(3):
        x, y = _batch(seed)
        start = [np.asarray(a, np.float64) for a in jstep.params]
        if seed:
            with torch.no_grad():
                for p, a, st in zip(tparams(tm), jstep.params,
                                    jstep.opt_states):
                    p.copy_(torch.from_numpy(np.asarray(a)))
                    topt_._accumulators[id(p)]["velocity"].copy_(
                        torch.from_numpy(np.asarray(st["velocity"])))
        got, want = float(tstep(x, y)), float(jstep(x, y).numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5)
        refs = [np.asarray(a, np.float64) - a0
                for a, a0 in zip(jstep.params, start)]
        gots = [p.detach().double().numpy() - a0
                for p, a0 in zip(tparams(tm), start)]
        floor = 1e-2 * max(np.linalg.norm(r) for r in refs)
        for n, got, ref in zip(jstep._pnames, gots, refs):
            far = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), floor)
            assert far <= 2e-2, (seed, n, far)
        whole = np.linalg.norm(np.concatenate([(g - r).ravel() for g, r
                                               in zip(gots, refs)])) \
            / np.linalg.norm(np.concatenate([r.ravel() for r in refs]))
        assert whole <= 5e-3, (seed, whole)
    jstep.sync()
    jb, tb = _buffers(jm, False), _buffers(tm, True)
    for n in before:
        np.testing.assert_array_equal(tb[n], before[n])
        np.testing.assert_array_equal(jb[n], before[n])
