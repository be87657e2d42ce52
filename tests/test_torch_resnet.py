"""paddle_tpu_torch.vision.models.resnet against
paddle_tpu.vision.models.resnet (BASELINE config 1's model), on the CPU.

Weights drawn by paddle_tpu and carried by ``resnet_params_from_numpy``
(parameters and the batch norms' ``_mean`` / ``_variance``); 10
classes; batch 2 x 64 x 64 images from a numpy seed, labels int32 as
bench.py passes them. At 64^2 layer4 is 2x2, so each of its batch
norms normalises a channel over 8 values (at 32^2 it would be 2, too
few for statistics that mean anything).

Here: resnet18 and a Bottleneck ResNet (BottleneckBlock at resnet18's
block counts) in NCHW, NHWC and NHWC with the space-to-depth stem, f32:
eval logits, the train-mode loss, every gradient and the running
statistics the forward wrote; the s2d stem equal to the plain one (the
reference's tests/test_s2d_stem.py); three TrainStep calls with
Momentum against the reference's TrainStep, every buffer unchanged in
both; one eager step (backward, Optimizer.step) moving the buffers
equally; the parameter counts of resnet50, resnext50_32x4d and
wide_resnet50_2. bf16 O1 is in tests/test_torch_resnet_o1.py.

Tolerances: loss and logits within 1e-5 relative (f32 sums in other
orders). Gradients: resnet18's within 1e-4 of each tensor's largest
element (measured <= 5.3e-5). The Bottleneck model's gradients are not
held whole: there, the two packages' f32 rounding, and a ReLU input
within it of 0 landing on either side, reach every gradient before
them amplified by each batch norm on the way (at init a batch-normed
network's gradient is that sensitive to its forward): the whole
gradients stand up to 0.023 of their norm apart, and no larger batch
cures it (0.0097-0.019 at batch 8 over the three layouts and two data
seeds, 0.017 at batch 16 in NHWC with the s2d stem; each flip's share
shrinks but the flips grow in number). So both models are also held
stage by stage (the stem, each residual block, the head), each stage
run on the reference's input to it and differentiated against the
reference's cotangent of its output, where a flip stays in its stage:
each stage's output within 1e-5 of its largest (measured <= 2.7e-6),
and each of its parameters' gradients and its input's within 1e-5 of
the reference's norm (measured <= 4.0e-6), in every stage but at most
one, whose tensors are held within 2e-2 (one case has such a stage:
the Bottleneck model in NHWC with the s2d stem, layer1.0, 1.1e-2,
where the reference's side of 0 is the wrong one: the port's stage
there is within 2e-6 of its own f64 run). Of 13 such cases in f32 (the
three layouts at batch 2 and 8 with two data seeds, and batch 16),
seven had a stage beyond 1e-5, in the reference or in the port by
turns, each case one stage, the farthest 1.2e-2.
tests/torch_resnet_parity_report.py prints these readings."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision.models import resnet as jres
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.vision.models import resnet as tres
from torch_port_helpers import RESNET_CLASSES as CLASSES
from torch_port_helpers import reference_stages, stage_distances
from torch_port_helpers import resnet_batch as batch
from torch_port_helpers import twin_resnets as twins
from torch_port_helpers import tbuffers, tnamed, tnamed_buffers, tparams, tstate

LOSS_TOL = dict(rtol=1e-5, atol=0)


def _buffers(m, port):
    if port:
        return {n: b.double().numpy() for n, b in tnamed_buffers(m)}
    return {n: np.asarray(b._data, np.float64) for n, b in m.named_buffers()}


@pytest.mark.parametrize("layout", ["nchw", "nhwc", "nhwc_s2d"])
@pytest.mark.parametrize("block", ["BasicBlock", "BottleneckBlock"])
def test_f32_logits_loss_gradients_and_statistics(block, layout):
    jm, tm = twins(block, layout)
    x, y = batch(layout)
    start = [b.clone() for b in tbuffers(tm)]
    jl, ref_stages, jg = reference_stages(jm, x, y)
    tl = TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl), jl, **LOSS_TOL)
    names = [n for n, _ in tnamed(tm)]
    assert names == [n for n, _ in jm.named_parameters()]
    if block == "BasicBlock":
        for n, p in tnamed(tm):
            got, want = p.grad.numpy(), jg[n]
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-4, (n, err)
    # the forward wrote the same running statistics into both
    jb, tb = _buffers(jm, False), _buffers(tm, True)
    assert sorted(jb) == sorted(tb) and len(tb) == 2 * (
        20 if block == "BasicBlock" else 29)
    for n in tb:
        np.testing.assert_allclose(tb[n], jb[n], rtol=1e-5, atol=1e-6)
    jm.eval()
    tm.eval()
    want = jm(pt.to_tensor(x)).numpy()
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    # stage by stage, from the statistics the reference's stages saw
    tm.train()
    with torch.no_grad():
        for b, b0 in zip(tbuffers(tm), start):
            b.copy_(b0)
    dist = stage_distances(tm, ref_stages, jg, y)
    assert sum(len(d[1]) for d in dist.values()) == len(names) + len(dist)
    for name, (err, _) in dist.items():
        assert err <= 1e-5, (name, err)
    apart = {name: max(d[1].values()) for name, d in dist.items()
             if max(d[1].values()) > 1e-5}
    assert len(apart) <= 1 and max(apart.values(), default=0) <= 2e-2, \
        apart


def test_s2d_stem_equals_the_plain_stem():
    """The reference's tests/test_s2d_stem.py on the port: the same
    weights through the 7x7/s2 stem and the space-to-depth stem, eval
    logits within its 5e-5, and the s2d stem's gradient reaching the
    standard [64, 3, 7, 7] conv1 weight."""
    plain = tres.ResNet(tres.BottleneckBlock, 50, num_classes=CLASSES,
                        data_format="NHWC", device="cpu")
    s2d = tres.ResNet(tres.BottleneckBlock, 50, num_classes=CLASSES,
                      data_format="NHWC", space_to_depth_stem=True,
                      device="cpu")
    s2d.load_state_dict(tstate(plain))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    a, b = plain._stem_conv(x), s2d._stem_conv(x)
    assert a.shape == b.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=5e-6)
    plain.eval()
    s2d.eval()
    np.testing.assert_allclose(plain(x).detach().numpy(),
                               s2d(x).detach().numpy(), atol=5e-5)
    s2d.train()
    (s2d(x) ** 2).mean().backward()
    g = s2d.conv1.weight.grad
    assert g is not None and tuple(g.shape) == (64, 3, 7, 7)
    assert float(g.abs().max()) > 0


def _momentum(params, port):
    cls = topt.Momentum if port else jopt.Momentum
    return cls(learning_rate=0.01, momentum=0.9, parameters=params,
               weight_decay=1e-4)


def test_train_step_momentum_matches_reference_and_keeps_buffers():
    """Three TrainStep calls with Momentum (bench_resnet50's optimizer at
    a small lr) against the reference's TrainStep, and the port's own
    TrainStep in f64: every batch-norm buffer in both packages as it was
    before the first call (the reference's compiled step returns no
    buffers; ROADMAP Queue C, known gaps).

    Run freely, the two packages' trajectories part after the first
    update, as the f32 gradients of the Bottleneck model do (a ReLU
    input near 0 taking either side; the third reference loss here is
    2.4554, the port's 2.4402 and the port's f64 run's 2.4402). So each
    step is held from the same state: before steps 2 and 3 the port's
    parameters and velocities are set to the reference's, and the step's
    loss is held within 1e-5 relative (measured <= 1.5e-6) and each
    tensor's update within 5e-3 of the reference's update's norm
    (measured <= 9.9e-4). A second port model runs freely against its
    f64 twin: losses within 1e-4 relative (measured 3e-6), each
    tensor's update over the three steps within 0.02 of its norm
    (measured <= 0.0061)."""
    jm, tm = twins("BasicBlock", "nhwc_s2d")
    _, free = twins("BasicBlock", "nhwc_s2d")
    _, t64 = twins("BasicBlock", "nhwc_s2d", dtype="float64")
    before = _buffers(tm, True)
    init = {n: p.detach().double().numpy().copy()
            for n, p in tnamed(tm)}

    def jloss(m, x, y):
        return JF.cross_entropy(m(x), y)

    def tloss(m, x, y):
        return TF.cross_entropy(m(x), y)

    jstep = JTrainStep(jm, _momentum(jm.parameters(), False), jloss)
    topt_ = _momentum(tparams(tm), True)
    tstep = ptt.TrainStep(tm, topt_, tloss)
    free_step = ptt.TrainStep(free, _momentum(tparams(free), True),
                              tloss)
    step64 = ptt.TrainStep(t64, _momentum(tparams(t64), True), tloss)
    assert jstep._pnames == [n for n, _ in tnamed(tm)]
    for seed in range(3):
        x, y = batch("nhwc_s2d", seed)
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
        for n, p, a, a0 in zip(jstep._pnames, tparams(tm),
                               jstep.params, start):
            ref = np.asarray(a, np.float64) - a0
            far = np.linalg.norm(p.detach().double().numpy() - a0 - ref) \
                / np.linalg.norm(ref)
            assert far <= 5e-3, (seed, n, far)
        np.testing.assert_allclose(
            float(free_step(x, y)),
            float(step64(torch.from_numpy(x).double(), y)), rtol=1e-4)
    jstep.sync()
    jb = _buffers(jm, False)
    for model in (tm, free):
        tb = _buffers(model, True)
        for n in before:
            np.testing.assert_array_equal(tb[n], before[n])
            np.testing.assert_array_equal(jb[n], before[n])
    # each tensor's update over the three steps, run freely
    exact = {k: v.detach().numpy() - init[k]
             for k, v in tnamed(t64)}
    far_exact = 0.0
    for n, p in tnamed(free):
        got = p.detach().double().numpy() - init[n]
        far_exact = max(far_exact, np.linalg.norm(got - exact[n])
                        / np.linalg.norm(exact[n]))
    assert far_exact <= 0.02, far_exact


def test_eager_step_moves_buffers_equally():
    """An eager step (forward, backward, Optimizer.step) keeps what the
    batch norms wrote, in both packages."""
    jm, tm = twins("BasicBlock", "nchw", seed=1)
    jo, to = _momentum(jm.parameters(), False), \
        _momentum(tparams(tm), True)
    x, y = batch("nchw", 4)
    JF.cross_entropy(jm(pt.to_tensor(x)), pt.to_tensor(y)).backward()
    jo.step()
    TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    to.step()
    jb, tb = _buffers(jm, False), _buffers(tm, True)
    assert np.abs(tb["bn1._mean"]).max() > 1e-3
    for n in tb:
        np.testing.assert_allclose(tb[n], jb[n], rtol=1e-5, atol=1e-6)
    want = {k: np.asarray(v._data) for k, v in jm.named_parameters()}
    for n, p in tnamed(tm):
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["resnet50", "resnext50_32x4d",
                                  "wide_resnet50_2"])
def test_parameter_names_shapes_and_counts(name):
    pt.seed(0)
    jm = getattr(jres, name)()
    tm = getattr(tres, name)(device="cpu")
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tstate(tm).items()}
    assert got == want
    count = sum(p.numel() for p in tparams(tm))
    assert count == sum(int(np.prod(p.shape))
                        for p in jm.parameters())
    assert count == {"resnet50": 25557032, "resnext50_32x4d": 25028904,
                     "wide_resnet50_2": 68883240}[name]


def test_rejections_follow_the_reference():
    with pytest.raises(NotImplementedError):
        tres.resnet18(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="NHWC"):
        tres.resnet50(space_to_depth_stem=True, device="cpu")
