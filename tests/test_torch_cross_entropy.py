"""paddle_tpu_torch's cross_entropy and CrossEntropyLoss against
paddle_tpu's (ops/nn_ops.py:657-724, nn/layers/loss.py), branch for
branch: hard labels with and without softmax, soft labels with and
without softmax, class weights, label smoothing on each branch,
ignore_index, every reduction, the class axis last and in the middle,
labels with and without their unit axis, int32 labels; the loss and the
input's gradient, on the CPU. f32 within 1e-5 relative (1e-6 absolute):
the same f32 reductions in other orders."""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = dict(rtol=1e-5, atol=1e-6)
C = 7


def _inputs(axis, soft, use_softmax, seed):
    rng = np.random.default_rng(seed)
    shape = (4, 5, C) if axis == -1 else (4, C, 5)
    z = rng.standard_normal(shape).astype(np.float32)
    if not use_softmax:
        # probabilities along the class axis, some of them tiny
        e = np.exp(2 * z)
        z = (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)
    if soft:
        lbl = rng.random(shape).astype(np.float32)
        lbl /= lbl.sum(axis=axis, keepdims=True)
    else:
        lbl = rng.integers(0, C, (4, 5)).astype(np.int32)
        lbl[0, :2] = -100          # ignored
        lbl[1, 3] = 2              # a custom ignore_index, when asked
    return z, lbl


CASES = list(itertools.product(
    [False, True],                 # soft labels
    [True, False],                 # use_softmax
    [0.0, 0.2],                    # label smoothing
    [False, True],                 # class weights
    ["mean", "sum", "none"]))


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("axis", [-1, 1])
def test_cross_entropy_matches_reference(case, axis):
    soft, use_softmax, smooth, weighted, reduction = CASES[case]
    z, lbl = _inputs(axis, soft, use_softmax, seed=case)
    w = np.linspace(0.5, 2.0, C).astype(np.float32) if weighted else None
    kw = dict(reduction=reduction, soft_label=soft, axis=axis,
              use_softmax=use_softmax, label_smoothing=smooth)
    if not soft and case % 3 == 0:
        # a custom ignore_index; -100 is then a class id out of range
        kw["ignore_index"] = 2
        lbl = np.where(lbl == -100, 0, lbl).astype(np.int32)
    if not soft and case % 2:
        # labels carrying their unit class axis
        lbl = np.expand_dims(lbl, axis)
    jz = pt.to_tensor(z, stop_gradient=False)
    jl = JF.cross_entropy(jz, pt.to_tensor(lbl), weight=None if w is None
                          else pt.to_tensor(w), **kw)
    tz = torch.from_numpy(z.copy()).requires_grad_()
    tl = TF.cross_entropy(tz, torch.from_numpy(lbl), weight=None if w is None
                          else torch.from_numpy(w), **kw)
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), **TOL)
    g = np.random.default_rng(1).standard_normal(jl.shape).astype(np.float32)
    (jl * pt.to_tensor(g)).sum().backward()
    (tl * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tz.grad.numpy(), jz.grad.numpy(), **TOL)


def test_all_labels_ignored_gives_zero():
    z = np.random.default_rng(2).standard_normal((3, C)).astype(np.float32)
    lbl = np.full((3,), -100, np.int32)
    w = np.ones(C, np.float32)
    for weight in (None, w):
        want = JF.cross_entropy(pt.to_tensor(z), pt.to_tensor(lbl),
                                weight=None if weight is None
                                else pt.to_tensor(weight)).numpy()
        got = TF.cross_entropy(torch.from_numpy(z), torch.from_numpy(lbl),
                               weight=None if weight is None
                               else torch.from_numpy(weight)).numpy()
        assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("kw", [
    dict(), dict(reduction="sum", label_smoothing=0.1),
    dict(soft_label=True, reduction="none"),
    dict(use_softmax=False, ignore_index=2)])
def test_cross_entropy_loss_layer_matches_reference(kw):
    soft = kw.get("soft_label", False)
    z, lbl = _inputs(-1, soft, kw.get("use_softmax", True), seed=3)
    if "ignore_index" in kw:
        lbl = np.where(lbl == -100, 0, lbl).astype(np.int32)
    w = np.linspace(1.0, 2.0, C).astype(np.float32)
    jl = jnn.CrossEntropyLoss(weight=pt.to_tensor(w), **kw)
    tl = tnn.CrossEntropyLoss(weight=torch.from_numpy(w), **kw)
    np.testing.assert_allclose(
        tl(torch.from_numpy(z), torch.from_numpy(lbl)).numpy(),
        jl(pt.to_tensor(z), pt.to_tensor(lbl)).numpy(), **TOL)


def test_unknown_reduction_raises():
    z = torch.zeros(2, C)
    with pytest.raises(ValueError):
        TF.cross_entropy(z, torch.zeros(2, dtype=torch.long),
                         reduction="avg")
