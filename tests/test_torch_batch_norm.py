"""paddle_tpu_torch's batch norm against paddle_tpu's
(ops/nn_ops.py:523 ``batch_norm`` and nn/layers/norm.py's layers).

Inputs from a numpy seed, on the CPU: the training output and the new
running statistics in both statistics forms (exact two-pass moments,
and ``FLAGS_fast_bn_stats``'s one-pass form around a running mean that
is not zero), eval and ``use_global_stats``, the running statistics
after an eager step of the layer, 1-D, 2-D and 3-D in both layouts, the
gradients of x, weight and bias, a layer without affine parameters,
bf16 O1 (the math in f32, an f32 output, a bf16 gradient for the bf16
input) and a bf16 input without auto_cast.

Tolerances: f32 within 1e-5 (relative and absolute; the same moments
summed in other orders); bf16 outputs within one bf16 ulp (2^-7
relative) of values of order 1."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
FLAG = "FLAGS_fast_bn_stats"


@pytest.fixture(params=[False, True], ids=["exact", "fast"])
def fast(request):
    """Both packages' FLAGS_fast_bn_stats set for the test, put back
    after it."""
    saved = pt.get_flags(FLAG)[FLAG], ptt.get_flags(FLAG)[FLAG]
    pt.set_flags({FLAG: request.param})
    ptt.set_flags({FLAG: request.param})
    yield request.param
    pt.set_flags({FLAG: saved[0]})
    ptt.set_flags({FLAG: saved[1]})


def _data(shape, ch, seed=0):
    rng = np.random.default_rng(seed)
    # channels with a mean and scale of their own, as activations have
    x = (rng.standard_normal(shape) * 1.5 + 0.7).astype(np.float32)
    rm = rng.standard_normal(ch).astype(np.float32) * 0.5
    rv = rng.uniform(0.5, 2.0, ch).astype(np.float32)
    w = rng.uniform(0.5, 1.5, ch).astype(np.float32)
    b = rng.standard_normal(ch).astype(np.float32)
    return x, rm, rv, w, b


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data, np.float32)


CASES = [((4, 6), "NCHW", 6), ((3, 5, 7), "NCHW", 5), ((3, 7, 5), "NLC", 5),
         ((2, 4, 5, 6), "NCHW", 4), ((2, 5, 6, 4), "NHWC", 4),
         ((2, 3, 4, 3, 5), "NCDHW", 3), ((2, 4, 3, 5, 3), "NDHWC", 3)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_training_output_stats_and_gradients_match_reference(case, fast):
    shape, df, ch = CASES[case]
    x, rm, rv, w, b = _data(shape, ch, seed=case)
    jx, jw, jb = (pt.to_tensor(a, stop_gradient=False) for a in (x, w, b))
    jout, jrm, jrv = JF.batch_norm(jx, pt.to_tensor(rm), pt.to_tensor(rv),
                                   jw, jb, training=True, momentum=0.8,
                                   epsilon=1e-4, data_format=df)
    g = np.random.default_rng(99).standard_normal(jout.shape).astype(
        np.float32)
    (jout * pt.to_tensor(g)).sum().backward()
    tx, tw, tb = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (x, w, b))
    tout, trm, trv = TF.batch_norm(tx, torch.from_numpy(rm),
                                   torch.from_numpy(rv), tw, tb,
                                   training=True, momentum=0.8,
                                   epsilon=1e-4, data_format=df)
    (tout * torch.from_numpy(g)).sum().backward()
    for got, want in ((tout, jout), (trm, jrm), (trv, jrv), (tx.grad, jx.grad),
                      (tw.grad, jw.grad), (tb.grad, jb.grad)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("name,shape,df", [
    ("BatchNorm1D", (4, 6), "NCL"), ("BatchNorm1D", (3, 7, 6), "NLC"),
    ("BatchNorm2D", (2, 6, 5, 4), "NCHW"), ("BatchNorm2D", (2, 5, 4, 6),
                                            "NHWC"),
    ("BatchNorm3D", (2, 3, 4, 2, 6), "NDHWC"), ("BatchNorm", (2, 6, 3, 3),
                                                "NCHW")])
def test_layer_eager_steps_move_the_buffers_as_the_reference(name, shape, df,
                                                              fast):
    """Two training forwards of the layer (the second with the buffers
    the first wrote, so the fast form's pivot is not zero), then eval
    and use_global_stats, which use and keep the running statistics."""
    ch = 6
    jl = getattr(jnn, name)(ch, momentum=0.7, data_format=df)
    tl = getattr(tnn, name)(ch, momentum=0.7, data_format=df, device="cpu")
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == [
        "_mean", "_variance", "bias", "weight"]
    tl.load_state_dict({k: torch.from_numpy(np.asarray(v._data).copy())
                        for k, v in jl.state_dict().items()})
    for seed in (1, 2):
        x = _data(shape, ch, seed)[0]
        jy, ty = jl(pt.to_tensor(x)), tl(torch.from_numpy(x))
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        for k in ("_mean", "_variance"):
            np.testing.assert_allclose(_np(getattr(tl, k)),
                                       _np(getattr(jl, k)), **TOL)
    moved = _np(tl._mean).copy()
    assert np.abs(moved).max() > 0.1
    x = _data(shape, ch, 3)[0]
    jl.eval()
    tl.eval()
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               _np(jl(pt.to_tensor(x))), **TOL)
    jl.train()
    tl.train()
    jl.use_global_stats = tl.use_global_stats = True
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               _np(jl(pt.to_tensor(x))), **TOL)
    np.testing.assert_array_equal(_np(tl._mean), moved)
    np.testing.assert_allclose(_np(tl._mean), _np(jl._mean), **TOL)


def test_layer_without_affine_and_with_initializers():
    """weight_attr=False / bias_attr=False leave them out in both
    packages; an initializer passed as weight_attr draws the weight."""
    from paddle_tpu_torch.nn.initializer import Constant
    jl = jnn.BatchNorm2D(4, weight_attr=False, bias_attr=False)
    tl = tnn.BatchNorm2D(4, weight_attr=False, bias_attr=False,
                         device="cpu")
    assert tl.weight is None and tl.bias is None
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())
    x = _data((2, 4, 3, 3), 4)[0]
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               _np(jl(pt.to_tensor(x))), **TOL)
    t2 = tnn.BatchNorm2D(4, weight_attr=Constant(2.0), device="cpu")
    assert torch.all(t2.weight._data == 2.0) and torch.all(t2.bias._data == 0)
    assert t2._mean.dtype == t2._variance.dtype == torch.float32


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_o1_runs_in_f32_and_matches_reference(df, fast):
    """Under bf16 O1 (black list) a bf16 input is normalised in f32: f32
    output, running statistics in f32, a bf16 gradient for the input;
    within bf16's rounding of the input's gradient of the reference."""
    shape = (2, 4, 5, 6) if df == "NCHW" else (2, 5, 6, 4)
    x, rm, rv, w, b = _data(shape, 4, seed=5)
    xb = x.astype(np.float32)
    import ml_dtypes
    jx = pt.to_tensor(xb.astype(ml_dtypes.bfloat16), stop_gradient=False)
    jw, jb = (pt.to_tensor(a, stop_gradient=False) for a in (w, b))
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        jout, jrm, jrv = JF.batch_norm(jx, pt.to_tensor(rm),
                                       pt.to_tensor(rv), jw, jb,
                                       training=True, data_format=df)
    (jout * jout).sum().backward()
    tx = torch.from_numpy(xb).to(torch.bfloat16).requires_grad_()
    tw, tb = (torch.from_numpy(a.copy()).requires_grad_() for a in (w, b))
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        tout, trm, trv = TF.batch_norm(tx, torch.from_numpy(rm),
                                       torch.from_numpy(rv), tw, tb,
                                       training=True, data_format=df)
    (tout * tout).sum().backward()
    assert tout.dtype == torch.float32 and str(jout.dtype).endswith("32")
    assert tx.grad.dtype == torch.bfloat16
    assert str(jx.grad.dtype).endswith("bfloat16")
    for got, want in ((tout, jout), (trm, jrm), (trv, jrv),
                      (tw.grad, jw.grad), (tb.grad, jb.grad)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **BF16_TOL)


def test_bf16_without_auto_cast_matches_reference(fast):
    """A bf16 input outside auto_cast: the statistics in f32, the
    normalisation and affine in bf16, as the reference computes them."""
    import ml_dtypes
    x, rm, rv, w, b = _data((4, 3, 5, 5), 3, seed=6)
    bf = ml_dtypes.bfloat16
    jout, jrm, jrv = JF.batch_norm(
        pt.to_tensor(x.astype(bf)), pt.to_tensor(rm), pt.to_tensor(rv),
        pt.to_tensor(w.astype(bf)), pt.to_tensor(b.astype(bf)),
        training=True)
    t = lambda a: torch.from_numpy(a.copy())
    tout, trm, trv = TF.batch_norm(
        t(x).bfloat16(), t(rm), t(rv), t(w).bfloat16(), t(b).bfloat16(),
        training=True)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=2 ** -6,
                               atol=2 ** -6)
    np.testing.assert_allclose(_np(trm), _np(jrm), **TOL)
    np.testing.assert_allclose(_np(trv), _np(jrv), **TOL)
