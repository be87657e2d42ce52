"""paddle_tpu_torch's convolutions and pools against paddle_tpu's
(nn/functional over ops/nn_ops.py, ops/vision_ops.py, and the layers of
nn/layers/conv.py and pooling.py).

Inputs from a numpy seed go through both packages on the CPU: every
padding form of the reference's ``_conv_padding`` (int, n ints, 2n
ints, pairs, "SAME", "VALID"), strides, dilation and groups, in the
channels-first and channels-last layouts; the transposes with output
padding and ``output_size``; max and average pools (exclusive or not)
with every padding form, the adaptive pools in their divisible and
general cases; gradients through a convolution and a pool; the layers
with the reference's weights; O1's output dtypes.

Tolerances: f32 results within 1e-5 (relative and absolute; XLA's and
torch's CPU convolutions sum in their own orders, measured <= 5e-6 at
these sizes); pools of f32 values within 1e-6 (a max is exact, an
average one division apart)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(a):
    return pt.to_tensor(a), torch.from_numpy(np.array(a))


def _cl(x):
    """channels-first -> channels-last"""
    return np.moveaxis(x, 1, -1).copy()


LAYOUTS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
CONV = {1: ("conv1d", (2, 4, 11)), 2: ("conv2d", (2, 4, 9, 8)),
        3: ("conv3d", (1, 4, 6, 5, 7))}
PADDINGS = {
    1: [0, 2, [1], [1, 2], [(2, 0)], "SAME", "valid"],
    2: [0, 1, [1, 2], [1, 0, 2, 1], [(2, 1), (0, 3)], "SAME", "VALID"],
    3: [0, 1, [1, 0, 2], [0, 1, 1, 0, 2, 1], [(1, 0), (0, 1), (2, 2)],
        "SAME", "VALID"],
}


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("pi", range(7))
def test_conv_matches_reference(n, channel_last, pi):
    name, shape = CONV[n]
    rng = np.random.default_rng(n * 10 + pi)
    x = rng.standard_normal(shape).astype(np.float32)
    padding = PADDINGS[n][pi]
    # a grouped, dilated, strided case and a plain one alternate
    groups, dilation, stride = (2, 2, 2) if pi % 2 else (1, 1, 1)
    w = rng.standard_normal((6, 4 // groups) + (3,) * n).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    df = LAYOUTS[n][channel_last]
    xx = _cl(x) if channel_last else x
    (jx, tx), (jw, tw), (jb, tb) = _pair(xx), _pair(w), _pair(b)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=df)
    want = getattr(JF, name)(jx, jw, jb, **kw).numpy()
    got = getattr(TF, name)(tx, tw, tb, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **CONV_TOL)


# (padding, output_padding, stride, dilation)
TRANSPOSE_CASES = [(0, 0, 1, 1), (1, 1, 2, 1), ([1, 2], [0, 1], 2, 2),
                   ([(2, 0), (1, 3)], 0, 3, 1), ("SAME", 0, 1, 2),
                   ("VALID", 0, 1, 2)]


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_transpose_string_padding_with_stride_raises(padding):
    """The reference's transposes hand string padding to
    lax.conv_general_dilated with an input dilation, which raises for a
    stride above 1; the port raises the same error."""
    x = np.zeros((1, 2, 4, 4), np.float32)
    w = np.zeros((2, 3, 3, 3), np.float32)
    (jx, tx), (jw, tw) = _pair(x), _pair(w)
    with pytest.raises(ValueError, match="String padding"):
        JF.conv2d_transpose(jx, jw, stride=2, padding=padding)
    with pytest.raises(ValueError, match="String padding"):
        TF.conv2d_transpose(tx, tw, stride=2, padding=padding)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("case", range(len(TRANSPOSE_CASES)))
def test_conv_transpose_matches_reference(n, channel_last, case):
    padding, outpad, stride, dilation = TRANSPOSE_CASES[case]
    if n == 3 and isinstance(padding, list) and \
            isinstance(padding[0], tuple):
        padding = padding + [(1, 1)]
    if n == 3 and isinstance(padding, list) and len(padding) == 2 and \
            isinstance(padding[0], int):
        padding = padding + [0]
    if n == 3 and isinstance(outpad, list):
        outpad = outpad + [1]
    rng = np.random.default_rng(100 + case)
    shape = (2, 4, 5, 6) if n == 2 else (1, 4, 4, 3, 5)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((4, 3) + (3,) * n).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    df = LAYOUTS[n][channel_last]
    xx = _cl(x) if channel_last else x
    (jx, tx), (jw, tw), (jb, tb) = _pair(xx), _pair(w), _pair(b)
    name = f"conv{n}d_transpose"
    kw = dict(stride=stride, padding=padding, output_padding=outpad,
              dilation=dilation, data_format=df)
    want = getattr(JF, name)(jx, jw, jb, **kw).numpy()
    got = getattr(TF, name)(tx, tw, tb, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **CONV_TOL)


POOLS = {1: ((2, 3, 13), ("max_pool1d", "avg_pool1d")),
         2: ((2, 3, 11, 9), ("max_pool2d", "avg_pool2d")),
         3: ((1, 2, 7, 6, 9), ("max_pool3d", "avg_pool3d"))}
# (kernel, stride, padding): torch's own padding, then pads it cannot
# take (uneven, wider than half the window), then "SAME" / "VALID"
POOL_CASES = [(3, 2, 1), (2, None, 0), (3, 1, [(0, 2)]), (2, 2, 1),
              (3, 2, "SAME"), (3, 3, "VALID"), (4, 2, [(1, 2)])]


def _nd(v, n):
    if isinstance(v, list):
        return v * n
    return v


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kind", ["max", "avg_exclusive", "avg_inclusive"])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool_matches_reference(n, kind, case):
    shape, (mx, av) = POOLS[n]
    k, s, p = POOL_CASES[case]
    p = _nd(p, n)
    rng = np.random.default_rng(200 + case)
    x = rng.standard_normal(shape).astype(np.float32)
    # 1-D pools take no data_format; the others run in both layouts
    for channel_last in ((False,) if n == 1 else (False, True)):
        xx = _cl(x) if channel_last else x
        jx, tx = _pair(xx)
        kw = {} if n == 1 else dict(data_format=LAYOUTS[n][channel_last])
        if kind != "max":
            kw["exclusive"] = kind == "avg_exclusive"
        name = mx if kind == "max" else av
        want = getattr(JF, name)(jx, k, s, p, **kw).numpy()
        got = getattr(TF, name)(tx, k, s, p, **kw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **POOL_TOL)


@pytest.mark.parametrize("name,shape,out", [
    ("adaptive_avg_pool1d", (2, 3, 12), 4),
    ("adaptive_avg_pool1d", (2, 3, 13), 5),
    ("adaptive_avg_pool2d", (2, 3, 8, 6), (4, 3)),
    ("adaptive_avg_pool2d", (2, 3, 7, 9), (3, 4)),
    ("adaptive_avg_pool2d", (2, 3, 7, 7), 1),
    ("adaptive_max_pool2d", (2, 3, 8, 6), (2, 3)),
    ("adaptive_max_pool2d", (2, 3, 7, 9), (3, 4)),
    ("adaptive_avg_pool3d", (1, 2, 4, 6, 8), (2, 3, 4)),
    ("adaptive_avg_pool3d", (1, 2, 5, 7, 6), (2, 3, 4)),
])
def test_adaptive_pool_matches_reference(name, shape, out):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    n = len(shape) - 2
    layouts = (False,) if name in ("adaptive_avg_pool1d",
                                   "adaptive_max_pool2d") else (False, True)
    for channel_last in layouts:
        xx = _cl(x) if channel_last else x
        jx, tx = _pair(xx)
        kw = {"data_format": LAYOUTS[n][1]} if channel_last else {}
        want = getattr(JF, name)(jx, out, **kw).numpy()
        got = getattr(TF, name)(tx, out, **kw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **POOL_TOL)


@pytest.mark.parametrize("channel_last", [False, True])
def test_conv_and_pool_gradients_match_reference(channel_last):
    """d/dx and d/dw of sum(g * maxpool(avgpool(conv(x, w, pad pairs))))
    with g drawn: the gradients flow through the explicit padding,
    both pools and the layout's views."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 10, 9)).astype(np.float32)
    w = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    df = "NHWC" if channel_last else "NCHW"
    xx = _cl(x) if channel_last else x

    def run(F, xt, wt):
        y = F.conv2d(xt, wt, padding=[(2, 1), (0, 2)], stride=1,
                     data_format=df)
        y = F.avg_pool2d(y, 3, 1, [(1, 0), (0, 1)], data_format=df)
        return F.max_pool2d(y, 3, 2, 1, data_format=df)

    jx = pt.to_tensor(xx, stop_gradient=False)
    jw = pt.to_tensor(w, stop_gradient=False)
    jy = run(JF, jx, jw)
    g = rng.standard_normal(jy.shape).astype(np.float32)
    (jy * pt.to_tensor(g)).sum().backward()
    tx = torch.from_numpy(xx.copy()).requires_grad_()
    tw = torch.from_numpy(w.copy()).requires_grad_()
    ty = run(TF, tx, tw)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **CONV_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **CONV_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), rtol=1e-5,
                               atol=1e-4)


def _load(tlayer, jlayer):
    sd = {k: torch.from_numpy(np.asarray(v._data).copy())
          for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(sd)


@pytest.mark.parametrize("name,args,kw,shape", [
    ("Conv1D", (4, 6, 3), dict(padding=1, data_format="NLC"), (2, 9, 4)),
    ("Conv2D", (4, 6, 3), dict(stride=2, padding="SAME", groups=2),
     (2, 4, 9, 8)),
    ("Conv3D", (4, 6, 2), dict(bias_attr=False, data_format="NDHWC"),
     (1, 5, 4, 6, 4)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1),
     (2, 4, 5, 6)),
    ("Conv3DTranspose", (4, 6, 3), dict(stride=2, data_format="NDHWC"),
     (1, 3, 4, 5, 4)),
    ("Conv1DTranspose", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 7)),
])
def test_conv_layers_match_reference(name, args, kw, shape):
    pt.seed(0)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw, device="cpu")
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    _load(tl, jl)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jx, tx = _pair(x)
    np.testing.assert_allclose(tl(tx).detach().numpy(), jl(jx).numpy(),
                               **CONV_TOL)


@pytest.mark.parametrize("name,n", [("Conv2DTranspose", 2),
                                    ("Conv3DTranspose", 3)])
def test_conv_transpose_output_size_matches_reference(name, n):
    pt.seed(0)
    jl = getattr(jnn, name)(3, 2, 3, stride=2, padding=1)
    tl = getattr(tnn, name)(3, 2, 3, stride=2, padding=1, device="cpu")
    _load(tl, jl)
    x = np.random.default_rng(2).standard_normal(
        (1, 3) + (4,) * n).astype(np.float32)
    jx, tx = _pair(x)
    size = [8] * n
    want = jl(jx, output_size=size).numpy()
    got = tl(tx, output_size=size).detach().numpy()
    assert got.shape == want.shape == (1, 2) + (8,) * n
    np.testing.assert_allclose(got, want, **CONV_TOL)
    with pytest.raises(ValueError):
        tl(tx, output_size=[11] * n)


def test_conv_layer_initializers_follow_the_reference():
    """KaimingUniform(negative_slope=sqrt(5)) and the bias's
    Uniform(+-1/sqrt(fan_in)): the same bounds in both packages (the
    draws themselves differ), the support filled to within a tenth of
    them; bias_attr=True and ParamAttr-free initializers as the
    reference's create_parameter takes them."""
    from paddle_tpu_torch.nn.initializer import Constant
    gen = torch.Generator().manual_seed(0)
    tl = tnn.Conv2D(16, 32, 3, groups=2, device="cpu", init_generator=gen)
    fan_in = 16 // 2 * 9
    w_bound = np.sqrt(6.0 / (1 + 5.0)) / np.sqrt(fan_in)
    b_bound = 1 / np.sqrt(fan_in)
    pt.seed(0)
    jl = jnn.Conv2D(16, 32, 3, groups=2)
    for t, j, bound in ((tl.weight, jl.weight, w_bound),
                        (tl.bias, jl.bias, b_bound)):
        assert tuple(t.shape) == tuple(j.shape)
        for arr in (t.detach().numpy(), np.asarray(j._data)):
            assert np.abs(arr).max() <= bound
            assert np.abs(arr).max() >= 0.9 * bound
    zero = tnn.Conv2D(4, 4, 1, bias_attr=True, device="cpu")
    assert torch.count_nonzero(zero.bias._data) == 0
    const = tnn.Conv2D(4, 4, 1, weight_attr=Constant(0.5), device="cpu")
    assert torch.all(const.weight._data == 0.5)
    assert tnn.Conv2D(4, 4, 1, bias_attr=False, device="cpu").bias is None


@pytest.mark.parametrize("name,args,shape", [
    ("MaxPool2D", (3, 2, 1), (2, 3, 9, 8)),
    ("AvgPool2D", (3, 2, 1), (2, 3, 9, 8)),
    ("AvgPool1D", (3, 2, 1), (2, 3, 9)),
    ("MaxPool1D", (2,), (2, 3, 9)),
    ("MaxPool3D", (2, 2, 0), (1, 2, 4, 6, 4)),
    ("AvgPool3D", (3, 1, 1), (1, 2, 4, 6, 4)),
    ("AdaptiveAvgPool1D", (4,), (2, 3, 9)),
    ("AdaptiveAvgPool2D", ((1, 1),), (2, 3, 7, 7)),
    ("AdaptiveAvgPool3D", (2,), (1, 2, 4, 6, 5)),
    ("AdaptiveMaxPool2D", ((2, 3),), (2, 3, 7, 7)),
])
def test_pool_layers_match_reference(name, args, shape):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jx, tx = _pair(x)
    want = getattr(jnn, name)(*args)(jx).numpy()
    got = getattr(tnn, name)(*args)(tx).numpy()
    np.testing.assert_allclose(got, want, **POOL_TOL)


def test_o1_dtypes_follow_the_reference():
    """Under bf16 O1 a convolution (white) runs and returns bf16, a pool
    follows its input and the functional pad and flatten keep it, in
    both packages."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x), _pair(w)
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        jc = JF.conv2d(jx, jw, padding=1)
        jp = JF.max_pool2d(jx, 2)
        jt = JF.conv2d_transpose(jc, jw, stride=2)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        tc = TF.conv2d(tx, tw, padding=1)
        tp = TF.max_pool2d(tx, 2)
        tt = TF.conv2d_transpose(tc, tw, stride=2)
    assert str(jc.dtype).endswith("bfloat16") and tc.dtype == torch.bfloat16
    assert str(jt.dtype).endswith("bfloat16") and tt.dtype == torch.bfloat16
    assert str(jp.dtype).endswith("float32") and tp.dtype == torch.float32
    # the bf16 products of the same rounded inputs, summed in f32 and
    # rounded once: an ulp of bf16 apart at most
    np.testing.assert_allclose(tc.float().numpy(),
                               np.asarray(jc._data, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("pad,mode,df", [
    ([1, 2, 0, 1, 2, 0, 1, 1], "constant", "NCHW"),
    ([1, 2, 3, 0], "constant", "NCHW"),
    ([1, 2, 3, 0], "constant", "NHWC"),
    ([2, 1, 1, 2], "reflect", "NCHW"),
    ([2, 1, 1, 2], "replicate", "NHWC"),
    ([1, 2, 2, 1], "circular", "NCHW"),
    ([1, 1], "reflect", "NCHW"),
])
def test_pad_and_flatten_match_reference(pad, mode, df):
    x = np.random.default_rng(6).standard_normal(
        (2, 3, 4, 5)).astype(np.float32)
    jx, tx = _pair(x)
    want = JF.pad(jx, pad, mode=mode, value=0.5, data_format=df).numpy()
    got = TF.pad(tx, pad, mode=mode, value=0.5, data_format=df).numpy()
    np.testing.assert_array_equal(got, want)
    for a, b in ((1, -1), (0, 2), (2, 3)):
        assert tuple(TF.flatten(tx, a, b).shape) == \
            tuple(pt.flatten(jx, a, b).shape)
    assert tuple(TF.flatten(torch.tensor(3.0)).shape) == (1,)
    assert tuple(tnn.Flatten()(tx).shape) == (2, 60)
