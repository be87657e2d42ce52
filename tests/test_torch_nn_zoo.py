"""The layer zoo (paddle_tpu_torch/nn/layers: activation, loss, norm,
pooling, common) and the nn ops behind it against the reference's on
the CPU, from the same weights (the reference draws them, the port
loads its ``state_dict`` by name) and inputs. Each layer case compares
the outputs and the gradients of every input and parameter through
``backward()`` of a fixed cotangent; ``interpolate``'s grid covers
every mode upsampling and downsampling, with ``align_corners`` on and
off, in both layouts (the reference's jax.image.resize conventions:
half-pixel nearest, antialiased linear and cubic, Keys' cubic with a =
-0.5, which torch.nn.functional.interpolate does not share).

The random ops (gumbel_softmax, rrelu, dropout2d, alpha_dropout) draw
from torch's generators where the reference draws from jax.random, so
they are held to the reference on an explicit noise path (the port's
draws handed to the reference in place of its own, by monkeypatching
jax.random) and checked on statistics.

Tolerance: 1e-5 (rtol = atol; the tables state a wider one where a
case's arithmetic takes more f32 roundings, as the cubic resize's
sums), as in tests/test_torch_ops.py: XLA and torch compute the same
f32 functions with other kernels, a few ulps apart."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import functional as TF
from torch_port_helpers import cpu_place, twin_layers

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _np(t):
    return np.asarray(t.numpy())


def _a(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


IMG = _a(2, 4, 8, 8, seed=1)
SEQ = _a(2, 4, 16, seed=2)
VOL = _a(1, 3, 4, 6, 6, seed=3)
A34, B34 = _a(3, 4, seed=4), _a(3, 4, seed=5)
P34 = _a(3, 4, seed=6, lo=0.05, hi=0.95)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(P, layer, inputs, train=False):
    """(outputs, grads) of layer(*inputs): inputs are (array, grad) pairs;
    the grads are those of the float inputs marked and of every
    parameter after backward() of sum(out * fixed cotangent) over the
    float outputs."""
    if not train:
        layer.eval()
    ts = [P.to_tensor(a, stop_gradient=not (g and a.dtype.kind == "f"))
          for a, g in inputs]
    outs = _flat(layer(*ts))
    rng = np.random.default_rng(9)
    total = None
    for o in outs:
        if o.stop_gradient or _np(o).dtype.kind != "f":
            continue
        cot = P.to_tensor(rng.standard_normal(tuple(o.shape)).astype(
            np.float32))
        term = (o * cot).sum()
        total = term if total is None else total + term
    grads = {}
    if total is not None:
        total.backward()
        for n, p in layer.named_parameters():
            if p.grad is not None:
                grads[n] = _np(p.grad)
        for i, (t, (_, g)) in enumerate(zip(ts, inputs)):
            if not t.stop_gradient and t.grad is not None:
                grads[i] = _np(t.grad)
    return [_np(o) for o in outs], grads


def _held(got, want, tol, what=""):
    (go, gg), (wo, wg) = got, want
    assert len(go) == len(wo), what
    for i, (a, b) in enumerate(zip(go, wo)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"{what} out {i}")
    assert set(gg) == set(wg), what
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], rtol=tol, atol=tol,
                                   err_msg=f"{what} grad {k}")


def x_(a):
    return (a, True)


def c_(a):
    return (a, False)


LBL = np.array([0, 3, 1], np.int32)
PM1 = np.where(B34 > 0, 1.0, -1.0).astype(np.float32)
NHWC = IMG.transpose(0, 2, 3, 1).copy()

# (id, layer, args, kwargs, inputs, tol)
LAYERS = [
    # activations
    ("ReLU6", "ReLU6", (), {}, [x_(A34 * 8)], TOL),
    ("Sigmoid", "Sigmoid", (), {}, [x_(A34 * 3)], TOL),
    ("Softmax", "Softmax", (), {"axis": 0}, [x_(A34)], TOL),
    ("LogSoftmax", "LogSoftmax", (), {}, [x_(A34)], TOL),
    ("LeakyReLU", "LeakyReLU", (0.2,), {}, [x_(A34)], TOL),
    ("PReLU", "PReLU", (4, 0.1), {}, [x_(IMG)], TOL),
    ("PReLU_nhwc", "PReLU", (4,), {"data_format": "NHWC"}, [x_(NHWC)], TOL),
    ("ELU", "ELU", (0.5,), {}, [x_(A34 * 3)], TOL),
    ("SELU", "SELU", (), {}, [x_(A34 * 3)], TOL),
    ("CELU", "CELU", (1.5,), {}, [x_(A34 * 3)], TOL),
    ("Mish", "Mish", (), {}, [x_(A34 * 3)], TOL),
    ("Hardswish", "Hardswish", (), {}, [x_(A34 * 5)], TOL),
    ("Hardsigmoid", "Hardsigmoid", (), {}, [x_(A34 * 5)], TOL),
    ("Hardtanh", "Hardtanh", (-0.5, 0.7), {}, [x_(A34)], TOL),
    ("Hardshrink", "Hardshrink", (0.3,), {}, [x_(A34)], TOL),
    ("Softshrink", "Softshrink", (0.3,), {}, [x_(A34)], TOL),
    ("Tanhshrink", "Tanhshrink", (), {}, [x_(A34)], TOL),
    ("Softplus", "Softplus", (2.0, 3.0), {}, [x_(A34 * 4)], TOL),
    ("Softsign", "Softsign", (), {}, [x_(A34)], TOL),
    ("ThresholdedReLU", "ThresholdedReLU", (0.2, 0.1), {}, [x_(A34)], TOL),
    ("LogSigmoid", "LogSigmoid", (), {}, [x_(A34 * 3)], TOL),
    ("Maxout", "Maxout", (2,), {}, [x_(IMG)], TOL),
    ("GLU", "GLU", (1,), {}, [x_(IMG)], TOL),
    ("Softmax2D", "Softmax2D", (), {}, [x_(IMG)], TOL),
    ("Silu", "Silu", (), {}, [x_(A34)], TOL),
    ("Tanh", "Tanh", (), {}, [x_(A34)], TOL),
    # losses
    ("MSELoss", "MSELoss", (), {}, [x_(A34), c_(B34)], TOL),
    ("L1Loss_sum", "L1Loss", ("sum",), {}, [x_(A34), c_(B34)], TOL),
    ("SmoothL1Loss", "SmoothL1Loss", ("none", 0.5), {}, [x_(A34 * 2),
                                                         c_(B34)], TOL),
    ("NLLLoss", "NLLLoss", (), {}, [x_(A34), c_(LBL)], TOL),
    ("BCELoss", "BCELoss", (), {}, [x_(P34), c_(P34[::-1].copy())], TOL),
    ("BCEWithLogitsLoss", "BCEWithLogitsLoss", (), {},
     [x_(A34 * 3), c_(P34)], TOL),
    ("KLDivLoss", "KLDivLoss", ("batchmean",), {}, [x_(A34), c_(P34)],
     TOL),
    ("MarginRankingLoss", "MarginRankingLoss", (0.1,), {},
     [x_(A34), x_(B34), c_(PM1)], TOL),
    ("HingeEmbeddingLoss", "HingeEmbeddingLoss", (0.5,), {},
     [x_(A34), c_(PM1)], TOL),
    ("CosineEmbeddingLoss", "CosineEmbeddingLoss", (0.1,), {},
     [x_(A34), x_(B34), c_(np.array([1, -1, 1], np.int32))], TOL),
    ("TripletMarginLoss", "TripletMarginLoss", (), {"swap": True},
     [x_(A34), x_(B34), x_(P34)], TOL),
    ("CrossEntropyLoss", "CrossEntropyLoss", (), {"label_smoothing": 0.1},
     [x_(A34), c_(LBL)], TOL),
    # norms
    ("GroupNorm", "GroupNorm", (2, 4), {}, [x_(IMG)], TOL),
    ("GroupNorm_nhwc", "GroupNorm", (4, 4), {"data_format": "NHWC"},
     [x_(NHWC)], TOL),
    ("InstanceNorm1D", "InstanceNorm1D", (4,), {}, [x_(SEQ)], TOL),
    ("InstanceNorm2D", "InstanceNorm2D", (4,), {"bias_attr": False},
     [x_(IMG)], TOL),
    ("InstanceNorm3D", "InstanceNorm3D", (3,), {}, [x_(VOL)], TOL),
    ("LocalResponseNorm", "LocalResponseNorm", (3, 1e-2, 0.75, 2.0), {},
     [x_(IMG)], TOL),
    ("SyncBatchNorm", "SyncBatchNorm", (4,), {}, [x_(IMG)], TOL),
    # pools
    ("AdaptiveMaxPool1D", "AdaptiveMaxPool1D", (5,), {}, [x_(SEQ)], TOL),
    ("AdaptiveMaxPool1D_mask", "AdaptiveMaxPool1D", (4, True), {},
     [x_(SEQ)], TOL),
    ("AdaptiveMaxPool3D", "AdaptiveMaxPool3D", ((2, 3, 4),), {},
     [x_(VOL)], TOL),
    ("AdaptiveMaxPool3D_mask", "AdaptiveMaxPool3D", (2, True), {},
     [x_(VOL)], TOL),
    # common
    ("Identity", "Identity", (3, "x"), {"k": 1}, [x_(A34)], TOL),
    ("Dropout2D_eval", "Dropout2D", (0.5,), {}, [x_(IMG)], TOL),
    ("Dropout3D_eval", "Dropout3D", (0.5,), {}, [x_(VOL)], TOL),
    ("AlphaDropout_eval", "AlphaDropout", (0.5,), {}, [x_(A34)], TOL),
    ("Upsample", "Upsample", ((12, 10),), {"mode": "bicubic"}, [x_(IMG)],
     1e-4),
    ("UpsamplingBilinear2D", "UpsamplingBilinear2D", (None, 1.5), {},
     [x_(IMG)], TOL),
    ("UpsamplingNearest2D", "UpsamplingNearest2D", (None, 2), {},
     [x_(IMG)], TOL),
    ("Pad1D", "Pad1D", ([2, 3],), {"mode": "reflect"}, [x_(SEQ)], TOL),
    ("Pad2D", "Pad2D", ([1, 2, 0, 3],), {"mode": "replicate"}, [x_(IMG)],
     TOL),
    ("Pad3D", "Pad3D", ([1, 1, 2, 0, 0, 1],), {"value": 0.5}, [x_(VOL)],
     TOL),
    ("ZeroPad2D", "ZeroPad2D", ([1, 0, 2, 1],), {}, [x_(IMG)], TOL),
    ("Bilinear", "Bilinear", (4, 3, 5), {}, [x_(A34), x_(B34[:, :3])],
     TOL),
    ("Bilinear_nobias", "Bilinear", (4, 3, 5), {"bias_attr": False},
     [x_(A34), x_(B34[:, :3])], TOL),
    ("CosineSimilarity", "CosineSimilarity", (0,), {},
     [x_(A34), x_(B34)], TOL),
    ("PairwiseDistance", "PairwiseDistance", (3.0,), {"keepdim": True},
     [x_(A34), x_(B34)], TOL),
    ("PixelShuffle", "PixelShuffle", (2,), {}, [x_(IMG)], TOL),
    ("PixelUnshuffle", "PixelUnshuffle", (2,), {}, [x_(IMG)], TOL),
    ("ChannelShuffle", "ChannelShuffle", (2,), {}, [x_(IMG)], TOL),
    ("Unfold", "Unfold", ([3, 2], [2, 1], [1, 0], [1, 2]), {}, [x_(IMG)],
     TOL),
    ("Fold", "Fold", ((5, 6), 2, 1, 0), {}, [x_(_a(2, 12, 20, seed=8))],
     TOL),
]


@pytest.mark.parametrize("cid,name,args,kw,inputs,tol", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_reference(cid, name, args, kw, inputs, tol):
    jm, tm = twin_layers(name, *args, **kw)
    _held(_run(ptt, tm, inputs), _run(pt, jm, inputs), tol, cid)


def test_every_zoo_layer_is_covered():
    """Each class of the five zoo modules has a case here, in
    tests/test_torch_rnn.py, or (the ones ported before) in their own
    test files."""
    from paddle_tpu.nn.layers import (activation, common, loss, norm,
                                      pooling)
    earlier = {"ReLU", "GELU", "Silu", "SiLU", "Swish", "Tanh",
               "CrossEntropyLoss", "Linear", "Embedding", "Dropout",
               "Flatten", "LayerNorm", "RMSNorm", "BatchNorm",
               "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "MaxPool1D",
               "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
               "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
               "AdaptiveAvgPool3D", "AdaptiveMaxPool2D"}
    here = {c[1] for c in LAYERS} | {"SpectralNorm", "MaxUnPool2D"}
    for mod in (activation, common, loss, norm, pooling):
        for n, o in vars(mod).items():
            if isinstance(o, type) and issubclass(o, pt.nn.Layer) \
                    and o.__module__ == mod.__name__ \
                    and not n.startswith("_"):
                assert n in here | earlier, n


def test_layer_train_mode_dropouts_are_identity_at_p0():
    x = ptt.to_tensor(IMG)
    for layer in (ptt.nn.Dropout2D(0.0), ptt.nn.AlphaDropout(0.0)):
        assert np.array_equal(_np(layer(x)), IMG)


def test_sync_batch_norm_is_batch_norm_on_one_card():
    _, sync = twin_layers("SyncBatchNorm", 4)
    _, bn = twin_layers("BatchNorm2D", 4)
    x = ptt.to_tensor(IMG)
    assert np.array_equal(_np(sync(x)), _np(bn(x)))
    assert np.array_equal(_np(sync._mean), _np(bn._mean))
    assert ptt.nn.SyncBatchNorm.convert_sync_batchnorm(bn) is bn


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm_layer_matches_reference(dim, iters):
    """The normalised weight, its gradient, and the updated u and v."""
    shape = (4, 6)
    jm, tm = twin_layers("SpectralNorm", shape, dim, iters)
    inputs = [x_(_a(*shape, seed=11))]
    got, want = _run(ptt, tm, inputs, True), _run(pt, jm, inputs, True)
    _held(got, want, TOL, "SpectralNorm")
    for n in ("weight_u", "weight_v"):
        np.testing.assert_allclose(_np(getattr(tm, n)),
                                   _np(getattr(jm, n)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_max_unpool_matches_reference(fmt):
    """MaxUnPool2D scatters max_pool2d_with_index's values back (the
    indices from the reference's op, both sides given the same)."""
    out, idx = pt.ops.max_pool2d_with_index(pt.to_tensor(IMG), 2)
    vals, idx = _np(out), _np(idx)
    if fmt == "NHWC":
        vals, idx = vals.transpose(0, 2, 3, 1), idx.transpose(0, 2, 3, 1)
    jm, tm = twin_layers("MaxUnPool2D", 2, data_format=fmt)
    inputs = [x_(vals.copy()), c_(idx.copy())]
    _held(_run(ptt, tm, inputs), _run(pt, jm, inputs), TOL, fmt)


def test_max_unpool_rejects_other_layouts():
    with pytest.raises(ValueError):
        ptt.nn.MaxUnPool2D(2, data_format="NCDHW")


# ---------------------------------------------------------------------------
# interpolate: every mode, both directions, align_corners, both layouts
# ---------------------------------------------------------------------------
def _interp(P, x, **kw):
    t = P.to_tensor(x, stop_gradient=False)
    out = P.nn.functional.interpolate(t, **kw)
    cot = P.to_tensor(np.random.default_rng(3).standard_normal(
        tuple(out.shape)).astype(np.float32))
    (out * cot).sum().backward()
    return _np(out), _np(t.grad)


GRID = [(mode, size, ac, fmt)
        for mode in ("nearest", "bilinear", "bicubic", "area")
        for size in ((13, 11), (3, 5))
        for ac in (False, True) for fmt in ("NCHW", "NHWC")]


@pytest.mark.parametrize("mode,size,align_corners,fmt", GRID,
                         ids=[f"{m}-{'up' if s[0] > 8 else 'down'}-"
                              f"{'ac' if a else 'hp'}-{f}"
                              for m, s, a, f in GRID])
def test_interpolate_grid_matches_reference(mode, size, align_corners, fmt):
    x = IMG if fmt == "NCHW" else NHWC
    kw = dict(size=list(size), mode=mode, align_corners=align_corners,
              data_format=fmt)
    got, want = _interp(ptt, x, **kw), _interp(pt, x, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4 if mode == "bicubic"
                                   else TOL, atol=1e-4 if mode == "bicubic"
                                   else TOL)


@pytest.mark.parametrize("mode,x,kw", [
    ("linear", SEQ, dict(size=[23], data_format="NCW")),
    ("linear", SEQ, dict(scale_factor=0.4, data_format="NCW")),
    ("linear", SEQ, dict(size=[7], align_corners=True, data_format="NCW")),
    ("trilinear", VOL, dict(size=[6, 3, 9], data_format="NCDHW")),
    ("trilinear", VOL, dict(scale_factor=[0.5, 1.5, 1.0],
                            align_corners=True, data_format="NCDHW")),
    ("nearest", VOL, dict(scale_factor=[1.5, 0.5, 2.0],
                          data_format="NCDHW"))],
    ids=["linear-up", "linear-down", "linear-ac", "trilinear",
         "trilinear-ac", "nearest-3d"])
def test_interpolate_1d_3d_matches_reference(mode, x, kw):
    got, want = _interp(ptt, x, mode=mode, **kw), _interp(pt, x, mode=mode,
                                                          **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_interpolate_conventions_differ_from_torch_where_documented():
    """The reference's nearest is torch's "nearest-exact" and its linear
    upsampling torch's half-pixel bilinear; its downsampling antialiases
    and its cubic is Keys' a = -0.5, so there torch's modes differ."""
    x = torch.from_numpy(IMG)
    near = TF.interpolate(x, size=[5, 11], mode="nearest")
    torch.testing.assert_close(near, torch.nn.functional.interpolate(
        x, size=(5, 11), mode="nearest-exact"), rtol=0, atol=0)
    up = TF.interpolate(x, size=[13, 11], mode="bilinear")
    torch.testing.assert_close(up, torch.nn.functional.interpolate(
        x, size=(13, 11), mode="bilinear", align_corners=False),
        rtol=1e-5, atol=1e-5)
    down = TF.interpolate(x, size=[3, 5], mode="bilinear")
    assert not torch.allclose(down, torch.nn.functional.interpolate(
        x, size=(3, 5), mode="bilinear", align_corners=False), atol=1e-3)
    cubic = TF.interpolate(x, size=[13, 11], mode="bicubic")
    assert not torch.allclose(cubic, torch.nn.functional.interpolate(
        x, size=(13, 11), mode="bicubic", align_corners=False), atol=1e-3)


# ---------------------------------------------------------------------------
# the random ops: an explicit noise path, and statistics
# ---------------------------------------------------------------------------
def test_gumbel_softmax_noise_path_matches_reference(monkeypatch):
    """The port's Gumbel draw handed to the reference's gumbel_softmax
    (jax.random.gumbel monkeypatched to return it): the soft and hard
    samples and the soft sample's gradient agree."""
    g = torch.Generator().manual_seed(5)
    u = torch.empty((3, 4)).uniform_(torch.finfo(torch.float32).tiny, 1.0,
                                     generator=g)
    noise = (-torch.log(-torch.log(u))).numpy()
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype: jax.numpy.asarray(noise))
    for hard in (False, True):
        outs = []
        for P in (pt, ptt):
            x = P.to_tensor(A34, stop_gradient=False)
            if P is pt:
                y = P.nn.functional.gumbel_softmax(x, 0.7, hard)
            else:
                y = P.nn.functional.gumbel_softmax(
                    x, 0.7, hard, generator=torch.Generator().manual_seed(5))
            (y * P.to_tensor(B34)).sum().backward()
            outs.append((_np(y), _np(x.grad)))
        for a, b in zip(*outs):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_gumbel_softmax_hard_frequencies():
    """Gumbel-max: the hard sample's class frequencies over 40,000 draws
    are softmax(x), within 5 standard errors."""
    logits = np.array([0.5, -1.0, 1.5, 0.0], np.float32)
    x = torch.from_numpy(np.tile(logits, (40000, 1)))
    y = TF.gumbel_softmax(x, 0.3, hard=True,
                          generator=torch.Generator().manual_seed(1))
    # the straight-through sum y_hard + y - y rounds once: within an ulp
    torch.testing.assert_close(y.sum(-1), torch.ones(40000), rtol=0,
                               atol=2.5e-7)
    assert torch.equal(y.round(), y.round().clamp(0, 1))
    freq = y.mean(0).numpy()
    p = np.exp(logits) / np.exp(logits).sum()
    assert (np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / 40000)).all()


def _same_draws(monkeypatch, name, make):
    """jax.random.`name` monkeypatched to return make(shape) whatever
    its key."""
    def fake(key, *args, **kw):
        shape = args[1] if name == "bernoulli" else args[0]
        return jax.numpy.asarray(make(tuple(shape)))
    monkeypatch.setattr(jax.random, name, fake)


def test_rrelu_noise_path_matches_reference(monkeypatch):
    slopes = torch.empty((3, 4)).uniform_(
        0.1, 0.3, generator=torch.Generator().manual_seed(2))
    _same_draws(monkeypatch, "uniform", lambda s: slopes.numpy())
    want = pt.nn.functional.rrelu(pt.to_tensor(A34), 0.1, 0.3)
    got = ptt.nn.functional.rrelu(
        ptt.to_tensor(A34), 0.1, 0.3,
        generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_rrelu_statistics():
    x = -torch.ones(200000)
    y = TF.rrelu(x, 0.1, 0.3, generator=torch.Generator().manual_seed(3))
    s = -y
    assert s.min() >= 0.1 and s.max() <= 0.3
    assert abs(float(s.mean()) - 0.2) < 1e-3
    assert abs(float(s.std()) - 0.2 / np.sqrt(12)) < 1e-3
    pos = torch.rand(100, generator=torch.Generator().manual_seed(4))
    assert torch.equal(TF.rrelu(pos), pos)


@pytest.mark.parametrize("op,x,kw", [
    ("dropout2d", IMG, {}), ("dropout2d", NHWC, {"data_format": "NHWC"}),
    ("alpha_dropout", A34, {})])
def test_dropouts_noise_path_matches_reference(monkeypatch, op, x, kw):
    """The port's keep mask (its generator's draws, redrawn here) handed
    to the reference's op through jax.random.bernoulli."""
    def keep(shape):
        return (torch.rand(shape, generator=torch.Generator().manual_seed(
            6)) < 0.6).numpy()
    _same_draws(monkeypatch, "bernoulli", keep)
    want = getattr(pt.nn.functional, op)(pt.to_tensor(x), 0.4, **kw)
    got = getattr(ptt.nn.functional, op)(
        ptt.to_tensor(x), 0.4, generator=torch.Generator().manual_seed(6),
        **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_dropout2d_drops_whole_channels():
    x = torch.ones(64, 32, 3, 3)
    y = TF.dropout2d(x, 0.25, generator=torch.Generator().manual_seed(7))
    per = y.reshape(64, 32, -1)
    assert ((per == 0).all(-1) | (per == 1 / 0.75).all(-1)).all()
    assert abs(float((per[..., 0] == 0).float().mean()) - 0.25) < 0.03


def test_alpha_dropout_moments():
    """On N(0, 1) inputs the output keeps mean 0. Its variance is (1 -
    p)^2, not 1: the reference scales by a = ((1 + p alpha'^2) / (1 -
    p))^-1/2 where SELU's fixed point needs ((1 - p)(1 + p
    alpha'^2))^-1/2 (nn_ops.py:200, ROADMAP Queue C), and the port
    keeps the reference's function."""
    x = torch.randn(400000, generator=torch.Generator().manual_seed(8))
    y = TF.alpha_dropout(x, 0.3, generator=torch.Generator().manual_seed(9))
    assert abs(float(y.mean())) < 0.01
    assert abs(float(y.var()) - 0.7 ** 2) < 0.01
