"""paddle_tpu_torch.sparse against paddle_tpu.sparse on the CPU: COO and
CSR indices equal (row-major nonzero sites, zeros dropped; as given for
sparse_coo_tensor; sorted and summed by coalesce), values and products
within rtol = atol 1e-5 (f32 sums in other orders), the sparse nn
functionals' output sites equal and values within 1e-5, and a two-layer
sparse convolution stack's weight gradients within 1e-4 of the
reference's (27-tap f32 convolutions through XLA and through torch)."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place

JS, TS = pt.sparse, ptt.sparse
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _dense(shape, density=0.3, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(shape).astype(np.float32)
    return np.where(rng.random(shape) < density, d, 0).astype(np.float32)


def _same_coo(got, want, exact=False):
    assert got.shape == want.shape and got.nnz() == want.nnz()
    gi, wi = got.indices().numpy(), want.indices().numpy()
    assert gi.dtype == wi.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(got.values().numpy(),
                                      want.values().numpy())
    else:
        np.testing.assert_allclose(got.values().numpy(),
                                   want.values().numpy(), **TOL)


def _same_csr(got, want):
    assert got.shape == want.shape and got.nnz() == want.nnz()
    for m in ("crows", "cols"):
        np.testing.assert_array_equal(getattr(got, m)().numpy(),
                                      getattr(want, m)().numpy())
    np.testing.assert_allclose(got.values().numpy(), want.values().numpy(),
                               **TOL)


@pytest.mark.parametrize("shape,sparse_dim", [
    ((5, 6), None), ((3, 4, 5), None), ((4, 5, 3), 2), ((2, 3, 4), 1)])
def test_to_sparse_coo_equal(shape, sparse_dim):
    d = _dense(shape)
    d[0] = 0                                   # an empty leading slice
    got = ptt.to_tensor(d).to_sparse_coo(sparse_dim)
    want = pt.to_tensor(d).to_sparse_coo(sparse_dim)
    _same_coo(got, want, exact=True)
    np.testing.assert_array_equal(got.to_dense().numpy(), d)
    assert got.is_sparse() and got.is_sparse_coo() and not got.is_sparse_csr()


def test_to_sparse_csr_equal_and_round_trips():
    d = _dense((6, 7))
    d[2] = 0
    got = ptt.to_tensor(d).to_sparse_csr()
    want = pt.to_tensor(d).to_sparse_csr()
    _same_csr(got, want)
    assert got.is_sparse_csr()
    np.testing.assert_array_equal(got.to_dense().numpy(), d)
    _same_coo(got.to_sparse_coo(), want.to_sparse_coo(), exact=True)
    _same_csr(ptt.to_tensor(d).to_sparse_coo().to_sparse_csr(),
              pt.to_tensor(d).to_sparse_coo().to_sparse_csr())
    with pytest.raises(ValueError, match="2 sparse dimensions"):
        ptt.to_tensor(_dense((2, 3, 4))).to_sparse_csr()


def test_sparse_coo_tensor_as_given_and_coalesce():
    idx = np.array([[2, 0, 1, 0, 2], [1, 3, 0, 3, 1]], np.int64)
    vals = np.array([1.0, 2.0, 3.0, -2.0, 4.0], np.float32)
    got = TS.sparse_coo_tensor(idx, vals)
    want = JS.sparse_coo_tensor(idx, vals)
    _same_coo(got, want, exact=True)
    assert got.shape == [3, 4]
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  want.to_dense().numpy())
    # sorted row-major, duplicates summed, a zero sum kept
    _same_coo(TS.coalesce(got), JS.coalesce(want), exact=True)
    assert got.coalesce().nnz() == 3
    h = TS.sparse_coo_tensor(idx[:1], np.ones((5, 2), np.float32),
                             shape=[4, 2], dtype="float64")
    assert h.shape == [4, 2] and str(h.dtype) == "torch.float64"


def test_batched_csr_and_attention_mask_layout():
    b, s = 3, 4
    crows = np.tile(np.array([0, 1, 3, 4, 6]), b)
    cols = np.tile(np.array([0, 0, 1, 2, 1, 3]), b)
    vals = np.arange(b * 6, dtype=np.float32)
    got = TS.sparse_csr_tensor(crows, cols, vals, [b, s, s])
    want = JS.sparse_csr_tensor(crows, cols, vals, [b, s, s])
    _same_csr(got, want)
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  want.to_dense().numpy())


def _pair(d, fmt):
    t, j = ptt.to_tensor(d), pt.to_tensor(d)
    return (t.to_sparse_coo(), j.to_sparse_coo()) if fmt == "coo" else \
        (t.to_sparse_csr(), j.to_sparse_csr())


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_products(fmt):
    d = _dense((6, 5), seed=1)
    sx, jx = _pair(d, fmt)
    rng = np.random.default_rng(2)
    y, v = rng.standard_normal((5, 3)).astype(np.float32), \
        rng.standard_normal(5).astype(np.float32)
    for got, want in ((TS.matmul(sx, ptt.to_tensor(y)),
                       JS.matmul(jx, pt.to_tensor(y))),
                      (TS.mv(sx, ptt.to_tensor(v)),
                       JS.mv(jx, pt.to_tensor(v))),
                      (TS.addmm(ptt.to_tensor(d[:, :3]), sx, ptt.to_tensor(y),
                                beta=0.5, alpha=2.0),
                       JS.addmm(pt.to_tensor(d[:, :3]), jx, pt.to_tensor(y),
                                beta=0.5, alpha=2.0))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    a = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal((4, 5)).astype(np.float32)
    _same_coo(TS.masked_matmul(a, b, sx), JS.masked_matmul(a, b, jx))


def test_matmul_gradient_reaches_the_dense_operand():
    """torch.autograd records the product (the reference's eager tape
    records none: it computes on the arrays)."""
    d = _dense((6, 5), seed=3)
    y = ptt.to_tensor(np.ones((5, 2), np.float32), stop_gradient=False)
    TS.matmul(ptt.to_tensor(d).to_sparse_coo(), y).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(),
                               np.repeat(d.sum(0)[:, None], 2, 1), **TOL)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_elementwise_and_structure(fmt):
    d1, d2 = _dense((4, 6), seed=4), _dense((4, 6), seed=5)
    t1, j1 = _pair(d1, fmt)
    t2, j2 = _pair(d2, fmt)
    same = _same_coo if fmt == "coo" else _same_csr
    for op in ("add", "subtract", "multiply"):
        same(getattr(TS, op)(t1, t2), getattr(JS, op)(j1, j2))
    same(TS.transpose(t1, [1, 0]), JS.transpose(j1, [1, 0]))
    same(TS.reshape(t1, [6, 4]), JS.reshape(j1, [6, 4]))
    assert TS.is_same_shape(t1, t2)


def test_values_maps_and_activations():
    d1 = _dense((4, 6), seed=4)
    t1, j1 = _pair(d1, "coo")
    for m in ("sin", "neg", "relu"):
        _same_coo(getattr(t1, m)(), getattr(j1, m)())
    _same_coo(TS.nn.functional.relu(t1), JS.nn.functional.relu(j1))
    _same_coo(TS.nn.LeakyReLU(0.2)(t1), JS.nn.LeakyReLU(0.2)(j1))
    _same_coo(TS.nn.Softmax()(t1), JS.nn.Softmax()(j1))
    np.testing.assert_allclose(t1.astype("float64").values().numpy(),
                               d1[d1 != 0])


def test_csr_softmax_per_row():
    b, s = 2, 4
    crows = np.tile(np.array([0, 1, 3, 3, 6]), b)
    cols = np.tile(np.array([0, 0, 1, 0, 2, 3]), b)
    vals = np.random.default_rng(6).standard_normal(b * 6).astype(np.float32)
    got = TS.nn.Softmax()(TS.sparse_csr_tensor(crows, cols, vals, [b, s, s]))
    want = JS.nn.Softmax()(JS.sparse_csr_tensor(crows, cols, vals, [b, s, s]))
    _same_csr(got, want)


def _voxels(shape=(2, 5, 6, 6, 3), seed=7, density=0.15):
    rng = np.random.default_rng(seed)
    site = rng.random(shape[:-1]) < density
    d = rng.standard_normal(shape).astype(np.float32) * site[..., None]
    return d.astype(np.float32)


def _coo_pair(d):
    return ptt.to_tensor(d).to_sparse_coo(d.ndim - 1), \
        pt.to_tensor(d).to_sparse_coo(d.ndim - 1)


CONVS = [("conv3d", dict(padding=1)), ("conv3d", dict(stride=2, padding=1)),
         ("conv3d", dict(padding=[(0, 1), (1, 1), (1, 0)], dilation=1)),
         ("subm_conv3d", dict()), ("subm_conv3d", dict(padding=1)),
         ("conv2d", dict(padding=1, stride=2)), ("subm_conv2d", dict())]


@pytest.mark.parametrize("name,kw", CONVS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONVS)])
def test_sparse_convs_match_reference(name, kw):
    nd = 3 if name.endswith("3d") else 2
    d = _voxels() if nd == 3 else _voxels((2, 7, 7, 3))
    sx, jx = _coo_pair(d)
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((3,) * nd + (3, 4)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    got = getattr(TS.nn.functional, name)(sx, ptt.to_tensor(w),
                                          ptt.to_tensor(bias), **kw)
    want = getattr(JS.nn.functional, name)(jx, pt.to_tensor(w),
                                           pt.to_tensor(bias), **kw)
    _same_coo(got, want)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               want.to_dense().numpy(), **TOL)


@pytest.mark.parametrize("kw", [dict(kernel_size=2), dict(
    kernel_size=3, stride=2, padding=1), dict(kernel_size=(1, 2, 2))])
def test_max_pool3d_matches_reference(kw):
    d = _voxels()
    d[0, 0] = -5.0 * (d[0, 0] != 0)    # active sites below zero
    sx, jx = _coo_pair(d)
    _same_coo(TS.nn.functional.max_pool3d(sx, **kw),
              JS.nn.functional.max_pool3d(jx, **kw))
    _same_coo(TS.nn.MaxPool3D(**kw)(sx), JS.nn.MaxPool3D(**kw)(jx))


def _layers(P, S, relu):
    rng = np.random.default_rng(9)
    c1 = S.nn.SubmConv3D(3, 4, 3)
    c2 = S.nn.Conv3D(4, 2, 3, stride=2, padding=1)
    for c in (c1, c2):
        c.set_state_dict({k: rng.standard_normal(v.shape).astype(
            np.float32) * 0.3 for k, v in c.state_dict().items()})

    def run(x):
        h = c1(x)
        if relu:
            h = S.nn.ReLU()(h)
        return c2(h)
    return c1, c2, run


def test_two_layer_conv_stack_gradients():
    d = _voxels()
    grads = {}
    for P, S in ((ptt, TS), (pt, JS)):
        c1, c2, run = _layers(P, S, relu=False)
        out = run(P.to_tensor(d).to_sparse_coo(4))
        (out.to_dense() ** 2).sum().backward()
        grads[P.__name__] = [p.grad.numpy() for c in (c1, c2)
                             for p in (c.weight, c.bias)]
        grads[P.__name__ + "out"] = out
    _same_coo(grads["paddle_tpu_torchout"], grads["paddle_tpuout"])
    for g, w in zip(grads["paddle_tpu_torch"], grads["paddle_tpu"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_relu_between_convs_keeps_the_tape_in_the_port_only():
    """The reference's sparse ReLU (and max_pool3d) build their result
    from the values' arrays, so backward stops there and the first
    convolution gets no gradient; the port's keep the tape (ROADMAP
    Queue C, known gaps)."""
    d = _voxels()
    for P, S, reaches in ((ptt, TS, True), (pt, JS, False)):
        c1, c2, run = _layers(P, S, relu=True)
        (run(P.to_tensor(d).to_sparse_coo(4)).to_dense() ** 2).sum() \
            .backward()
        assert c2.weight.grad is not None
        assert (c1.weight.grad is not None) == reaches


def test_sparse_attention_matches_reference():
    b, h, s, d = 2, 2, 8, 4
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    cols, crow = [], [0]
    for r in range(s):
        cols += list(range(max(0, r - 2), r + 1)) if r != 5 else []
        crow.append(len(cols))
    nnz = len(cols)
    crows = np.tile(np.array(crow), b * h)
    colsb = np.tile(np.array(cols), b * h)
    kp = np.where(rng.random((b, s)) < 0.2, -1e4, 0).astype(np.float32)
    for T, S, P in ((ptt.to_tensor, TS, "port"), (pt.to_tensor, JS, "ref")):
        m = S.sparse_csr_tensor(crows, colsb, np.ones(b * h * nnz,
                                                      np.float32),
                                [b * h, s, s])
        out = S.nn.functional.attention(T(q), T(k), T(v), m,
                                        key_padding_mask=T(kp)).numpy()
        if P == "port":
            got = out
    np.testing.assert_allclose(got, out, rtol=1e-5, atol=1e-6)
    assert (got[:, :, 5] == 0).all()          # a row with no entry


def test_creation_on_the_requested_place():
    coo = TS.sparse_coo_tensor(np.array([[0, 1]]), np.ones(2, np.float32),
                               place="cpu")
    assert coo.values().place.is_cpu_place()
    csr = TS.sparse_csr_tensor([0, 1, 2], [1, 0], np.ones(2, np.float32),
                               [2, 2], place="cpu")
    assert csr.crows().place.is_cpu_place()
