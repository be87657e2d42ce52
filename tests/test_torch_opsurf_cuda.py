"""The op surfaces on the card (marked cuda: skips without one): what
only the card can show. cuFFT at sizes that are not powers of two
against the CPU's pocketfft; scatter_reduce's ties and the order of
index_add on the device; torch.nonzero's row-major order (the sparse
layouts' indices, equal to the CPU's); the sparse layouts, products and
convolutions on cuda against the same calls on CPU tensors. TF32 off for
the products. This file imports no JAX: the card's machine has none."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch import fft, geometric, signal, sparse
from paddle_tpu_torch.core.tensor import Tensor

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = saved


def _both(a):
    return Tensor._wrap(torch.from_numpy(a).cuda()), \
        Tensor._wrap(torch.from_numpy(a))


@pytest.mark.parametrize("n", [1000, 1023, 501, 97])
def test_cufft_sizes_not_powers_of_two(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((4, n)).astype(np.float32)
    g, c = _both(a)
    for name in ("fft", "rfft", "ihfft"):
        got = getattr(fft, name)(g, norm="ortho").numpy()
        want = getattr(fft, name)(c, norm="ortho").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    spec = fft.rfft(g)
    np.testing.assert_allclose(fft.irfft(spec, n=n).numpy(), a, atol=1e-5)
    # half precision is cast up before cuFFT (which takes f16 only at
    # powers of two, bf16 never)
    assert fft.rfft(g.astype("bfloat16")).dtype == torch.complex64
    assert fft.fft(g.astype("float16")).dtype == torch.complex64


def test_stft_istft_on_the_card_match_the_cpu():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((8, 16000)).astype(np.float32)
    g, c = _both(a)
    for args in (dict(n_fft=1024, hop_length=320), dict(n_fft=400,
                                                        hop_length=160)):
        sg, sc = signal.stft(g, **args), signal.stft(c, **args)
        np.testing.assert_allclose(sg.numpy(), sc.numpy(), rtol=1e-4,
                                   atol=1e-3)
        back = signal.istft(sg, length=16000, **args)
        np.testing.assert_allclose(back.numpy(), a, atol=1e-5)


def test_scatter_reduce_ties_and_index_add_on_the_device():
    x = np.array([[2.0], [2.0], [1.0], [7.0]], np.float32)
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([0, 0, 0, 5], np.int32)    # 5 is outside: dropped
    for op in ("max", "min"):
        grads = []
        for dev in ("cuda", "cpu"):
            t = torch.from_numpy(x if op == "max" else -x).to(dev) \
                .requires_grad_()
            out = geometric.send_u_recv(t, torch.from_numpy(src).to(dev),
                                        torch.from_numpy(dst).to(dev), op,
                                        out_size=3)
            out.sum().backward()
            grads.append(t.grad.cpu().numpy()[:, 0].tolist())
            assert out.detach().cpu().numpy()[1:].tolist() == [[0.0], [0.0]]
        assert grads[0] == grads[1] == [0.5, 0.5, 0.0, 0.0]
    # sums of many messages into few segments: atomics in any order,
    # within f32 rounding of the CPU's
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((5000, 16)).astype(np.float32)
    d = rng.integers(0, 7, 5000).astype(np.int32)
    s = np.arange(5000, dtype=np.int32)
    (fg, fc), (sg, sc), (dg, dc) = _both(feats), _both(s), _both(d)
    got = geometric.send_u_recv(fg, sg, dg, "mean").numpy()
    want = geometric.send_u_recv(fc, sc, dc, "mean").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_nonzero_order_and_sparse_layouts_on_cuda():
    rng = np.random.default_rng(3)
    d = np.where(rng.random((64, 48)) < 0.1,
                 rng.standard_normal((64, 48)), 0).astype(np.float32)
    g, c = _both(d)
    for conv in (lambda t: t.to_sparse_coo(), lambda t: t.to_sparse_csr()):
        sg, sc = conv(g), conv(c)
        for m in ("indices", "crows", "cols", "values"):
            if hasattr(sg, m):
                np.testing.assert_array_equal(getattr(sg, m)().numpy(),
                                              getattr(sc, m)().numpy())
        assert sg.values().place.is_gpu_place()
    y = rng.standard_normal((48, 8)).astype(np.float32)
    yg, yc = _both(y)
    for fmt in ("to_sparse_coo", "to_sparse_csr"):
        np.testing.assert_allclose(
            sparse.matmul(getattr(g, fmt)(), yg).numpy(),
            sparse.matmul(getattr(c, fmt)(), yc).numpy(), rtol=1e-5,
            atol=1e-5)
    h = rng.standard_normal((2, 6, 8, 8, 4)).astype(np.float32)
    h *= (rng.random((2, 6, 8, 8)) < 0.2)[..., None]
    w = rng.standard_normal((3, 3, 3, 4, 4)).astype(np.float32) * 0.2
    outs = []
    for dev in ("cuda", "cpu"):
        x = Tensor._wrap(torch.from_numpy(h).to(dev)).to_sparse_coo(4)
        wt = Tensor._wrap(torch.from_numpy(w).to(dev))
        o = sparse.nn.functional.max_pool3d(
            sparse.nn.functional.conv3d(
                sparse.nn.functional.subm_conv3d(x, wt), wt, stride=2,
                padding=1), 2)
        outs.append((o.indices().numpy(), o.values().numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-4)


def test_distribution_and_quanter_on_the_card():
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch import quantization as Q
    P.seed(0)
    loc = Tensor._wrap(torch.zeros(4096, 17, device="cuda"))
    d = D.Normal(loc, Tensor._wrap(torch.ones(4096, 17, device="cuda")))
    s = d.sample((4,))
    assert s.place.is_gpu_place() and abs(float(s.numpy().mean())) < 0.01
    q = Q.FakeQuanterWithAbsMaxObserverLayer()
    q.cuda()
    q.train()
    q(torch.linspace(-3, 3, 100, device="cuda"))
    assert q.scale.place.is_gpu_place() and float(q.scale.numpy()[0]) == 3.0


def test_qat_train_step_captures_and_leaves_the_observers():
    """A QAT model's TrainStep captures its graph on the card (the fake
    quant allocates nothing from the host inside a capture) and moves no
    observer; its losses fall."""
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.optimizer import SGD
    P.seed(1)
    m = P.nn.Sequential(P.nn.Linear(8, 16, device="cuda"), P.nn.ReLU(),
                        P.nn.Linear(16, 2, device="cuda"))
    q = Q.FakeQuanterWithAbsMaxObserver()
    m = Q.QAT(Q.QuantConfig(activation=q, weight=q)).quantize(m)
    m.train()
    x, y = torch.randn(32, 8, device="cuda"), torch.randn(32, 2,
                                                           device="cuda")
    m(x)
    quanters = [s for s in m.sublayers()
                if isinstance(s, Q.FakeQuanterWithAbsMaxObserverLayer)]
    before = [s.scale.numpy().copy() for s in quanters]
    step = P.jit.TrainStep(m, SGD(learning_rate=0.05,
                                  parameters=m.parameters()),
                           lambda mm, a, b: ((mm(a) - b) ** 2).mean())
    losses = [float(step(x, y)) for _ in range(4)]
    assert losses[-1] < losses[0]
    for s, b in zip(quanters, before):
        np.testing.assert_array_equal(s.scale.numpy(), b)
